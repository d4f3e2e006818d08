"""aprilgrid_tpu_torch — the AprilGrid detector in PyTorch with CUDA kernels.

A port of the JAX package ``aprilgrid_tpu`` (which stays the reference)
to PyTorch and hand-written CUDA kernels for NVIDIA Hopper. It carries
all that package does: the hybrid detector, exact and turbo
(``decimate=True/"auto"``): dense front-end and tag decode on the card,
board search in native C++ on the host; the xla mode (the board search on
the card too); its streaming ingest, input adapters, and data-, camera-
and pipeline-parallel forms over several devices; and the overlay,
live-stream and chart surfaces.

Public API (mirrors the reference's surface, reference src/lib.rs:1-8):

* :class:`TagDetector` — ``detect``, ``detect_batch`` and
  ``refined_saddle_points``; runs on the card
  by default (``device="cuda"``), on the plain PyTorch versions of the
  kernels with ``device="cpu"``.
* :class:`DetectorParams` — tuning knobs.
* :class:`TagFamily` — supported tag families.
* :func:`to_detector_input` / :func:`detect_adapted` (``adapters``) —
  torch tensors (CPU or CUDA; HW, HWC, CHW), numpy arrays and other
  ``__dlpack__`` producers normalised to the detector's layouts, on the
  input's device.
* :func:`detect_stream` (``parallel.streaming``) — batches uploaded ahead
  of the detect (pinned staging, a side stream); :class:`MultiCameraDetector`
  — synchronised cameras as one batch, each camera on its device of a
  ``camera`` mesh axis.
* :func:`detect_batch_sharded` and :func:`make_mesh`
  (``parallel.sharding``) — data-parallel ``detect_batch`` over a mesh
  axis; :class:`PipelineParallelDetector` (``parallel.pipeline_parallel``)
  — the front-end on one device, the decode on another.
* :func:`saddle_distance2`, :class:`Tag`, :class:`Saddle` — the
  reference's structs, for API parity.

Not exported, as in the JAX package (import the module):

* ``viz`` — ``render_overlay``, ``dump_overlay`` and
  ``write_timeline_html``: detection overlays and the timeline viewer.
* ``live`` — ``LiveStream``: the MJPEG/HTTP live viewer.
* ``boards.generator`` — ``AprilGridBoard``, ``render_png``,
  ``svg_string``, ``pdf_bytes``, ``generate_chart``: Kalibr-compatible
  charts; ``python -m aprilgrid_tpu_torch.boards`` is their command line.
"""

import torch

from .adapters import detect_adapted, to_detector_input
from .config import Capacities, DetectorParams, PipelineConstants
from .detector import Saddle, Tag, TagDetector, saddle_distance2
from .families import FamilySpec, TagFamily, get_family
from .parallel.pipeline_parallel import PipelineParallelDetector
from .parallel.sharding import detect_batch_sharded, make_mesh
from .parallel.streaming import MultiCameraDetector, detect_stream

__version__ = "0.3.0"

# Every plane stays f32 at full precision: TF32 convolutions or products
# would move the saddle response threshold and the fits.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__all__ = [
    "Capacities",
    "DetectorParams",
    "FamilySpec",
    "MultiCameraDetector",
    "PipelineConstants",
    "PipelineParallelDetector",
    "Saddle",
    "Tag",
    "TagDetector",
    "TagFamily",
    "detect_adapted",
    "detect_batch_sharded",
    "detect_stream",
    "get_family",
    "make_mesh",
    "saddle_distance2",
    "to_detector_input",
]
