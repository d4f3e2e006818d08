"""aprilgrid_tpu_torch — the AprilGrid detector in PyTorch with CUDA kernels.

A port of the JAX package ``aprilgrid_tpu`` (which stays the reference)
to PyTorch and hand-written CUDA kernels for NVIDIA Hopper. So far it
carries the hybrid detector, exact and turbo (``decimate=True/"auto"``):
dense front-end and tag decode on the card, board search in native C++ on
the host.

Public API (mirrors the reference's surface, reference src/lib.rs:1-8):

* :class:`TagDetector` — ``detect``, ``detect_batch`` and
  ``refined_saddle_points``; runs on the card
  by default (``device="cuda"``), on the plain PyTorch versions of the
  kernels with ``device="cpu"``.
* :class:`DetectorParams` — tuning knobs.
* :class:`TagFamily` — supported tag families.
"""

import torch

from .config import Capacities, DetectorParams, PipelineConstants
from .detector import TagDetector
from .families import FamilySpec, TagFamily, get_family

# Every plane stays f32 at full precision: TF32 convolutions or products
# would move the saddle response threshold and the fits.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__all__ = [
    "Capacities",
    "DetectorParams",
    "FamilySpec",
    "PipelineConstants",
    "TagDetector",
    "TagFamily",
    "get_family",
]
