"""Input adapters, the counterpart of the reference's kornia adapter.

The reference feature-gates a kornia image adapter (detect_kornia,
src/detector.rs:478-503: u8 1- or 3-channel images wrapped and dispatched
to detect). Here the adapter takes the Python array ecosystem:

* :func:`to_detector_input` — torch tensors (CPU or CUDA; HW, HWC or CHW),
  numpy arrays and any ``__dlpack__`` producer, normalised to the
  detector's layouts as a contiguous tensor on the input's device;
* :func:`detect_adapted` — ``detector.detect`` on the result.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

_DTYPES = (torch.uint8, torch.uint16, torch.float32)


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy(a)``, no copy, read-only arrays included.

    ``np.asarray`` of a PIL image is read-only, and PyTorch warns that
    writing through a tensor over it is undefined. The detector never
    writes into its input: every kernel and every plain version writes
    only tensors it allocated. So that one warning is silenced here, and
    only here; the tensor aliases ``a``."""
    if a.flags.writeable:
        return torch.from_numpy(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable",
                                UserWarning)
        return torch.from_numpy(a)


def to_detector_input(img) -> torch.Tensor:
    """Normalise an array-like image to the detector's layouts: (H, W) gray,
    (H, W, 2) gray+alpha, or (H, W, 3|4) RGB(A), each in uint8, uint16 or
    float32 (the reference's DynamicImage contract, src/detector.rs:409,507;
    its kornia adapter at :478-503 was narrower).

    The rules, checked in this order: a channel-first layout (C in 1-4
    leading, a trailing dim that is no channel count) moves to
    channels-last; a 1-channel axis is squeezed; any other layout raises
    ``ValueError``; float64 narrows to float32; a dtype other than
    u8/u16/f32 raises ``TypeError``.

    Returns a contiguous ``torch.Tensor`` on the input's device: a CUDA
    tensor stays on the card, a numpy array becomes a CPU tensor, another
    ``__dlpack__`` producer goes through ``torch.from_dlpack``. uint16
    moves and copies through its int16 view (few CUDA kernels take
    uint16)."""
    if isinstance(img, torch.Tensor):
        t = img.detach()
    elif isinstance(img, np.ndarray) or not hasattr(img, "__dlpack__"):
        t = from_numpy(np.ascontiguousarray(img))
    else:
        t = torch.from_dlpack(img)

    if t.ndim == 3:
        if t.shape[0] in (1, 2, 3, 4) and t.shape[2] not in (1, 2, 3, 4):
            t = t.permute(1, 2, 0)  # CHW -> HWC
        if t.shape[2] == 1:
            t = t[..., 0]
    if t.ndim not in (2, 3) or (t.ndim == 3 and t.shape[2] not in (2, 3, 4)):
        raise ValueError(f"unsupported image layout {tuple(t.shape)}")
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    if t.dtype not in _DTYPES:
        raise TypeError(f"only u8/u16/f32 images supported, got {t.dtype}")
    if t.dtype == torch.uint16:
        return t.view(torch.int16).contiguous().view(torch.uint16)
    return t.contiguous()


def detect_adapted(detector, img) -> dict[int, list[tuple[float, float]]]:
    """``detector.detect`` over any supported array-like (the reference's
    detect_kornia)."""
    return detector.detect(to_detector_input(img))
