"""The benchmark's one traffic generator: a cell's frame pool and the order
and timing in which its frames reach the detector.

A configuration (``configs/<name>.json``) names its captures, how many
pool frames each gives, and the jitter that makes each pool frame its own:
an integer shift of up to ``shift_px`` on both axes (the exposed border
filled with the capture's per-channel median), an exposure gain drawn from
``gain``, and Gaussian sensor noise of ``noise_dn`` (x 257 for 16-bit
frames). The shifts and gains come from ``numpy.random.default_rng(seed)``;
the noise from a ``torch.Generator`` on the pool's device, seeded from the
same ``seed``, in one call a frame. The same seed gives the same pool.

A traffic mix (``traffic/<name>.json``) is a closed loop (``"loop":
"closed"``): batches of ``batch`` frames sent back to back; each batch
holds every pool frame equally often (``batch`` a multiple of the pool), in
a seeded order, and ``distinct_batches`` such batches are built in set-up
and sent in turn.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``: a configuration, a traffic mix or a
    workload, found by its name."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_capture(spec: dict) -> np.ndarray:
    """A capture of a configuration, checked against its sha256, as the
    reference's ``load_image`` reads it: 16-bit gray as uint16, 8-bit gray
    as uint8 (H, W), anything else as RGB uint8 (H, W, 3)."""
    from PIL import Image

    path = ROOT / spec["file"]
    data = path.read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if digest != spec["sha256"]:
        raise ValueError(f"{spec['file']}: sha256 {digest}, configuration says {spec['sha256']}")
    with Image.open(io.BytesIO(data)) as im:
        if im.mode in ("I;16", "I;16B"):
            return np.array(im, dtype=np.uint16)
        if im.mode == "L":
            return np.array(im, dtype=np.uint8)
        return np.array(im.convert("RGB"), dtype=np.uint8)


def jitter_params(config: dict, seed: int) -> list[dict]:
    """Per pool frame: the capture index, shift (dy, dx) and gain, from
    ``seed``, in pool order (the captures' frames in the configuration's
    order)."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    j = config["jitter"]
    s = int(j["shift_px"])
    lo, hi = (float(g) for g in j["gain"])
    out = []
    for ci, cap in enumerate(config["captures"]):
        for _ in range(int(cap["frames"])):
            dy, dx = (int(v) for v in rng.integers(-s, s + 1, size=2))
            out.append({"capture": ci, "dy": dy, "dx": dx, "gain": float(rng.uniform(lo, hi))})
    return out


def _shifted(cap, dy: int, dx: int, fill):
    """``cap`` moved by (dy, dx) pixels, the exposed border set to
    ``fill`` (per channel)."""
    import torch

    h, w = cap.shape[:2]
    out = torch.empty_like(cap)
    out[:] = fill
    ys, yd = (slice(0, h - dy), slice(dy, h)) if dy >= 0 else (slice(-dy, h), slice(0, h + dy))
    xs, xd = (slice(0, w - dx), slice(dx, w)) if dx >= 0 else (slice(-dx, w), slice(0, w + dx))
    out[yd, xd] = cap[ys, xs]
    return out


def make_pool(config: dict, seed: int, device: str = "cpu") -> tuple[np.ndarray, list[dict]]:
    """The cell's frame pool as one numpy array (P, H, W[, C]) in the
    captures' dtype, and each frame's jitter. ``device`` is where the noise
    is drawn and the frames composed (the card in a run, the CPU in
    tests); the same seed on the same kind of device gives the same
    pool."""
    import torch

    caps = [load_capture(c) for c in config["captures"]]
    if len({(c.shape, c.dtype) for c in caps}) != 1:
        raise ValueError("a configuration's captures must share one shape and dtype")
    dtype = caps[0].dtype
    top = float(np.iinfo(dtype).max)
    sigma = float(config["jitter"]["noise_dn"]) * (257.0 if dtype == np.uint16 else 1.0)
    params = jitter_params(config, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    dev_caps, fills = [], []
    for c in caps:
        t = torch.from_numpy(c.astype(np.float32)).to(device)
        dev_caps.append(t)
        fills.append(torch.from_numpy(
            np.median(c.reshape(-1, 1 if c.ndim == 2 else c.shape[2]), axis=0)
            .astype(np.float32).reshape(() if c.ndim == 2 else (c.shape[2],))).to(device))
    pool = np.empty((len(params),) + caps[0].shape, dtype)
    for i, p in enumerate(params):
        f = _shifted(dev_caps[p["capture"]], p["dy"], p["dx"], fills[p["capture"]])
        f.mul_(p["gain"])
        f.add_(torch.randn(f.shape, generator=gen, device=device).mul_(sigma))
        f.round_().clamp_(0.0, top)
        pool[i] = f.cpu().numpy().astype(dtype)
    return pool, params


def balanced_order(rng: np.random.Generator, n: int, length: int) -> np.ndarray:
    """``length`` indices into ``range(n)``, each used equally often (to
    within one), in a seeded order."""
    return rng.permutation(np.resize(np.arange(n), length))


def closed_batches(pool: np.ndarray, traffic: dict, seed: int) -> tuple[list, list]:
    """The closed loop's batches (numpy arrays, built once) and, for each,
    the pool index of every frame."""
    batch, n = int(traffic["batch"]), len(pool)
    if batch % n:
        raise ValueError(f"batch {batch} is not a multiple of the pool's {n} frames")
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    orders = [balanced_order(rng, n, batch) for _ in range(int(traffic["distinct_batches"]))]
    return [np.ascontiguousarray(pool[o]) for o in orders], orders
