"""The control of the benchmark's comparison: the frozen reference with its
front-end planes in bfloat16, the precision below the float32 the detector
states, and the step a later change could be tempted by (half the bytes of
every plane). The luma, blur and Hessian-response planes are rounded to
bfloat16 (round to nearest, ties to even) as they are stored; the rest is
the reference's own arithmetic. ``compare.py``'s limits have to fail it.
"""

from __future__ import annotations

import numpy as np

from . import numpy_ref as ref


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to the nearest bfloat16 (ties to even), as
    float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def refined_saddle_points_bf16(img: np.ndarray, params):
    """``numpy_ref.refined_saddle_points`` with each plane stored in
    bfloat16."""
    luma = bf16(ref.to_luma32f(img))
    blur = bf16(ref.gaussian_blur_f32(luma, 1.5))
    resp = bf16(ref.hessian_response(blur))
    thr = float(resp.min()) * 0.05
    centers = ref.saddle_cluster_centers(resp, thr)
    saddles = ref.rochade_refine(blur, centers, 2)
    if not saddles:
        return []
    max_k = max(s.k for s in saddles) / 10.0
    return [
        s
        for s in saddles
        if s.k >= max_k and params.min_saddle_angle <= s.phi <= params.max_saddle_angle
    ]


class ControlDetector(ref.TagDetector):
    def refined_saddle_points(self, img):
        return refined_saddle_points_bf16(img, self.params)
