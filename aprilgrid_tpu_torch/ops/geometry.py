"""Vectorized 2-D geometry predicates.

Tensor ports of the reference's scalar helpers (src/math_util.rs:5-33) and
of the quad validity gate (is_valid_quad, src/saddle.rs:17-67), as the JAX
package's ``ops/geometry.py`` has them. All functions broadcast over
leading dimensions, so one call evaluates thousands of candidate quads.

Each expression keeps the JAX package's f32 op order: the decomposed gate
tables of ``ops/quads.py`` and ``ops/board.py`` are bit-identical to
``is_valid_quad`` only because they repeat these op sequences. Degrees and
radians are one multiply by the f32 constant, as ``jnp.degrees`` and
``jnp.radians`` compute them.
"""

from __future__ import annotations

import math

import torch

from .compact import take

# f32(pi / 180) and f32(180 / pi): the Python floats are rounded to f32
# when they multiply an f32 tensor
_RAD = math.pi / 180.0
_DEG = 180.0 / math.pi


def rust_round(x: torch.Tensor) -> torch.Tensor:
    """f32::round — half away from zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def radians(x: torch.Tensor) -> torch.Tensor:
    return x * _RAD


def degrees(x: torch.Tensor) -> torch.Tensor:
    return x * _DEG


def theta_distance_degree(t0: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """Line-orientation distance folded to [0, 90] (src/math_util.rs:15-23)."""
    d = t0 - t1 + 90.0
    d = torch.where(d < 0.0, d + 180.0, d)
    d = torch.where(d > 180.0, d - 180.0, d)
    return torch.where(d > 90.0, d - 90.0, 90.0 - d)


def cross(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    return v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0]


def dot(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    return v0[..., 0] * v1[..., 0] + v0[..., 1] * v1[..., 1]


def angle_degree(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Signed angle from v0 to v1, degrees (src/math_util.rs:31-33)."""
    return degrees(torch.atan2(cross(v0, v1), dot(v0, v1)))


def is_valid_quad(
    p_s0: torch.Tensor,
    t_s0: torch.Tensor,
    p_d0: torch.Tensor,
    t_d0: torch.Tensor,
    p_s1: torch.Tensor,
    p_d1: torch.Tensor,
    t_d1: torch.Tensor,
) -> torch.Tensor:
    """Vectorized is_valid_quad (src/saddle.rs:17-67).

    Positions are (..., 2); thetas are (...). Only s0/d0/d1 thetas enter
    the gates (s1's does not), matching the reference.
    """
    ok = theta_distance_degree(t_d0, t_d1) <= 5.0

    v01 = p_d0 - p_s0
    v03 = p_d1 - p_s0
    v02 = p_s1 - p_s0

    # white-block filter: diagonal vs s0's ridge direction in [60, 120] deg
    rad = radians(t_s0)
    v_theta = torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)
    ang = torch.abs(angle_degree(v02, v_theta))
    ok = ok & (ang >= 60.0) & (ang <= 120.0)

    c0 = cross(v01, v02)
    c1 = cross(v02, v03)
    ok = ok & (c0 * c1 >= 0.0)

    v12 = p_s1 - p_d0
    v23 = p_d1 - p_s1
    c01 = cross(v01, v12)
    c12 = cross(v12, v23)
    ok = ok & (c01 * c12 >= 0.0)

    v30 = p_s0 - p_d1
    a0 = angle_degree(v01, v12)
    a1 = angle_degree(v12, v23)
    a2 = angle_degree(v23, v30)
    a3 = angle_degree(v30, v01)
    ok = ok & (torch.abs(a0 - a2) <= 10.0) & (torch.abs(a1 - a3) <= 10.0)

    return ok & (dot(v01, v02) >= 0.0) & (dot(v03, v02) >= 0.0)


def is_valid_quad_idx(p: torch.Tensor, theta: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """is_valid_quad over index quads ``q`` (B, ..., 4) into each frame's
    saddles, ``p`` (B, N, 2) and ``theta`` (B, N)."""
    pq = take(p, q)          # (B, ..., 4, 2)
    t = take(theta, q)       # (B, ..., 4)
    return is_valid_quad(
        pq[..., 0, :], t[..., 0],
        pq[..., 1, :], t[..., 1],
        pq[..., 2, :],
        pq[..., 3, :], t[..., 3],
    )
