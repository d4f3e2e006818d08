"""Detector configuration.

All of the reference detector's inline magic numbers
(reference: src/detector.rs:25-41 plus constants scattered through
src/detector.rs / src/board.rs) are promoted to one frozen dataclass so the
whole pipeline is configured in a single place. Field names and defaults
are those of the JAX package's ``config.py``, so ``convert.params_from_dict``
can carry a configuration across unchanged.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    """User-facing tuning knobs (reference: src/detector.rs:25-41)."""

    tag_spacing_ratio: float = 0.3
    min_saddle_angle: float = 30.0
    max_saddle_angle: float = 60.0
    max_num_of_boards: int = 2


@dataclasses.dataclass(frozen=True)
class PipelineConstants:
    """Fixed algorithm constants of the reference pipeline.

    Each field cites where the reference hardcodes the value.
    """

    blur_sigma: float = 1.5                  # src/detector.rs:410
    response_threshold_ratio: float = 0.05   # src/detector.rs:418
    rochade_half_patch: int = 2              # src/detector.rs:430
    rochade_move_threshold: float = 1.0      # src/detector.rs:202
    saddle_k_ratio: float = 0.1              # src/detector.rs:436 (k >= max_k/10)
    quad_nn: int = 50                        # src/detector.rs:550
    same_theta_max_deg: float = 5.0          # src/detector.rs:557
    diff_theta_min_deg: float = 80.0         # src/detector.rs:559
    max_seeds: int = 30                      # src/detector.rs:617
    early_exit_score: int = 36               # src/detector.rs:627
    decode_margin: float = 0.5               # src/detector.rs:459
    min_contrast: int = 50                   # src/detector.rs:97
    valid_brightness_threshold: int = 10     # src/detector.rs:462
    max_invalid_bit: int = 3                 # src/detector.rs:462
    expand_radius_factor: float = 0.5        # src/board.rs:183 (radius^2 = 0.5*edge^2)
    expand_theta_max_deg: float = 5.0        # src/board.rs:185
    expand_nn: int = 3                       # src/board.rs:194


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Fixed capacities of the pipeline's arrays.

    The reference uses dynamically sized Vec/HashMap everywhere; here every
    set is a fixed-capacity padded array with a validity mask. Defaults are
    sized for the bundled test set (iphone.png needs ~300 live saddles for
    66 tags) with generous headroom. The hybrid path reads ``max_saddles``,
    ``grid_radius`` and ``max_tags``; the other fields size the on-device
    board search, which this package does not have yet, and are kept so
    a configuration carries across unchanged.
    """

    max_clusters: int = 4096
    max_masked: int = 98304
    max_saddles: int = 768        # refined saddles kept (in cluster order)
    max_quads: int = 32
    max_boards: int = 32
    seeds_per_group: int = 1
    max_attempts: int = 64
    knn_pool: int = 64
    grid_radius: int = 12         # board grid coords in [-R, R] (6x11 fits)
    max_tags: int = 96            # decoded tags per board pass
    label_prop_rounds: int = 64


DEFAULT_PARAMS = DetectorParams()
CONSTANTS = PipelineConstants()
DEFAULT_CAPACITIES = Capacities()
