"""Hand-written CUDA kernels of the hybrid detector's main path.

Each public function here is a wrapper: on a CPU tensor it runs its plain
PyTorch version (the reference the kernel is held against); on a CUDA
tensor it launches its kernel from ``csrc/`` or raises — it never falls
back. ``LAUNCHES`` counts kernel launches per wrapper (plain runs do not
count), so a run can show that the main path went through the kernels.
"""

LAUNCHES = {"front_kernel": 0, "cluster_rochade_raw": 0, "hamming_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
