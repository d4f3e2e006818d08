"""Hand-written CUDA kernels of the hybrid detector's exact, turbo and plane
paths.

Each public function here is a wrapper: on a CPU tensor it runs its plain
PyTorch version (the reference the kernel is held against); on a CUDA
tensor it launches its kernel from ``csrc/`` or raises — it never falls
back. ``LAUNCHES`` counts kernel launches per wrapper (plain runs do not
count), so a run can show that the main path went through the kernels.
"""

LAUNCHES = {
    "front_kernel": 0,
    "cluster_rochade_raw": 0,
    "hamming_scan": 0,
    "front_kernel_decimate": 0,
    "cluster_rochade_raw[luma_f32]": 0,  # the cluster kernel's f32-luma mode
    "nms_extract_raw": 0,
    "sparse_refine_raw": 0,
    "fused_frontend": 0,
    "gray_kernel": 0,
    "cluster_rochade": 0,                # the cluster kernel fed a blur plane
    "front_kernel[emit_blur]": 0,        # the front kernel writing its blur plane
    "decode_packed": 0,                  # a pass's decode, the scan included
    "nms_extract_raw[merge]": 0,         # the NMS kernel with the peak merge
    # the row-sharding modes (a window of a taller frame: row_off, global_h)
    "front_kernel[row_off]": 0,
    "front_kernel_decimate[row_off]": 0,
    "cluster_rochade_raw[row_off]": 0,
    "cluster_rochade_raw[luma_f32,row_off]": 0,
    "nms_extract_raw[row_off]": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
