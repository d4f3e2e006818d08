// Hamming table scan: per rotated bit row, the minimum Hamming distance
// over the family code table and the FIRST code index reaching it.
//
// Replaces the JAX package's pallas/decode.py::hamming_scan, which runs
// the distance as a 0/1 matmul on the MXU (ham = |r| + |c| - 2 r.c) and
// reduces min/argmin in VMEM. For 0/1 rows that is exactly the popcount of
// the XOR, so here each block packs the code table (nb <= 64 bits per
// code) into uint64 words in shared memory, and each thread packs one row
// and scans the table in order, keeping the first minimum (strict <), as
// the reference's best_tag scan does (src/detector.rs:142-169).
//
// Bound on the H100: neither, at the main path's sizes. The input is
// rows x nb f32 (a few hundred KB per chunk) and the work is
// rows x codes popcounts (~7M at 32 frames x 384 rows x 587 codes); both
// bounds are microseconds and the launch dominates. The design keeps the
// table in shared memory so the scan's inner loop is one shared load, an
// XOR and a popcount.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
hamming_scan_kernel(const float* rows, int n_rows, int nb, const float* codes,
                    int n_codes, float* out_min, int* out_idx) {
  extern __shared__ unsigned long long table[];
  for (int j = threadIdx.x; j < n_codes; j += THREADS) {
    unsigned long long word = 0ull;
    for (int k = 0; k < nb; ++k)
      if (codes[(size_t)j * nb + k] > 0.5f) word |= 1ull << k;
    table[j] = word;
  }
  __syncthreads();
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n_rows) return;
  unsigned long long word = 0ull;
  for (int k = 0; k < nb; ++k)
    if (rows[(size_t)r * nb + k] > 0.5f) word |= 1ull << k;
  int best = 65, best_j = 0;
  for (int j = 0; j < n_codes; ++j) {
    int d = __popcll(word ^ table[j]);
    if (d < best) {
      best = d;
      best_j = j;
    }
  }
  out_min[r] = (float)best;
  out_idx[r] = best_j;
}

}  // namespace

// rows: (n_rows, nb) f32 0/1; codes: (n_codes, nb) f32 0/1; nb <= 64.
// out_min: (n_rows,) f32; out_idx: (n_rows,) int32. Returns
// cudaGetLastError().
extern "C" int ag_hamming_scan(const void* rows, int n_rows, int nb,
                               const void* codes, int n_codes, void* out_min,
                               void* out_idx, void* stream) {
  if (n_rows == 0) return 0;
  const size_t smem = (size_t)n_codes * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hamming_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((n_rows + THREADS - 1) / THREADS);
  hamming_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)rows, n_rows, nb, (const float*)codes, n_codes,
      (float*)out_min, (int*)out_idx);
  return (int)cudaGetLastError();
}
