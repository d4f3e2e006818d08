// Warp-level pieces of the Hamming table scan, shared by the standalone
// scan and the one-launch decode of a board pass (decode.cu).
//
// A bit row of nb <= 64 bits is one uint64 word, LSB first. A warp builds
// it with two ballots (lane k holds bits k and k + 32), and scans the code
// table with lanes splitting the codes: lane l takes codes l, l + 32, ...
// and keeps the smallest key (d << 20) | j, d the Hamming distance and j
// the code index (j < 2^20). One warp minimum of the keys then gives the
// smallest distance and, among the codes at that distance, the lowest
// index: the first minimum of the reference's in-order scan
// (best_tag, src/detector.rs:142-169).
#pragma once

#include <cuda_runtime.h>

namespace agdecode {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KEY_SHIFT = 20;
constexpr unsigned KEY_INDEX = (1u << KEY_SHIFT) - 1u;
// the key of an empty table: distance 65 (beyond any row), index 0
constexpr unsigned NO_CODE = 65u << KEY_SHIFT;

// The warp's 64-bit word of two per-lane bits: bit k of `lo` and bit k of
// `hi` become bits k and k + 32.
__device__ __forceinline__ unsigned long long ballot_word(bool lo, bool hi) {
  return (unsigned long long)__ballot_sync(FULL, lo) |
         ((unsigned long long)__ballot_sync(FULL, hi) << 32);
}

// The word of a 0/1 f32 row of nb values (> 0.5 is a one).
__device__ __forceinline__ unsigned long long row_word(const float* v, int nb,
                                                       int lane) {
  const bool lo = lane < nb && v[lane] > 0.5f;
  const bool hi = lane + 32 < nb && v[lane + 32] > 0.5f;
  return ballot_word(lo, hi);
}

// First-minimum keys of R words against the table (shared memory), the
// table read once for all R; every lane gets the R keys.
template <int R>
__device__ __forceinline__ void first_min_keys(
    const unsigned long long (&word)[R], const unsigned long long* table,
    int n_codes, int lane, unsigned (&key)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) key[r] = NO_CODE;
  for (int j = lane; j < n_codes; j += 32) {
    const unsigned long long code = table[j];
#pragma unroll
    for (int r = 0; r < R; ++r)
      key[r] = min(key[r],
                   ((unsigned)__popcll(word[r] ^ code) << KEY_SHIFT) | (unsigned)j);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) key[r] = __reduce_min_sync(FULL, key[r]);
}

}  // namespace agdecode
