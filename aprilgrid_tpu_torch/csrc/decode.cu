// Tag decode: the Hamming table scan, alone and inside the decode of a
// whole board pass.
//
// hamming_scan_kernel replaces the JAX package's
// pallas/decode.py::hamming_scan, which runs the distance as a 0/1 matmul
// on the MXU (ham = |r| + |c| - 2 r.c) and reduces min/argmin in VMEM. For
// 0/1 rows that is the popcount of the XOR. decode_packed_kernel is the
// counterpart of the jitted decode of one pass
// (aprilgrid_tpu/detector.py:234-275, `_decode_packed_fn`): the gather of
// the quads' corners from the packed saddles, the affine bit sampling,
// the 4-rotation scan and the canonical corner order, in one launch.
//
// Bound on the H100: neither bytes nor operations, at the main path's
// sizes. A pass's decode reads a few hundred KB and does a few million
// XOR + popcounts; both bounds are a microsecond or less. What sets the
// time is the launch with the chain of dependent loads (qarr, corners,
// luma8) and the scan at the card's popcount rate. The design
// (decode.cuh): a warp per row or quad slot, the row packed into one word
// by two ballots, lanes splitting the codes with a first-minimum key
// (d << 20) | j, one warp reduction; the table as uint64 words in shared
// memory.
#include "decode.cuh"

namespace {

using agdecode::FULL;
using agdecode::KEY_INDEX;
using agdecode::KEY_SHIFT;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_BLOCKS_PER_SM = 2;

// Rows in a grid-stride loop, a warp per row; each block first packs the
// f32 table into words, a warp per code.
__global__ void __launch_bounds__(THREADS)
hamming_scan_kernel(const float* rows, int n_rows, int nb, const float* codes,
                    int n_codes, float* out_min, int* out_idx) {
  extern __shared__ unsigned long long table[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int j = warp; j < n_codes; j += WARPS) {
    const unsigned long long word =
        agdecode::row_word(codes + (size_t)j * nb, nb, lane);
    if (lane == 0) table[j] = word;
  }
  __syncthreads();
  for (int r = blockIdx.x * WARPS + warp; r < n_rows; r += gridDim.x * WARPS) {
    const unsigned long long word[1] = {
        agdecode::row_word(rows + (size_t)r * nb, nb, lane)};
    unsigned key[1];
    agdecode::first_min_keys<1>(word, table, n_codes, lane, key);
    if (lane == 0) {
      out_min[r] = (float)(key[0] >> KEY_SHIFT);
      out_idx[r] = (int)(key[0] & KEY_INDEX);
    }
  }
}

// f32::round (half away from zero) as the plain version computes it:
// sign(x) * floor(|x| + 0.5).
__device__ __forceinline__ float rust_round(float x) {
  const float s = (float)((0.f < x) - (x < 0.f));
  return __fmul_rn(s, floorf(__fadd_rn(fabsf(x), 0.5f)));
}

// torch.clamp(x, min=0): NaN stays NaN.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// torch.clamp(x.to(int64), 0, hi) for x >= 0 or NaN (the conversion
// saturates, NaN gives 0, as on the card).
__device__ __forceinline__ long long index_of(float x, int hi) {
  const long long v = __float2ll_rz(x);
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// A warp per quad slot (frame b, slot t) of the (B, dcap) grid, every slot
// computed in full (a failed slot still gets the corner order of the
// rotation its scan chose). Row of `out`: [id, valid, x0, y0, ... x3, y3].
__global__ void __launch_bounds__(THREADS)
decode_packed_kernel(const float* packed, int n_rows, const unsigned char* luma8,
                     int hp, int wp, const int* qarr, int bsz, int dcap, int h,
                     int w, const float* pinv, const float* grid, const int* src,
                     int nb, const unsigned long long* words, int n_codes,
                     int hamming, int valid_brightness_threshold,
                     int max_invalid_bit, int min_contrast, float* out) {
  extern __shared__ unsigned long long table[];
  for (int j = threadIdx.x; j < n_codes; j += THREADS) table[j] = words[j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // warp w of block k takes slot w * gridDim.x + k: a block's warps lie
  // across the frames and slots, so the cheap padding slots at the end of
  // each frame's range spread over the blocks and SMs
  const int slot = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  if (slot >= bsz * dcap) return;  // whole warps, after the barrier
  const int b = slot / dcap, t = slot - b * dcap;

  // the slot's quad: saddle rows, -1 padding clamped to 0; valid below
  // the frame's count
  const int* qrow = qarr + (size_t)b * (dcap * 4 + 1);
  const bool quad_valid = t < qrow[dcap * 4];
  float c[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = min(max(qrow[t * 4 + k], 0), n_rows - 1);
    const float2 p = *reinterpret_cast<const float2*>(
        packed + ((size_t)b * n_rows + q) * 4);
    c[2 * k] = p.x;
    c[2 * k + 1] = p.y;
  }

  // decode_positions: the corner bound gate, the affine in the plain
  // version's op order (0 + the first product, so -0 becomes +0)
  bool corners_ok = quad_valid;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    corners_ok = corners_ok && clamp0(rust_round(c[2 * k])) < (float)w &&
                 clamp0(rust_round(c[2 * k + 1])) < (float)h;
  float prm[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(pinv + p * 8 + k), c[k]));
    prm[p] = acc;
  }

  // bit_code: lane k samples bits k and k + 32 (position order)
  const unsigned char* plane = luma8 + (size_t)b * hp * wp;
  int v[2];
  bool in_frame = true, on[2];
  unsigned lmin = 256u, lmax = 0u;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = lane + 32 * s;
    on[s] = i < nb;
    v[s] = 0;
    if (!on[s]) continue;
    const float gx = __ldg(grid + 2 * i), gy = __ldg(grid + 2 * i + 1);
    const float px = __fadd_rn(__fadd_rn(__fmul_rn(prm[0], gx), __fmul_rn(prm[1], gy)), prm[2]);
    const float py = __fadd_rn(__fadd_rn(__fmul_rn(prm[3], gx), __fmul_rn(prm[4], gy)), prm[5]);
    const float sx = clamp0(rust_round(px)), sy = clamp0(rust_round(py));
    in_frame = in_frame && sx < (float)w && sy < (float)h;
    v[s] = plane[index_of(sy, h - 1) * wp + index_of(sx, w - 1)];
    lmin = min(lmin, (unsigned)v[s]);
    lmax = max(lmax, (unsigned)v[s]);
  }
  const int mn = (int)__reduce_min_sync(FULL, lmin);
  const int mx = (int)__reduce_max_sync(FULL, lmax);
  const int mid = (mn + mx + 1) >> 1;
  const int invalid =
      __popc(__ballot_sync(FULL, on[0] && abs(mid - v[0]) < valid_brightness_threshold)) +
      __popc(__ballot_sync(FULL, on[1] && abs(mid - v[1]) < valid_brightness_threshold));
  const bool sample_ok = __all_sync(FULL, in_frame);
  const bool code_ok = mx - mn >= min_contrast && invalid <= max_invalid_bit;
  // bit i = position i brighter than mid (MSB-first order)
  const unsigned long long msb =
      agdecode::ballot_word(on[0] && v[0] > mid, on[1] && v[1] > mid);

  // the 4 rotated LSB-first words: bit i of rotation r is position
  // src[r][i] (the flip and _rot_perms, ops/decode.py:66-74)
  unsigned long long rot[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool lo = on[0] && ((msb >> __ldg(src + r * nb + lane)) & 1ull);
    const bool hi = on[1] && ((msb >> __ldg(src + r * nb + lane + 32)) & 1ull);
    rot[r] = agdecode::ballot_word(lo, hi);
  }
  unsigned key[4];
  if (rot[0] == rot[1] && rot[0] == rot[2] && rot[0] == rot[3]) {
    // one word under every rotation (a padding slot's blank sample, a
    // symmetric pattern): its keys are equal, scan it once
    const unsigned long long once[1] = {rot[0]};
    unsigned k[1];
    agdecode::first_min_keys<1>(once, table, n_codes, lane, k);
    key[0] = key[1] = key[2] = key[3] = k[0];
  } else {
    agdecode::first_min_keys<4>(rot, table, n_codes, lane, key);
  }

  // best_tag: the first rotation under the family's distance, else 0
  int rotation = 0;
  bool tag_ok = false;
#pragma unroll
  for (int r = 3; r >= 0; --r)
    if ((int)(key[r] >> KEY_SHIFT) < hamming) {
      rotation = r;
      tag_ok = true;
    }
  const bool valid = corners_ok && sample_ok && code_ok && tag_ok;
  // lanes 0-9 write the row; corner j is corner (3 - j + rotation) % 4
  if (lane < 10) {
    float val;
    if (lane == 0) {
      val = valid ? (float)(key[rotation] & KEY_INDEX) : -1.f;
    } else if (lane == 1) {
      val = valid ? 1.f : 0.f;
    } else {
      const int j = (lane - 2) >> 1;
      val = c[2 * ((3 - j + rotation) & 3) + (lane & 1)];
    }
    out[(size_t)slot * 10 + lane] = val;
  }
}

int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// rows: (n_rows, nb) f32 0/1; codes: (n_codes, nb) f32 0/1; nb <= 64,
// n_codes < 2^20. out_min: (n_rows,) f32; out_idx: (n_rows,) int32.
// Returns a cudaError_t.
extern "C" int ag_hamming_scan(const void* rows, int n_rows, int nb,
                               const void* codes, int n_codes, void* out_min,
                               void* out_idx, void* stream) {
  if (n_rows == 0) return 0;
  const size_t smem = (size_t)n_codes * sizeof(unsigned long long);
  int err = allow_smem((const void*)hamming_scan_kernel, smem);
  if (err) return err;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  const int want = (n_rows + WARPS - 1) / WARPS;
  const int grid = want < SCAN_BLOCKS_PER_SM * sms ? want : SCAN_BLOCKS_PER_SM * sms;
  hamming_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)rows, n_rows, nb, (const float*)codes, n_codes,
      (float*)out_min, (int*)out_idx);
  return (int)cudaGetLastError();
}

// packed: (bsz, n_rows, 4) f32 saddle rows [x, y, theta, valid]; luma8:
// (bsz, hp, wp) u8; qarr: (bsz, dcap * 4 + 1) int32 quads | count; (h, w)
// the true frame; pinv (6, 8) f32, grid (nb, 2) f32, src (4, nb) int32 and
// words (n_codes,) uint64 the family's constants; out: (bsz, dcap, 10) f32.
// Returns a cudaError_t.
extern "C" int ag_decode_packed(const void* packed, int n_rows, const void* luma8,
                                int hp, int wp, const void* qarr, int bsz, int dcap,
                                int h, int w, const void* pinv, const void* grid,
                                const void* src, int nb, const void* words,
                                int n_codes, int hamming, int valid_brightness_threshold,
                                int max_invalid_bit, int min_contrast, void* out,
                                void* stream) {
  const int slots = bsz * dcap;
  if (slots == 0) return 0;
  const size_t smem = (size_t)n_codes * sizeof(unsigned long long);
  const int err = allow_smem((const void*)decode_packed_kernel, smem);
  if (err) return err;
  decode_packed_kernel<<<(slots + WARPS - 1) / WARPS, THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const float*)packed, n_rows, (const unsigned char*)luma8, hp, wp,
      (const int*)qarr, bsz, dcap, h, w, (const float*)pinv, (const float*)grid,
      (const int*)src, nb, (const unsigned long long*)words, n_codes, hamming,
      valid_brightness_threshold, max_invalid_bit, min_contrast, (float*)out);
  return (int)cudaGetLastError();
}
