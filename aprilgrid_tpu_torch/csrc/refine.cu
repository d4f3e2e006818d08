// Sparse refine kernel: padded raw frames + per-slot candidate centres ->
// one full-resolution ROCHADE saddle per valid slot.
//
// Replaces the JAX package's pallas/refine.py::sparse_refine_raw (the
// turbo path's re-refinement of the half-resolution survivors). The TPU
// kernel walks the valid prefix of a frame serially, one aligned 24-row
// window DMA per candidate, and evaluates the record densely on a (16, 256)
// sub-window. Here every (frame, slot) is a warp of its own, eight slots a
// block: a warp whose slot is not valid writes a row of zeros and leaves; a
// live warp gathers the 15x15 raw patch around the rounded centre with
// indices clamped to the image (the blur's edge replication), converts it
// to f32 luma (stencil.cuh formulas), runs the 7-tap blur horizontally then
// vertically down to the 9x9 support in its own shared-memory scratch
// (__syncwarp between the passes, no block barrier after the tap tables are
// staged), and evaluates the fit as a warp (rochade.cuh::fit_record_warp).
// The gates and the angles of ops/rochade.py (rounded centre at least hp2
// pixels from every edge; k, theta, phi of saddle_angles, in its op order)
// are evaluated here too, so the wrapper enqueues nothing but the launch.
// Valid slots need not be a prefix. The TPU kernel's lower width limit for
// RGB frames is a DMA-alignment matter and does not exist here.
//
// Bound on the H100: memory, and little of it — 225 raw pixels read and 32
// bytes written per slot; what the launch costs is the dispatch of ~2 k warp
// instructions per live slot.
#include "rochade.cuh"
#include "stencil.cuh"

namespace {

using namespace ag;

constexpr int RP = 15;        // raw patch side: 9 + 2 * blur radius
constexpr int RS = 9;         // fit support side
constexpr int RWARPS = 8;     // slots (warps) per block
constexpr float RAD2DEG = 57.29577951308232f;   // 180 / pi

// A warp's shared-memory scratch.
struct RefineScratch {
  float lum[RP * RP];
  float tmp[RP * RS];
  float bl[RS * RS];
  FitScratch fit;
};

// f32::round (half away from zero) as an int.
__device__ __forceinline__ int round_away(float x) {
  return (int)copysignf(floorf(__fadd_rn(fabsf(x), 0.5f)), x);
}

__global__ void __launch_bounds__(RWARPS * 32)
refine_kernel(const void* raw, int hp, int wp, int channels, int mode, int h,
              int w, Taps7 taps, const float* centers, const uint8_t* valid,
              int kcap, const __grid_constant__ FitTaps fit, float move_thr,
              int hp2, float* out) {
  __shared__ RefineScratch scratch[RWARPS];
  // the tap tables in shared memory: lanes read different rows of them
  __shared__ FitTaps ftaps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * RWARPS + warp, b = blockIdx.y;
  const size_t s = (size_t)b * kcap + slot;
  const bool live = slot < kcap && valid[s];
  // a slot that is not valid comes back as a row of zeros
  if (slot < kcap && !live && lane < 8) out[s * 8 + lane] = 0.0f;
  if (!__syncthreads_or(live)) return;
  const int* src = reinterpret_cast<const int*>(&fit);
  for (int k = threadIdx.x; k < (int)(sizeof(FitTaps) / sizeof(int)); k += RWARPS * 32)
    reinterpret_cast<int*>(&ftaps)[k] = src[k];
  __syncthreads();
  if (!live) return;   // from here on a warp works alone
  RefineScratch& sc = scratch[warp];
  const int cxr = round_away(centers[2 * s]), cyr = round_away(centers[2 * s + 1]);
  const bool inside = cyr >= hp2 && cyr < h - hp2 && cxr >= hp2 && cxr < w - hp2;
  // clamped into the image: an out-of-image centre fails the gate above,
  // its reads must be in range
  const int rx = min(max(cxr, 0), w - 1), ry = min(max(cyr, 0), h - 1);
  const size_t row_elems = (size_t)wp * channels;
  const size_t frame0 = (size_t)b * (hp + 16) * row_elems;
  for (int idx = lane; idx < RP * RP; idx += 32) {
    int y = idx / RP, x = idx % RP;
    int yy = min(max(ry - 7 + y, 0), h - 1);
    int xx = min(max(rx - 7 + x, 0), w - 1);
    sc.lum[idx] = luma_f32(raw, frame0 + (size_t)(yy + 8) * row_elems, xx,
                           channels, mode);
  }
  __syncwarp();
  for (int idx = lane; idx < RP * RS; idx += 32) {
    int y = idx / RS, x = idx % RS;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      acc = __fadd_rn(acc, __fmul_rn(sc.lum[y * RP + x + k], taps.k[k]));
    sc.tmp[idx] = acc;
  }
  __syncwarp();
  for (int idx = lane; idx < RS * RS; idx += 32) {
    float acc = 0.0f;   // tmp[y + k][x] for bl[y][x]
#pragma unroll
    for (int k = 0; k < 7; ++k)
      acc = __fadd_rn(acc, __fmul_rn(sc.tmp[idx + k * RS], taps.k[k]));
    sc.bl[idx] = acc;
  }
  __syncwarp();
  float x0, y0, c3, c4, c5;
  const bool ok =
      fit_record_warp(sc.fit, sc.bl, RS, ftaps, move_thr, &x0, &y0, &c3, &c4, &c5);
  if (lane != 0) return;
  // ops/rochade.py::saddle_angles, op for op
  const float k = __fsqrt_rn(__fadd_rn(__fmul_rn(c4, c4), __fmul_rn(c3, c3)));
  const float safe_k = k == 0.0f ? 1.0f : k;
  const float theta = __fmul_rn(__fmul_rn(atan2f(c3, c4), 0.5f), RAD2DEG);
  const float cosv = fminf(fmaxf(__fdiv_rn(-c5, safe_k), -1.0f), 1.0f);
  const float phi = __fmul_rn(__fmul_rn(acosf(cosv), 0.5f), RAD2DEG);
  float* row = out + s * 8;
  row[0] = __fadd_rn((float)rx, x0);
  row[1] = __fadd_rn((float)ry, y0);
  row[2] = k;
  row[3] = theta;
  row[4] = phi;
  row[5] = ok && inside ? 1.0f : 0.0f;
  row[6] = 0.0f;
  row[7] = 0.0f;
}

}  // namespace

// raw: (b, hp + 16, wp * channels) u8 (mode 0) or u16 (mode 1), (h, w) the
// true frame size; centers: (b, kcap, 2) f32 (x, y); valid: (b, kcap) bytes;
// out: (b, kcap, 8) f32, every row written: [x, y, k, theta, phi, ok, 0, 0],
// zeros for a slot that is not valid. Returns cudaGetLastError().
extern "C" int ag_sparse_refine_raw(const void* raw, int b, int hp, int wp,
                                    int channels, int mode, int h, int w,
                                    const float* taps7, const void* centers,
                                    const void* valid, int kcap,
                                    const void* fit_taps, float move_thr,
                                    int hp2, void* out, void* stream) {
  Taps7 taps;
  for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
  const FitTaps fit = *(const FitTaps*)fit_taps;
  dim3 grid((kcap + RWARPS - 1) / RWARPS, b);
  refine_kernel<<<grid, RWARPS * 32, 0, (cudaStream_t)stream>>>(
      raw, hp, wp, channels, mode, h, w, taps, (const float*)centers,
      (const uint8_t*)valid, kcap, fit, move_thr, hp2, (float*)out);
  return (int)cudaGetLastError();
}
