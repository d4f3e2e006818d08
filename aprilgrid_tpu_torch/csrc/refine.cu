// Sparse refine kernel: padded raw frames + per-slot candidate centres ->
// one full-resolution ROCHADE record per valid slot.
//
// Replaces the JAX package's pallas/refine.py::sparse_refine_raw (the
// turbo path's re-refinement of the half-resolution survivors). The TPU
// kernel walks the valid prefix of a frame serially, one aligned 24-row
// window DMA per candidate, and evaluates the record densely on a (16, 256)
// sub-window. Here every (frame, slot) is a block of its own: it gathers
// the 15x15 raw patch around the rounded centre with indices clamped to the
// image (the blur's edge replication), converts it to f32 luma (stencil.cuh
// formulas), runs the 7-tap blur horizontally then vertically down to the
// 9x9 support, and one thread evaluates the fit (rochade.cuh). The TPU
// kernel's lower width limit for RGB frames is a DMA-alignment matter and
// does not exist here.
//
// Bound on the H100: memory, and little of it — 225 raw pixels read and 32
// bytes written per valid slot; the blocks are small and independent, so
// the cost is launch and latency, not bandwidth.
#include "rochade.cuh"
#include "stencil.cuh"

namespace {

using namespace ag;

constexpr int RP = 15;        // raw patch side: 9 + 2 * blur radius
constexpr int RS = 9;         // fit support side
constexpr int RTHREADS = 64;

__global__ void __launch_bounds__(RTHREADS)
refine_kernel(const void* raw, int hp, int wp, int channels, int mode, int h,
              int w, Taps7 taps, const float* centers, const uint8_t* valid,
              int kcap, FitTaps fit, float move_thr, float* out) {
  const int slot = blockIdx.x, b = blockIdx.y;
  const size_t s = (size_t)b * kcap + slot;
  if (!valid[s]) return;  // the slot's row stays 0
  __shared__ float lum[RP][RP];
  __shared__ float tmp[RP][RS];
  __shared__ float bl[RS][RS];
  const float cx = centers[2 * s], cy = centers[2 * s + 1];
  // f32::round (half away from zero), then clamped into the image: an
  // out-of-image centre is gated by the caller, its reads must be in range
  const int rx = min(max((int)copysignf(floorf(__fadd_rn(fabsf(cx), 0.5f)), cx), 0), w - 1);
  const int ry = min(max((int)copysignf(floorf(__fadd_rn(fabsf(cy), 0.5f)), cy), 0), h - 1);
  const size_t row_elems = (size_t)wp * channels;
  const size_t frame0 = (size_t)b * (hp + 16) * row_elems;
  for (int idx = threadIdx.x; idx < RP * RP; idx += RTHREADS) {
    int y = idx / RP, x = idx % RP;
    int yy = min(max(ry - 7 + y, 0), h - 1);
    int xx = min(max(rx - 7 + x, 0), w - 1);
    lum[y][x] = luma_f32(raw, frame0 + (size_t)(yy + 8) * row_elems, xx,
                         channels, mode);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < RP * RS; idx += RTHREADS) {
    int y = idx / RS, x = idx % RS;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      acc = __fadd_rn(acc, __fmul_rn(lum[y][x + k], taps.k[k]));
    tmp[y][x] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < RS * RS; idx += RTHREADS) {
    int y = idx / RS, x = idx % RS;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      acc = __fadd_rn(acc, __fmul_rn(tmp[y + k][x], taps.k[k]));
    bl[y][x] = acc;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float x0, y0, c3, c4, c5;
  const bool ok =
      fit_record(&bl[0][0], RS, fit, move_thr, &x0, &y0, &c3, &c4, &c5);
  float* row = out + s * 8;
  row[0] = __fadd_rn((float)rx, x0);
  row[1] = __fadd_rn((float)ry, y0);
  row[2] = 0.0f;
  row[3] = c3;
  row[4] = c4;
  row[5] = c5;
  row[6] = ok ? 1.0f : 0.0f;
  row[7] = 1.0f;  // slot processed
}

}  // namespace

// raw: (b, hp + 16, wp * channels) u8 (mode 0) or u16 (mode 1), (h, w) the
// true frame size; centers: (b, kcap, 2) f32 (x, y); valid: (b, kcap) bytes;
// out: (b, kcap, 8) f32 zero-filled by the caller, rows
// [x, y, 0, c3, c4, c5, ok, processed]. Returns cudaGetLastError().
extern "C" int ag_sparse_refine_raw(const void* raw, int b, int hp, int wp,
                                    int channels, int mode, int h, int w,
                                    const float* taps7, const void* centers,
                                    const void* valid, int kcap,
                                    const void* fit_taps, float move_thr,
                                    void* out, void* stream) {
  Taps7 taps;
  for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
  const FitTaps fit = *(const FitTaps*)fit_taps;
  dim3 grid(kcap, b);
  refine_kernel<<<grid, RTHREADS, 0, (cudaStream_t)stream>>>(
      raw, hp, wp, channels, mode, h, w, taps, (const float*)centers,
      (const uint8_t*)valid, kcap, fit, move_thr, (float*)out);
  return (int)cudaGetLastError();
}
