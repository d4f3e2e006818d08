// NMS extraction kernel: half-resolution f32 luma plane + per-frame
// response threshold -> per-cell candidate records of the response peaks.
//
// Replaces the JAX package's pallas/nms.py::nms_extract_raw (the turbo
// path's clustering-free extraction, merge = 0). The TPU kernel evaluates
// everything densely per 160-row window — the ROCHADE record at every
// pixel, two log-tree min filters, selection matmuls into the cell grid.
// The function itself is sparse, and here it is three launches over device
// scratch that the wrapper allocates:
//
//   (a) blur_resp: the tile stencil (stencil.cuh, MODE_F32) writes the
//       blur plane and the masked response plane: the Hessian response
//       where it is < thr strictly inside the image, else BIGF;
//   (b) gate: one thread per pixel; a masked pixel inside the 4-pixel
//       margin evaluates the ROCHADE fit on its 9x9 blur patch
//       (rochade.cuh) and stays a candidate only if the fit accepts;
//   (c) peaks: a candidate is a plateau pixel when no candidate of its 7x7
//       window has a smaller response, and a peak when no plateau pixel
//       of that window with the same response precedes it in scan order;
//       a peak writes [col + x0, row + y0, c3, c4, c5, row * w + col + 1]
//       into its aligned 4x4 cell of the zero-filled cell grid.
//
// Two peaks are more than 3 pixels apart (Chebyshev), so no two share a
// cell and the writes of (c) never collide. Responses are compared with
// == on the values launch (a) stored, so ties resolve exactly as in the
// plain version.
//
// Bound on the H100: memory. (a) reads the half plane and writes two f32
// planes; (b) and (c) read the masked response plane once each and touch
// the blur plane only around masked pixels.
#include "rochade.cuh"
#include "stencil.cuh"

namespace {

using namespace ag;

constexpr float BIGF = 3.0e38f;  // "not a candidate"
constexpr int NMS_R = 3;         // Chebyshev radius of the peak window

__global__ void __launch_bounds__(THREADS)
blur_resp_kernel(const float* half_p, int hp, int wp, int h, int w,
                 Taps7 taps, const float* thr, float* blur, float* cand) {
  __shared__ TileSmem s;
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int c0 = si * STRIP_W;
  blur_tile(s, half_p, b, ti, si, hp, wp, 1, MODE_F32, w, taps);
  const float t = thr[b];
  const size_t fbase = (size_t)b * hp * wp;
  for (int idx = threadIdx.x; idx < TILE_H * STRIP_W; idx += THREADS) {
    int y = idx / STRIP_W, x = idx % STRIP_W;
    int r = ti * TILE_H + y, c = c0 + x;
    size_t i = fbase + (size_t)r * wp + c;
    blur[i] = s.lum[y + 1][x + 1];
    float v = BIGF;
    if (r > 0 && r < h - 1 && c > 0 && c < w - 1) {
      float resp = hessian_at(s, y + 1, x + 1);
      if (resp < t) v = resp;
    }
    cand[i] = v;
  }
}

__global__ void gate_kernel(const float* blur, float* cand, int hp, int wp,
                            int h, int w, int hp2, FitTaps fit,
                            float move_thr, long long total) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  if (cand[g] >= BIGF) return;
  const long long fpix = (long long)hp * wp;
  const int i = (int)(g % fpix);
  const int r = i / wp, c = i % wp;
  float x0, y0, c3, c4, c5;
  if (r < hp2 || r >= h - hp2 || c < hp2 || c >= w - hp2 ||
      !fit_record(blur + (g - i) + (size_t)(r - 4) * wp + (c - 4), wp, fit,
                  move_thr, &x0, &y0, &c3, &c4, &c5))
    cand[g] = BIGF;
}

// No candidate of the 7x7 window around (r, c) has a response below v.
__device__ bool is_plateau(const float* cd, int wp, int r, int c, float v) {
  for (int dr = -NMS_R; dr <= NMS_R; ++dr)
    for (int dc = -NMS_R; dc <= NMS_R; ++dc)
      if (cd[(size_t)(r + dr) * wp + (c + dc)] < v) return false;
  return true;
}

__global__ void peaks_kernel(const float* blur, const float* cand, int hp,
                             int wp, int w, FitTaps fit, float move_thr,
                             float* cells, long long total) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const float v = cand[g];
  if (v >= BIGF) return;
  const long long fpix = (long long)hp * wp;
  const int b = (int)(g / fpix);
  const int i = (int)(g % fpix);
  const int r = i / wp, c = i % wp;
  // candidates lie inside the 4-pixel margin, so every window below stays
  // inside the plane
  const float* cd = cand + (g - i);
  if (!is_plateau(cd, wp, r, c, v)) return;
  for (int dr = -NMS_R; dr <= 0; ++dr)
    for (int dc = -NMS_R; dc <= NMS_R; ++dc) {
      if (dr == 0 && dc >= 0) break;
      if (cd[(size_t)(r + dr) * wp + (c + dc)] == v &&
          is_plateau(cd, wp, r + dr, c + dc, v))
        return;  // an equal plateau pixel earlier in scan order wins
    }
  float x0, y0, c3, c4, c5;
  fit_record(blur + (g - i) + (size_t)(r - 4) * wp + (c - 4), wp, fit,
             move_thr, &x0, &y0, &c3, &c4, &c5);
  const int cr = hp / 4, cc = wp / 4;
  const size_t plane = (size_t)cr * cc;
  float* cell = cells + (size_t)b * 6 * plane + (size_t)(r / 4) * cc + (c / 4);
  cell[0] = __fadd_rn((float)c, x0);
  cell[plane] = __fadd_rn((float)r, y0);
  cell[2 * plane] = c3;
  cell[3 * plane] = c4;
  cell[4 * plane] = c5;
  cell[5 * plane] = (float)(r * w + c + 1);
}

}  // namespace

// half_p: (b, hp + 16, wp) f32 padded half plane, (h, w) its true size;
// thr: (b,) f32 device; scratch: blur and cand (b, hp, wp) f32; cells:
// (b, 6, hp / 4, wp / 4) f32 zero-filled by the caller. Returns the first
// launch error, or 0.
extern "C" int ag_nms_extract_raw(const void* half_p, int b, int hp, int wp,
                                  int h, int w, const void* thr,
                                  const float* taps7, const void* fit_taps,
                                  float move_thr, int hp2, void* blur,
                                  void* cand, void* cells, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Taps7 taps;
  for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
  const FitTaps fit = *(const FitTaps*)fit_taps;
  dim3 tgrid(wp / STRIP_W, hp / TILE_H, b);
  blur_resp_kernel<<<tgrid, THREADS, 0, st>>>(
      (const float*)half_p, hp, wp, h, w, taps, (const float*)thr,
      (float*)blur, (float*)cand);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)b * hp * wp;
  const unsigned pgrid = (unsigned)((total + THREADS - 1) / THREADS);
  gate_kernel<<<pgrid, THREADS, 0, st>>>((const float*)blur, (float*)cand, hp,
                                         wp, h, w, hp2, fit, move_thr, total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  peaks_kernel<<<pgrid, THREADS, 0, st>>>((const float*)blur,
                                          (const float*)cand, hp, wp, w, fit,
                                          move_thr, (float*)cells, total);
  return (int)cudaGetLastError();
}
