// Front kernel: padded raw frames -> u8 luma plane + per-(tile, strip)
// Hessian-response minima.
//
// Replaces the JAX package's pallas/frontend.py::front_kernel
// (emit_blur=False, the hybrid detector's main path). The TPU kernel walks
// 64-row tiles in order with the whole frame width in VMEM; here every
// (frame, 64-row tile, 64-column strip) is an independent block that stages
// its raw pixels plus a 4-pixel halo in shared memory (stencil.cuh).
//
// Bound on the H100: memory. Per pixel it reads the raw bytes (1-3) and
// writes one luma byte, against ~40 f32 operations, far below the card's
// operations-per-byte balance point. The design keeps the f32 luma and blur
// planes out of device memory entirely (they live only in shared memory),
// so device traffic is the raw read plus the luma8 write; the halo re-read
// (72x72 staged for 64x64 produced, ~27%) hits L2. The response minimum is
// reduced per block and the last (cross-block) reduction over the strips of
// a tile is left to the caller, as the JAX pipeline takes the global
// minimum outside its kernel.
//
// The turbo path's front kernel (ag_front_kernel_decimate, replacing
// pallas/frontend.py::front_kernel_decimate) is two launches: decimate_kernel
// writes the full-resolution luma8 and the half-resolution f32 luma plane
// (2x2 pairwise mean, in the padded layout with the half plane's own edge
// values replicated), then front_kernel runs on that plane in MODE_F32 for
// the half-resolution response minima. Bound: memory again — raw read,
// luma8 write and the half plane (one f32 per four pixels) written once;
// the second launch reads the half plane back, which a later fusion of the
// two launches would save.
#include "stencil.cuh"

namespace {

using namespace ag;

__global__ void __launch_bounds__(THREADS)
front_kernel(const void* raw, int hp, int wp, int channels, int mode, int h,
             int w, Taps7 taps, uint8_t* luma8, float* strip_min,
             int n_strips) {
  __shared__ TileSmem s;
  __shared__ float warp_min[THREADS / 32];
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int c0 = si * STRIP_W;
  const int tid = threadIdx.x;

  // luma8 of the tile's own rows, straight from the raw pixels (an f32
  // luma plane has none: luma8 is null)
  if (luma8 != nullptr) {
    const size_t row_elems = (size_t)wp * channels;
    const size_t frame_elems = (size_t)(hp + 16) * row_elems;
    for (int idx = tid; idx < TILE_H * STRIP_W; idx += THREADS) {
      int y = idx / STRIP_W, x = idx % STRIP_W;
      int r = ti * TILE_H + y;
      size_t off = (size_t)b * frame_elems + (size_t)(r + 8) * row_elems;
      luma8[((size_t)b * hp + r) * wp + c0 + x] =
          luma_u8(raw, off, c0 + x, channels, mode);
    }
  }

  blur_tile(s, raw, b, ti, si, hp, wp, channels, mode, w, taps);

  float m = INFINITY;
  for (int idx = tid; idx < TILE_H * STRIP_W; idx += THREADS) {
    int y = idx / STRIP_W, x = idx % STRIP_W;
    int r = ti * TILE_H + y, c = c0 + x;
    float v = hessian_at(s, y + 1, x + 1);
    // the reference leaves the image border 0; rows >= h are padding
    if (r <= 0 || r >= h - 1 || c == 0 || c >= w - 1) v = 0.0f;
    m = v < m ? v : m;
  }
  for (int o = 16; o > 0; o >>= 1) {
    float t = __shfl_down_sync(0xffffffffu, m, o);
    m = t < m ? t : m;
  }
  if ((tid & 31) == 0) warp_min[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float r = warp_min[0];
    for (int i = 1; i < THREADS / 32; ++i) r = warp_min[i] < r ? warp_min[i] : r;
    strip_min[((size_t)b * gridDim.y + ti) * n_strips + si] = r;
  }
}

constexpr int DEC_BX = 32, DEC_BY = 8;

// One thread per half-resolution slot (gy, gx): the luma8 of its 2x2
// full-resolution pixels, and element (gy, gx) of the padded half plane,
// which holds half pixel (clamp(gy - 8), clamp(gx)) — the mean
// ((l00 + l01) + (l10 + l11)) * 0.25 of the f32 luma, in that association.
__global__ void __launch_bounds__(DEC_BX * DEC_BY)
decimate_kernel(const void* raw, int hp, int wp, int channels, int mode,
                int hh, int wh, int hhp, int whp, uint8_t* luma8,
                float* half_p) {
  const int gx = blockIdx.x * DEC_BX + threadIdx.x;
  const int gy = blockIdx.y * DEC_BY + threadIdx.y;
  const int b = blockIdx.z;
  const size_t row_elems = (size_t)wp * channels;
  const size_t frame0 = (size_t)b * (hp + 16) * row_elems;
  if (2 * gy < hp && 2 * gx < wp) {
    for (int dy = 0; dy < 2; ++dy) {
      const int r = 2 * gy + dy;
      const size_t off = frame0 + (size_t)(r + 8) * row_elems;
      uchar2 v;
      v.x = luma_u8(raw, off, 2 * gx, channels, mode);
      v.y = luma_u8(raw, off, 2 * gx + 1, channels, mode);
      *(uchar2*)(luma8 + ((size_t)b * hp + r) * wp + 2 * gx) = v;
    }
  }
  if (gy < hhp + 16 && gx < whp) {
    const int y = min(max(gy - 8, 0), hh - 1);
    const int x = min(max(gx, 0), wh - 1);
    const size_t off0 = frame0 + (size_t)(2 * y + 8) * row_elems;
    const size_t off1 = off0 + row_elems;
    const float top = __fadd_rn(luma_f32(raw, off0, 2 * x, channels, mode),
                                luma_f32(raw, off0, 2 * x + 1, channels, mode));
    const float bot = __fadd_rn(luma_f32(raw, off1, 2 * x, channels, mode),
                                luma_f32(raw, off1, 2 * x + 1, channels, mode));
    half_p[((size_t)b * (hhp + 16) + gy) * whp + gx] =
        __fmul_rn(__fadd_rn(top, bot), 0.25f);
  }
}

Taps7 taps_of(const float* taps7) {
  Taps7 taps;
  for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
  return taps;
}

int launch_front(const void* raw, int b, int hp, int wp, int channels,
                 int mode, int h, int w, const Taps7& taps, void* luma8,
                 void* strip_min, cudaStream_t st) {
  const int n_strips = wp / STRIP_W;
  dim3 grid(n_strips, hp / TILE_H, b);
  front_kernel<<<grid, THREADS, 0, st>>>(raw, hp, wp, channels, mode, h, w,
                                         taps, (uint8_t*)luma8,
                                         (float*)strip_min, n_strips);
  return (int)cudaGetLastError();
}

}  // namespace

// raw: (b, hp + 16, wp * channels) u8 (mode 0) or u16 (mode 1); luma8:
// (b, hp, wp) u8; strip_min: (b, hp / 64, wp / 64) f32. Returns
// cudaGetLastError().
extern "C" int ag_front_kernel(const void* raw, int b, int hp, int wp,
                               int channels, int mode, int h, int w,
                               const float* taps7, void* luma8,
                               void* strip_min, void* stream) {
  return launch_front(raw, b, hp, wp, channels, mode, h, w, taps_of(taps7),
                      luma8, strip_min, (cudaStream_t)stream);
}

// raw, luma8: as above, (h, w) the true frame size. half_p:
// (b, hhp + 16, whp) f32, the padded layout of the (h / 2, w / 2) half
// plane; strip_min: (b, hhp / 64, whp / 64) f32 half-resolution response
// minima. Returns the first launch error, or 0.
extern "C" int ag_front_kernel_decimate(const void* raw, int b, int hp, int wp,
                                        int channels, int mode, int h, int w,
                                        const float* taps7, void* luma8,
                                        void* half_p, int hhp, int whp,
                                        void* strip_min, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hh = h / 2, wh = w / 2;
  const int gh = max(hp / 2, hhp + 16), gw = max(wp / 2, whp);
  dim3 grid((gw + DEC_BX - 1) / DEC_BX, (gh + DEC_BY - 1) / DEC_BY, b);
  decimate_kernel<<<grid, dim3(DEC_BX, DEC_BY), 0, st>>>(
      raw, hp, wp, channels, mode, hh, wh, hhp, whp, (uint8_t*)luma8,
      (float*)half_p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_front(half_p, b, hhp, whp, 1, MODE_F32, hh, wh, taps_of(taps7),
                      nullptr, strip_min, st);
}
