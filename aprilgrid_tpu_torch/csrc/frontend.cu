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
//
// With a blur pointer the front kernel also writes the f32 blur plane of the
// whole padded frame (the TPU kernel's emit_blur=True): the input of the
// blur-fed cluster kernel (cluster.cu, ag_cluster_rochade). Bound: memory,
// now dominated by the 4-byte plane written once per pixel.
//
// gray_kernel (replacing pallas/frontend.py::gray_kernel) is the front
// kernel's gray conversion alone: bare raw frames -> f32 and u8 luma planes
// padded to 64-row / 128-column multiples, every element outside the frame
// a replica of the frame's nearest edge pixel. One thread per output pixel;
// bound: memory (1-3 raw bytes read, 5 bytes written per pixel).
//
// fused_kernel (replacing pallas/frontend.py::fused_frontend) is the plane
// path's stencil: a bare f32 luma plane -> blur and Hessian-response planes
// plus the per-(tile, strip) response minima, on the same 64x64 tile
// stencil. The TPU kernel returns padded planes and the caller crops them;
// here the kernel masks its stores to the output shape it is given, so the
// cropped form is written directly. The response is zeroed on the one-pixel
// border of the true image and in all padding before the minimum is taken.
// Bound: memory — 4 bytes read and 8 written per pixel against ~42 f32
// operations.
#include "stencil.cuh"

namespace {

using namespace ag;

__global__ void __launch_bounds__(THREADS)
front_kernel(const void* raw, int hp, int wp, int channels, int mode, int h,
             int w, Taps7 taps, uint8_t* luma8, float* blur, float* strip_min,
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
    if (blur != nullptr)
      blur[((size_t)b * hp + r) * wp + c] = s.lum[y + 1][x + 1];
    float v = hessian_at(s, y + 1, x + 1);
    // the reference leaves the image border 0; rows >= h are padding
    if (r <= 0 || r >= h - 1 || c == 0 || c >= w - 1) v = 0.0f;
    m = v < m ? v : m;
  }
  m = block_min(m, warp_min);
  if (tid == 0) strip_min[((size_t)b * gridDim.y + ti) * n_strips + si] = m;
}

// The plane path's stencil for block (frame, 64-row tile, 64-column strip)
// of a (hin, win) luma plane: blur and response stored where (row, column)
// lies inside (out_h, out_w), the response border of the true (h, w) image
// and all padding zeroed, the block's response minimum to strip_min.
__global__ void __launch_bounds__(THREADS)
fused_kernel(const float* luma, int hin, int win, int h, int w, Taps7 taps,
             float* blur, float* resp, int out_h, int out_w, float* strip_min,
             int n_strips) {
  __shared__ TileSmem s;
  __shared__ float warp_min[THREADS / 32];
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  blur_tile_plane(s, luma, b, ti, si, hin, win, taps);

  float m = INFINITY;
  for (int idx = tid; idx < TILE_H * STRIP_W; idx += THREADS) {
    int y = idx / STRIP_W, x = idx % STRIP_W;
    int r = ti * TILE_H + y, c = si * STRIP_W + x;
    float v = hessian_at(s, y + 1, x + 1);
    if (r == 0 || r >= h - 1 || c == 0 || c >= w - 1) v = 0.0f;
    m = v < m ? v : m;
    if (r < out_h && c < out_w) {
      const size_t o = ((size_t)b * out_h + r) * out_w + c;
      blur[o] = s.lum[y + 1][x + 1];
      if (resp != nullptr) resp[o] = v;
    }
  }
  m = block_min(m, warp_min);
  if (tid == 0) strip_min[((size_t)b * gridDim.y + ti) * n_strips + si] = m;
}

constexpr int GRAY_BX = 32, GRAY_BY = 8;

// One thread per element (r, c) of the padded luma planes: the luma of raw
// pixel (min(r, h - 1), min(c, w - 1)).
__global__ void __launch_bounds__(GRAY_BX * GRAY_BY)
gray_kernel(const void* raw, int h, int w, int channels, int mode, int hp,
            int wp, float* luma_f, uint8_t* luma8) {
  const int c = blockIdx.x * GRAY_BX + threadIdx.x;
  const int r = blockIdx.y * GRAY_BY + threadIdx.y;
  const int b = blockIdx.z;
  if (r >= hp || c >= wp) return;
  const size_t off =
      ((size_t)b * h + min(r, h - 1)) * ((size_t)w * channels);
  const int cc = min(c, w - 1);
  const size_t o = ((size_t)b * hp + r) * wp + c;
  luma_f[o] = luma_f32(raw, off, cc, channels, mode);
  luma8[o] = luma_u8(raw, off, cc, channels, mode);
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
                 void* blur, void* strip_min, cudaStream_t st) {
  const int n_strips = wp / STRIP_W;
  dim3 grid(n_strips, hp / TILE_H, b);
  front_kernel<<<grid, THREADS, 0, st>>>(raw, hp, wp, channels, mode, h, w,
                                         taps, (uint8_t*)luma8, (float*)blur,
                                         (float*)strip_min, n_strips);
  return (int)cudaGetLastError();
}

}  // namespace

// raw: (b, hp + 16, wp * channels) u8 (mode 0) or u16 (mode 1); luma8:
// (b, hp, wp) u8; blur: (b, hp, wp) f32 or null (no blur plane wanted);
// strip_min: (b, hp / 64, wp / 64) f32. Returns cudaGetLastError().
extern "C" int ag_front_kernel(const void* raw, int b, int hp, int wp,
                               int channels, int mode, int h, int w,
                               const float* taps7, void* luma8, void* blur,
                               void* strip_min, void* stream) {
  return launch_front(raw, b, hp, wp, channels, mode, h, w, taps_of(taps7),
                      luma8, blur, strip_min, (cudaStream_t)stream);
}

// luma: (b, hin, win) f32; (h, w) the true image size, hp = ceil(h / 64) *
// 64 and wp = ceil(w / 128) * 128 the tiled extent (h <= hin <= hp, w <= win
// <= wp); blur and resp (resp may be null): (b, out_h, out_w) f32 with
// (out_h, out_w) = (h, w) or (hp, wp); strip_min: (b, hp / 64, wp / 64) f32.
// Returns cudaGetLastError().
extern "C" int ag_fused_frontend(const void* luma, int b, int hin, int win,
                                 int h, int w, int hp, int wp,
                                 const float* taps7, void* blur, void* resp,
                                 int out_h, int out_w, void* strip_min,
                                 void* stream) {
  const int n_strips = wp / STRIP_W;
  dim3 grid(n_strips, hp / TILE_H, b);
  fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)luma, hin, win, h, w, taps_of(taps7), (float*)blur,
      (float*)resp, out_h, out_w, (float*)strip_min, n_strips);
  return (int)cudaGetLastError();
}

// raw: (b, h, w * channels) u8 (mode 0) or u16 (mode 1, one channel), no
// padding; luma_f: (b, hp, wp) f32 and luma8: (b, hp, wp) u8 with hp >= h,
// wp >= w. Returns cudaGetLastError().
extern "C" int ag_gray_kernel(const void* raw, int b, int h, int w,
                              int channels, int mode, int hp, int wp,
                              void* luma_f, void* luma8, void* stream) {
  dim3 grid((wp + GRAY_BX - 1) / GRAY_BX, (hp + GRAY_BY - 1) / GRAY_BY, b);
  gray_kernel<<<grid, dim3(GRAY_BX, GRAY_BY), 0, (cudaStream_t)stream>>>(
      raw, h, w, channels, mode, hp, wp, (float*)luma_f, (uint8_t*)luma8);
  return (int)cudaGetLastError();
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
                      nullptr, nullptr, strip_min, st);
}
