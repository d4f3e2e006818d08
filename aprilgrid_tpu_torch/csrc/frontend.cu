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
#include "stencil.cuh"

namespace {

using namespace ag;

__global__ void __launch_bounds__(THREADS)
front_kernel(const void* raw, int hp, int wp, int channels, int u16, int h,
             int w, Taps7 taps, uint8_t* luma8, float* strip_min,
             int n_strips) {
  __shared__ TileSmem s;
  __shared__ float warp_min[THREADS / 32];
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int c0 = si * STRIP_W;
  const int tid = threadIdx.x;

  // luma8 of the tile's own rows, straight from the raw pixels
  const size_t row_elems = (size_t)wp * channels;
  const size_t frame_elems = (size_t)(hp + 16) * row_elems;
  for (int idx = tid; idx < TILE_H * STRIP_W; idx += THREADS) {
    int y = idx / STRIP_W, x = idx % STRIP_W;
    int r = ti * TILE_H + y;
    size_t off = (size_t)b * frame_elems + (size_t)(r + 8) * row_elems;
    luma8[((size_t)b * hp + r) * wp + c0 + x] =
        luma_u8((const uint8_t*)raw + off, (const uint16_t*)raw + off,
                c0 + x, channels, u16);
  }

  blur_tile(s, raw, b, ti, si, hp, wp, channels, u16, w, taps);

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

}  // namespace

// raw: (b, hp + 16, wp * channels) u8 or u16; luma8: (b, hp, wp) u8;
// strip_min: (b, hp / 64, wp / 64) f32. Returns cudaGetLastError().
extern "C" int ag_front_kernel(const void* raw, int b, int hp, int wp,
                               int channels, int u16, int h, int w,
                               const float* taps7, void* luma8,
                               void* strip_min, void* stream) {
  Taps7 taps;
  for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
  const int n_strips = wp / ag::STRIP_W;
  dim3 grid(n_strips, hp / ag::TILE_H, b);
  front_kernel<<<grid, ag::THREADS, 0, (cudaStream_t)stream>>>(
      raw, hp, wp, channels, u16, h, w, taps, (uint8_t*)luma8,
      (float*)strip_min, n_strips);
  return (int)cudaGetLastError();
}
