// The tile stencil in its first version, and the numerics that every
// stencil kernel shares: padded raw frame -> f32 luma -> 7-tap separable
// Gaussian blur -> 3x3 Hessian response, for one (frame, 64-row tile,
// 64-column strip) block.
//
// Numerics follow the JAX package's ops/gray.py and ops/frontend.py op for
// op, each op rounded on its own: IEEE divides for the gray scales, every
// tap one multiply and one add accumulated from 0 in tap order, and the
// library is built with --fmad=false so nothing is contracted into an
// FMA. The one FMA on purpose is the RGB luma: the JAX front kernel
// (pallas/frontend.py, _rgb_luma_chunks) evaluates it as a matmul whose
// lowering accumulates the three channel terms with fused multiply-adds,
// so it is written here with explicit __fmaf_rn. (Compiled whole, the JAX
// kernel also contracts some blur multiply-adds and divides by constant
// reciprocals; it agrees with the op-by-op values to ~1e-9 in the
// response, the tolerance its own tests use.)
//
// Its one user is frontend.cu's fused_kernel (the plane path's
// fused_frontend): blur_tile_plane stages a bare f32 plane without margins,
// rows and columns clamped to the plane as given, then blur_passes and
// hessian_at. The front, cluster and NMS kernels run tile.cuh's
// register-blocked passes on the same values in the same op order, and
// take luma_f32 / luma_u8 and hessian_of from here.
//
// Layout: the padded raw frame (pad_raw) has hp + 16 rows (8 edge rows
// above the image, >= 8 below) of wp * channels elements. Tile i covers
// padded rows [64 i + 8, 64 i + 72), i.e. image rows [64 i, 64 i + 64);
// luma is clamped to columns [0, w) (the clamped-border blur of the
// reference), rows are clamped by the padding itself.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ag {

constexpr int TILE_H = 64;          // image rows per block
constexpr int STRIP_W = 64;         // image columns per block
constexpr int HALO = 4;             // blur radius 3 + 1 Hessian row/col
constexpr int LROWS = TILE_H + 2 * HALO;    // 72 luma rows
constexpr int LCOLS = STRIP_W + 2 * HALO;   // 72 luma cols
constexpr int TCOLS = STRIP_W + 2;          // horizontal pass: 66 cols
constexpr int BROWS = TILE_H + 2;           // vertical pass: 66 rows
constexpr int THREADS = 256;

struct Taps7 {
  float k[7];
};

// element type of a padded frame
constexpr int MODE_U8 = 0;
constexpr int MODE_U16 = 1;
constexpr int MODE_F32 = 2;   // f32 luma plane, one channel

// Rec.709 weights pre-divided by 255, as the reference's deinterleave
// matrix stores them (f32 of the double quotient).
constexpr float kLumaR = (float)(0.2126 / 255.0);
constexpr float kLumaG = (float)(0.7152 / 255.0);
constexpr float kLumaB = (float)(0.0722 / 255.0);

// f32 luma of padded-frame element: ``off`` is the element offset of the
// row's first element, ``c`` the column.
__device__ __forceinline__ float luma_f32(const void* raw, size_t off, int c,
                                          int channels, int mode) {
  if (mode == MODE_F32) return ((const float*)raw)[off + c];
  const uint8_t* row8 = (const uint8_t*)raw + off;
  if (channels == 3) {
    float r = (float)row8[3 * c];
    float g = (float)row8[3 * c + 1];
    float b = (float)row8[3 * c + 2];
    float acc = __fmul_rn(r, kLumaR);
    acc = __fmaf_rn(g, kLumaG, acc);
    return __fmaf_rn(b, kLumaB, acc);
  }
  if (mode == MODE_U16)
    return __fdiv_rn((float)((const uint16_t*)raw)[off + c], 65535.0f);
  return __fdiv_rn((float)row8[c], 255.0f);
}

// u8 luma of padded-raw element (image crate to_luma8); u8/u16 modes.
__device__ __forceinline__ uint8_t luma_u8(const void* raw, size_t off, int c,
                                           int channels, int mode) {
  const uint8_t* row8 = (const uint8_t*)raw + off;
  if (channels == 3) {
    int v = 2126 * (int)row8[3 * c] + 7152 * (int)row8[3 * c + 1] +
            722 * (int)row8[3 * c + 2];
    return (uint8_t)(v / 10000);
  }
  if (mode == MODE_U16) {
    float x = (float)((const uint16_t*)raw)[off + c];
    float q = __fdiv_rn(__fadd_rn(__fmul_rn(x, 255.0f), 32767.0f), 65535.0f);
    return (uint8_t)(int)floorf(q);
  }
  return row8[c];
}

struct TileSmem {
  float lum[LROWS][LCOLS];   // reused for the vertical pass
  float tmp[LROWS][TCOLS];
};

// The two blur passes over the staged luma tile s.lum[LROWS][LCOLS]: the
// blurred tile lands in the top-left [BROWS][TCOLS] corner of s.lum. Luma
// entry (y, x) being image row R - 4 + y, column C - 4 + x, blurred entry
// (y, x) is the blur at image row R - 1 + y, column C - 1 + x.
__device__ __forceinline__ void blur_passes(TileSmem& s, const Taps7& taps) {
  const int tid = threadIdx.x;
  __syncthreads();
  // horizontal pass: tmp[y][x] = blur_h at column C - 1 + x
  for (int idx = tid; idx < LROWS * TCOLS; idx += THREADS) {
    int y = idx / TCOLS, x = idx % TCOLS;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      acc = __fadd_rn(acc, __fmul_rn(s.lum[y][x + k], taps.k[k]));
    s.tmp[y][x] = acc;
  }
  __syncthreads();
  // vertical pass into lum[0..BROWS)[0..TCOLS): row y = luma row y + 3
  for (int idx = tid; idx < BROWS * TCOLS; idx += THREADS) {
    int y = idx / TCOLS, x = idx % TCOLS;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      acc = __fadd_rn(acc, __fmul_rn(s.tmp[y + k][x], taps.k[k]));
    s.lum[y][x] = acc;
  }
  __syncthreads();
}

// Fills s.lum (as the blurred tile, [BROWS][TCOLS] in the top-left corner
// of the array) for block (frame b, tile ti, strip si) of a bare (frames,
// hin, win) f32 luma plane: entry (y, x) is the blur at row 64 ti - 1 + y,
// column 64 si - 1 + x. No margin rows, so rows as well as columns are
// clamped to the plane (its edge values replicated, the reference's
// clamped-border blur).
__device__ __forceinline__ void blur_tile_plane(TileSmem& s,
                                                const float* plane, int b,
                                                int ti, int si, int hin,
                                                int win, const Taps7& taps) {
  const float* frame = plane + (size_t)b * hin * win;
  for (int idx = threadIdx.x; idx < LROWS * LCOLS; idx += THREADS) {
    int y = idx / LCOLS, x = idx % LCOLS;
    int r = min(max(ti * TILE_H - HALO + y, 0), hin - 1);
    int c = min(max(si * STRIP_W - HALO + x, 0), win - 1);
    s.lum[y][x] = frame[(size_t)r * win + c];
  }
  blur_passes(s, taps);
}

// Hessian determinant from the 3x3 blur values around a pixel (upper row,
// own row, lower row, each left to right): the reference stencil
// (src/image_util.rs:72-109) in its op order.
__device__ __forceinline__ float hessian_of(float ul, float up, float ur,
                                            float left, float c, float right,
                                            float dl, float down, float dr) {
  float lxx = __fadd_rn(__fsub_rn(left, __fmul_rn(2.0f, c)), right);
  float lyy = __fadd_rn(__fsub_rn(up, __fmul_rn(2.0f, c)), down);
  float lxy = __fmul_rn(__fsub_rn(__fadd_rn(__fsub_rn(ur, ul), dl), dr), 0.25f);
  return __fsub_rn(__fmul_rn(lxx, lyy), __fmul_rn(lxy, lxy));
}

// The same at the blur value ``p`` points to, in a plane (or tile) of row
// stride ``stride``, all eight neighbours readable.
__device__ __forceinline__ float hessian_ptr(const float* p, int stride) {
  return hessian_of(p[-stride - 1], p[-stride], p[-stride + 1], p[-1], p[0],
                    p[1], p[stride - 1], p[stride], p[stride + 1]);
}

// The same at blurred-tile entry (y, x) (1 <= y, x).
__device__ __forceinline__ float hessian_at(const TileSmem& s, int y, int x) {
  return hessian_ptr(&s.lum[y][x], LCOLS);
}

// Minimum of ``m`` over the block's THREADS threads, valid in thread 0;
// ``warp_min`` is THREADS / 32 floats of shared memory.
__device__ __forceinline__ float block_min(float m, float* warp_min) {
  const int tid = threadIdx.x;
  for (int o = 16; o > 0; o >>= 1) {
    float t = __shfl_down_sync(0xffffffffu, m, o);
    m = t < m ? t : m;
  }
  if ((tid & 31) == 0) warp_min[tid >> 5] = m;
  __syncthreads();
  if (tid == 0)
    for (int i = 1; i < THREADS / 32; ++i) m = warp_min[i] < m ? warp_min[i] : m;
  return m;
}

}  // namespace ag
