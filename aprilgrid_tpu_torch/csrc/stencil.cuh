// Shared tile stencil of the front and cluster kernels: padded raw frame
// -> f32 luma -> 7-tap separable Gaussian blur -> 3x3 Hessian response,
// for one (frame, 64-row tile, 64-column strip) block.
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

// Rec.709 weights pre-divided by 255, as the reference's deinterleave
// matrix stores them (f32 of the double quotient).
constexpr float kLumaR = (float)(0.2126 / 255.0);
constexpr float kLumaG = (float)(0.7152 / 255.0);
constexpr float kLumaB = (float)(0.0722 / 255.0);

// f32 luma of padded-raw element (row pointer, column c).
__device__ __forceinline__ float luma_f32(const uint8_t* row8,
                                          const uint16_t* row16, int c,
                                          int channels, int u16) {
  if (channels == 3) {
    float r = (float)row8[3 * c];
    float g = (float)row8[3 * c + 1];
    float b = (float)row8[3 * c + 2];
    float acc = __fmul_rn(r, kLumaR);
    acc = __fmaf_rn(g, kLumaG, acc);
    return __fmaf_rn(b, kLumaB, acc);
  }
  if (u16) return __fdiv_rn((float)row16[c], 65535.0f);
  return __fdiv_rn((float)row8[c], 255.0f);
}

// u8 luma of padded-raw element (image crate to_luma8).
__device__ __forceinline__ uint8_t luma_u8(const uint8_t* row8,
                                           const uint16_t* row16, int c,
                                           int channels, int u16) {
  if (channels == 3) {
    int v = 2126 * (int)row8[3 * c] + 7152 * (int)row8[3 * c + 1] +
            722 * (int)row8[3 * c + 2];
    return (uint8_t)(v / 10000);
  }
  if (u16) {
    float x = (float)row16[c];
    float q = __fdiv_rn(__fadd_rn(__fmul_rn(x, 255.0f), 32767.0f), 65535.0f);
    return (uint8_t)(int)floorf(q);
  }
  return row8[c];
}

struct TileSmem {
  float lum[LROWS][LCOLS];   // reused for the vertical pass
  float tmp[LROWS][TCOLS];
};

// Fills s.lum (as the blurred tile, [BROWS][TCOLS] in the top-left corner
// of the array) for block (frame b, tile ti, strip si). Entry (y, x) of the
// result is the blur at image row 64 ti - 1 + y, column 64 si - 1 + x.
__device__ __forceinline__ void blur_tile(TileSmem& s, const void* raw,
                                          int b, int ti, int si, int hp,
                                          int wp, int channels, int u16,
                                          int w, const Taps7& taps) {
  const int tid = threadIdx.x;
  const int c0 = si * STRIP_W;
  const size_t row_elems = (size_t)wp * channels;
  const size_t frame_elems = (size_t)(hp + 16) * row_elems;
  // padded row of luma row y: 64 ti + 4 + y (y in [0, LROWS))
  const int pr0 = ti * TILE_H + 4;
  for (int idx = tid; idx < LROWS * LCOLS; idx += THREADS) {
    int y = idx / LCOLS, x = idx % LCOLS;
    int c = min(max(c0 - HALO + x, 0), w - 1);
    size_t off = (size_t)b * frame_elems + (size_t)(pr0 + y) * row_elems;
    s.lum[y][x] = luma_f32((const uint8_t*)raw + off,
                           (const uint16_t*)raw + off, c, channels, u16);
  }
  __syncthreads();
  // horizontal pass: tmp[y][x] = blur_h at column c0 - 1 + x
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

// Hessian determinant at blurred-tile entry (y, x) (1 <= y, x): the
// reference stencil (src/image_util.rs:72-109) in its op order.
__device__ __forceinline__ float hessian_at(const TileSmem& s, int y, int x) {
  float c = s.lum[y][x];
  float left = s.lum[y][x - 1], right = s.lum[y][x + 1];
  float up = s.lum[y - 1][x], down = s.lum[y + 1][x];
  float ul = s.lum[y - 1][x - 1], ur = s.lum[y - 1][x + 1];
  float dl = s.lum[y + 1][x - 1], dr = s.lum[y + 1][x + 1];
  float lxx = __fadd_rn(__fsub_rn(left, __fmul_rn(2.0f, c)), right);
  float lyy = __fadd_rn(__fsub_rn(up, __fmul_rn(2.0f, c)), down);
  float lxy = __fmul_rn(__fsub_rn(__fadd_rn(__fsub_rn(ur, ul), dl), dr), 0.25f);
  return __fsub_rn(__fmul_rn(lxx, lyy), __fmul_rn(lxy, lxy));
}

}  // namespace ag
