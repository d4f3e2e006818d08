// The register-blocked tile passes of the front, cluster and NMS kernels:
// padded raw frame (or f32 luma plane) -> staged f32 luma -> 7-tap
// separable Gaussian blur -> 3x3 Hessian response, for one (frame, 64-row
// tile, 64-column strip) block of 256 threads. frontend.cu's
// front_tile_kernel and front_decimate_kernel, cluster.cu's
// blur_mask_kernel and nms.cu's blur_resp_kernel run these passes; the
// values and their op order are stencil.cuh's (its head gives the
// numerics), only the number of instructions each value passes through
// differs.
#pragma once

#include <type_traits>

#include "stencil.cuh"

namespace ag {

// The block and the values in their op order are those of the first
// version of these kernels (stencil.cuh's blur_passes and hessian_at,
// which fused_kernel still runs); what changes is how often each value
// passes through an instruction (the cost of each: frontend.cu's head).
// Rows of the staged luma and of the horizontal pass are an odd number of
// 16-byte words apart, so eight lanes on eight consecutive rows (the
// horizontal pass) or on eight consecutive words of one row (every other
// pass) hit distinct banks with their 16-byte accesses. 44,832 B of shared memory and at most 48
// registers a thread let five blocks share an SM.
constexpr int FT_LSTR = 76;      // staged luma: 72 columns (+4)
constexpr int FT_TSTR = 76;      // horizontal outputs: 68 columns (+8)
constexpr int FT_QUADS = 18;     // 4-column quads of a staged row (72)
constexpr int FT_HGROUP = 16;    // horizontal outputs a thread keeps
constexpr int FT_HGROUPS = 4;    // full groups of a row: outputs 0..63
constexpr int FT_VQUADS = 17;    // vertical-pass quads: 68 >= TCOLS columns
constexpr int FT_VRUN = 6;       // rows a thread walks in the vertical pass
constexpr int FT_VRUNS = BROWS / FT_VRUN;         // 11
constexpr int FT_RRUN = 4;       // rows a thread walks in the Hessian pass
constexpr int FT_BLOCKS = 5;     // blocks an SM holds
static_assert(FT_VRUNS * FT_VRUN == BROWS, "vertical runs tile the rows");
static_assert((STRIP_W / 4) * (TILE_H / FT_RRUN) == THREADS,
              "one Hessian run per thread");
static_assert(FT_HGROUPS * FT_HGROUP + 8 == LCOLS, "the tail window ends the row");
static_assert(LROWS * FT_HGROUPS % 32 == 0, "tail items fill warps of their own");

struct FrontTileSmem {
  float lum[LROWS][FT_LSTR];     // staged luma, then the blurred tile
  float tmp[LROWS][FT_TSTR];     // horizontal pass
  float lut[256];                // u8 gray: __fdiv_rn(v, 255.0f)
  float warp_min[THREADS / 32];
};

// The input modes of the staging, one loop each: the raw modes of
// ag_front_kernel and an f32 luma plane in pad_half's layout (the turbo
// path's half plane, which cluster.cu's blur_mask_kernel and nms.cu's
// blur_resp_kernel read).
constexpr int RAW_GRAY8 = 0, RAW_GRAY16 = 1, RAW_RGB8 = 2, RAW_F32 = 3;

// u8 luma of an RGB pixel (image crate to_luma8), as luma_u8.
__device__ __forceinline__ uint32_t rgb_u8(uint32_t r, uint32_t g, uint32_t b) {
  return (2126u * r + 7152u * g + 722u * b) / 10000u;
}

// f32 luma of an RGB pixel, as luma_f32 (explicit FMAs).
__device__ __forceinline__ float rgb_f32(uint32_t r, uint32_t g, uint32_t b) {
  float acc = __fmul_rn((float)r, kLumaR);
  acc = __fmaf_rn((float)g, kLumaG, acc);
  return __fmaf_rn((float)b, kLumaB, acc);
}

// u8 luma of a u16 gray pixel, as luma_u8: floor of the rounded f32
// quotient (x * 255 + 32767) / 65535, which equals the integer quotient for
// every x (tests/test_torch_frontend.py::test_u16_luma_helpers_are_exact).
__device__ __forceinline__ uint32_t gray16_u8(uint32_t v) {
  return (v * 255u + 32767u) / 65535u;
}

// f32 luma of a u16 gray pixel, as luma_f32: __fdiv_rn(x, 65535) for every
// x as the product with the f32 reciprocal and one FMA correction (the
// same test), three f32 operations in place of a divide.
__device__ __forceinline__ float gray16_f32(uint32_t v) {
  constexpr float inv = (float)(1.0 / 65535.0);
  const float x = (float)v;
  const float q = __fmul_rn(x, inv);
  return __fmaf_rn(__fmaf_rn(-q, 65535.0f, x), inv, q);
}

// The raw bytes of one staged quad: 4 u8, 4 u16, 4 RGB pixels or 4 f32.
template <int RAW>
using RawQuad = typename std::conditional<
    RAW == RAW_GRAY8, uint32_t,
    typename std::conditional<
        RAW == RAW_GRAY16, uint2,
        typename std::conditional<RAW == RAW_RGB8, uint3, float4>::type>::type>::type;

// Stages the block's 72 x 72 luma (rows 64 ti - 4 .. 64 ti + 67 and
// columns c0 - 4 .. c0 + 67 of the image, columns clamped to [0, w)) into
// s.lum. A quad is 4 columns of one row, read with one 4-, 8-, 12- or
// 16-byte load; a thread starts the loads of its quads (RGB and f32: three
// at a time, for the registers) before it converts any, so their latencies
// overlap. A quad that holds a clamped column, or any quad of an unaligned
// frame, takes the per-element path. With LUMA8, quads of the tile's own
// rows and columns also write their 4 luma8 bytes in one store (raw modes
// only). Addresses are 32-bit offsets from the block's first staged row
// and first luma8 pixel.
template <int RAW, bool LUMA8 = true>
__device__ __forceinline__ void stage_quads(FrontTileSmem& s, const void* raw,
                                            int b, int ti, int si, int hp,
                                            int wp, int w, bool aligned,
                                            uint8_t* luma8) {
  static_assert(!(LUMA8 && RAW == RAW_F32), "an f32 plane has no luma8");
  using Elem = typename std::conditional<
      RAW == RAW_GRAY16, uint16_t,
      typename std::conditional<RAW == RAW_F32, float, uint8_t>::type>::type;
  constexpr int ch = RAW == RAW_RGB8 ? 3 : 1;
  constexpr int mode = RAW == RAW_GRAY16 ? MODE_U16 : RAW == RAW_F32 ? MODE_F32 : MODE_U8;
  constexpr int ITEMS = LROWS * FT_QUADS;
  constexpr int PER = (ITEMS + THREADS - 1) / THREADS;
  constexpr int BATCH = RAW == RAW_RGB8 || RAW == RAW_F32 ? 3 : PER;
  const int c0 = si * STRIP_W;
  const int row_elems = wp * ch;
  // padded row 64 ti + 4 = staged row 0
  const Elem* rows =
      (const Elem*)raw + ((size_t)b * (hp + 16) + ti * TILE_H + 4) * row_elems;
  uint8_t* own = LUMA8 ? luma8 + ((size_t)b * hp + ti * TILE_H) * wp + c0 : nullptr;
#pragma unroll
  for (int p0 = 0; p0 < PER; p0 += BATCH) {
    RawQuad<RAW> q[BATCH];
#pragma unroll
    for (int p = 0; p < BATCH; ++p) {
      const int i = threadIdx.x + (p0 + p) * THREADS;
      const int y = i / FT_QUADS, c = c0 - HALO + 4 * (i - y * FT_QUADS);
      if (i < ITEMS && aligned && c >= 0 && c + 3 < w)
        q[p] = *reinterpret_cast<const RawQuad<RAW>*>(rows + y * row_elems + ch * c);
    }
#pragma unroll
    for (int p = 0; p < BATCH; ++p) {
      const int i = threadIdx.x + (p0 + p) * THREADS;
      if (i >= ITEMS) break;
      const int y = i / FT_QUADS, k = i - y * FT_QUADS;
      const int c = c0 - HALO + 4 * k;
      float4 f;
      uint32_t l8;
      if (aligned && c >= 0 && c + 3 < w) {
        if constexpr (RAW == RAW_GRAY8) {
          const uint32_t v = q[p];
          l8 = v;
          f = make_float4(s.lut[v & 255u], s.lut[(v >> 8) & 255u],
                          s.lut[(v >> 16) & 255u], s.lut[v >> 24]);
        } else if constexpr (RAW == RAW_GRAY16) {
          const uint2 v = q[p];
          const uint32_t x0 = v.x & 0xffffu, x1 = v.x >> 16;
          const uint32_t x2 = v.y & 0xffffu, x3 = v.y >> 16;
          f = make_float4(gray16_f32(x0), gray16_f32(x1), gray16_f32(x2), gray16_f32(x3));
          l8 = gray16_u8(x0) | gray16_u8(x1) << 8 | gray16_u8(x2) << 16 |
               gray16_u8(x3) << 24;
        } else if constexpr (RAW == RAW_RGB8) {
          const uint3 v = q[p];
          // bytes r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
          const uint32_t r0 = v.x & 255u, g0 = (v.x >> 8) & 255u, b0 = (v.x >> 16) & 255u;
          const uint32_t r1 = v.x >> 24, g1 = v.y & 255u, b1 = (v.y >> 8) & 255u;
          const uint32_t r2 = (v.y >> 16) & 255u, g2 = v.y >> 24, b2 = v.z & 255u;
          const uint32_t r3 = (v.z >> 8) & 255u, g3 = (v.z >> 16) & 255u, b3 = v.z >> 24;
          f = make_float4(rgb_f32(r0, g0, b0), rgb_f32(r1, g1, b1),
                          rgb_f32(r2, g2, b2), rgb_f32(r3, g3, b3));
          l8 = rgb_u8(r0, g0, b0) | rgb_u8(r1, g1, b1) << 8 |
               rgb_u8(r2, g2, b2) << 16 | rgb_u8(r3, g3, b3) << 24;
        } else {
          f = q[p];
          l8 = 0;
        }
      } else {
        float e[4];
        l8 = 0;
        for (int j = 0; j < 4; ++j) {
          const int cc = min(max(c + j, 0), w - 1);
          e[j] = luma_f32(rows, (size_t)y * row_elems, cc, ch, mode);
          if constexpr (LUMA8)
            l8 |= (uint32_t)luma_u8(rows, (size_t)y * row_elems, cc, ch, mode) << (8 * j);
        }
        f = make_float4(e[0], e[1], e[2], e[3]);
      }
      *reinterpret_cast<float4*>(&s.lum[y][4 * k]) = f;
      // the tile's own rows and columns: staged rows 4..67, quads 1..16
      if (LUMA8 && y >= HALO && y < TILE_H + HALO && k >= 1 && k <= STRIP_W / 4)
        *reinterpret_cast<uint32_t*>(own + (y - HALO) * wp + 4 * (k - 1)) = l8;
    }
  }
}

// Horizontal pass: tmp[y][x] = sum_k lum[y][x + k] * taps[k] (the blur at
// image column c0 - 1 + x). A thread computes 16 adjacent outputs of one
// row from a 24-value window of six 16-byte loads, storing each 4 as they
// are done, lanes walking rows; the last two outputs of each row (64, 65)
// come from the window of columns 64..71 in warps of their own, which also
// write columns 66, 67 (zeros, read only into vertical-pass columns that
// no response reads).
__device__ __forceinline__ void horizontal_pass(FrontTileSmem& s, const Taps7& taps) {
  for (int i = threadIdx.x; i < LROWS * (FT_HGROUPS + 1); i += THREADS) {
    const int g = i / LROWS, y = i - g * LROWS;
    const float4* src = reinterpret_cast<const float4*>(&s.lum[y][FT_HGROUP * g]);
    float4* dst = reinterpret_cast<float4*>(&s.tmp[y][FT_HGROUP * g]);
    if (g == FT_HGROUPS) {
      const float4 a = src[0], e = src[1];
      const float v[8] = {a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w};
      float o[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(v[j + k], taps.k[k]));
        o[j] = acc;
      }
      dst[0] = make_float4(o[0], o[1], 0.0f, 0.0f);
      continue;
    }
    float v[FT_HGROUP + 8];
#pragma unroll
    for (int q = 0; q < FT_HGROUP / 4 + 2; ++q) {
      const float4 t = src[q];
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int q = 0; q < FT_HGROUP / 4; ++q) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 7; ++k)
          acc = __fadd_rn(acc, __fmul_rn(v[4 * q + j + k], taps.k[k]));
        o[j] = acc;
      }
      dst[q] = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

__device__ __forceinline__ float4 vtap(float4 acc, float4 v, float t) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(v.x, t)), __fadd_rn(acc.y, __fmul_rn(v.y, t)),
                     __fadd_rn(acc.z, __fmul_rn(v.z, t)), __fadd_rn(acc.w, __fmul_rn(v.w, t)));
}

// Vertical pass into lum[0..BROWS)[0..68): row y is the blur at image row
// 64 ti - 1 + y. A thread walks FT_VRUN rows of a 4-column quad with a
// 7-row window in registers: one 16-byte load and one store per row.
__device__ __forceinline__ void vertical_pass(FrontTileSmem& s, const Taps7& taps) {
  for (int i = threadIdx.x; i < FT_VQUADS * FT_VRUNS; i += THREADS) {
    const int run = i / FT_VQUADS, q = i - run * FT_VQUADS;
    const int y0 = run * FT_VRUN;
    float4 win[7];
#pragma unroll
    for (int r = 0; r < 6; ++r)
      win[r] = *reinterpret_cast<const float4*>(&s.tmp[y0 + r][4 * q]);
#pragma unroll
    for (int r = 0; r < FT_VRUN; ++r) {
      win[6] = *reinterpret_cast<const float4*>(&s.tmp[y0 + r + 6][4 * q]);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < 7; ++k) acc = vtap(acc, win[k], taps.k[k]);
      *reinterpret_cast<float4*>(&s.lum[y0 + r][4 * q]) = acc;
#pragma unroll
      for (int k = 0; k < 6; ++k) win[k] = win[k + 1];
    }
  }
}

// Columns 4q .. 4q + 5 of blurred-tile row y: one 16- and one 8-byte load.
__device__ __forceinline__ void load_row6(const FrontTileSmem& s, int y, int q,
                                          float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(&s.lum[y][4 * q]);
  const float2 e = *reinterpret_cast<const float2*>(&s.lum[y][4 * q + 4]);
  dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w, dst[4] = e.x, dst[5] = e.y;
}

// The Hessian response of output rows y0 .. y0 + FT_RRUN - 1, columns
// 4q .. 4q + 3 of the block, from a rotating 3-row window of the blurred
// tile (6 columns a row: output column 4q + j is the centre of j .. j + 2);
// returns their minimum. With BORDER the block holds a pixel of the image's
// one-pixel border or of the padding, whose response is 0; other blocks
// skip the test. Rows ``rows`` say which rows count: row r (of the h-row
// image or window) is row r + ro of a gh-row frame, and the first and last
// ``inset`` rows of the window are out too. With ``blur`` (pixel (r0, c)
// of the frame's blur plane, rows ``wp`` apart) the blurred pixels go out
// as 16-byte rows.
struct Rows {
  int h, ro, gh, inset;
  __device__ __forceinline__ bool in(int r) const {
    const int g = r + ro;
    return r < h && g > 0 && g < gh - 1 && r >= inset && r < h - inset;
  }
};

template <bool BORDER>
__device__ __forceinline__ float response_run(const FrontTileSmem& s, int q,
                                              int y0, int r0, int c, Rows rows,
                                              int w, float* blur, int wp) {
  float up[6], mid[6], dn[6];
  load_row6(s, y0, q, up);
  load_row6(s, y0 + 1, q, mid);
  bool col_in[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col_in[j] = c + j != 0 && c + j < w - 1;
  float m = INFINITY;
#pragma unroll
  for (int r = 0; r < FT_RRUN; ++r) {
    load_row6(s, y0 + r + 2, q, dn);
    // the reference leaves the image border 0; rows >= h are padding
    const bool row_in = rows.in(r0 + r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = hessian_of(up[j], up[j + 1], up[j + 2], mid[j], mid[j + 1],
                           mid[j + 2], dn[j], dn[j + 1], dn[j + 2]);
      if (BORDER && !(row_in && col_in[j])) v = 0.0f;
      m = v < m ? v : m;
    }
    if (blur != nullptr)
      *reinterpret_cast<float4*>(blur + (size_t)r * wp) =
          make_float4(mid[1], mid[2], mid[3], mid[4]);
#pragma unroll
    for (int j = 0; j < 6; ++j) up[j] = mid[j], mid[j] = dn[j];
  }
  return m;
}

// A row step of the Hessian pass as bits: ballot k of the warp (``bal``)
// holds pixel k of every lane (``m``: the lane's four pixels, columns
// 4 (l % 16) .. + 3 of lane l's row group); the result is the 32 bits of
// the aligned 32-column segment of the lane's octet, pixel k of lane l at
// bit 4 (l % 8) + k. Every lane of the warp calls it.
__device__ __forceinline__ unsigned segment_bits(const bool (&m)[4], unsigned (&bal)[4]) {
  const int lane = threadIdx.x & 31;
  unsigned seg = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bal[k] = __ballot_sync(0xffffffffu, m[k]);
    unsigned x = (bal[k] >> (lane & 24)) & 0xffu;   // bit j -> bit 4 j
    x = (x | (x << 12)) & 0x000f000fu;
    x = (x | (x << 6)) & 0x03030303u;
    x = (x | (x << 3)) & 0x11111111u;
    seg |= x << k;
  }
  return seg;
}

// Both blur passes on the block's staged 72 x 72 luma, between barriers:
// the blurred tile is then s.lum[0..66)[0..68), entry (y, x) the blur at
// image row 64 ti - 1 + y, column 64 si - 1 + x.
__device__ __forceinline__ void blur_tile_passes(FrontTileSmem& s, const Taps7& taps) {
  __syncthreads();
  horizontal_pass(s, taps);
  __syncthreads();
  vertical_pass(s, taps);
  __syncthreads();
}

// The passes after the staging, on the block's staged 72 x 72 luma: blur,
// then the Hessian response of the tile's 64 x 64 pixels — a thread owns 4
// adjacent columns of FT_RRUN rows — the border of the true (h, w) image
// zeroed (and rows outside ``rows``), reduced to the block's minimum (valid
// in thread 0). With ``blur`` (the frame's (h_pad, wp) blur plane) the
// blurred pixels go out too.
__device__ __forceinline__ float blur_response_min(FrontTileSmem& s, const Taps7& taps,
                                                   int b, int ti, int si, Rows rows,
                                                   int w, float* blur, int h_pad,
                                                   int wp) {
  blur_tile_passes(s, taps);
  const int tid = threadIdx.x;
  const int q = tid % (STRIP_W / 4), y0 = (tid / (STRIP_W / 4)) * FT_RRUN;
  const int r0 = ti * TILE_H + y0, c = si * STRIP_W + 4 * q;
  float* brow = blur != nullptr ? blur + ((size_t)b * h_pad + r0) * wp + c : nullptr;
  // a border pixel: row 0 or >= h - 1, column 0 or >= w - 1; a window of a
  // taller frame tests every row
  const bool border = ti == 0 || (ti + 1) * TILE_H >= rows.h || si == 0 ||
                      (si + 1) * STRIP_W >= w || rows.ro != 0 || rows.gh != rows.h ||
                      rows.inset != 0;
  const float m = border ? response_run<true>(s, q, y0, r0, c, rows, w, brow, wp)
                         : response_run<false>(s, q, y0, r0, c, rows, w, brow, wp);
  return block_min(m, s.warp_min);
}

}  // namespace ag
