// Front kernel: padded raw frames -> u8 luma plane + per-(tile, strip)
// Hessian-response minima.
//
// Replaces the JAX package's pallas/frontend.py::front_kernel
// (emit_blur=False, the hybrid detector's main path). The TPU kernel walks
// 64-row tiles in order with the whole frame width in VMEM; here every
// (frame, 64-row tile, 64-column strip) is an independent block that stages
// its raw pixels plus a 4-pixel halo in shared memory. ag_front_kernel
// launches front_tile_kernel. The response minimum is reduced per block
// and the last (cross-block) reduction over the strips of a tile is left
// to the caller, as the JAX pipeline takes the global minimum outside its
// kernel. Its staging and passes (FrontTileSmem, stage_quads, the blur
// passes, the Hessian rows) live in tile.cuh, which cluster.cu's
// blur_mask_kernel runs too.
//
// Bound on the H100: instruction rate and latency, not bytes. The first
// version (a kernel on stencil.cuh's blur_tile, since removed) moved 270 MB
// in 0.507 ms at two_boards b32 (chip_smoke.py --front-only; H100 80GB
// HBM3 at 700 W), a sixth of the card's bytes rate, and u8 gray cost as
// much per pixel as RGB with three times the bytes. Per pixel, from its
// source (chip_smoke.py::front_op_counts): luma8 and the staged luma each
// read the raw bytes one at a time, ~28 shared-memory accesses (7 loads per
// output of each blur pass, 9 for the Hessian), a 32-bit divide and modulo
// in each of five index loops, an IEEE divide per u8 gray pixel, ~45 f32
// operations. front_tile_kernel keeps the block, the values and their op
// order and cuts the rest: one 4-, 8- or 12-byte load per quad of 4 raw
// pixels at a 32-bit offset, a thread's loads all in flight before it
// converts any (RGB: three at a time), luma8 from the same bytes in one
// 4-byte store; u8 gray through a 256-entry table of __fdiv_rn(v, 255)
// built by the block; 16 horizontal outputs a thread from a 24-value
// register window, 6 vertical rows a thread down a 7-row window, 4 Hessian
// rows down a 3-row window, the border test only in blocks that hold a
// border pixel; rows an odd number of 16-byte words apart, so 16-byte
// shared accesses meet no bank conflict:
// ~2.6 shared accesses a pixel (+1.3 table loads for u8 gray) and five
// blocks an SM. It runs at about half the first version's time, still ~3x
// its byte bound: what is left is the latency between each block's five
// barrier-separated phases and the instructions around the f32 chain. With
// a blur pointer the blurred pixels leave as 16-byte rows from registers
// (the TPU kernel's emit_blur=True, the input of the blur-fed cluster
// kernel, cluster.cu's ag_cluster_rochade). Times and the steps that led
// here: PERF.md, section 6.
//
// The turbo path's front kernel (ag_front_kernel_decimate, replacing
// pallas/frontend.py::front_kernel_decimate) is one launch of
// front_decimate_kernel: a block per (frame, 64-row half tile, 64-column
// half strip) stages its half-resolution luma straight from the raw bytes
// (the 2x2 pairwise mean of the f32 luma, in registers), writes its half
// plane pixels (pad_half's layout) and the luma8 of its raw pixels from
// the same registers, and runs front_tile_kernel's passes on the half tile
// for the half-resolution response minima. Bound: bytes by the count (raw
// in, luma8 and half plane out); in fact it runs at ~1.8x that bound, at
// the same time per raw pixel in all three raw modes, so neither the bytes
// nor the conversion instructions set it. The first design's two launches
// (a thread per half slot reading each raw byte twice and writing the half
// plane, then the first front kernel reading it back) took 0.335 ms at
// two_boards b32 on an NVIDIA H100 80GB HBM3 at 700 W, this one 0.186
// (PERF.md, section 6).
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
#include "tile.cuh"

namespace {

using namespace ag;

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

// ag_front_kernel's block: stage, then blur_response_min.
__global__ void __launch_bounds__(THREADS, FT_BLOCKS)
front_tile_kernel(const void* raw, int hp, int wp, int raw_mode, int h, int w,
                  bool aligned, Taps7 taps, const int* roff, int gh,
                  uint8_t* luma8, float* blur, float* strip_min, int n_strips) {
  __shared__ __align__(16) FrontTileSmem s;
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  if (raw_mode == RAW_GRAY8) {
    s.lut[tid] = __fdiv_rn((float)tid, 255.0f);
    __syncthreads();
    stage_quads<RAW_GRAY8>(s, raw, b, ti, si, hp, wp, w, aligned, luma8);
  } else if (raw_mode == RAW_GRAY16) {
    stage_quads<RAW_GRAY16>(s, raw, b, ti, si, hp, wp, w, aligned, luma8);
  } else {
    stage_quads<RAW_RGB8>(s, raw, b, ti, si, hp, wp, w, aligned, luma8);
  }
  const Rows rows{h, roff != nullptr ? roff[b] : 0, gh, 0};
  const float m = blur_response_min(s, taps, b, ti, si, rows, w, blur, hp, wp);
  if (tid == 0) strip_min[((size_t)b * gridDim.y + ti) * n_strips + si] = m;
}

// ---- front_decimate_kernel: ag_front_kernel_decimate in one launch ----
//
// Block (frame, 64-row half tile ti, 64-column half strip si) of the half
// plane (hh, wh) = (h / 2, w / 2) stages its 72 x 72 half-resolution luma
// straight from the raw bytes — half row clamp(64 ti - 4 + y, 0, hh - 1)
// from raw rows 2y', 2y' + 1, half column clamp(64 si - 4 + x, 0, wh - 1)
// from raw columns 2x', 2x' + 1 — and runs front_tile_kernel's passes on it
// with (h, w) = (hh, wh). The 144 x 144 raw pixels are never staged: a
// staged half quad (4 half pixels of one half row) is two rows of 8 raw
// pixels, read with two 8- (u8) or 16-byte (u16) loads or six 8-byte
// loads (RGB), converted as stage_quads converts, and averaged in
// registers, ((l00 + l01) + (l10 + l11)) * 0.25 in that association.
// From the same registers the block writes its own half-plane pixels as
// 16-byte rows and the luma8 of their raw pixels as 8-byte words.
//
// What differs from the full-resolution kernel, and why:
// - The grids differ. luma8 is (hp, wp) = (ceil(h/64)*64, ceil(w/128)*128)
//   and the half grid covers only 2 hhp x 2 whp raw pixels, which can be
//   fewer (h = 129: hp = 192, 2 hhp = 128; w = 257: wp = 384, 2 whp =
//   256). The launch covers both; a block beyond the half grid writes
//   luma8 alone.
// - luma8 is the luma of the padded raw rows as they stand, not of the
//   clamped staging: rows at and beyond 2 hh (the padding rows, and with an
//   odd h the last image row, which belongs to no half row), columns of a
//   half quad that reaches wh and all of an unaligned frame are written by
//   luma8_tail, element by element from their own addresses.
// - half_p is in pad_half's layout: 8 replica rows above the half plane
//   (written by the blocks of tile 0 from staged row 0, half row 0) and
//   rows hhp + 8 .. hhp + 15 below (written by the last tile from staged
//   row 71, half row hh - 1); columns wh .. whp - 1 come out of the clamped
//   staging.
// - The vector loads need the frame pointer aligned to 8 (u8, RGB) or 16
//   (u16) bytes; rows are wp * C elements apart with wp a multiple of 128
//   and a quad starts at a raw column that is a multiple of 8. A quad that
//   holds a clamped column, or any quad of an unaligned frame, takes the
//   per-element path.
// - Registers, not shared memory (FrontTileSmem), set the blocks an SM
//   holds: the staging's raw words and conversions take 59-64 registers a
//   thread, so the kernel is built for four blocks an SM; held to 48
//   registers (five blocks) every mode spilled and RGB ran a third
//   slower. For the same reason RGB loads one half quad (six words) at a
//   time; two at a time spilled.
// - u16 gray converts without an f32 divide: gray16_f32 and gray16_u8 give
//   the IEEE quotients of luma_f32 and luma_u8 for every u16 value.

constexpr int FD_BLOCKS = 4;     // blocks an SM holds (64 registers)

// The raw bytes of one raw row of a staged half quad: 8 u8, 8 u16 or 8 RGB
// pixels.
struct Rgb8 {
  uint2 a, b, c;
};
template <int RAW>
using RawOct = typename std::conditional<
    RAW == RAW_GRAY8, uint2,
    typename std::conditional<RAW == RAW_GRAY16, uint4, Rgb8>::type>::type;

template <int RAW>
__device__ __forceinline__ RawOct<RAW> load_oct(const void* p) {
  if constexpr (RAW == RAW_RGB8) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    return Rgb8{q[0], q[1], q[2]};
  } else {
    return *reinterpret_cast<const RawOct<RAW>*>(p);
  }
}

// Byte i (0..23) of an RGB row's 24 bytes.
__device__ __forceinline__ uint32_t rgb_byte(const Rgb8& v, int i) {
  const uint32_t w[6] = {v.a.x, v.a.y, v.b.x, v.b.y, v.c.x, v.c.y};
  return (w[i >> 2] >> (8 * (i & 3))) & 255u;
}

// Raw value of pixel j (0..7) of a gray row.
template <int RAW>
__device__ __forceinline__ uint32_t gray_px(const RawOct<RAW>& v, int j) {
  if constexpr (RAW == RAW_GRAY8) {
    return ((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 255u;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    return (w[j >> 1] >> (16 * (j & 1))) & 0xffffu;
  }
}

// f32 luma of pixel j of a raw row, as luma_f32.
template <int RAW>
__device__ __forceinline__ float oct_f32(const FrontTileSmem& s, const RawOct<RAW>& v,
                                         int j) {
  if constexpr (RAW == RAW_GRAY8) {
    return s.lut[gray_px<RAW>(v, j)];
  } else if constexpr (RAW == RAW_GRAY16) {
    return gray16_f32(gray_px<RAW>(v, j));
  } else {
    return rgb_f32(rgb_byte(v, 3 * j), rgb_byte(v, 3 * j + 1), rgb_byte(v, 3 * j + 2));
  }
}

// luma8 of the 8 pixels of a raw row, as luma_u8, packed in 8 bytes.
template <int RAW>
__device__ __forceinline__ uint2 oct_u8(const RawOct<RAW>& v) {
  if constexpr (RAW == RAW_GRAY8) {
    return v;
  } else {
    uint32_t w8[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t l;
      if constexpr (RAW == RAW_GRAY16)
        l = gray16_u8(gray_px<RAW>(v, j));
      else
        l = rgb_u8(rgb_byte(v, 3 * j), rgb_byte(v, 3 * j + 1), rgb_byte(v, 3 * j + 2));
      w8[j >> 2] |= l << (8 * (j & 3));
    }
    return make_uint2(w8[0], w8[1]);
  }
}

// Stages block (b, ti, si)'s 72 x 72 half-resolution luma into s.lum (see
// above). A thread starts the loads of a batch of its half quads before it
// converts any, so their latencies overlap. Quads of the tile's own rows
// and columns write their 4 half pixels to half_p in one 16-byte store and,
// where they took the vector loads and hold no clamped row, the luma8 of
// their 16 raw pixels in two 8-byte stores; the blocks of the first and
// last half tile also write the replica rows of half_p. Addresses are
// 32-bit offsets from the block's first staged raw row, first luma8 pixel
// and first half pixel.
template <int RAW>
__device__ __forceinline__ void stage_half_quads(FrontTileSmem& s, const void* raw,
                                                 int b, int ti, int si, int hp,
                                                 int wp, int hh, int wh, int hhp,
                                                 int whp, bool aligned,
                                                 uint8_t* luma8, float* half_p) {
  using Elem = typename std::conditional<RAW == RAW_GRAY16, uint16_t, uint8_t>::type;
  constexpr int ch = RAW == RAW_RGB8 ? 3 : 1;
  constexpr int mode = RAW == RAW_GRAY16 ? MODE_U16 : MODE_U8;
  constexpr int ITEMS = LROWS * FT_QUADS;
  constexpr int PER = (ITEMS + THREADS - 1) / THREADS;
  constexpr int BATCH = RAW == RAW_GRAY8 ? PER : RAW == RAW_GRAY16 ? 3 : 1;
  const int row_elems = wp * ch;
  const int y_top = max(ti * TILE_H - HALO, 0);   // the first staged half row
  const Elem* rows = (const Elem*)raw + ((size_t)b * (hp + 16) + 8 + 2 * y_top) * row_elems;
  uint8_t* own8 = luma8 + ((size_t)b * hp + 2 * ti * TILE_H) * wp + 2 * si * STRIP_W;
  float* own_half = half_p + ((size_t)b * (hhp + 16) + 8 + ti * TILE_H) * whp + si * STRIP_W;
  const bool first_tile = ti == 0, last_tile = (ti + 1) * TILE_H == hhp;
#pragma unroll
  for (int p0 = 0; p0 < PER; p0 += BATCH) {
    RawOct<RAW> q[BATCH][2];
#pragma unroll
    for (int p = 0; p < BATCH; ++p) {
      const int i = threadIdx.x + (p0 + p) * THREADS;
      const int y = i / FT_QUADS, x = si * STRIP_W - HALO + 4 * (i - y * FT_QUADS);
      if (i < ITEMS && aligned && x >= 0 && x + 3 < wh) {
        const int yr = min(max(ti * TILE_H - HALO + y, 0), hh - 1);
        const Elem* p8 = rows + 2 * (yr - y_top) * row_elems + 2 * ch * x;
        q[p][0] = load_oct<RAW>(p8);
        q[p][1] = load_oct<RAW>(p8 + row_elems);
      }
    }
#pragma unroll
    for (int p = 0; p < BATCH; ++p) {
      const int i = threadIdx.x + (p0 + p) * THREADS;
      if (i >= ITEMS) break;
      const int y = i / FT_QUADS, k = i - y * FT_QUADS;
      const int x = si * STRIP_W - HALO + 4 * k;
      const int yu = ti * TILE_H - HALO + y;          // the half row, unclamped
      const int off = 2 * (min(max(yu, 0), hh - 1) - y_top) * row_elems;
      const bool own = y >= HALO && y < TILE_H + HALO && k >= 1 && k <= STRIP_W / 4;
      const bool vec = aligned && x >= 0 && x + 3 < wh;
      // the luma8 of this quad's raw pixels, where they are its own (the
      // per-element quads' luma8 is luma8_tail's)
      const bool want8 = own && yu < hh && vec;
      float v[4];
      uint2 l0, l1;
      if (vec) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float top = __fadd_rn(oct_f32<RAW>(s, q[p][0], 2 * j),
                                      oct_f32<RAW>(s, q[p][0], 2 * j + 1));
          const float bot = __fadd_rn(oct_f32<RAW>(s, q[p][1], 2 * j),
                                      oct_f32<RAW>(s, q[p][1], 2 * j + 1));
          v[j] = __fmul_rn(__fadd_rn(top, bot), 0.25f);
        }
        if (want8) l0 = oct_u8<RAW>(q[p][0]), l1 = oct_u8<RAW>(q[p][1]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 2 * min(max(x + j, 0), wh - 1), o1 = off + row_elems;
          v[j] = __fmul_rn(__fadd_rn(__fadd_rn(luma_f32(rows, off, c, ch, mode),
                                               luma_f32(rows, off, c + 1, ch, mode)),
                                     __fadd_rn(luma_f32(rows, o1, c, ch, mode),
                                               luma_f32(rows, o1, c + 1, ch, mode))),
                           0.25f);
        }
      }
      const float4 hq = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&s.lum[y][4 * k]) = hq;
      if (own) {
        const int oy = y - HALO, ox = 4 * (k - 1);
        *reinterpret_cast<float4*>(own_half + oy * whp + ox) = hq;
        if (want8) {
          *reinterpret_cast<uint2*>(own8 + 2 * oy * wp + 2 * ox) = l0;
          *reinterpret_cast<uint2*>(own8 + (2 * oy + 1) * wp + 2 * ox) = l1;
        }
      }
      // pad_half's replica rows: half row 0 above, half row hh - 1 below
      const bool pad_col = k >= 1 && k <= STRIP_W / 4;
      if (pad_col && ((first_tile && y == 0) || (last_tile && y == LROWS - 1))) {
        float* dst = own_half + (y == 0 ? -8 : TILE_H) * whp + 4 * (k - 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) *reinterpret_cast<float4*>(dst + j * whp) = hq;
      }
    }
  }
}

// luma8 of block (b, ti, si)'s own raw pixels (rows 128 ti .., columns
// 128 si .., inside (hp, wp)) that no staged quad writes: those of half
// rows at or beyond hh, of half quads that reach wh and, in an unaligned
// frame, all — straight from the padded raw rows, element by element, as
// two 8-byte words per half quad.
__device__ __forceinline__ void luma8_tail(const void* raw, int b, int ti, int si,
                                           int hp, int wp, int ch, int mode, int hh,
                                           int wh, bool aligned, uint8_t* luma8) {
  const size_t row_elems = (size_t)wp * ch;
  for (int i = threadIdx.x; i < TILE_H * (STRIP_W / 4); i += THREADS) {
    const int yh = ti * TILE_H + i / (STRIP_W / 4);
    const int xh = si * STRIP_W + 4 * (i % (STRIP_W / 4));
    const int r = 2 * yh, c = 2 * xh;
    if (r >= hp || c >= wp || (aligned && yh < hh && xh + 3 < wh)) continue;
    for (int dr = 0; dr < 2; ++dr) {
      const size_t off = ((size_t)b * (hp + 16) + r + dr + 8) * row_elems;
      uint32_t w8[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w8[j >> 2] |= (uint32_t)luma_u8(raw, off, c + j, ch, mode) << (8 * (j & 3));
      *reinterpret_cast<uint2*>(luma8 + ((size_t)b * hp + r + dr) * wp + c) =
          make_uint2(w8[0], w8[1]);
    }
  }
}

// ag_front_kernel_decimate's block for one raw mode: luma8 tail, staging,
// then blur_response_min on the half tile, whose one-pixel border of the
// (hh, wh) half image is zeroed; blocks beyond the half grid end after the
// tail.
template <int RAW>
__global__ void __launch_bounds__(THREADS, FD_BLOCKS)
front_decimate_kernel(const void* raw, int hp, int wp, int hh, int wh, int hhp,
                      int whp, bool aligned, Taps7 taps, const int* roff,
                      int ghh, uint8_t* luma8, float* half_p, float* strip_min) {
  __shared__ __align__(16) FrontTileSmem s;
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  if (!aligned || (ti + 1) * TILE_H > hh || (si + 1) * STRIP_W > wh)
    luma8_tail(raw, b, ti, si, hp, wp, RAW == RAW_RGB8 ? 3 : 1,
               RAW == RAW_GRAY16 ? MODE_U16 : MODE_U8, hh, wh, aligned, luma8);
  const int n_ht = hhp / TILE_H, n_hs = whp / STRIP_W;
  if (ti >= n_ht || si >= n_hs) return;   // beyond the half grid: luma8 only
  if (RAW == RAW_GRAY8) {
    s.lut[tid] = __fdiv_rn((float)tid, 255.0f);
    __syncthreads();
  }
  stage_half_quads<RAW>(s, raw, b, ti, si, hp, wp, hh, wh, hhp, whp, aligned,
                        luma8, half_p);
  // a window of a taller frame: its outer 4 half rows blur into its own
  // replicated edge rows, and their responses are a neighbour's to take
  const Rows rows{hh, roff != nullptr ? roff[b] : 0, ghh, roff != nullptr ? 4 : 0};
  const float m = blur_response_min(s, taps, b, ti, si, rows, wh, nullptr, 0, 0);
  if (tid == 0) strip_min[((size_t)b * n_ht + ti) * n_hs + si] = m;
}

Taps7 taps_of(const float* taps7) {
  Taps7 taps;
  for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
  return taps;
}

}  // namespace

// raw: (b, hp + 16, wp * channels) u8 (mode 0) or u16 (mode 1); roff:
// (b,) int32 device row offsets of windows of a gh-row frame, or null (gh
// = h); luma8: (b, hp, wp) u8; blur: (b, hp, wp) f32 or null (no blur
// plane wanted); strip_min: (b, hp / 64, wp / 64) f32. Returns
// cudaGetLastError().
extern "C" int ag_front_kernel(const void* raw, int b, int hp, int wp,
                               int channels, int mode, int h, int w,
                               const float* taps7, const void* roff, int gh,
                               void* luma8, void* blur, void* strip_min,
                               void* stream) {
  const int n_strips = wp / STRIP_W;
  const int raw_mode =
      channels == 3 ? RAW_RGB8 : mode == MODE_U16 ? RAW_GRAY16 : RAW_GRAY8;
  // the quads' 4- (u8) or 8-byte (u16) loads; rows start 128-byte aligned
  const bool aligned = (uintptr_t)raw % (mode == MODE_U16 ? 8 : 4) == 0;
  dim3 grid(n_strips, hp / TILE_H, b);
  front_tile_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      raw, hp, wp, raw_mode, h, w, aligned, taps_of(taps7), (const int*)roff,
      gh, (uint8_t*)luma8, (float*)blur, (float*)strip_min, n_strips);
  return (int)cudaGetLastError();
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

// raw, luma8: as above, (h, w) the true frame size; roff: (b,) int32
// device row offsets in half rows of windows of a ghh-half-row frame, or
// null (ghh = h / 2). half_p: (b, hhp + 16, whp) f32, the padded layout of
// the (h / 2, w / 2) half plane; strip_min: (b, hhp / 64, whp / 64) f32
// half-resolution response minima. Returns cudaGetLastError().
extern "C" int ag_front_kernel_decimate(const void* raw, int b, int hp, int wp,
                                        int channels, int mode, int h, int w,
                                        const float* taps7, const void* roff,
                                        int ghh, void* luma8, void* half_p,
                                        int hhp, int whp, void* strip_min,
                                        void* stream) {
  // the 8- (u8, RGB: 3 x 8) or 16-byte (u16) loads of a raw row's 8 pixels
  const bool aligned = (uintptr_t)raw % (mode == MODE_U16 ? 16 : 8) == 0;
  // the half grid, or the luma8 grid where it is taller or wider
  dim3 grid(max(whp / STRIP_W, wp / (2 * STRIP_W)),
            max(hhp / TILE_H, (hp + 2 * TILE_H - 1) / (2 * TILE_H)), b);
  auto kernel = channels == 3      ? front_decimate_kernel<RAW_RGB8>
                : mode == MODE_U16 ? front_decimate_kernel<RAW_GRAY16>
                                   : front_decimate_kernel<RAW_GRAY8>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      raw, hp, wp, h / 2, w / 2, hhp, whp, aligned, taps_of(taps7),
      (const int*)roff, ghh, (uint8_t*)luma8, (float*)half_p, (float*)strip_min);
  return (int)cudaGetLastError();
}
