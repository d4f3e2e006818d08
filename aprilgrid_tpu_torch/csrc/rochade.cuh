// ROCHADE quadric fit shared by the cluster, NMS and refine kernels: the
// tap tables (FitTaps, filled by kernels/_fit.py from
// ops/rochade.py::fit_taps) and the fit itself, which follows the op
// sequence of ops/rochade.py::fit_record — cone smoothing of the 9x9 blur
// support to 5x5, the five rank-1 fit stencils as a vertical then a
// horizontal pass, every tap one multiply and one add from 0 in table
// order, then a closed form — so a kernel's record equals the plain
// version's bit for bit. Three forms remain, none of them a thread that
// runs the whole fit with its arrays in local memory:
//
//   fit_solve        the closed form after the five coefficients (offset,
//                    c3..c5, accept gate), a thread's work, op for op the
//                    tail of fit_record; both forms below end in it;
//   fit_record_warp  one fit by a warp (cluster record, NMS peaks, sparse
//                    refine): each of the 25 smoothed elements, 25 vertical
//                    sums and 5 coefficients is one lane's chain, the same
//                    chain fit_record runs for that element;
//   the tile form    fit_tile_smooth + fit_tile_at, a fit at any pixel of
//                    a 64 x 64 tile (the NMS gate). The fit does not depend
//                    on where its pixel is: smoothed element (a, c) of pixel
//                    (r, c0) is the value at (r - 2 + a, c0 - 2 + c) of one
//                    plane S = cone stencil of the blur. Each value of S is
//                    the chain fit_record runs for that element, whichever
//                    pixel asks, so a block computes S once for its tile and
//                    pixels share it bit for bit; the two 5-tap passes and
//                    the closed form then run per masked pixel on its 5x5
//                    window of S (ops/rochade.py::record_planes is the
//                    plain statement, with the passes as planes too).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ag {

struct FitTaps {
  int n_cone;
  int cone_dr[25];
  int cone_dc[25];
  float cone_w[25];
  int vid[5];
  int nv[5];
  int vd[5][5];
  float vw[5][5];
  int nh[5];
  int hd[5][5];
  float hw[5][5];
};

// The closed form after the fit: subpixel offset, quadric coefficients
// and the accept gate (saddle, move within ``move_thr``, |c5| < k).
__device__ __forceinline__ bool fit_solve(float a1, float a2, float a3,
                                          float a4, float a5, float move_thr,
                                          float* x0o, float* y0o, float* c3o,
                                          float* c4o, float* c5o) {
  const float dqf = __fsub_rn(__fmul_rn(__fmul_rn(2.0f, a1), __fmul_rn(2.0f, a3)),
                              __fmul_rn(a2, a2));
  const float sd = dqf == 0.0f ? 1.0f : dqf;
  const float x0 = __fdiv_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(-2.0f, a3), a4), __fmul_rn(a2, a5)), sd);
  const float y0 = __fdiv_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(-2.0f, a1), a5), __fmul_rn(a2, a4)), sd);
  const float c5 = __fmul_rn(__fadd_rn(a1, a3), 0.5f);
  const float c4 = __fmul_rn(__fsub_rn(a1, a3), 0.5f);
  const float c3 = __fmul_rn(a2, 0.5f);
  const float kk = __fsqrt_rn(__fadd_rn(__fmul_rn(c4, c4), __fmul_rn(c3, c3)));
  *x0o = x0;
  *y0o = y0;
  *c3o = c3;
  *c4o = c4;
  *c5o = c5;
  return dqf < 0.0f && fabsf(x0) <= move_thr && fabsf(y0) <= move_thr &&
         fabsf(c5) < kk;
}

// A warp's shared-memory scratch for fit_record_warp.
struct FitScratch {
  float patch[81];   // the 9x9 support, row-major
  float sm[25];      // cone-smoothed 5x5
  float vert[25];    // vertical pass, [fit][column]
};

// fit_record by a whole warp (all 32 lanes call it, converged; every lane
// gets the results). The 81 patch values go to shared memory; lane a * 5 + c
// runs the cone taps of smoothed element (a, c), lane j * 5 + c the
// vertical taps of fit j at column c (fits that share a vertical factor
// hold the same taps, so each computes the plain version's shared pass), lane j
// the horizontal taps of coefficient j, and every lane the closed form.
// Each element runs the sequence of ops/rochade.py::fit_record — one
// multiply and one add per tap from 0, in table order — so the record is
// the same bit for bit; the dependent chain is ~100 operations, and no
// thread-private array is indexed at run time (the values sit in shared
// memory; callers stage the tap tables there too, because lanes read
// different rows of them).
__device__ inline bool fit_record_warp(FitScratch& s, const float* p00,
                                       int stride, const FitTaps& f,
                                       float move_thr, float* x0o, float* y0o,
                                       float* c3o, float* c4o, float* c5o) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  __syncwarp();   // the previous fit's reads of the scratch are done
  for (int k = lane; k < 81; k += 32)
    s.patch[k] = p00[(size_t)(k / 9) * stride + (k % 9)];
  __syncwarp();
  const int a = lane / 5, c = lane % 5;   // also (fit j, column c) below
  if (lane < 25) {
    float acc = 0.0f;
    for (int t = 0; t < f.n_cone; ++t)
      acc = __fadd_rn(acc, __fmul_rn(f.cone_w[t],
                                     s.patch[(a + f.cone_dr[t]) * 9 + c + f.cone_dc[t]]));
    s.sm[lane] = acc;
  }
  __syncwarp();
  if (lane < 25) {
    float acc = 0.0f;
    for (int t = 0; t < f.nv[a]; ++t)
      acc = __fadd_rn(acc, __fmul_rn(f.vw[a][t], s.sm[f.vd[a][t] * 5 + c]));
    s.vert[lane] = acc;
  }
  __syncwarp();
  float coef = 0.0f;
  if (lane < 5)
    for (int t = 0; t < f.nh[lane]; ++t)
      coef = __fadd_rn(coef, __fmul_rn(f.hw[lane][t], s.vert[lane * 5 + f.hd[lane][t]]));
  const float a1 = __shfl_sync(full, coef, 0), a2 = __shfl_sync(full, coef, 1),
              a3 = __shfl_sync(full, coef, 2), a4 = __shfl_sync(full, coef, 3),
              a5 = __shfl_sync(full, coef, 4);
  return fit_solve(a1, a2, a3, a4, a5, move_thr, x0o, y0o, c3o, c4o, c5o);
}

// ---- the tile form -------------------------------------------------------

constexpr int FIT_TILE = 64;             // pixels per tile side
constexpr int FIT_BL = FIT_TILE + 8;     // staged blur tile: 4-pixel halo
constexpr int FIT_S = FIT_TILE + 4;      // smoothed plane S: 2-pixel halo

// The tap tables as the tile form takes them, with offsets known at
// compile time: the cone as the dense 5x5 it is (every cone weight is
// positive), the 5-tap tables of each fit by offset 0..4 with a bit per tap
// that the table holds (a tap whose weight came out exactly 0 is in no
// table, and is skipped here as there).
struct FitTileTaps {
  float cone[25];      // by dr * 5 + dc
  float vw[5][5];      // [fit][offset], the fit's vertical factor
  unsigned vmask[5];   // bit d: the table holds offset d
  float hw[5][5];      // [fit][offset]
  unsigned hmask[5];
};

// FitTaps -> FitTileTaps. False unless the cone table is the dense 5x5 in
// row-major order and every 5-tap table ascends by offset — the order in
// which ops/rochade.py::fit_taps lists them, so that walking the offsets
// 0..4 and skipping the absent ones is the table's own order.
inline bool fit_tile_taps(const FitTaps& f, FitTileTaps* o) {
  *o = FitTileTaps{};
  if (f.n_cone != 25) return false;
  for (int t = 0; t < 25; ++t) {
    if (f.cone_dr[t] != t / 5 || f.cone_dc[t] != t % 5) return false;
    o->cone[t] = f.cone_w[t];
  }
  for (int j = 0; j < 5; ++j) {
    if (f.nh[j] > 5 || f.nv[j] > 5) return false;
    for (int t = 0, last = -1; t < f.nh[j]; last = f.hd[j][t++]) {
      const int d = f.hd[j][t];
      if (d <= last || d > 4) return false;
      o->hw[j][d] = f.hw[j][t];
      o->hmask[j] |= 1u << d;
    }
    for (int t = 0, last = -1; t < f.nv[j]; last = f.vd[j][t++]) {
      const int d = f.vd[j][t];
      if (d <= last || d > 4) return false;
      o->vw[j][d] = f.vw[j][t];
      o->vmask[j] |= 1u << d;
    }
  }
  return true;
}

// A tile's shared memory: the staged blur tile, its entry (y, x) the blur
// at image (R - 4 + y, C - 4 + x) for the tile whose first pixel is (R, C),
// and the smoothed plane, S[y][x] being S at image (R - 2 + y, C - 2 + x).
struct __align__(16) FitTileSmem {
  float bl[FIT_BL * FIT_BL];
  float S[FIT_S * FIT_S];
};

// S of one tile from its staged blur tile, by the whole block (every
// thread calls it; ends in a barrier, after which ``bl`` is free). This is
// the fit's large part, 25 of a pixel's ~55 taps and once 625 of a fit's
// 775, and the part that pixels share: a thread computes four neighbouring
// values of a row at a time from ten 16-byte loads, so a tap costs its
// multiply and its add. ``t`` should be the kernel's __grid_constant__
// parameter: the weights are then operands from the constant bank.
__device__ __forceinline__ void fit_tile_smooth(FitTileSmem& s, const FitTileTaps& t) {
  for (int q = threadIdx.x; q < FIT_S * (FIT_S / 4); q += blockDim.x) {
    const int y = q / (FIT_S / 4), x = 4 * (q - y * (FIT_S / 4));
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int dr = 0; dr < 5; ++dr) {
      const float* p = s.bl + (y + dr) * FIT_BL + x;
      const float4 lo = *reinterpret_cast<const float4*>(p);
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      const float row[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int dc = 0; dc < 5; ++dc)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(t.cone[dr * 5 + dc], row[k + dc]));
    }
    *reinterpret_cast<float4*>(s.S + y * FIT_S + x) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();
}

// The fit of tile pixel (y, x) from S: its 5x5 window of S is the smoothed
// patch, then per coefficient the vertical pass over the window's columns
// and the horizontal pass (fits that share a vertical factor hold the same
// taps and so repeat the same sums), then the closed form. A thread's work,
// ~150 taps on 25 loads, all in registers: masked pixels are a few per
// cent of a tile, so the V values are computed where a pixel asks for them
// and not as planes.
__device__ __forceinline__ bool fit_tile_at(const float* S, int y, int x,
                                            const FitTileTaps& t, float move_thr,
                                            float* x0o, float* y0o, float* c3o,
                                            float* c4o, float* c5o) {
  float sm[5][5];
#pragma unroll
  for (int a = 0; a < 5; ++a)
#pragma unroll
    for (int c = 0; c < 5; ++c) sm[a][c] = S[(y + a) * FIT_S + x + c];
  float coef[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    float vert[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < 5; ++d)
      if ((t.vmask[j] >> d) & 1u) {
#pragma unroll
        for (int c = 0; c < 5; ++c)
          vert[c] = __fadd_rn(vert[c], __fmul_rn(t.vw[j][d], sm[d][c]));
      }
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < 5; ++d)
      if ((t.hmask[j] >> d) & 1u) acc = __fadd_rn(acc, __fmul_rn(t.hw[j][d], vert[d]));
    coef[j] = acc;
  }
  return fit_solve(coef[0], coef[1], coef[2], coef[3], coef[4], move_thr, x0o,
                   y0o, c3o, c4o, c5o);
}

}  // namespace ag
