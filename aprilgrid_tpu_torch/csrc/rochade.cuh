// ROCHADE quadric fit shared by the cluster, NMS and refine kernels: the
// tap tables (FitTaps, filled by kernels/_fit.py from
// ops/rochade.py::fit_taps) and the record routine, which follows the op
// sequence of ops/rochade.py::fit_record — cone smoothing of the 9x9 blur
// support to 5x5, the five rank-1 fit stencils as a vertical then a
// horizontal pass, every tap one multiply and one add in table order —
// so a kernel's record equals the plain version's bit for bit.
// fit_record is one thread's work; fit_record_warp spreads the same
// per-element sequences over a warp.
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

// Fit on the 9x9 blur patch whose top-left element is ``p00`` (row stride
// ``stride``); the candidate pixel is the patch centre. Returns the accept
// gate (saddle, move within ``move_thr``, |c5| < k).
__device__ inline bool fit_record(const float* p00, int stride,
                                  const FitTaps& f, float move_thr,
                                  float* x0o, float* y0o, float* c3o,
                                  float* c4o, float* c5o) {
  float patch[9][9];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int c = 0; c < 9; ++c) patch[a][c] = p00[(size_t)a * stride + c];
  float sm[5][5];
#pragma unroll
  for (int a = 0; a < 5; ++a)
#pragma unroll
    for (int c = 0; c < 5; ++c) sm[a][c] = 0.0f;
  for (int t = 0; t < f.n_cone; ++t) {
    const int dr = f.cone_dr[t], dc = f.cone_dc[t];
    const float wt = f.cone_w[t];
#pragma unroll
    for (int a = 0; a < 5; ++a)
#pragma unroll
      for (int c = 0; c < 5; ++c)
        sm[a][c] = __fadd_rn(sm[a][c], __fmul_rn(wt, patch[a + dr][c + dc]));
  }
  float vert[5][5];
  bool have[5] = {false, false, false, false, false};
  float coef[5];
  for (int j = 0; j < 5; ++j) {
    const int v = f.vid[j];
    if (!have[v]) {
      for (int c = 0; c < 5; ++c) {
        float acc = 0.0f;
        for (int t = 0; t < f.nv[j]; ++t)
          acc = __fadd_rn(acc, __fmul_rn(f.vw[j][t], sm[f.vd[j][t]][c]));
        vert[v][c] = acc;
      }
      have[v] = true;
    }
    float acc = 0.0f;
    for (int t = 0; t < f.nh[j]; ++t)
      acc = __fadd_rn(acc, __fmul_rn(f.hw[j][t], vert[v][f.hd[j][t]]));
    coef[j] = acc;
  }
  return fit_solve(coef[0], coef[1], coef[2], coef[3], coef[4], move_thr, x0o,
                   y0o, c3o, c4o, c5o);
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
// hold the same taps, so each computes fit_record's shared pass), lane j
// the horizontal taps of coefficient j, and every lane the closed form.
// Each element runs fit_record's own sequence — one multiply and one add
// per tap from 0, in table order — so the record is the same bit for bit;
// the dependent chain is ~100 operations instead of ~1,580, and no
// thread-private array is indexed at run time (the values sit in shared
// memory, the tap tables in the kernel's parameter bank).
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

}  // namespace ag
