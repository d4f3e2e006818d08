// ROCHADE quadric fit shared by the cluster, NMS and refine kernels: the
// tap tables (FitTaps, filled by kernels/_fit.py from
// ops/rochade.py::fit_taps) and the record routine, which follows the op
// sequence of ops/rochade.py::fit_record — cone smoothing of the 9x9 blur
// support to 5x5, the five rank-1 fit stencils as a vertical then a
// horizontal pass, every tap one multiply and one add in table order —
// so a kernel's record equals the plain version's bit for bit.
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
  const float a1 = coef[0], a2 = coef[1], a3 = coef[2], a4 = coef[3],
              a5 = coef[4];
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

}  // namespace ag
