// Cluster kernel: padded raw frames + per-frame response threshold ->
// accepted ROCHADE saddle candidates, append-compacted per frame.
//
// Replaces the JAX package's pallas/cluster.py::cluster_rochade_raw. The
// TPU kernel sweeps 184-row windows in VMEM, relaxes min-index labels to
// a fixpoint, drains the roots serially and reads a dense per-pixel
// ROCHADE record at each rounded centroid. On the GPU the same function is
// four launches over device scratch that the wrapper allocates:
//
//   (a) blur_mask: the front kernel's tile stencil (stencil.cuh) writes the
//       f32 blur plane and seeds the labels of the masked pixels
//       (resp < thr inside the image's zero border) with their own index;
//   (b) unite: 4-connected union-find with atomicMin links (every link
//       points to a smaller index, so each component's root is its
//       minimum linear index — the reference's scan-order cluster key);
//   (c) stats: path compression plus integer atomics of the member count
//       and the member row/column sums at the root (order-independent);
//   (d) record: one thread per root takes the plain mean of the members
//       (int64 sums over the f32 count), rounds it, applies the bounds
//       gate and evaluates the ROCHADE fit on the 9x9 blur patch around
//       it (rochade.cuh, the op order of ops/rochade.py::fit_record: rank-1
//       fit stencils, as the TPU kernel's _record_planes). Accepted roots
//       append [x, y, 0, c3, c4, c5, 1, label + 1] with an atomicAdd
//       cursor; rows past the capacity are counted, not written.
//
// The append order is free: saddles_from_candidates sorts by label. The
// labeling is global, so the TPU kernel's blob-size cap (blobs taller
// than ~40 rows or wider than 256 columns were dropped and counted) does
// not exist here; the wrapper reports 0 drops.
//
// The frame may be an f32 luma plane in the padded layout (mode 2, the
// turbo path's half-resolution plane from the decimating front kernel):
// launch (a) then blurs the plane as it is; (b)-(d) are unchanged. The TPU
// kernel's turbo-only blob pre-filter and its 160-row window shorten its
// serial root drain and have no counterpart here.
//
// ag_cluster_rochade (replacing pallas/cluster.py::cluster_rochade, the
// blur-fed twin) takes the padded f32 blur plane itself — the front
// kernel's blur output, or fused_frontend's: launch (a) is then
// mask_kernel, one thread per pixel evaluating the Hessian response on the
// plane in device memory and seeding the labels; (b)-(d) read that plane.
// The plane has no margin rows, so pixel (r, c) sits at r * wp + c.
//
// Bound on the H100: memory. The dense part (a) reads the raw frame and
// writes the blur plane and the label plane (9 bytes per pixel for u8
// gray); (b)-(d) read the label plane once each and touch only the sparse
// masked pixels. The label, count and sum planes are pixel-indexed, so the
// atomics of a blob land on one root without any compaction pass.
#include "rochade.cuh"
#include "stencil.cuh"

namespace {

using namespace ag;

__global__ void __launch_bounds__(THREADS)
blur_mask_kernel(const void* raw, int hp, int wp, int channels, int mode,
                 int h, int w, Taps7 taps, const float* thr, float* blur,
                 int* labels, int* cnt, unsigned long long* sums) {
  __shared__ TileSmem s;
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int c0 = si * STRIP_W;
  blur_tile(s, raw, b, ti, si, hp, wp, channels, mode, w, taps);
  const float t = thr[b];
  const size_t fbase = (size_t)b * hp * wp;
  for (int idx = threadIdx.x; idx < TILE_H * STRIP_W; idx += THREADS) {
    int y = idx / STRIP_W, x = idx % STRIP_W;
    int r = ti * TILE_H + y, c = c0 + x;
    int i = r * wp + c;
    blur[fbase + i] = s.lum[y + 1][x + 1];
    bool m = r > 0 && r < h - 1 && c > 0 && c < w - 1 &&
             hessian_at(s, y + 1, x + 1) < t;
    labels[fbase + i] = m ? i : -1;
    if (m) {
      cnt[fbase + i] = 0;
      sums[2 * (fbase + i)] = 0ull;
      sums[2 * (fbase + i) + 1] = 0ull;
    }
  }
}

// Launch (a) of the blur-fed form: the mask from a (frames, hp, wp) blur
// plane. Inside the image's one-pixel border all eight neighbours lie in
// the plane.
__global__ void mask_kernel(const float* blur, int hp, int wp, int h, int w,
                            const float* thr, int* labels, int* cnt,
                            unsigned long long* sums, long long total) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const long long fpix = (long long)hp * wp;
  const int i = (int)(g % fpix);
  const int r = i / wp, c = i % wp;
  bool m = r > 0 && r < h - 1 && c > 0 && c < w - 1 &&
           hessian_ptr(blur + g, wp) < thr[g / fpix];
  labels[g] = m ? i : -1;
  if (m) {
    cnt[g] = 0;
    sums[2 * g] = 0ull;
    sums[2 * g + 1] = 0ull;
  }
}

__device__ __forceinline__ int find_root(const int* lab, int x) {
  int p = __ldcg(lab + x);
  while (p != x) {
    x = p;
    p = __ldcg(lab + x);
  }
  return x;
}

// Link the trees of a and b; the larger root is re-pointed at the
// smaller one with atomicMin, retrying when another thread moved it first.
__device__ void unite(int* lab, int a, int b) {
  while (true) {
    a = find_root(lab, a);
    b = find_root(lab, b);
    if (a == b) return;
    if (a < b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(lab + a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void unite_kernel(int* labels, int hp, int wp, long long total) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const long long fpix = (long long)hp * wp;
  int* lab = labels + (g / fpix) * fpix;
  int i = (int)(g % fpix);
  if (lab[i] < 0) return;
  int c = i % wp;
  if (c > 0 && lab[i - 1] >= 0) unite(lab, i, i - 1);
  if (i >= wp && lab[i - wp] >= 0) unite(lab, i, i - wp);
}

__global__ void stats_kernel(int* labels, int* cnt, unsigned long long* sums,
                             int hp, int wp, long long total) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const long long fpix = (long long)hp * wp;
  const long long base = (g / fpix) * fpix;
  int* lab = labels + base;
  int i = (int)(g % fpix);
  if (lab[i] < 0) return;
  int root = find_root(lab, i);
  lab[i] = root;
  atomicAdd(cnt + base + root, 1);
  atomicAdd(sums + 2 * (base + root), (unsigned long long)(i / wp));
  atomicAdd(sums + 2 * (base + root) + 1, (unsigned long long)(i % wp));
}

__global__ void record_kernel(const int* labels, const int* cnt,
                              const unsigned long long* sums,
                              const float* blur, int hp, int wp, int h, int w,
                              int hp2, FitTaps fit, float move_thr,
                              int* napp, float* fields, int capf,
                              long long total) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const long long fpix = (long long)hp * wp;
  const int b = (int)(g / fpix);
  const long long base = (long long)b * fpix;
  const int i = (int)(g % fpix);
  if (labels[base + i] != i) return;  // not a root (or not masked: -1)
  const float n = __int2float_rn(cnt[base + i]);
  const float cy = __fdiv_rn(__ull2float_rn(sums[2 * (base + i)]), n);
  const float cx = __fdiv_rn(__ull2float_rn(sums[2 * (base + i) + 1]), n);
  const int rx = (int)floorf(__fadd_rn(cx, 0.5f));
  const int ry = (int)floorf(__fadd_rn(cy, 0.5f));
  if (ry - hp2 < 0 || ry + hp2 >= h || rx - hp2 < 0 || rx + hp2 >= w) return;
  float x0, y0, c3, c4, c5;
  if (!fit_record(blur + base + (size_t)(ry - 4) * wp + (rx - 4), wp, fit,
                  move_thr, &x0, &y0, &c3, &c4, &c5))
    return;
  const int slot = atomicAdd(napp + b, 1);
  if (slot >= capf) return;
  float* row = fields + ((size_t)b * capf + slot) * 8;
  row[0] = __fadd_rn((float)rx, x0);
  row[1] = __fadd_rn((float)ry, y0);
  row[2] = 0.0f;
  row[3] = c3;
  row[4] = c4;
  row[5] = c5;
  row[6] = 1.0f;
  row[7] = (float)((i / wp) * w + (i % wp) + 1);
}

// Launches (b)-(d) over labels seeded by launch (a) and the blur plane it
// wrote or was given.
int launch_components(const float* blur, int b, int hp, int wp, int h, int w,
                      const FitTaps& fit, float move_thr, int hp2, int* labels,
                      int* cnt, unsigned long long* sums, int* napp,
                      float* fields, int capf, cudaStream_t st) {
  const long long total = (long long)b * hp * wp;
  const unsigned pgrid = (unsigned)((total + THREADS - 1) / THREADS);
  unite_kernel<<<pgrid, THREADS, 0, st>>>(labels, hp, wp, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_kernel<<<pgrid, THREADS, 0, st>>>(labels, cnt, sums, hp, wp, total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  record_kernel<<<pgrid, THREADS, 0, st>>>(labels, cnt, sums, blur, hp, wp, h,
                                           w, hp2, fit, move_thr, napp, fields,
                                           capf, total);
  return (int)cudaGetLastError();
}

}  // namespace

// raw: (b, hp + 16, wp * channels) u8 (mode 0), u16 (mode 1) or f32 luma
// (mode 2, one channel); thr: (b,) f32 device;
// scratch: blur (b, hp, wp) f32, labels and cnt (b, hp, wp) int32, sums
// (b, hp, wp, 2) uint64; napp (b,) int32 and fields (b, capf, 8) f32
// zero-filled by the caller. Returns the first launch error, or 0.
extern "C" int ag_cluster_rochade_raw(
    const void* raw, int b, int hp, int wp, int channels, int mode, int h,
    int w, const void* thr, const float* taps7, const void* fit_taps,
    float move_thr, int hp2, void* blur, void* labels, void* cnt, void* sums,
    void* napp, void* fields, int capf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ag::Taps7 taps;
  for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
  dim3 tgrid(wp / ag::STRIP_W, hp / ag::TILE_H, b);
  blur_mask_kernel<<<tgrid, ag::THREADS, 0, st>>>(
      raw, hp, wp, channels, mode, h, w, taps, (const float*)thr,
      (float*)blur, (int*)labels, (int*)cnt, (unsigned long long*)sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_components((const float*)blur, b, hp, wp, h, w,
                           *(const ag::FitTaps*)fit_taps, move_thr, hp2,
                           (int*)labels, (int*)cnt, (unsigned long long*)sums,
                           (int*)napp, (float*)fields, capf, st);
}

// blur: (b, hp, wp) f32 padded blur plane (input); the rest as above.
// Returns the first launch error, or 0.
extern "C" int ag_cluster_rochade(
    const void* blur, int b, int hp, int wp, int h, int w, const void* thr,
    const void* fit_taps, float move_thr, int hp2, void* labels, void* cnt,
    void* sums, void* napp, void* fields, int capf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)b * hp * wp;
  const unsigned pgrid = (unsigned)((total + ag::THREADS - 1) / ag::THREADS);
  mask_kernel<<<pgrid, ag::THREADS, 0, st>>>(
      (const float*)blur, hp, wp, h, w, (const float*)thr, (int*)labels,
      (int*)cnt, (unsigned long long*)sums, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_components((const float*)blur, b, hp, wp, h, w,
                           *(const ag::FitTaps*)fit_taps, move_thr, hp2,
                           (int*)labels, (int*)cnt, (unsigned long long*)sums,
                           (int*)napp, (float*)fields, capf, st);
}
