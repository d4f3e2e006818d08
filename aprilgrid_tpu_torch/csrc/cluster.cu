// Cluster kernels: padded frames (raw, f32 luma or f32 blur plane) +
// per-frame response threshold -> accepted ROCHADE saddle candidates,
// append-compacted per frame.
//
// Replaces the JAX package's pallas/cluster.py::cluster_rochade_raw
// (ag_cluster_rochade_raw; its f32-luma input is mode 2) and
// pallas/cluster.py::cluster_rochade, the blur-fed twin
// (ag_cluster_rochade). The TPU kernels sweep 184-row windows in VMEM,
// relax min-index labels to a fixpoint, drain the roots serially and read a
// dense per-pixel ROCHADE record at each rounded centroid. The function is
// dense only up to the mask: 1-3 % of the pixels are masked and a 1080p
// frame holds a few thousand blobs. So one launch runs per pixel and the
// four after it run over compact lists that it starts:
//
//   (a) blur_mask (raw or f32 luma in: front_tile_kernel's staging and
//       blur passes of tile.cuh, then its Hessian rows, a thread 4 columns
//       of 4 rows; writes the f32 blur plane) or mask (blur plane in, 16
//       bytes per thread and row): the label plane gets -1 at unmasked
//       pixels and, at a masked one (resp < thr inside the image's
//       one-pixel border), the index of the first pixel of its run within
//       its aligned 32-column segment (a ballot gives a warp the segment's
//       mask bits), and every masked pixel is appended to the frame's pixel
//       list: ballots place a pixel within its block, one atomicAdd per
//       block on the frame's cursor places the block;
//   (b) unite, over the pixel list: 4-connected union-find on the label
//       plane with atomicMin links, for the links (a) left open — between
//       runs across a segment border, and between a run and the one above
//       it, once per pair. Every link points to a smaller index, so a
//       component's root is its minimum linear index — the reference's
//       scan-order cluster key — whatever the list's order;
//   (c) roots, over the pixel list: a pixel that is still its own label
//       takes the next slot of the frame's root list (one atomicAdd per
//       block), zeroes the slot's sums and leaves -(slot + 2) in the label
//       plane;
//   (d) stats, over the pixel list: the first pixel of each run walks to
//       the root, reads its slot and adds the run's length and its row and
//       column sums to the slot's integer sums with atomics
//       (order-independent, so the centroid is deterministic);
//   (e) record, a warp per root slot: the plain mean of the members (int64
//       sums over the f32 count), rounded, the bounds gate, and the ROCHADE
//       fit on the 9x9 blur patch around it by the whole warp
//       (rochade.cuh::fit_record_warp, per element the op sequence of
//       ops/rochade.py::fit_record). Accepted roots append
//       [x, y, 0, c3, c4, c5, 1, label + 1] with an atomicAdd cursor; rows
//       past the capacity are counted, not written.
//
// Row sharding (ag_cluster_rochade_raw with roff non-null): frame b is a
// window whose row r is row r + roff[b] of a gh-row frame. The mask and the
// bounds gate hold in the window's rows and in the frame's, y is emitted in
// the frame's rows; the label stays the window's scan-order index.
//
// Launches (b)-(e) have a fixed grid (blockIdx.y is the frame, the blocks
// of a frame stride over its list) and read the list lengths from device
// memory: the host never waits. No index is divided in 64 bits.
//
// The append order is free: saddles_from_candidates sorts by label. The
// labeling is global, so the TPU kernel's blob-size cap (blobs taller than
// ~40 rows or wider than 256 columns were dropped and counted) does not
// exist here; the wrapper reports 0 drops. The TPU kernel's turbo-only blob
// pre-filter and its 160-row window shorten its serial root drain and have
// no counterpart either.
//
// Layouts: a raw or luma frame has 8 margin rows above the image
// (pad_raw, pad_half); the blur and label planes have none, pixel (r, c)
// sits at r * wp + c. A masked pixel has r, c >= 1, so its left and upper
// neighbours are in the plane. A frame's 4-connected components number at
// most half its pixels (two horizontal neighbours never root two
// components), which sizes the root list and the sums.
//
// Bound on the H100: memory, by the dense launch alone — (a) reads the
// frame and writes the blur and label planes (11 bytes per pixel for RGB,
// 8 for a blur plane in); the lists hold ~50 k pixels and ~2 k roots of a
// 1080p frame, and nothing after (a) touches a plane except at those. The
// list launches wait on chains of L2 round trips (labels) and on atomics,
// so (a) links what a warp can see in registers and every cursor is
// advanced once per block: same-address atomics run one after another.
// Launch (a) of the raw form runs the front kernel's staging and passes, so
// it is bound as that kernel is: by the latency between its barrier-
// separated phases, not by its bytes. At two_boards b32 on an NVIDIA H100
// 80GB HBM3 at 700 W it takes 0.356 ms against a 0.220-ms bytes floor
// (738 MB), the share of its floor that front_tile_kernel with a blur
// plane reaches; the first version (blur_tile, hessian_at and a warp a
// row) took 0.464 (PERF.md, section 6). Recomputing the fit's blur patch
// from the frame in (e), so that (a) writes no blur plane, cut (a) to
// 0.309 but raised (e) from 0.075 to 0.111: the entry fell 2 %, the
// f32-luma mode's rose 1 %, and it was not kept.
#include "rochade.cuh"
#include "tile.cuh"

namespace {

using namespace ag;

constexpr int MASK_COLS = 128;   // mask_kernel: columns per block (a warp a row)
constexpr int MASK_ROWS = 8;     // rows per block (one per warp)
constexpr int LIST_BLOCKS = 8 * 132;   // list launches: blocks over all frames

constexpr unsigned FULL = 0xffffffffu;

// First position of the run of set bits of ``seg`` that holds bit ``pos``:
// a masked pixel's first label is the first pixel of its run inside its
// aligned 32-column segment, so launch (b) has only the links between runs
// left to make.
__device__ __forceinline__ int run_start(unsigned seg, int pos) {
  return 32 - __clz(~seg & ((1u << pos) - 1u));
}

// Reserves list entries for the whole block with one atomicAdd on the
// frame's cursor: every thread calls it, ``n`` (the warp's count) is the
// same in all lanes of a warp; returns the warp's first entry. ``sh`` is
// two ints of shared memory.
__device__ __forceinline__ int reserve_entries(int n, int* cursor, int* sh) {
  if (threadIdx.x == 0) sh[0] = 0;
  __syncthreads();
  int first = 0;
  if ((threadIdx.x & 31) == 0 && n > 0) first = atomicAdd(&sh[0], n);
  __syncthreads();
  if (threadIdx.x == 0) sh[1] = sh[0] > 0 ? atomicAdd(cursor, sh[0]) : 0;
  __syncthreads();
  return sh[1] + __shfl_sync(FULL, first, 0);
}

// The labels of a thread's four pixels i .. i + 3 of one row (mask bits
// m) and the warp's four ballots of them: ballot k holds pixel k of every
// lane. A lane's 32-column segment is its octet of lanes, pixel k of lane
// l at bit 4 (l % 8) + k of the segment's bits (tile.cuh::segment_bits).
__device__ __forceinline__ int4 row_labels(const bool (&m)[4], int i, unsigned (&bal)[4]) {
  const int lane = threadIdx.x & 31;
  const unsigned seg = segment_bits(m, bal);
  const int pos = 4 * (lane & 7), seg0 = i - pos;
  int4 lab;
  lab.x = m[0] ? seg0 + run_start(seg, pos) : -1;
  lab.y = m[1] ? seg0 + run_start(seg, pos + 1) : -1;
  lab.z = m[2] ? seg0 + run_start(seg, pos + 2) : -1;
  lab.w = m[3] ? seg0 + run_start(seg, pos + 3) : -1;
  return lab;
}

// Launch (a)'s pixels in response_run's layout: the thread's columns
// c .. c + 3 of rows r0 .. r0 + 3 (pixel i0 = r0 * wp + c of the frame's
// planes; a warp holds two row groups of 64 columns, an octet of lanes one
// aligned 32-column segment), from a rotating 3-row window of the blurred
// tile. Each row's blurred pixels and labels leave as one 16-byte store
// each (``blur`` and ``labels`` point at pixel i0); bit 4 r + k of
// ``mine`` is the mask of pixel (r0 + r, c + k), and ``count`` adds up the
// warp's masked pixels. A pixel is masked where its row is in ``rows``,
// its column in [1, w - 1) and its response below t; without BORDER every
// pixel of the block is inside, and only the response is tested.
template <bool BORDER>
__device__ __forceinline__ void mask_run(const FrontTileSmem& s, int q, int y0, int r0,
                                         int c, Rows rows, int w, float t, int wp,
                                         int i0, float* blur, int* labels,
                                         unsigned& mine, int& count) {
  float up[6], mid[6], dn[6];
  load_row6(s, y0, q, up);
  load_row6(s, y0 + 1, q, mid);
  bool col_in[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col_in[j] = c + j != 0 && c + j < w - 1;
#pragma unroll
  for (int r = 0; r < FT_RRUN; ++r) {
    load_row6(s, y0 + r + 2, q, dn);
    const bool row_in = rows.in(r0 + r);
    bool m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = hessian_of(up[j], up[j + 1], up[j + 2], mid[j], mid[j + 1],
                                 mid[j + 2], dn[j], dn[j + 1], dn[j + 2]);
      m[j] = (!BORDER || (row_in && col_in[j])) && v < t;
      mine |= (unsigned)m[j] << (4 * r + j);
    }
    unsigned bal[4];
    const int4 lab = row_labels(m, i0 + r * wp, bal);
#pragma unroll
    for (int k = 0; k < 4; ++k) count += __popc(bal[k]);
    *reinterpret_cast<int4*>(labels + (size_t)r * wp) = lab;
    *reinterpret_cast<float4*>(blur + (size_t)r * wp) =
        make_float4(mid[1], mid[2], mid[3], mid[4]);
#pragma unroll
    for (int j = 0; j < 6; ++j) up[j] = mid[j], mid[j] = dn[j];
  }
}

// Launch (a) of the raw form, one instance per input mode (RAW_*): a block
// is a (frame, 64-row tile, 64-column strip) and runs front_tile_kernel's
// staging (without luma8) and blur passes (tile.cuh), then mask_run; the
// block's list entries are reserved once, after all its rows.
template <int RAW>
__global__ void __launch_bounds__(THREADS, FT_BLOCKS)
blur_mask_kernel(const void* raw, int hp, int wp, int h, int w, bool aligned,
                 Taps7 taps, const float* thr, const int* roff, int gh, float* blur,
                 int* labels, int* plist, int* npix) {
  __shared__ __align__(16) FrontTileSmem s;
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  if constexpr (RAW == RAW_GRAY8) {
    s.lut[tid] = __fdiv_rn((float)tid, 255.0f);
    __syncthreads();
  }
  stage_quads<RAW, false>(s, raw, b, ti, si, hp, wp, w, aligned, nullptr);
  blur_tile_passes(s, taps);
  const int q = tid % (STRIP_W / 4), y0 = (tid / (STRIP_W / 4)) * FT_RRUN;
  const int r0 = ti * TILE_H + y0, c = si * STRIP_W + 4 * q;
  const int i0 = r0 * wp + c;
  const size_t fbase = (size_t)b * hp * wp;
  // the mask's rows: the window's 1 .. h - 2 and the frame's 1 .. gh - 2
  // (gh == h without roff)
  const Rows rows{h, roff != nullptr ? roff[b] : 0, gh, 1};
  const float t = thr[b];
  // a block that holds no pixel of the one-pixel border or of the padding,
  // in a frame that is no window of a taller one, tests the response alone
  const bool border = ti == 0 || (ti + 1) * TILE_H >= h || si == 0 ||
                      (si + 1) * STRIP_W >= w || rows.ro != 0 || gh != h;
  unsigned mine = 0u;
  int count = 0;
  if (border)
    mask_run<true>(s, q, y0, r0, c, rows, w, t, wp, i0, blur + fbase + i0,
                   labels + fbase + i0, mine, count);
  else
    mask_run<false>(s, q, y0, r0, c, rows, w, t, wp, i0, blur + fbase + i0,
                    labels + fbase + i0, mine, count);
  // warp_min is free after the passes: the two ints of reserve_entries
  int at = reserve_entries(count, npix + b, reinterpret_cast<int*>(s.warp_min));
  const unsigned below = (1u << (tid & 31)) - 1u;
#pragma unroll
  for (int k = 0; k < 4 * FT_RRUN; ++k) {
    const bool m = (mine >> k) & 1u;
    const unsigned bal = __ballot_sync(FULL, m);
    if (m) plist[fbase + at + __popc(bal & below)] = i0 + (k >> 2) * wp + (k & 3);
    at += __popc(bal);
  }
}

// Launch (a) of the blur-fed form: the mask from a (frames, hp, wp) blur
// plane. A block is 8 rows of 128 columns, a thread four pixels of a row:
// three 16-byte loads and the two columns beside them. Inside the image's
// one-pixel border all eight neighbours lie in the plane.
__global__ void __launch_bounds__(THREADS)
mask_kernel(const float* blur, int hp, int wp, int h, int w, const float* thr,
            int* labels, int* plist, int* npix) {
  const int b = blockIdx.z;
  const int r = blockIdx.y * MASK_ROWS + (threadIdx.x >> 5);
  const int c = blockIdx.x * MASK_COLS + 4 * (threadIdx.x & 31);
  const size_t fbase = (size_t)b * hp * wp;
  const int i = r * wp + c;
  bool m[4] = {false, false, false, false};
  if (r > 0 && r < h - 1 && c < w - 1) {   // else none of the four is inside
    const float t = thr[b];
    const float* p = blur + fbase + i;
    float v[3][6];   // rows r - 1 .. r + 1, columns c - 1 .. c + 4
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* q = p + (k - 1) * wp;
      const float4 mid = *reinterpret_cast<const float4*>(q);
      v[k][0] = c > 0 ? q[-1] : 0.0f;
      v[k][1] = mid.x;
      v[k][2] = mid.y;
      v[k][3] = mid.z;
      v[k][4] = mid.w;
      v[k][5] = c + 4 < wp ? q[4] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = c + k > 0 && c + k < w - 1 &&
             hessian_of(v[0][k], v[0][k + 1], v[0][k + 2], v[1][k], v[1][k + 1],
                        v[1][k + 2], v[2][k], v[2][k + 1], v[2][k + 2]) < t;
  }
  unsigned bal[4];
  *reinterpret_cast<int4*>(labels + fbase + i) = row_labels(m, i, bal);
  int count = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) count += __popc(bal[k]);
  __shared__ int sh[2];
  int at = reserve_entries(count, npix + b, sh);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (m[k]) plist[fbase + at + __popc(bal[k] & ((1u << lane) - 1u))] = i + k;
    at += __popc(bal[k]);
  }
}

// Root of x's tree, halving the path on the way: a pixel passed is
// re-pointed at its grandparent with atomicMin, so a label only ever moves
// to a smaller pixel of the same component, whoever else writes it.
__device__ __forceinline__ int find_root(int* lab, int x) {
  while (true) {
    const int p = __ldcg(lab + x);
    if (p == x) return x;
    const int gp = __ldcg(lab + p);
    if (gp == p) return p;
    atomicMin(lab + x, gp);
    x = gp;
  }
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

// The list launches: blockIdx.y is the frame, and the frame's gridDim.x
// blocks stride over its list from list_first() in steps of list_step().
__device__ __forceinline__ int list_first() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int list_step() { return gridDim.x * blockDim.x; }

__global__ void unite_kernel(int* labels, const int* plist, const int* npix,
                             int hp, int wp) {
  const size_t fbase = (size_t)blockIdx.y * hp * wp;
  int* lab = labels + fbase;
  const int n = npix[blockIdx.y];
  for (int k = list_first(); k < n; k += list_step()) {
    const int i = plist[fbase + k];
    // runs inside a 32-column segment are linked already: join runs across
    // a segment border, and a run to the one above where their overlap
    // begins (further right the pixel to the left makes the same link).
    // A pixel's label is a pixel of its component, so the trees are joined
    // from the labels just read, a step nearer the roots.
    const bool first = (i & 31) == 0;
    const int me = lab[i], left = lab[i - 1], up = lab[i - wp];
    if (first && left >= 0) unite(lab, me, left);
    if (up >= 0 && (first || left < 0 || lab[i - wp - 1] < 0))
      unite(lab, me, up);
  }
}

__global__ void __launch_bounds__(THREADS)
roots_kernel(int* labels, const int* plist, const int* npix, int hp, int wp,
             int* rlist, int* nroot, int* cnt, unsigned long long* sums) {
  __shared__ int sh[2];
  const size_t fbase = (size_t)blockIdx.y * hp * wp;
  const size_t rbase = fbase / 2;
  int* lab = labels + fbase;
  const int n = npix[blockIdx.y];
  const int lane = threadIdx.x & 31;
  // the whole block takes every trip: it reserves its slots together
  for (int k0 = blockIdx.x * blockDim.x; k0 < n; k0 += list_step()) {
    const int k = k0 + threadIdx.x;
    const int i = k < n ? plist[fbase + k] : -1;
    const bool root = i >= 0 && lab[i] == i;
    const unsigned bal = __ballot_sync(FULL, root);
    const int at = reserve_entries(__popc(bal), nroot + blockIdx.y, sh);
    if (!root) continue;
    const int slot = at + __popc(bal & ((1u << lane) - 1u));
    rlist[rbase + slot] = i;
    cnt[rbase + slot] = 0;
    sums[2 * (rbase + slot)] = 0ull;
    sums[2 * (rbase + slot) + 1] = 0ull;
    lab[i] = -(slot + 2);
  }
}

// One thread per run: the first pixel of a run inside its 32-column segment
// adds the whole run to its root's sums.
__global__ void stats_kernel(const int* labels, const int* plist,
                             const int* npix, int hp, int wp, int* cnt,
                             unsigned long long* sums) {
  const size_t fbase = (size_t)blockIdx.y * hp * wp;
  const size_t rbase = fbase / 2;
  const int* lab = labels + fbase;
  const int n = npix[blockIdx.y];
  for (int k = list_first(); k < n; k += list_step()) {
    const int i = plist[fbase + k];
    // after roots_kernel -1 alone means unmasked: a root holds -(slot + 2)
    if ((i & 31) != 0 && lab[i - 1] != -1) continue;
    int len = 1;
    while (((i + len) & 31) != 0 && lab[i + len] != -1) ++len;
    int p = lab[i];
    while (p >= 0) p = lab[p];
    const size_t slot = rbase + (size_t)(-p - 2);
    const unsigned long long r = i / wp, c = i % wp, l = len;
    atomicAdd(cnt + slot, len);
    atomicAdd(sums + 2 * slot, l * r);
    atomicAdd(sums + 2 * slot + 1, l * c + l * (l - 1ull) / 2ull);
  }
}

__global__ void __launch_bounds__(THREADS)
record_kernel(const int* rlist, const int* nroot, const int* cnt,
              const unsigned long long* sums, const float* blur, int hp,
              int wp, int h, int w, int hp2, const int* roff, int gh,
              const __grid_constant__ FitTaps fit, float move_thr, int* napp,
              float* fields, int capf) {
  constexpr int WARPS = THREADS / 32;
  __shared__ FitScratch scratch[WARPS];
  // the tap tables in shared memory: lanes read different rows of them
  __shared__ FitTaps taps;
  const int* src = reinterpret_cast<const int*>(&fit);
  for (int k = threadIdx.x; k < (int)(sizeof(FitTaps) / sizeof(int)); k += THREADS)
    reinterpret_cast<int*>(&taps)[k] = src[k];
  __syncthreads();
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const size_t fbase = (size_t)b * hp * wp;
  const size_t rbase = fbase / 2;
  const int n = nroot[b];
  const int ro = roff != nullptr ? roff[b] : 0;
  for (int k = blockIdx.x * WARPS + warp; k < n; k += gridDim.x * WARPS) {
    const size_t slot = rbase + k;
    const float cn = __int2float_rn(cnt[slot]);
    const float cy = __fdiv_rn(__ull2float_rn(sums[2 * slot]), cn);
    const float cx = __fdiv_rn(__ull2float_rn(sums[2 * slot + 1]), cn);
    const int rx = (int)floorf(__fadd_rn(cx, 0.5f));
    const int ry = (int)floorf(__fadd_rn(cy, 0.5f));
    // the gates below are the same for every lane of the warp
    if (ry - hp2 < 0 || ry + hp2 >= h || ry + ro - hp2 < 0 || ry + ro + hp2 >= gh ||
        rx - hp2 < 0 || rx + hp2 >= w)
      continue;
    float x0, y0, c3, c4, c5;
    const bool ok = fit_record_warp(
        scratch[warp], blur + fbase + (size_t)(ry - 4) * wp + (rx - 4), wp,
        taps, move_thr, &x0, &y0, &c3, &c4, &c5);
    if (!ok || (threadIdx.x & 31) != 0) continue;
    const int at = atomicAdd(napp + b, 1);
    if (at >= capf) continue;
    const int i = rlist[slot];
    float* row = fields + ((size_t)b * capf + at) * 8;
    row[0] = __fadd_rn((float)rx, x0);
    row[1] = __fadd_rn((float)(ry + ro), y0);
    row[2] = 0.0f;
    row[3] = c3;
    row[4] = c4;
    row[5] = c5;
    row[6] = 1.0f;
    row[7] = (float)((i / wp) * w + (i % wp) + 1);
  }
}

// Launches (b)-(e) over the labels and the pixel list of launch (a) and the
// blur plane it wrote or was given. ctr: the (3, b) cursors — pixel list,
// root list, appended rows.
int launch_components(const float* blur, int b, int hp, int wp, int h, int w,
                      const int* roff, int gh, const FitTaps& fit,
                      float move_thr, int hp2, int* labels,
                      int* plist, int* rlist, int* cnt,
                      unsigned long long* sums, int* ctr, float* fields,
                      int capf, cudaStream_t st) {
  const int* npix = ctr;
  int* nroot = ctr + b;
  int* napp = ctr + 2 * b;
  const dim3 grid((LIST_BLOCKS + b - 1) / b, b);
  unite_kernel<<<grid, THREADS, 0, st>>>(labels, plist, npix, hp, wp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  roots_kernel<<<grid, THREADS, 0, st>>>(labels, plist, npix, hp, wp, rlist,
                                         nroot, cnt, sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_kernel<<<grid, THREADS, 0, st>>>(labels, plist, npix, hp, wp, cnt, sums);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  record_kernel<<<grid, THREADS, 0, st>>>(rlist, nroot, cnt, sums, blur, hp, wp,
                                          h, w, hp2, roff, gh, fit, move_thr,
                                          napp, fields, capf);
  return (int)cudaGetLastError();
}

}  // namespace

// raw: (b, hp + 16, wp * channels) u8 (mode 0), u16 (mode 1) or f32 luma
// (mode 2, one channel); thr: (b,) f32 device; roff: (b,) int32 device row
// offsets of windows of a gh-row frame, or null (gh = h);
// scratch: blur (b, hp, wp) f32, labels and plist (b, hp, wp) int32, rlist
// and cnt (b, hp * wp / 2) int32, sums (b, hp * wp / 2, 2) uint64; ctr
// (3, b) int32 and fields (b, capf, 8) f32 zero-filled by the caller.
// Returns the first launch error, or 0.
extern "C" int ag_cluster_rochade_raw(
    const void* raw, int b, int hp, int wp, int channels, int mode, int h,
    int w, const void* thr, const float* taps7, const void* fit_taps,
    float move_thr, int hp2, const void* roff, int gh, void* blur,
    void* labels, void* plist, void* rlist, void* cnt, void* sums, void* ctr,
    void* fields, int capf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ag::Taps7 taps;
  for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
  // the quads' 4- (u8, RGB: 12), 8- (u16) or 16-byte (f32) loads; rows
  // start 128-byte aligned
  const bool aligned =
      (uintptr_t)raw % (mode == ag::MODE_F32 ? 16 : mode == ag::MODE_U16 ? 8 : 4) == 0;
  auto kernel = channels == 3          ? blur_mask_kernel<ag::RAW_RGB8>
                : mode == ag::MODE_F32 ? blur_mask_kernel<ag::RAW_F32>
                : mode == ag::MODE_U16 ? blur_mask_kernel<ag::RAW_GRAY16>
                                       : blur_mask_kernel<ag::RAW_GRAY8>;
  dim3 tgrid(wp / ag::STRIP_W, hp / ag::TILE_H, b);
  kernel<<<tgrid, ag::THREADS, 0, st>>>(
      raw, hp, wp, h, w, aligned, taps, (const float*)thr, (const int*)roff, gh,
      (float*)blur, (int*)labels, (int*)plist, (int*)ctr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_components((const float*)blur, b, hp, wp, h, w, (const int*)roff,
                           gh, *(const ag::FitTaps*)fit_taps, move_thr, hp2,
                           (int*)labels, (int*)plist, (int*)rlist, (int*)cnt,
                           (unsigned long long*)sums, (int*)ctr,
                           (float*)fields, capf, st);
}

// blur: (b, hp, wp) f32 padded blur plane (input), hp a multiple of 8 and
// wp of 128; the rest as above. Returns the first launch error, or 0.
extern "C" int ag_cluster_rochade(
    const void* blur, int b, int hp, int wp, int h, int w, const void* thr,
    const void* fit_taps, float move_thr, int hp2, void* labels, void* plist,
    void* rlist, void* cnt, void* sums, void* ctr, void* fields, int capf,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 mgrid(wp / MASK_COLS, hp / MASK_ROWS, b);
  mask_kernel<<<mgrid, ag::THREADS, 0, st>>>(
      (const float*)blur, hp, wp, h, w, (const float*)thr, (int*)labels,
      (int*)plist, (int*)ctr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_components((const float*)blur, b, hp, wp, h, w, nullptr, h,
                           *(const ag::FitTaps*)fit_taps, move_thr, hp2,
                           (int*)labels, (int*)plist, (int*)rlist, (int*)cnt,
                           (unsigned long long*)sums, (int*)ctr,
                           (float*)fields, capf, st);
}
