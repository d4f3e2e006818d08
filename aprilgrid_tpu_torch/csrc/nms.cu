// NMS extraction kernel: half-resolution f32 luma plane + per-frame
// response threshold -> per-cell candidate records of the response peaks.
//
// Replaces the JAX package's pallas/nms.py::nms_extract_raw (the turbo
// path's clustering-free extraction). The TPU kernel evaluates
// everything densely per 160-row window — the ROCHADE record at every
// pixel, two log-tree min filters, selection matmuls into the cell grid.
// Here it is three launches over 64 x 64 tiles and device scratch that the
// wrapper allocates (blur and candidate planes, a flag per tile):
//
//   (a) blur_resp: the register-blocked tile passes of tile.cuh (the
//       front and cluster kernels' staging of the f32 plane, 16 bytes a
//       quad, and both blur passes), then the Hessian rows in
//       response_run's layout, a thread 4 columns of 4 rows, write the blur
//       plane and the candidate plane: the Hessian response where it is
//       < thr at least hp2 pixels from every image edge, else BIGF, a
//       16-byte store a row each; the tile's flag says whether it holds
//       such a pixel;
//   (b) gate, flagged tiles only: the ROCHADE fit in its tile form
//       (rochade.cuh). A block stages the blur tile with its 4-pixel halo
//       and computes the cone-smoothed plane S on 68 x 68 once for all of
//       the tile's pixels, four values a thread at a time — the fit is
//       position-independent, so neighbouring pixels share every S value
//       bit for bit, and the cone is 625 of a fit's 775 taps; the tile's
//       masked pixels, a few hundred of 4096, then go into a list in shared
//       memory, and each runs the two 5-tap passes on its 5x5 window of S
//       and the closed form, in registers and on full warps, and becomes
//       BIGF if the fit rejects. The flag is rewritten: a candidate
//       survived;
//   (c) peaks, 16 rows of a flagged tile per block, four pixels a thread,
//       no barrier: a candidate is a plateau pixel when no candidate of its
//       7x7 window has a smaller response (49 loads that wait on nothing),
//       and a peak when no plateau pixel of that window with the same
//       response precedes it in scan order. A warp ballots its peaks and
//       runs the fit of each as a warp (fit_record_warp), then writes
//       [col + x0, row + y0, c3, c4, c5, row * w + col + 1] into the peak's
//       aligned 4x4 cell of the zero-filled cell grid.
//
// With the geodesic peak merge (merge = m in 1..8) (a) also writes the
// relay mask as bits (response < thr strictly inside the image; a row's
// four ballots give each octet of lanes the word of its 32 columns, bit j
// column 32 k + j, as the cluster kernel builds its segments), and a third
// launch takes the place of (c):
//
//   (d) merge, flagged tiles only: a block takes its 64 x 64 tile with a
//       MERGE_MAX-pixel halo (80 x 80), lists the region's relay pixels
//       from the relay words of its rows (32 columns a thread), finds the
//       peaks among them as (c) does, and gives each peak its key: its
//       position in the region's scan order, which orders as the plane's
//       does. Only relay pixels ever hold a key (a peak is a candidate, and
//       a candidate's response is below thr inside the margin). A thread
//       holds its relay pixels (at most 25) in registers, key and position
//       in one word (key << 16 | position), so that taking a smaller
//       neighbour's key is one integer min. A pass (from +x, -x, +y, -y)
//       reads the neighbour's key from one of two key planes in shared
//       memory (a ring of "no key" around the region) and writes the
//       thread's keys into the other. One barrier a pass.
//       The halo: a key moves at most one pixel a pass, and a sweep moves it
//       at most one pixel along each axis, so after m sweeps the tile's own
//       keys depend only on the region: the staged simulation is exact
//       there, and the block's answer is the merge of the whole plane.
//       The early exit: after each sweep the block asks whether a key moved
//       (__syncthreads_or). A pass is a function of the keys alone, so a
//       sweep that moves none leaves a fixed point of the staged simulation
//       and every later sweep moves none either: the keys at that sweep
//       are the keys of sweep m. The halo argument is about the staged
//       simulation, which this only cuts short once it stands still. The
//       tile's surviving peaks (key still their own) go out as in (c), a
//       warp's fit each, and its flag becomes the number of sweeps run.
//
// What bound the merge's first form: a fourth launch ran all 32 passes of
// m8 on every staged pixel, 25 a thread, each a key and a mask byte
// through shared memory with its index recomputed and two barriers a pass
// (0.373 ms at two_boards b32 on an H100), after a marking launch that
// wrote peaks into a zero-filled byte plane that it read again. Here a
// pass costs a thread a load, a byte permute, a min and a store for each
// of its relay pixels, about a tenth of the region on the photographs;
// what binds (d) now is that instruction issue, then its survivors' fits.
//
// Row sharding (roff non-null): pixel row r is row r + roff[b] of a
// gh-row frame; the image-edge gates hold in both, y and the label are
// emitted in the frame's rows. Without it the launches are the merge-free
// ones above, unchanged.
//
// Two peaks are more than 3 pixels apart (Chebyshev), so no two share a
// cell (nor a thread's four pixels) and the writes of (c) never collide.
// Responses are compared with == on the values launch (a) stored, so ties
// resolve exactly as in the plain version.
//
// Bound on the H100: by bytes for the function as a whole (the half plane
// in, the cell grid out), with the tile form's operations a close second.
// (a) is the stencil family's launch, 12 bytes a pixel against 42
// operations, and runs the front and cluster kernels' tile passes, so it
// is bound as they are: by the latency between its barrier-separated
// phases, not by its bytes. At two_boards b32 on an NVIDIA H100 80GB HBM3
// at 700 W it takes 0.093 ms against a 0.068-ms bytes floor (229 MB), the
// share of its floor that the cluster kernel's launch (a) reaches on the
// same plane (PERF.md, section 6). (b) is bound by instruction
// throughput — 25 cone taps a pixel of a flagged tile, each a multiply and an
// add (--fmad=false: the taps are not fused), and ~150 taps a masked
// pixel — in 39 KB of shared memory a block; (c) reads the candidate
// plane once and touches the blur plane only around peaks. No launch has a
// thread that runs a whole fit.
#include "rochade.cuh"
#include "tile.cuh"

namespace {

using namespace ag;

constexpr float BIGF = 3.0e38f;  // "not a candidate"
constexpr int NMS_R = 3;         // Chebyshev radius of the peak window
constexpr int PEAK_ROWS = 16;    // peaks_kernel: rows per block (two a warp)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MERGE_MAX = 8;     // sweeps of the peak merge, and its halo
constexpr int ME = FIT_TILE + 2 * MERGE_MAX;   // merge_kernel: staged side, 80
constexpr int MP = ME + 2;                     // with the ring that holds no key
constexpr int MPER = ME * ME / THREADS;        // relay pixels a thread, at most
constexpr unsigned short NOKEY = 0xffffu;      // "no peak's key"

static_assert(ME * ME % THREADS == 0, "the staged region in whole rounds");
static_assert(MP * MP < NOKEY && MP * MP % 2 == 0, "positions fit 16 bits");

static_assert(FIT_TILE == TILE_H && FIT_TILE == STRIP_W, "one tile size");

__device__ __forceinline__ int* tile_flag(int* flags, int b, int ti, int si,
                                          int hp, int wp) {
  return flags + ((size_t)b * (hp / TILE_H) + ti) * (wp / STRIP_W) + si;
}

// The gates of a thread's 16 pixels in launch (a), for a border block:
// bit 4 r + j says that pixel (r0 + r, c + j) lies in the margin — row in
// [hp2, h - hp2), its frame row r0 + r + ro in [hp2, gh - hp2), column in
// [hp2, w - hp2) — and bit 16 + 4 r + j that it lies strictly inside the
// window and the frame (rows and columns 1 .. n - 2), the relay's band.
__device__ __forceinline__ unsigned run_gates(int r0, int c, int h, int w, int ro, int gh,
                                              int hp2) {
  unsigned in = 0u;
#pragma unroll
  for (int r = 0; r < FT_RRUN; ++r) {
    const int y = r0 + r, g = y + ro;
    const bool row_m = y >= hp2 && y < h - hp2 && g >= hp2 && g < gh - hp2;
    const bool row_i = y > 0 && y < h - 1 && g > 0 && g < gh - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool col_m = c + j >= hp2 && c + j < w - hp2;
      const bool col_i = c + j > 0 && c + j < w - 1;
      in |= (unsigned)(row_m && col_m) << (4 * r + j) |
            (unsigned)(row_i && col_i) << (16 + 4 * r + j);
    }
  }
  return in;
}

// Launch (a)'s pixels in response_run's layout (tile.cuh): the thread's
// columns c .. c + 3 of rows r0 .. r0 + FT_RRUN - 1, from a rotating 3-row
// window of the blurred tile. Each row's blurred pixels and candidate
// values leave as one 16-byte store each (``blur`` and ``cand`` point at
// pixel (r0, c)). A candidate is a pixel of the margin whose response is
// below t; it keeps its response, every other pixel BIGF. With MASK a
// relay pixel is one strictly inside the image whose response is below t:
// a row's four ballots give each octet of lanes the word of its aligned
// 32-column segment (tile.cuh::segment_bits), and the octet's first lane
// stores it (``relay`` points at the word of (r0, c)). With BORDER ``in``
// holds the pixels' gates (run_gates); without, every pixel of the block
// lies in the margin and only the response is tested. Returns whether the
// thread holds a candidate.
template <bool MASK, bool BORDER>
__device__ __forceinline__ bool resp_run(const FrontTileSmem& s, int q, int y0,
                                         unsigned in, float t, int wp, float* blur,
                                         float* cand, unsigned* relay) {
  float up[6], mid[6], dn[6];
  load_row6(s, y0, q, up);
  load_row6(s, y0 + 1, q, mid);
  bool any = false;
#pragma unroll
  for (int r = 0; r < FT_RRUN; ++r) {
    load_row6(s, y0 + r + 2, q, dn);
    float o[4];
    bool rel[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = hessian_of(up[j], up[j + 1], up[j + 2], mid[j], mid[j + 1],
                                 mid[j + 2], dn[j], dn[j + 1], dn[j + 2]);
      const bool below = v < t;
      const bool m = below && (!BORDER || (in >> (4 * r + j) & 1u));
      o[j] = m ? v : BIGF;
      any |= m;
      rel[j] = below && (!BORDER || (in >> (16 + 4 * r + j) & 1u));
    }
    *reinterpret_cast<float4*>(cand + (size_t)r * wp) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(blur + (size_t)r * wp) =
        make_float4(mid[1], mid[2], mid[3], mid[4]);
    if constexpr (MASK) {
      unsigned bal[4];
      const unsigned word = segment_bits(rel, bal);
      if ((threadIdx.x & 7) == 0) relay[(size_t)r * (wp / 32)] = word;
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) up[j] = mid[j], mid[j] = dn[j];
  }
  return any;
}

// Launch (a): a block is a (frame, 64-row tile, 64-column strip), staged
// from the f32 half plane with 16-byte quads (per element where a quad
// leaves the plane's columns or the plane is unaligned), blurred by the
// register-blocked passes of tile.cuh, then resp_run; the tile's flag says
// whether it holds a candidate. MASK: also the merge's relay mask, a bit a
// pixel (b, hp, wp / 32).
template <bool MASK>
__global__ void __launch_bounds__(THREADS, FT_BLOCKS)
blur_resp_kernel(const float* half_p, int hp, int wp, int h, int w, int hp2,
                 bool aligned, Taps7 taps, const float* thr, const int* roff, int gh,
                 float* blur, float* cand, int* flags, unsigned* relay) {
  __shared__ __align__(16) FrontTileSmem s;
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  stage_quads<RAW_F32, false>(s, half_p, b, ti, si, hp, wp, w, aligned, nullptr);
  blur_tile_passes(s, taps);
  const int q = tid % (STRIP_W / 4), y0 = (tid / (STRIP_W / 4)) * FT_RRUN;
  const int r0 = ti * TILE_H + y0, c = si * STRIP_W + 4 * q;
  const size_t i0 = ((size_t)b * hp + r0) * wp + c;
  unsigned* words = MASK ? relay + ((size_t)b * hp + r0) * (wp / 32) + c / 32 : nullptr;
  const int ro = roff != nullptr ? roff[b] : 0;   // gh == h without roff
  const float t = thr[b];
  // a block all of whose pixels lie hp2 or more from every edge of the
  // window, in a frame that is no window of a taller one, tests the
  // response alone (hp2 >= 1: the relay's band is wider than the margin)
  const bool border = ti * TILE_H < hp2 || (ti + 1) * TILE_H > h - hp2 ||
                      si * STRIP_W < hp2 || (si + 1) * STRIP_W > w - hp2 || ro != 0 ||
                      gh != h;
  const bool any =
      border ? resp_run<MASK, true>(s, q, y0, run_gates(r0, c, h, w, ro, gh, hp2), t, wp,
                                    blur + i0, cand + i0, words)
             : resp_run<MASK, false>(s, q, y0, 0u, t, wp, blur + i0, cand + i0, words);
  const int some = __syncthreads_or(any);
  if (tid == 0) *tile_flag(flags, b, ti, si, hp, wp) = some;
}

__global__ void __launch_bounds__(THREADS)
gate_kernel(const float* blur, float* cand, int* flags, int hp, int wp,
            const __grid_constant__ FitTileTaps fit, float move_thr) {
  __shared__ FitTileSmem s;
  __shared__ int count;
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  int* flag = tile_flag(flags, b, ti, si, hp, wp);
  if (!*flag) return;   // the whole block: no masked pixel in this tile
  const size_t fbase = (size_t)b * hp * wp;
  const size_t tile0 = fbase + (size_t)ti * FIT_TILE * wp + si * FIT_TILE;
  if (threadIdx.x == 0) count = 0;
  // this thread's pixels of the tile (threadIdx.x + THREADS k): their
  // candidate values are asked for now and read once S stands
  constexpr int PIX = FIT_TILE * FIT_TILE / THREADS;
  float cv[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    cv[k] = cand[tile0 + (size_t)(idx / FIT_TILE) * wp + idx % FIT_TILE];
  }
  // rows and columns outside the padded plane are clamped: they reach only
  // pixels outside the margin, which are no candidates
  for (int idx = threadIdx.x; idx < FIT_BL * FIT_BL; idx += THREADS) {
    const int y = idx / FIT_BL, x = idx - y * FIT_BL;
    const int r = min(max(ti * FIT_TILE - 4 + y, 0), hp - 1);
    const int c = min(max(si * FIT_TILE - 4 + x, 0), wp - 1);
    s.bl[idx] = blur[fbase + (size_t)r * wp + c];
  }
  __syncthreads();
  fit_tile_smooth(s, fit);
  // the tile's masked pixels, a few hundred of its 4096, as a list (over
  // the blur tile, which is free now), so that the fits run on full warps
  int* list = reinterpret_cast<int*>(s.bl);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const bool m = cv[k] < BIGF;
    const unsigned bal = __ballot_sync(FULL, m);
    int at = 0;
    if (lane == 0 && bal) at = atomicAdd(&count, __popc(bal));
    at = __shfl_sync(FULL, at, 0);
    if (m) list[at + __popc(bal & ((1u << lane) - 1u))] = threadIdx.x + k * THREADS;
  }
  __syncthreads();
  const int n = count;
  bool any = false;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const int idx = list[k], y = idx / FIT_TILE, x = idx % FIT_TILE;
    float x0, y0, c3, c4, c5;
    if (fit_tile_at(s.S, y, x, fit, move_thr, &x0, &y0, &c3, &c4, &c5))
      any = true;
    else
      cand[tile0 + (size_t)y * wp + x] = BIGF;
  }
  const int some = __syncthreads_or(any);
  if (threadIdx.x == 0) *flag = some;
}

// One pass over the 7x7 window around (r, c), 49 loads that wait on nothing:
// whether a candidate of the window has a response below v, and in
// ``equal_before`` a bit for each of the 24 window pixels that precede
// (r, c) in scan order and hold exactly v.
__device__ __forceinline__ bool any_below(const float* cd, int wp, int r, int c,
                                          float v, unsigned* equal_before) {
  const float* p = cd + (size_t)(r - NMS_R) * wp + (c - NMS_R);
  bool below = false;
  unsigned eq = 0u;
#pragma unroll
  for (int i = 0; i < 2 * NMS_R + 1; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NMS_R + 1; ++j) {
      const float x = p[(size_t)i * wp + j];
      below |= x < v;
      const int k = i * (2 * NMS_R + 1) + j;
      if (k < NMS_R * (2 * NMS_R + 1) + NMS_R) eq |= (unsigned)(x == v) << k;
    }
  *equal_before = eq;
  return below;
}

// Candidate (r, c) with response v is a peak: a plateau pixel (no smaller
// candidate in its window) that no equal plateau pixel of the window
// precedes in scan order. Candidates lie inside the 4-pixel margin, so
// every window read here stays inside the plane.
__device__ bool is_peak(const float* cd, int wp, int r, int c, float v) {
  unsigned eq, unused;
  if (any_below(cd, wp, r, c, v, &eq)) return false;
  while (eq) {
    const int k = __ffs(eq) - 1;
    eq &= eq - 1;
    if (!any_below(cd, wp, r - NMS_R + k / (2 * NMS_R + 1),
                   c - NMS_R + k % (2 * NMS_R + 1), v, &unused))
      return false;  // an equal plateau pixel earlier in scan order wins
  }
  return true;
}

// A warp's peaks, a bit per lane in ``bal`` at (row ``r``, column ``c``)
// of each lane: the fit of each by the whole warp, its record written into
// the peak's cell. Row ``r`` is row r + ro of the gh-row frame.
__device__ __forceinline__ void emit_peaks(unsigned bal, int r, int c,
                                           const float* blur, size_t fbase,
                                           int hp, int wp, int w, int ro,
                                           const FitTaps& fit, float move_thr,
                                           FitScratch& scratch, float* cells,
                                           int b) {
  const int lane = threadIdx.x & 31;
  const int cr = hp / 4, cc = wp / 4;
  const size_t plane = (size_t)cr * cc;
  while (bal) {
    const int from = __ffs(bal) - 1;
    bal &= bal - 1;
    const int pr = __shfl_sync(FULL, r, from);
    const int pc = __shfl_sync(FULL, c, from);
    float x0, y0, c3, c4, c5;
    fit_record_warp(scratch, blur + fbase + (size_t)(pr - 4) * wp + (pc - 4), wp,
                    fit, move_thr, &x0, &y0, &c3, &c4, &c5);
    if (lane == 0) {
      float* cell = cells + (size_t)b * 6 * plane + (size_t)(pr / 4) * cc + (pc / 4);
      cell[0] = __fadd_rn((float)pc, x0);
      cell[plane] = __fadd_rn((float)(pr + ro), y0);
      cell[2 * plane] = c3;
      cell[3 * plane] = c4;
      cell[4 * plane] = c5;
      cell[5 * plane] = (float)((pr + ro) * w + pc + 1);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
peaks_kernel(const float* blur, const float* cand, int* flags, int hp, int wp,
             int w, const int* roff, const __grid_constant__ FitTaps fit,
             float move_thr, float* cells) {
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * PEAK_ROWS;
  if (!*tile_flag(flags, b, r0 / TILE_H, blockIdx.x, hp, wp)) return;
  const int warp = threadIdx.x >> 5;
  const int r = r0 + (threadIdx.x >> 4);
  const int c = blockIdx.x * STRIP_W + 4 * (threadIdx.x & 15);
  const size_t fbase = (size_t)b * hp * wp;
  const float* cd = cand + fbase;
  const float4 v4 = *reinterpret_cast<const float4*>(cd + (size_t)r * wp + c);
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  int pk = -1;   // the peak among this thread's four pixels: at most one
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (v[k] < BIGF && is_peak(cd, wp, r, c + k, v[k])) pk = k;
  // no barrier in this kernel: a warp without a peak leaves. The fit reads
  // its tap tables from the parameter bank, where lanes that read different
  // rows take turns; staging them in shared memory would cost a block more
  // than its two or three fits do
  __shared__ FitScratch scratch[THREADS / 32];
  emit_peaks(__ballot_sync(FULL, pk >= 0), r, c + pk, blur, fbase, hp, wp, w,
             roff != nullptr ? roff[b] : 0, fit, move_thr, scratch[warp], cells, b);
}

// Launch (d): the merge on flagged tile (b, ti, si) and the emission of its
// surviving peaks. A position p = (y + 1) * MP + x + 1 is pixel (r0 + y,
// c0 + x) of the region (0 <= y, x < ME): the ring's positions hold no key.
struct MergeSmem {
  unsigned short key[2][MP * MP];
  unsigned short list[ME * ME];     // relay pixels, later the survivors
  unsigned words[ME][4];            // the relay words that cover each row
  FitScratch scratch[THREADS / 32];
  int nrelay, nsurv;
};

// Appends ``v`` to ``list`` where ``m`` holds, a warp's lanes in lane order
// at one atomically taken place (``n`` counts); all 32 lanes call it.
__device__ __forceinline__ void append(unsigned short* list, int* n, bool m,
                                       unsigned short v) {
  const int lane = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(FULL, m);
  int at = 0;
  if (lane == 0 && bal) at = atomicAdd(n, __popc(bal));
  at = __shfl_sync(FULL, at, 0);
  if (m) list[at + __popc(bal & ((1u << lane) - 1u))] = v;
}

__global__ void __launch_bounds__(THREADS, 4)
merge_kernel(const float* blur, const float* cand, const unsigned* relay,
             int* flags, int hp, int wp, int w, const int* roff, int merge,
             const __grid_constant__ FitTaps fit, float move_thr, float* cells) {
  __shared__ __align__(4) MergeSmem s;
  const int si = blockIdx.x, ti = blockIdx.y, b = blockIdx.z;
  int* flag = tile_flag(flags, b, ti, si, hp, wp);
  if (!*flag) return;   // the whole block: no candidate, so no peak, here
  const size_t fbase = (size_t)b * hp * wp;
  const float* cd = cand + fbase;
  const int r0 = ti * FIT_TILE - MERGE_MAX, c0 = si * FIT_TILE - MERGE_MAX;
  unsigned* k0 = reinterpret_cast<unsigned*>(s.key[0]);
  for (int i = threadIdx.x; i < MP * MP / 2; i += THREADS) k0[i] = 0xffffffffu;
  // the words of the relay plane that cover the region's rows: columns
  // c0 - 24 .. c0 + 103 (c0 = 24 mod 32); outside the plane none
  for (int i = threadIdx.x; i < ME * 4; i += THREADS) {
    const int r = r0 + i / 4, wd = (c0 >> 5) + i % 4;
    s.words[i / 4][i % 4] = r >= 0 && r < hp && wd >= 0 && wd < wp / 32
                                ? relay[((size_t)b * hp + r) * (wp / 32) + wd] : 0u;
  }
  if (threadIdx.x == 0) s.nrelay = s.nsurv = 0;
  __syncthreads();
  // the relay pixels' list: 32 columns of a row a thread (x from 32 j,
  // the third 16), at one atomically taken place
  if (threadIdx.x < ME * 3) {
    const int y = threadIdx.x / 3, j = threadIdx.x % 3;
    unsigned bits = __funnelshift_r(s.words[y][j], s.words[y][j + 1], 24);
    if (j == 2) bits &= 0xffffu;
    int at = bits ? atomicAdd(&s.nrelay, __popc(bits)) : 0;
    while (bits) {
      const int x = 32 * j + __ffs(bits) - 1;
      bits &= bits - 1;
      s.list[at++] = (unsigned short)((y + 1) * MP + x + 1);
    }
  }
  __syncthreads();
  // the peaks among them (every candidate is a relay pixel): a peak's key
  // is its position. Candidates lie inside the margin: every window read
  // stays in the plane
  const int n = s.nrelay, rounds = (n + THREADS - 1) / THREADS;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int p = s.list[i], r = r0 + p / MP - 1, c = c0 + p % MP - 1;
    const float v = cd[(size_t)r * wp + c];
    if (v < BIGF && is_peak(cd, wp, r, c, v)) s.key[0][p] = (unsigned short)p;
  }
  __syncthreads();
  unsigned* k1 = reinterpret_cast<unsigned*>(s.key[1]);
  for (int i = threadIdx.x; i < MP * MP / 2; i += THREADS) k1[i] = k0[i];
  // this thread's relay pixels: list entries threadIdx.x + k * THREADS
  const int cnt = n > (int)threadIdx.x ? (n - (int)threadIdx.x + THREADS - 1) / THREADS : 0;
  unsigned e[MPER];
#pragma unroll
  for (int k = 0; k < MPER; ++k) {
    if (k >= cnt) break;
    const unsigned p = s.list[threadIdx.x + k * THREADS];
    e[k] = (unsigned)s.key[0][p] << 16 | p;
  }
  __syncthreads();   // both key planes stand
  // pass d reads key[d & 1] and writes every relay pixel's key into
  // key[(d + 1) & 1]; four passes a sweep, so the parity is the same in
  // every sweep. ``moved`` gathers the bits that changed
  int sweeps = 0;
  while (sweeps < merge) {
    ++sweeps;
    unsigned moved = 0u;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int off = d == 0 ? 1 : d == 1 ? -1 : d == 2 ? MP : -MP;
      const unsigned short* from = s.key[d & 1];
      unsigned short* to = s.key[(d + 1) & 1];
#pragma unroll
      for (int k = 0; k < MPER; ++k) {
        if (k >= cnt) break;
        const int p = (int)(e[k] & 0xffffu);
        // (neighbour's key) << 16 | p: the smaller word holds the smaller key
        const unsigned v = min(e[k], __byte_perm(e[k], from[p + off], 0x5410));
        moved |= v ^ e[k];
        e[k] = v;
        to[p] = (unsigned short)(v >> 16);
      }
      if (d < 3) __syncthreads();
    }
    if (!__syncthreads_or(moved != 0u)) break;   // a fixed point: see the head
  }
  // the tile's own peaks that kept their key, then their records
  constexpr int lo = MERGE_MAX + 1, hi = MERGE_MAX + FIT_TILE;
#pragma unroll
  for (int k = 0; k < MPER; ++k) {
    if (k >= rounds) break;   // the same for the whole block: ballots stay full
    unsigned p = 0u;
    bool keep = false;
    if (k < cnt) {
      p = e[k] & 0xffffu;
      const unsigned y = p / MP, x = p % MP;
      keep = e[k] >> 16 == p && y >= lo && y <= hi && x >= lo && x <= hi;
    }
    append(s.list, &s.nsurv, keep, (unsigned short)p);
  }
  __syncthreads();
  // survivor j to warp j % 8: the fits spread over the block's warps
  const int ns = s.nsurv, ro = roff != nullptr ? roff[b] : 0;
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < ns; base += THREADS) {
    const int at = base + lane * WARPS + (threadIdx.x >> 5);
    const int p = at < ns ? s.list[at] : 0;
    emit_peaks(__ballot_sync(FULL, at < ns), r0 + p / MP - 1, c0 + p % MP - 1, blur,
               fbase, hp, wp, w, ro, fit, move_thr, s.scratch[threadIdx.x >> 5], cells, b);
  }
  if (threadIdx.x == 0) *flag = sweeps;
}

}  // namespace

// half_p: (b, hp + 16, wp) f32 padded half plane, hp and wp multiples of
// 64, (h, w) its true size; thr: (b,) f32 device; roff: (b,) int32 device
// row offsets or null, gh the frame's rows (h without roff); merge: 0-8
// sweeps; scratch: blur and cand (b, hp, wp) f32, flags (b, hp / 64,
// wp / 64) int32, with merge > 0 relay (b, hp, wp / 32) 32-bit words (else
// null); cells: (b, 6, hp / 4, wp / 4) f32 zero-filled by the caller. After
// a merge a flagged tile's flag is the number of sweeps its block ran.
// With half_p null (merge > 0 only) the merge launch alone runs on the blur,
// cand, relay and flags the caller gives (the smoke's synthetic planes);
// thr and the blur taps are then not read. Returns the first launch error,
// -1 if the fit's tables are not in the order the tile form takes
// (rochade.cuh::fit_tile_taps), -2 for a merge outside 0..MERGE_MAX (1..
// with half_p null), or 0.
extern "C" int ag_nms_extract_raw(const void* half_p, int b, int hp, int wp,
                                  int h, int w, const void* thr,
                                  const float* taps7, const void* fit_taps,
                                  float move_thr, int hp2, const void* roff,
                                  int gh, int merge, void* blur, void* cand,
                                  void* flags, void* relay, void* cells,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (merge < (half_p == nullptr ? 1 : 0) || merge > MERGE_MAX) return -2;
  const FitTaps fit = *(const FitTaps*)fit_taps;
  FitTileTaps tile_taps;
  if (!fit_tile_taps(fit, &tile_taps)) return -1;
  const int* ro = (const int*)roff;
  const dim3 tgrid(wp / STRIP_W, hp / TILE_H, b);
  cudaError_t e;
  if (half_p != nullptr) {
    Taps7 taps;
    for (int k = 0; k < 7; ++k) taps.k[k] = taps7[k];
    // the staging's 16-byte quads; rows start 256-byte aligned
    const bool aligned = (uintptr_t)half_p % 16 == 0;
    if (merge > 0)
      blur_resp_kernel<true><<<tgrid, THREADS, 0, st>>>(
          (const float*)half_p, hp, wp, h, w, hp2, aligned, taps, (const float*)thr, ro,
          gh, (float*)blur, (float*)cand, (int*)flags, (unsigned*)relay);
    else
      blur_resp_kernel<false><<<tgrid, THREADS, 0, st>>>(
          (const float*)half_p, hp, wp, h, w, hp2, aligned, taps, (const float*)thr, ro,
          gh, (float*)blur, (float*)cand, (int*)flags, nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gate_kernel<<<tgrid, THREADS, 0, st>>>((const float*)blur, (float*)cand,
                                             (int*)flags, hp, wp, tile_taps,
                                             move_thr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (merge == 0) {
    const dim3 pgrid(wp / STRIP_W, hp / PEAK_ROWS, b);
    peaks_kernel<<<pgrid, THREADS, 0, st>>>(
        (const float*)blur, (const float*)cand, (int*)flags, hp, wp, w, ro, fit,
        move_thr, (float*)cells);
    return (int)cudaGetLastError();
  }
  merge_kernel<<<tgrid, THREADS, 0, st>>>(
      (const float*)blur, (const float*)cand, (const unsigned*)relay, (int*)flags,
      hp, wp, w, ro, merge, fit, move_thr, (float*)cells);
  return (int)cudaGetLastError();
}
