// Host-side board search: the irregular mid-section of the detect
// pipeline as a native C++ runtime component.
//
// The dense stages (blur/hessian/clustering/ROCHADE/decode) run on TPU;
// this library implements the sequential, pointer-chasing part — quad
// hypothesis search and recursive board growth — exactly as the
// reference does (init_quads src/detector.rs:543-586, Board
// src/board.rs, try_find_best_board src/detector.rs:588-639), operating
// on the saddle arrays the TPU front-end produces. A uniform spatial
// grid replaces the reference's kd-tree for O(1) expected-time neighbor
// queries, and the board cell map is a flat bounded grid instead of a
// hash map.
//
// The batch entry point fans frames out across a host thread pool —
// frames are independent, and the search state (Workspace, SpatialGrid,
// scratch vectors) is allocated per call, so the per-frame function is
// reentrant as-is. The reference is single-threaded by design
// (SURVEY.md section 2c); our host runtime has no such constraint.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread search.cpp -o libagsearch.so

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr int kRadius = 16;              // board grid coords in [-16, 16]
constexpr int kG = 2 * kRadius + 1;      // 33
constexpr int kG2 = kG * kG;             // 1089
constexpr int kEmpty = -2;               // cell states: -2 absent,
constexpr int kNone = -1;                // -1 attempted/failed, >=0 quad slot

struct Saddle {
  float x, y, theta;
  float ct, st;  // cos/sin of theta (degrees), precomputed once
};

// |line angle difference| folded to [0, 90] (src/math_util.rs:15-23)
inline float theta_distance_degree(float t0, float t1) {
  float d = t0 - t1 + 90.0f;
  if (d < 0.0f) d += 180.0f;
  else if (d > 180.0f) d -= 180.0f;
  return d > 90.0f ? d - 90.0f : 90.0f - d;
}

inline float cross(float ax, float ay, float bx, float by) {
  return ax * by - ay * bx;
}
inline float dot(float ax, float ay, float bx, float by) {
  return ax * bx + ay * by;
}
inline float angle_degree(float ax, float ay, float bx, float by) {
  return std::atan2(by * ax - bx * ay, ax * bx + ay * by) * 180.0f / kPi;
}

// |a_i - a_j| <= 10 deg gate on two corner angles given their
// unnormalized (cos, sin) pairs: algebraic fast path with an exact
// atan2 confirmation near the decision boundary (and near the +-180
// wrap, where the cosine-of-difference test alone would be ambiguous),
// so accept/reject decisions are bit-identical to the reference's
// angle_degree formulation (src/saddle.rs:54-62).
inline bool angles_close10(float cos_i, float sin_i, float cos_j,
                           float sin_j) {
  // Squared-domain fast path (round 4): the old path paid 3 sqrts per
  // call (thr = kCos10*sqrt(m2) and one per wrap_risk magnitude) on a
  // serial dependency chain; comparing lhs^2 against thr^2 with a band
  // that STRICTLY CONTAINS the old (thr-eps, thr+eps) band needs none.
  // Every fast verdict here fires only strictly outside the old band,
  // so it equals the old fast verdict; anything newly inside the wider
  // band falls through to the exact atan2 — decisions are identical.
  //   band check: (thr+eps)^2 - thr^2 = 2*kCos10*m*(1e-4*m + 1e-30)
  //     + eps^2 <= 1.98e-4*m2 + 2e-30*m + 1e-8*m2  <  3e-4*m2 + 1e-29
  //     for all m (the 1.02e-4*m2 spare dominates 2e-30*m from
  //     m >= 2e-26; below that 1e-29 covers it), and symmetrically for
  //     thr^2 - (thr-eps)^2 <= 2*thr*eps.
  //   wrap_risk: cos < -0.99*|v|  =>  cos < 0 && cos^2 >= 0.98*v2
  //     (0.98 < 0.9801 widens the risky set), superset of the old one.
  float a2 = cos_i * cos_i + sin_i * sin_i;
  float b2 = cos_j * cos_j + sin_j * sin_j;
  float m2 = a2 * b2;
  float lhs = cos_i * cos_j + sin_i * sin_j;  // cos(ai - aj) * m
  constexpr float kCos10Sq = 0.96984631039295419f;  // cos(10 deg)^2
  bool wrap_risk = cos_i < 0.0f && cos_j < 0.0f &&
                   cos_i * cos_i >= 0.98f * a2 &&
                   cos_j * cos_j >= 0.98f * b2;
  if (!wrap_risk) {
    if (lhs >= 0.0f) {
      float l2 = lhs * lhs;
      float t2 = kCos10Sq * m2;
      float band = 3e-4f * m2 + 1e-29f;
      if (l2 > t2 + band) return true;
      if (l2 < t2 - band) return false;
    } else if (m2 > 1e-50f) {
      // lhs < 0 < thr - eps for any nondegenerate magnitudes
      return false;
    }
  }
  float ai = std::atan2(sin_i, cos_i) * 180.0f / kPi;
  float aj = std::atan2(sin_j, cos_j) * 180.0f / kPi;
  return std::fabs(ai - aj) <= 10.0f;
}

// quad validity gates (src/saddle.rs:17-67), factored so callers with
// combinatorial candidate nests (try_expand_one's 3^4 loop, init_quads'
// |same| x C(|diff|, 2) sweep) can hoist the gates that depend on only
// two of the four saddles out of the nest. The predicates and their
// order are exactly the reference's; hoisting only skips evaluations
// whose outcome is already known. The two atan2-based angle gates use
// algebraic fast paths (square/cosine comparisons) with exact
// confirmation inside a narrow boundary band — atan2 only runs for the
// rare near-boundary candidates.

// gate 1 (src/saddle.rs:18): the two diagonal saddles' line angles
// agree within 5 degrees. Depends on (d0, d1) only.
inline bool gate_diag_theta(const Saddle& d0, const Saddle& d1) {
  return !(theta_distance_degree(d0.theta, d1.theta) > 5.0f);
}

// gate 2 (src/saddle.rs:27-38): |angle(v02, s0 theta-dir)| in [60, 120]
// <=> cos^2 <= 1/4 for a unit dir. Depends on (s0, s1) only.
inline bool gate_v02_angle(const Saddle& s0, const Saddle& s1) {
  float v02x = s1.x - s0.x, v02y = s1.y - s0.y;
  float dt = v02x * s0.ct + v02y * s0.st;
  float q = dt * dt;
  float n2 = v02x * v02x + v02y * v02y;
  float hi = 0.25f * n2;
  float eps = 1e-4f * n2 + 1e-30f;
  if (q > hi + eps) return false;
  if (q >= hi - eps) {  // boundary band: exact reference math
    float th = s0.theta / 180.0f * kPi;
    float vtx = std::cos(th), vty = std::sin(th);
    float ang = std::fabs(angle_degree(v02x, v02y, vtx, vty));
    if (!(ang >= 60.0f && ang <= 120.0f)) return false;
  }
  return true;
}

// gates 3+ (src/saddle.rs:40-66): convexity, opposite-angle agreement,
// orientation dots — need all four saddles. Split so the init_quads
// nest can hoist the (s0, s1, single-diagonal) gates out of the pair
// loop: quad_rest_mid is the middle conjunct chain (second convexity
// cross + the two opposite-angle agreements), byte-for-byte the same
// arithmetic in the same order.
inline bool quad_rest_mid(const Saddle& s0, const Saddle& d0,
                          const Saddle& s1, const Saddle& d1,
                          float v01x, float v01y, float v03x,
                          float v03y) {
  float v12x = s1.x - d0.x, v12y = s1.y - d0.y;
  float v23x = d1.x - s1.x, v23y = d1.y - s1.y;
  float c01 = cross(v01x, v01y, v12x, v12y);
  float c12 = cross(v12x, v12y, v23x, v23y);
  if (c01 * c12 < 0.0f) return false;
  float v30x = s0.x - d1.x, v30y = s0.y - d1.y;
  float c23 = cross(v23x, v23y, v30x, v30y);
  float c30 = cross(v30x, v30y, v01x, v01y);
  float d01 = dot(v01x, v01y, v12x, v12y);
  float d12 = dot(v12x, v12y, v23x, v23y);
  float d23 = dot(v23x, v23y, v30x, v30y);
  float d30 = dot(v30x, v30y, v01x, v01y);
  if (!angles_close10(d01, c01, d23, c23)) return false;
  if (!angles_close10(d12, c12, d30, c30)) return false;
  return true;
}

bool is_valid_quad_rest(const Saddle& s0, const Saddle& d0,
                        const Saddle& s1, const Saddle& d1) {
  float v01x = d0.x - s0.x, v01y = d0.y - s0.y;
  float v03x = d1.x - s0.x, v03y = d1.y - s0.y;
  float v02x = s1.x - s0.x, v02y = s1.y - s0.y;

  float c0 = cross(v01x, v01y, v02x, v02y);
  float c1 = cross(v02x, v02y, v03x, v03y);
  if (c0 * c1 < 0.0f) return false;
  if (!quad_rest_mid(s0, d0, s1, d1, v01x, v01y, v03x, v03y))
    return false;
  if (dot(v01x, v01y, v02x, v02y) < 0.0f ||
      dot(v03x, v03y, v02x, v02y) < 0.0f)
    return false;
  return true;
}

bool is_valid_quad(const Saddle& s0, const Saddle& d0, const Saddle& s1,
                   const Saddle& d1) {
  return gate_diag_theta(d0, d1) && gate_v02_angle(s0, s1) &&
         is_valid_quad_rest(s0, d0, s1, d1);
}

// Uniform grid over the saddle bounding box for neighbor queries
// (replaces the reference's kd-tree, src/detector.rs:592-595).
struct SpatialGrid {
  float x0 = 0, y0 = 0, inv_cell = 0, cell = 1;
  int nx = 1, ny = 1;
  std::vector<int> starts;   // CSR layout: cell -> [starts[c], starts[c+1])
  std::vector<int> items;
  // grid-ordered coordinate copies (SoA): the NN scans walk cells in
  // CSR order, so contiguous sx/sy loads replace the scattered
  // saddles[items[ii]] AoS loads that dominated pass-2 profiles
  std::vector<float> sx, sy;
  const std::vector<Saddle>* pts = nullptr;

  // cell_mult scales the density-derived cell size: 1.0 suits the
  // 50-NN seed queries; ~0.25 suits the tiny-radius 3-NN expansion
  // queries (see knn_radius)
  void build(const std::vector<Saddle>& saddles, float cell_mult = 1.0f) {
    pts = &saddles;
    int n = (int)saddles.size();
    float x1 = -1e30f, y1 = -1e30f;
    x0 = 1e30f;
    y0 = 1e30f;
    for (const auto& s : saddles) {
      x0 = std::min(x0, s.x);
      y0 = std::min(y0, s.y);
      x1 = std::max(x1, s.x);
      y1 = std::max(y1, s.y);
    }
    if (n == 0) x1 = x0 = y1 = y0 = 0;
    float w = std::max(1.0f, x1 - x0), h = std::max(1.0f, y1 - y0);
    cell = std::max(
        std::sqrt(w * h / std::max(1, n) * 2.0f) * cell_mult, 1e-3f);
    inv_cell = 1.0f / cell;
    nx = std::max(1, (int)(w * inv_cell) + 1);
    ny = std::max(1, (int)(h * inv_cell) + 1);
    starts.assign((size_t)nx * ny + 1, 0);
    for (int i = 0; i < n; ++i) ++starts[cell_of(saddles[i].x, saddles[i].y) + 1];
    for (size_t c = 1; c < starts.size(); ++c) starts[c] += starts[c - 1];
    items.resize(n);
    std::vector<int> cursor(starts.begin(), starts.end() - 1);
    for (int i = 0; i < n; ++i)
      items[cursor[cell_of(saddles[i].x, saddles[i].y)]++] = i;
    sx.resize(n);
    sy.resize(n);
    for (int ii = 0; ii < n; ++ii) {
      sx[ii] = saddles[items[ii]].x;
      sy[ii] = saddles[items[ii]].y;
    }
  }

  size_t cell_of(float x, float y) const {
    int cx = std::clamp((int)((x - x0) * inv_cell), 0, nx - 1);
    int cy = std::clamp((int)((y - y0) * inv_cell), 0, ny - 1);
    return (size_t)cy * nx + cx;
  }


  // Min squared distance from (qx, qy) to any cell NOT visited after
  // finishing ring `ring` of the clamped walk: the unvisited region is
  // the in-box complement of the visited square — four strips. Exact
  // geometry (minus a cell/1000 binning-jitter guard), so it is ALWAYS
  // at least the legacy (ring-1)*cell bound and, for query points
  // extrapolated outside the saddle bounding box (closest_potential
  // projects a + v*ratio well past the cloud on sparse pass-2
  // leftovers), it adds the out-of-box offset the legacy bound ignored
  // — those walks visited nearly every cell before stopping.
  float unvisited_d2(float qx, float qy, int cx, int cy, int ring) const {
    float guard = 0.001f * cell;
    float bx1 = x0 + (float)nx * cell, by1 = y0 + (float)ny * cell;
    float xbox = std::max(0.0f, std::max(x0 - qx, qx - bx1));
    float ybox = std::max(0.0f, std::max(y0 - qy, qy - by1));
    float best = 1e30f;
    if (cx + ring + 1 <= nx - 1) {  // right strip, full box height
      float dx = std::max(
          0.0f, x0 + (float)(cx + ring + 1) * cell - qx - guard);
      best = std::min(best, dx * dx + ybox * ybox);
    }
    if (cx - ring - 1 >= 0) {       // left strip
      float dx = std::max(
          0.0f, qx - (x0 + (float)(cx - ring) * cell) - guard);
      best = std::min(best, dx * dx + ybox * ybox);
    }
    if (cy + ring + 1 <= ny - 1) {  // bottom strip, full box width
      float dy = std::max(
          0.0f, y0 + (float)(cy + ring + 1) * cell - qy - guard);
      best = std::min(best, xbox * xbox + dy * dy);
    }
    if (cy - ring - 1 >= 0) {       // top strip
      float dy = std::max(
          0.0f, qy - (y0 + (float)(cy - ring) * cell) - guard);
      best = std::min(best, xbox * xbox + dy * dy);
    }
    return best;                    // 1e30: everything is visited
  }

  // k nearest neighbors of (qx, qy), sorted by distance.
  // Small-k fast path: the hot expansion queries are 3-NN (and 1-NN for
  // hole repair) — a bounded insertion sort with distance pruning beats
  // collect-everything + partial_sort by a wide margin there.
  void knn(float qx, float qy, int k,
           std::vector<std::pair<float, int>>& out) const {
    if (k <= 4) {
      knn_small(qx, qy, k, out);
      return;
    }
    out.clear();
    const auto& saddles = *pts;
    const int total = (int)items.size();
    if (k * 4 >= total || total <= 512) {
      // large-k queries over small point sets (init_quads' 50-NN after
      // board removal) degenerate to near-full ring scans with a
      // partial_sort PER RING — one brute-force pass + one sort is
      // cheaper and yields the identical list: both paths order the
      // same (dist, idx) pairs lexicographically (gprof: the ring walk
      // was ~20% of a no-board pass-2 search)
      for (int i = 0; i < total; ++i) {
        float dx = saddles[i].x - qx, dy = saddles[i].y - qy;
        out.emplace_back(dx * dx + dy * dy, i);
      }
      if ((int)out.size() > k) {
        // nth_element + sort of the prefix orders the same (dist, idx)
        // pairs lexicographically as partial_sort — identical list,
        // ~3x fewer comparisons at k=50, n~500
        std::nth_element(out.begin(), out.begin() + (k - 1), out.end());
        std::sort(out.begin(), out.begin() + k);
        out.resize(k);
      } else {
        std::sort(out.begin(), out.end());
      }
      return;
    }
    int cx = std::clamp((int)((qx - x0) * inv_cell), 0, nx - 1);
    int cy = std::clamp((int)((qy - y0) * inv_cell), 0, ny - 1);
    // beyond this ring every cell is out of bounds; without the clamp a
    // query that can never satisfy k (fewer than k alive points — the
    // common case in board pass 2) walked (nx+ny)^2-ish empty rings and
    // dominated the whole host search (gprof: 76% in the cell visitor)
    int max_ring =
        std::max(std::max(cx, nx - 1 - cx), std::max(cy, ny - 1 - cy));
    auto scan_row = [&](int gx0, int gx1, int gy) {
      size_t c0 = (size_t)gy * nx + gx0;
      size_t c1 = (size_t)gy * nx + gx1;
      for (int ii = starts[c0]; ii < starts[c1 + 1]; ++ii) {
        float dx = sx[ii] - qx, dy = sy[ii] - qy;
        out.emplace_back(dx * dx + dy * dy, items[ii]);
      }
    };
    for (int ring = 0; ring <= max_ring; ++ring) {
      int xa = std::max(cx - ring, 0), xb = std::min(cx + ring, nx - 1);
      int ya = cy - ring, yb = cy + ring;
      if (ring == 0) {
        scan_row(cx, cx, cy);
      } else {
        if (ya >= 0) scan_row(xa, xb, ya);  // top row
        if (yb < ny) scan_row(xa, xb, yb);  // bottom
        int gy0 = std::max(ya + 1, 0), gy1 = std::min(yb - 1, ny - 1);
        if (cx - ring >= 0)
          for (int gy = gy0; gy <= gy1; ++gy)
            scan_row(cx - ring, cx - ring, gy);
        if (cx + ring < nx)
          for (int gy = gy0; gy <= gy1; ++gy)
            scan_row(cx + ring, cx + ring, gy);
      }
      if ((int)out.size() >= total) break;  // every point collected
      if ((int)out.size() >= k) {
        std::partial_sort(out.begin(), out.begin() + k, out.end());
        // guaranteed-complete radius after ring r is (r-1) cells (the
        // query point may sit at a corner of its cell)
        float safe = (float)(ring - 1) * cell;
        if (ring >= 1 && out[k - 1].first <= safe * safe) {
          out.resize(k);
          return;
        }
      }
    }
    std::sort(out.begin(), out.end());
    if ((int)out.size() > k) out.resize(k);
  }

  void knn_small(float qx, float qy, int k,
                 std::vector<std::pair<float, int>>& out) const {
    const int total = (int)items.size();
    float bd[4] = {1e30f, 1e30f, 1e30f, 1e30f};
    int bi[4] = {-1, -1, -1, -1};
    int n0 = 0, visited = 0;
    int cx = std::clamp((int)((qx - x0) * inv_cell), 0, nx - 1);
    int cy = std::clamp((int)((qy - y0) * inv_cell), 0, ny - 1);
    // see knn(): clamp to the last in-bounds ring and stop once every
    // stored point has been visited (k may exceed the alive count)
    int max_ring =
        std::max(std::max(cx, nx - 1 - cx), std::max(cy, ny - 1 - cy));
    // contiguous CSR span scan (same visit order as the cell-by-cell
    // walk, so insertion ties break identically)
    auto scan_span = [&](int i0, int i1) {
      visited += i1 - i0;
      for (int ii = i0; ii < i1; ++ii) {
        float dx = sx[ii] - qx, dy = sy[ii] - qy;
        float d = dx * dx + dy * dy;
        if (n0 == k && d >= bd[k - 1]) continue;
        int i = items[ii];
        int j = std::min(n0, k - 1);
        while (j > 0 && bd[j - 1] > d) {
          bd[j] = bd[j - 1];
          bi[j] = bi[j - 1];
          --j;
        }
        bd[j] = d;
        bi[j] = i;
        if (n0 < k) ++n0;
      }
    };
    // a ring ROW [xa, xb] x {gy} is ONE contiguous CSR span
    auto scan_row = [&](int gx0, int gx1, int gy) {
      size_t c0 = (size_t)gy * nx + gx0;
      size_t c1 = (size_t)gy * nx + gx1;
      scan_span(starts[c0], starts[c1 + 1]);
    };
    for (int ring = 0; ring <= max_ring; ++ring) {
      int xa = std::max(cx - ring, 0), xb = std::min(cx + ring, nx - 1);
      int ya = cy - ring, yb = cy + ring;
      if (ring == 0) {
        scan_row(cx, cx, cy);
      } else {
        if (ya >= 0) scan_row(xa, xb, ya);
        if (yb < ny) scan_row(xa, xb, yb);
        int gy0 = std::max(ya + 1, 0), gy1 = std::min(yb - 1, ny - 1);
        if (cx - ring >= 0)
          for (int gy = gy0; gy <= gy1; ++gy)
            scan_row(cx - ring, cx - ring, gy);
        if (cx + ring < nx)
          for (int gy = gy0; gy <= gy1; ++gy)
            scan_row(cx + ring, cx + ring, gy);
      }
      if (visited >= total) break;
      if (n0 == k) {
        // cheap lower bound first: any unvisited point is at least
        // (ring-1) cells away; the exact strip geometry only runs when
        // that fails to certify the break (same break decisions)
        float safe = (float)(ring - 1) * cell;
        if ((ring >= 1 && safe * safe >= bd[k - 1]) ||
            unvisited_d2(qx, qy, cx, cy, ring) >= bd[k - 1])
          break;
      }
    }
    out.clear();
    for (int j = 0; j < n0; ++j) out.emplace_back(bd[j], bi[j]);
  }

  // k nearest neighbors WITHIN radius sqrt(r2) — identical result to
  // knn_small followed by the caller's dsq <= r2 filter (an in-radius
  // point outside the overall top-k implies k closer points that are
  // also in-radius). The running top-k deliberately ADMITS
  // out-of-radius points: they tighten the ring-walk stop bound to
  // min(r2, kth-best-overall) — on sparse noise fields the kth-best
  // bound fires first (a radius-only bound walked the full huge-radius
  // disc on pass-2 leftover edges: iphone pass-2 3.0 -> 4.1 ms/frame,
  // tools/probe_iphone.py), on dense boards the radius bound does
  // (gprof: unbounded 3-NN was 65 % of a no-board pass-2 search) —
  // and the emit loop filters them back out.
  void knn_radius(float qx, float qy, int k, float r2,
                  std::vector<std::pair<float, int>>& out) const {
    const int total = (int)items.size();
    float bd[4] = {1e30f, 1e30f, 1e30f, 1e30f};
    int bi[4] = {-1, -1, -1, -1};
    int n0 = 0, visited = 0;
    int cx = std::clamp((int)((qx - x0) * inv_cell), 0, nx - 1);
    int cy = std::clamp((int)((qy - y0) * inv_cell), 0, ny - 1);
    int max_ring =
        std::max(std::max(cx, nx - 1 - cx), std::max(cy, ny - 1 - cy));
    auto scan_span = [&](int i0, int i1) {
      visited += i1 - i0;
      for (int ii = i0; ii < i1; ++ii) {
        float dx = sx[ii] - qx, dy = sy[ii] - qy;
        float d = dx * dx + dy * dy;
        if (n0 == k && d >= bd[k - 1]) continue;
        int i = items[ii];
        int j = std::min(n0, k - 1);
        while (j > 0 && bd[j - 1] > d) {
          bd[j] = bd[j - 1];
          bi[j] = bi[j - 1];
          --j;
        }
        bd[j] = d;
        bi[j] = i;
        if (n0 < k) ++n0;
      }
    };
    auto scan_row = [&](int gx0, int gx1, int gy) {
      size_t c0 = (size_t)gy * nx + gx0;
      size_t c1 = (size_t)gy * nx + gx1;
      scan_span(starts[c0], starts[c1 + 1]);
    };
    for (int ring = 0; ring <= max_ring; ++ring) {
      int xa = std::max(cx - ring, 0), xb = std::min(cx + ring, nx - 1);
      int ya = cy - ring, yb = cy + ring;
      if (ring == 0) {
        scan_row(cx, cx, cy);
      } else {
        if (ya >= 0) scan_row(xa, xb, ya);
        if (yb < ny) scan_row(xa, xb, yb);
        int gy0 = std::max(ya + 1, 0), gy1 = std::min(yb - 1, ny - 1);
        if (cx - ring >= 0)
          for (int gy = gy0; gy <= gy1; ++gy)
            scan_row(cx - ring, cx - ring, gy);
        if (cx + ring < nx)
          for (int gy = gy0; gy <= gy1; ++gy)
            scan_row(cx + ring, cx + ring, gy);
      }
      if (visited >= total) break;
      // stop once every unvisited cell is farther than the radius and
      // (when full) the kth-best-overall; cheap (ring-1)-cell lower
      // bound first, exact strip geometry only when it can't certify
      float bound = n0 == k ? std::min(r2, bd[k - 1]) : r2;
      float safe = (float)(ring - 1) * cell;
      if ((ring >= 1 && safe * safe >= bound) ||
          unvisited_d2(qx, qy, cx, cy, ring) >= bound)
        break;
    }
    out.clear();
    for (int j = 0; j < n0; ++j)
      if (bd[j] <= r2) out.emplace_back(bd[j], bi[j]);
  }
};

// Memoized expansion-candidate lists. closest_potential's 3-NN search,
// radius gate and theta gate depend only on the (a, b) edge pair and
// the round's alive set — both fixed across every board grown within
// one ag_find_board call. Only the per-grow `active` gate is dynamic,
// and it filters a distance-ordered list, so applying it at retrieval
// is EXACTLY equivalent to recomputing (the repeated re-grows of the
// same physical board from different candidate quads hit this cache
// almost every query). Open-addressed, sized for ~thousands of edges.
struct PairCache {
  struct Entry {
    uint32_t key = kFree;
    int8_t n0 = 0, n1 = 0;
    int16_t c0[3] = {0, 0, 0}, c1[3] = {0, 0, 0};
  };
  static constexpr uint32_t kFree = 0xffffffffu;
  std::vector<Entry> slots;
  uint32_t mask = 0;
  size_t filled = 0;
  Entry spill;  // returned past the load cap: computed but not stored

  void reset(int n_points) {
    // Demand scales with seeds x growth-grid (each cell expansion
    // queries fresh (ai, bi) edges), not just with n_points: a dense
    // low-resolution board can touch thousands of distinct pairs, so
    // floor the table at 4096 and keep the load factor low. The spill
    // guard below keeps the open-addressing probe FINITE regardless —
    // an over-budget scene recomputes instead of hanging (a 64-saddle
    // decimated board scene filled the old 1024-slot table and spun
    // the probe loop forever).
    size_t cap = 4096;
    while (cap < (size_t)n_points * 16) cap <<= 1;
    if (slots.size() != cap) slots.assign(cap, Entry{});
    else std::fill(slots.begin(), slots.end(), Entry{});
    mask = (uint32_t)cap - 1;
    filled = 0;
  }

  Entry& probe(uint32_t key, bool& hit) {
    uint32_t h = (key * 2654435761u) & mask;
    for (;;) {
      Entry& e = slots[h];
      if (e.key == key) {
        hit = true;
        return e;
      }
      if (e.key == kFree) {
        hit = false;
        if (2 * filled >= slots.size()) {  // half full: stop storing
          spill = Entry{};
          return spill;
        }
        ++filled;
        return e;
      }
      h = (h + 1) & mask;
    }
  }
};

// Env-gated search statistics (AG_SEARCH_STATS=1): per-ag_find_board
// counters dumped to stderr, for attributing host-search time between
// seeding, candidate grows, and the expansion nest. Zero overhead in
// the counters themselves (plain thread_local increments, no atomics).
struct SearchStats {
  long seeds = 0, cands = 0, grows = 0, expands = 0, cp_miss = 0,
       vr_calls = 0, vr_hits = 0, knn50 = 0;
  // rdtsc cycle attribution (only meaningful when stats are on)
  unsigned long long cy_init = 0, cy_grow = 0, cy_cp = 0, cy_vr = 0,
                     cy_knn50 = 0, cy_g1 = 0, cy_nest = 0;
  void reset() { *this = SearchStats{}; }
};
static thread_local SearchStats g_stats;
static bool stats_enabled() {
  static const bool on = [] {
    const char* e = std::getenv("AG_SEARCH_STATS");
    return e && *e && *e != '0';
  }();
  return on;
}
// Scope timer feeding a SearchStats cycle counter; free when stats are
// off (one predictable branch per scope).
struct StatScope {
  unsigned long long* acc;
  unsigned long long t0;
  explicit StatScope(unsigned long long& a)
      : acc(stats_enabled() ? &a : nullptr),
        t0(acc ? __builtin_ia32_rdtsc() : 0) {}
  ~StatScope() {
    if (acc) *acc += __builtin_ia32_rdtsc() - t0;
  }
};

// Memo for is_valid_quad_rest verdicts keyed by the ORDERED saddle
// index 4-tuple. The predicate is a pure function of the four saddles,
// so caching is exact by construction. It pays on multi-pass scenes
// whose leftovers form only low-score boards (no early exit): all 30
// seeds' candidate grows then walk the same saddle field and re-test
// the same combos through try_expand_one's 3^4 nest (measured 211k
// evaluations/frame on iphone.png's pass-2 leftovers — ~3.1 ms/frame
// of host time vs two_boards' 0.52, tools/probe_iphone.py). Generation
// stamps make reuse across calls O(1): no per-call clear, ++gen
// invalidates everything. thread_local storage keeps batch workers
// shared-nothing.
struct QuadMemo {
  struct Entry {
    uint64_t key = 0;
    uint32_t gen = 0;   // matches QuadMemo::gen when live
    uint8_t val = 0;
  };
  static constexpr size_t kSlots = 1 << 17;  // 131k x 16 B = 2 MiB
  std::vector<Entry> slots;
  uint32_t gen = 0;
  size_t filled = 0;  // live entries this generation (load cap)

  void next_gen() {
    if (slots.empty()) slots.assign(kSlots, Entry{});
    ++gen;
    filled = 0;
    if (gen == 0) {  // u32 wrap: stale gens would alias as live
      std::fill(slots.begin(), slots.end(), Entry{});
      gen = 1;
    }
  }

  // returns true with *out set when memoized; false when the caller
  // must evaluate (and then record via the returned slot, if any)
  Entry* probe(uint64_t key, bool& hit, bool& val) {
    uint64_t h = (key * 0x9e3779b97f4a7c15ull) >> 47;  // top bits -> 17
    for (;;) {
      Entry& e = slots[h & (kSlots - 1)];
      if (e.gen != gen) {  // free (or stale): miss, insertable
        hit = false;
        if (2 * filled >= kSlots) return nullptr;  // half full: spill
        ++filled;
        return &e;
      }
      if (e.key == key) {
        hit = true;
        val = (bool)e.val;
        return &e;
      }
      ++h;
    }
  }
};

// Reusable workspace: one Board growth (Board, src/board.rs:18-235)
// on a flat bounded grid.
struct Workspace {
  std::vector<int> cellmap;             // kG2, kEmpty/kNone/slot
  std::vector<int> touched;             // dirty cells for cheap reset
  std::vector<std::array<int, 4>> quads;
  std::vector<uint8_t> active;
  std::vector<std::pair<float, int>> nn;
  std::vector<std::array<int, 3>> dfs;  // (x, y, next_dir)

  Workspace() : cellmap(kG2, kEmpty) {}

  void reset() {
    for (int c : touched) cellmap[c] = kEmpty;
    touched.clear();
    quads.clear();
    dfs.clear();
  }

  static int cid(int x, int y) {
    return (y + kRadius) * kG + (x + kRadius);
  }
  static bool inside(int x, int y) {
    return x >= -kRadius && x <= kRadius && y >= -kRadius && y <= kRadius;
  }
  int get(int x, int y) const {
    return inside(x, y) ? cellmap[cid(x, y)] : kEmpty;
  }
  void put(int x, int y, int v) {
    if (!inside(x, y)) return;
    int c = cid(x, y);
    if (cellmap[c] == kEmpty) touched.push_back(c);
    cellmap[c] = v;
  }
};

struct Searcher {
  const std::vector<Saddle>& s;
  const SpatialGrid& grid;        // density-scaled cells (seed 50-NN, 1-NN)
  const SpatialGrid& grid_fine;   // 4x finer cells (radius-bounded 3-NN)
  float spacing;
  Workspace& ws;
  PairCache& cache;
  QuadMemo& qmemo;
  int score = 0;

  Searcher(const std::vector<Saddle>& saddles, const SpatialGrid& g,
           const SpatialGrid& gf, float spacing_ratio, Workspace& w,
           PairCache& pc, QuadMemo& qm)
      : s(saddles), grid(g), grid_fine(gf), spacing(spacing_ratio), ws(w),
        cache(pc), qmemo(qm) {}

  // is_valid_quad_rest with the ordered-tuple memo (exact: the
  // predicate depends on nothing but the four saddles)
  bool valid_rest(int a, int b, int c, int d) {
    uint64_t key = ((uint64_t)(uint16_t)a << 48) |
                   ((uint64_t)(uint16_t)b << 32) |
                   ((uint64_t)(uint16_t)c << 16) | (uint64_t)(uint16_t)d;
    bool hit, val;
    QuadMemo::Entry* e = qmemo.probe(key, hit, val);
    ++g_stats.vr_calls;
    if (hit) { ++g_stats.vr_hits; return val; }
    {
      StatScope _t(g_stats.cy_vr);
      val = is_valid_quad_rest(s[a], s[b], s[c], s[d]);
    }
    if (e) {
      e->key = key;
      e->gen = qmemo.gen;
      e->val = (uint8_t)val;
    }
    return val;
  }

  // find_closest_potential_saddle_idxs (src/board.rs:177-234); the
  // active-agnostic candidate lists are memoized per (ai, bi) edge
  void closest_potential(int ai, int bi, int out0[3], int& n0,
                         int out1[3], int& n1) {
    bool hit;
    PairCache::Entry& e =
        cache.probe(((uint32_t)ai << 16) | (uint32_t)bi, hit);
    if (!hit) {
      ++g_stats.cp_miss;
      StatScope _t(g_stats.cy_cp);
      const Saddle& a = s[ai];
      const Saddle& b = s[bi];
      float ratio = 1.0f + spacing;
      float vx = b.x - a.x, vy = b.y - a.y;
      float radius_sq = 0.5f * (vx * vx + vy * vy);
      e.key = ((uint32_t)ai << 16) | (uint32_t)bi;
      e.n0 = e.n1 = 0;
      // radius-bounded 3-NN on the fine grid == 3-NN + dsq<=radius_sq
      // filter on any grid (same set, same order: anything within the
      // radius that misses the overall top-3 implies three closer
      // points that are also within the radius); the huge-radius
      // degenerate edges fall back to the coarse grid so the ring walk
      // never crawls hundreds of near-empty fine cells — still
      // radius-BOUNDED there: the unbounded coarse 3-NN walked rings
      // until it found 3 neighbors ANYWHERE and then filtered nearly
      // all of them (pass-2 noise leftovers: 1476 cache-miss edges
      // x 2 sparse-field walks ≈ 2.5 ms/frame on iphone.png,
      // tools/probe_iphone.py + AG_SEARCH_STATS)
      bool fine = radius_sq <= 16.0f * grid_fine.cell * grid_fine.cell;
      auto query = [&](float qx, float qy, const Saddle& ref,
                       int16_t* dst, int8_t& cnt) {
        if (fine)
          grid_fine.knn_radius(qx, qy, 3, radius_sq, ws.nn);
        else
          grid.knn_radius(qx, qy, 3, radius_sq, ws.nn);
        for (auto& [dsq, idx] : ws.nn) {
          if (dsq <= radius_sq &&
              theta_distance_degree(ref.theta, s[idx].theta) < 5.0f)
            dst[cnt++] = (int16_t)idx;
        }
      };
      query(a.x + vx * ratio, a.y + vy * ratio, a, e.c0, e.n0);
      // the b-side list is only ever read when the a-side is nonempty
      // (every try_expand_one caller returns false on n0 == 0 / n3 == 0
      // before touching the other side), so an empty a-side makes the
      // b-side walk dead work — skip it (exact: retrievals of this
      // entry short-circuit the same way). Pass-2 noise fields hit
      // this on roughly half the cache misses (the forward
      // extrapolation lands in empty space).
      if (e.n0 > 0)
        query(b.x + vx * ratio, b.y + vy * ratio, b, e.c1, e.n1);
    }
    n0 = n1 = 0;
    for (int j = 0; j < e.n0; ++j)
      if (ws.active[e.c0[j]]) out0[n0++] = e.c0[j];
    for (int j = 0; j < e.n1; ++j)
      if (ws.active[e.c1[j]]) out1[n1++] = e.c1[j];
  }

  // try_expand_one (src/board.rs:153-176). The 3^4 candidate nest
  // dominated no-board pass-2 scenes (measured ~211k is_valid_quad
  // calls/frame on iphone.png's leftovers); the quad gates that depend
  // on only (c1, c3) or (c0, c2) are evaluated once per pair instead of
  // per combo. Identical predicates in identical first-accept order, so
  // the returned quad is exactly the reference's.
  bool try_expand_one(const int q[4], int out[4]) {
    ++g_stats.expands;
    int n0, n1, n2, n3;
    int c0[3], c1[3], c2[3], c3[3];
    closest_potential(q[0], q[1], c0, n0, c1, n1);
    if (n0 == 0 || n1 == 0) return false;
    closest_potential(q[3], q[2], c3, n3, c2, n2);
    if (n2 == 0 || n3 == 0) return false;
    bool g13[3][3], any13 = false;
    for (int i1 = 0; i1 < n1; ++i1)
      for (int i3 = 0; i3 < n3; ++i3)
        any13 |= (g13[i1][i3] = gate_diag_theta(s[c1[i1]], s[c3[i3]]));
    if (!any13) return false;
    bool g02[3][3];
    for (int i0 = 0; i0 < n0; ++i0)
      for (int i2 = 0; i2 < n2; ++i2)
        g02[i0][i2] = gate_v02_angle(s[c0[i0]], s[c2[i2]]);
    for (int i0 = 0; i0 < n0; ++i0)
      for (int i1 = 0; i1 < n1; ++i1)
        for (int i2 = 0; i2 < n2; ++i2) {
          if (!g02[i0][i2]) continue;
          for (int i3 = 0; i3 < n3; ++i3)
            if (g13[i1][i3] &&
                valid_rest(c0[i0], c1[i1], c2[i2], c3[i3])) {
              out[0] = c0[i0];
              out[1] = c1[i1];
              out[2] = c2[i2];
              out[3] = c3[i3];
              return true;
            }
        }
    return false;
  }

  // Board::new + try_expand (src/board.rs:27-152) with an explicit DFS
  // stack carrying per-cell direction progress (no retries).
  void grow(const int* seed, const std::vector<uint8_t>& active_mask) {
    ++g_stats.grows;
    StatScope _t(g_stats.cy_grow);
    ws.reset();
    ws.active = active_mask;
    for (int i = 1; i < 4; ++i) ws.active[seed[i]] = 0;
    ws.quads.push_back({seed[0], seed[1], seed[2], seed[3]});
    ws.put(0, 0, 0);
    score = 1;
    ws.dfs.push_back({0, 0, 0});
    static const int dxs[4] = {1, 0, -1, 0};
    static const int dys[4] = {0, -1, 0, 1};
    while (!ws.dfs.empty()) {
      auto& [x, y, di] = ws.dfs.back();
      if (di == 4) {
        ws.dfs.pop_back();
        continue;
      }
      int i = di++;
      int slot = ws.get(x, y);
      if (slot < 0) {  // should not happen; guard
        ws.dfs.pop_back();
        continue;
      }
      const auto quad = ws.quads[slot];
      int q[4];
      for (int j = 0; j < 4; ++j) q[j] = quad[(j + i) % 4];  // rotate_left(i)
      int nx_ = x + dxs[i], ny_ = y + dys[i];
      int st = ws.get(nx_, ny_);
      if (st >= 0) continue;
      if (!Workspace::inside(nx_, ny_)) continue;
      int found[4];
      if (try_expand_one(q, found)) {
        std::array<int, 4> v;
        for (int j = 0; j < 4; ++j) v[(j + i) % 4] = found[j];  // rotate_right
        for (int j = 0; j < 4; ++j) ws.active[v[j]] = 0;
        ++score;
        ws.quads.push_back(v);
        ws.put(nx_, ny_, (int)ws.quads.size() - 1);
        ws.dfs.push_back({nx_, ny_, 0});  // depth-first recursion
      } else {
        ws.put(nx_, ny_, kNone);
      }
    }
  }

  // try_fix_missing (src/board.rs:52-112) on the flat grid
  void fix_missing() {
    std::vector<std::array<int, 4>> fixes;  // (x0,y0,x1,y1) donor cells
    for (int c : ws.touched) {
      if (ws.cellmap[c] != kNone) continue;
      int x = c % kG - kRadius, y = c / kG - kRadius;
      int b0 = ws.get(x + 1, y), b1 = ws.get(x - 1, y);
      int b2 = ws.get(x, y + 1), b3 = ws.get(x, y - 1);
      if (b0 != kEmpty && b1 != kEmpty) {
        if (b0 >= 0 && b1 >= 0) fixes.push_back({x + 1, y, x - 1, y});
      } else if (b2 != kEmpty && b3 != kEmpty && b2 >= 0 && b3 >= 0) {
        fixes.push_back({x, y + 1, x, y - 1});
      }
    }
    for (auto& f : fixes) {
      const auto& q0 = ws.quads[ws.get(f[0], f[1])];
      const auto& q1 = ws.quads[ws.get(f[2], f[3])];
      int idxs[4];
      for (int i = 0; i < 4; ++i) {
        float mx = (s[q0[i]].x + s[q1[i]].x) * 0.5f;
        float my = (s[q0[i]].y + s[q1[i]].y) * 0.5f;
        grid.knn(mx, my, 1, ws.nn);
        idxs[i] = ws.nn.empty() ? 0 : ws.nn[0].second;
      }
      if (is_valid_quad(s[idxs[0]], s[idxs[1]], s[idxs[2]], s[idxs[3]])) {
        ws.quads.push_back({idxs[0], idxs[1], idxs[2], idxs[3]});
        ws.put((f[0] + f[2]) / 2, (f[1] + f[3]) / 2, (int)ws.quads.size() - 1);
      }
    }
  }
};

// init_quads (src/detector.rs:543-586)
void init_quads(const std::vector<Saddle>& s, const SpatialGrid& grid,
                int s0_idx, std::vector<std::pair<float, int>>& nn,
                std::vector<std::array<int, 4>>& out) {
  out.clear();
  const Saddle& s0 = s[s0_idx];
  ++g_stats.knn50;
  {
    StatScope _t(g_stats.cy_knn50);
    grid.knn(s0.x, s0.y, std::min<size_t>(50, s.size()), nn);
  }
  // scratch reused across the 30 seeds x 2+ passes per frame (the
  // per-call mallocs showed up at ~180 allocations/frame); workers are
  // shared-nothing so thread_local is safe
  static thread_local std::vector<int> same, diff;
  same.clear();
  diff.clear();
  for (size_t i = 1; i < nn.size(); ++i) {
    int idx = nn[i].second;
    float td = theta_distance_degree(s0.theta, s[idx].theta);
    if (td < 5.0f)
      same.push_back(idx);
    else if (td > 80.0f)
      diff.push_back(idx);
  }
  // hoisted quad gates: gate 1 depends on the (d0, d1) pair only —
  // compute each of the C(|diff|, 2) pair verdicts once instead of per
  // s1 — and gate 2 on (s0, s1) only — once per s1 instead of per pair.
  // Identical predicates, identical enumeration order.
  size_t nd = diff.size();
  static thread_local std::vector<uint8_t> g1;
  g1.assign(nd * nd, 0);
  {
    StatScope _t(g_stats.cy_g1);
    for (size_t a = 0; a < nd; ++a)
      for (size_t b = a + 1; b < nd; ++b)
        g1[a * nd + b] = gate_diag_theta(s[diff[a]], s[diff[b]]);
  }
  StatScope _tn(g_stats.cy_nest);
  // The pair nest evaluates is_valid_quad_rest = [c0*c1 convexity] &&
  // [mid gates] && [both diagonals forward of v02]. The first and last
  // conjuncts depend on (s0, s1, ONE diagonal), so per s1 they are
  // precomputed once per diff index and the pair loop walks only the
  // forward-passing diffs (order-preserving compaction), testing the
  // convexity product from the cached crosses before paying for the
  // mid gates. Same conjunction, same arithmetic (cross(v02,v03) ==
  // -cross(v03,v02) exactly in IEEE), same emission order.
  static thread_local std::vector<float> dvx, dvy, cxv;
  static thread_local std::vector<int> fwd;
  dvx.resize(nd);
  dvy.resize(nd);
  cxv.resize(nd);
  fwd.reserve(nd);
  for (size_t i = 0; i < nd; ++i) {
    dvx[i] = s[diff[i]].x - s0.x;
    dvy[i] = s[diff[i]].y - s0.y;
  }
  for (int s1_idx : same) {
    if (!gate_v02_angle(s0, s[s1_idx])) continue;
    const Saddle& s1 = s[s1_idx];
    float v02x = s1.x - s0.x, v02y = s1.y - s0.y;
    fwd.clear();
    for (size_t i = 0; i < nd; ++i) {
      cxv[i] = dvx[i] * v02y - dvy[i] * v02x;
      if (!(dvx[i] * v02x + dvy[i] * v02y < 0.0f)) fwd.push_back((int)i);
    }
    for (size_t ai = 0; ai < fwd.size(); ++ai) {
      size_t a = (size_t)fwd[ai];
      for (size_t bi = ai + 1; bi < fwd.size(); ++bi) {
        size_t b = (size_t)fwd[bi];
        if (!g1[a * nd + b]) continue;
        if (cxv[a] * -cxv[b] < 0.0f) continue;
        const Saddle& d0 = s[diff[a]];
        const Saddle& d1 = s[diff[b]];
        if (!quad_rest_mid(s0, d0, s1, d1, dvx[a], dvy[a], dvx[b],
                           dvy[b]))
          continue;
        if (cxv[a] > 0.0f)
          out.push_back({s0_idx, diff[a], s1_idx, diff[b]});
        else
          out.push_back({s0_idx, diff[b], s1_idx, diff[a]});
      }
    }
  }
}

float rust_round(float v) {
  return std::copysign(std::floor(std::fabs(v) + 0.5f), v);
}

}  // namespace

extern "C" {

// Test-only export: the full quad validity predicate on four (x, y,
// theta-degree) saddles, for randomized boundary-equivalence tests
// against the oracle (the angle gates use algebraic fast paths whose
// decision bands must stay inside the exact atan2 semantics —
// tests/test_units.py pins this near the 5/10-degree boundaries).
int ag_is_valid_quad(const float* xyt) {
  Saddle s[4];
  for (int i = 0; i < 4; ++i) {
    float th = xyt[i * 3 + 2] / 180.0f * kPi;
    s[i] = {xyt[i * 3], xyt[i * 3 + 1], xyt[i * 3 + 2], std::cos(th),
            std::sin(th)};
  }
  return is_valid_quad(s[0], s[1], s[2], s[3]) ? 1 : 0;
}

// One try_find_best_board pass (src/detector.rs:588-639) over the alive
// saddles. Returns the number of tag quads written to out_quads
// (cap x 4 int32 global saddle indices). Every candidate quad is grown
// exactly like the reference (a former "fast" skip heuristic was removed:
// it was unsound on merged-board scenes such as two_boards.png).
int ag_find_board(const float* px, const float* py, const float* theta,
                  const uint8_t* alive, int n, float spacing_ratio,
                  int max_seeds, int early_exit_score,
                  int32_t* out_quads, int cap) {
  std::vector<Saddle> s;
  std::vector<int> gidx;
  s.reserve(n);
  for (int i = 0; i < n; ++i) {
    if (alive[i]) {
      float th = theta[i] / 180.0f * kPi;
      s.push_back({px[i], py[i], theta[i], std::cos(th), std::sin(th)});
      gidx.push_back(i);
    }
  }
  int m = (int)s.size();
  if (m == 0) return 0;

  SpatialGrid grid;
  grid.build(s);
  SpatialGrid grid_fine;
  grid_fine.build(s, 0.25f);

  // theta histogram over integer degrees in [-90, 90]; largest bucket,
  // seeds popped back-to-front (src/detector.rs:601-617)
  std::vector<std::vector<int>> buckets(181);
  for (int i = 0; i < m; ++i) {
    int b = std::clamp((int)rust_round(s[i].theta) + 90, 0, 180);
    buckets[b].push_back(i);
  }
  size_t best_b = 0;
  for (size_t b = 1; b < buckets.size(); ++b)
    if (buckets[b].size() > buckets[best_b].size()) best_b = b;
  std::vector<int> seeds = buckets[best_b];

  std::vector<uint8_t> active_mask(m, 1);
  Workspace ws;
  PairCache cache;
  cache.reset(m);
  static thread_local QuadMemo qmemo;  // shared-nothing across workers
  qmemo.next_gen();
  if (stats_enabled()) g_stats.reset();
  Searcher searcher(s, grid, grid_fine, spacing_ratio, ws, cache, qmemo);
  int best_score = 0;
  std::vector<std::array<int, 4>> best_quads;
  std::vector<int> best_cellmap;
  std::vector<int> best_touched;
  std::vector<std::array<int, 4>> cand;
  std::vector<std::pair<float, int>> nn;
  int count = 0;
  while (!seeds.empty() && count < max_seeds) {
    int s0 = seeds.back();
    seeds.pop_back();
    ++g_stats.seeds;
    {
      StatScope _t(g_stats.cy_init);
      init_quads(s, grid, s0, nn, cand);
    }
    g_stats.cands += (long)cand.size();
    for (auto& q : cand) {
      int qi[4] = {q[0], q[1], q[2], q[3]};
      searcher.grow(qi, active_mask);
      if (searcher.score > best_score) {
        best_score = searcher.score;
        best_quads = ws.quads;
        best_cellmap = ws.cellmap;
        best_touched = ws.touched;
      }
    }
    if (best_score >= early_exit_score) break;
    ++count;
  }
  if (stats_enabled())
    std::fprintf(stderr,
                 "[ag_stats] m=%d seeds=%ld cands=%ld grows=%ld "
                 "expands=%ld cp_miss=%ld vr=%ld/%ld knn50=%ld best=%d "
                 "cyc init=%llu grow=%llu cp=%llu vr=%llu "
                 "knn50=%llu g1=%llu nest=%llu\n",
                 m, g_stats.seeds, g_stats.cands, g_stats.grows,
                 g_stats.expands, g_stats.cp_miss, g_stats.vr_hits,
                 g_stats.vr_calls, g_stats.knn50, best_score,
                 g_stats.cy_init, g_stats.cy_grow, g_stats.cy_cp,
                 g_stats.cy_vr, g_stats.cy_knn50, g_stats.cy_g1,
                 g_stats.cy_nest);
  if (best_score == 0) return 0;

  // restore the best board into the workspace and repair holes
  ws.reset();
  ws.quads = best_quads;
  ws.cellmap = best_cellmap;
  ws.touched = best_touched;
  searcher.fix_missing();

  int written = 0;
  for (int c : ws.touched) {
    int slot = ws.cellmap[c];
    if (slot < 0 || written >= cap) continue;
    for (int j = 0; j < 4; ++j)
      out_quads[written * 4 + j] = gidx[ws.quads[slot][j]];
    ++written;
  }
  return written;
}

// Batched variant: B independent frames with the same layout, fanned
// out across a host thread pool (work-stealing atomic cursor; each
// frame's search state is call-local, so workers share nothing).
// num_threads <= 0 means one worker per hardware thread.
void ag_find_board_batch(const float* px, const float* py,
                         const float* theta, const uint8_t* alive, int b,
                         int n, float spacing_ratio, int max_seeds,
                         int early_exit_score, int num_threads,
                         int32_t* out_quads, int32_t* out_counts, int cap) {
  auto run_one = [&](int i) {
    out_counts[i] =
        ag_find_board(px + (size_t)i * n, py + (size_t)i * n,
                      theta + (size_t)i * n, alive + (size_t)i * n, n,
                      spacing_ratio, max_seeds, early_exit_score,
                      out_quads + (size_t)i * cap * 4, cap);
  };
  if (num_threads <= 0) {
    num_threads = (int)std::thread::hardware_concurrency();
    if (num_threads <= 0) num_threads = 1;
  }
  num_threads = std::min(num_threads, b);
  if (num_threads <= 1) {
    for (int i = 0; i < b; ++i) run_one(i);
    return;
  }
  std::atomic<int> cursor{0};
  auto worker = [&]() {
    for (int i; (i = cursor.fetch_add(1, std::memory_order_relaxed)) < b;)
      run_one(i);
  };
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // extern "C"
