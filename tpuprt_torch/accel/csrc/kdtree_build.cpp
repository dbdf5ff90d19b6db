// Host-side SAH kd-tree builder (a copy of tpuprt's native builder,
// equal to it in everything but comments).
//
// Native (C++) scene-compile component: the analogue of the reference's
// KdTreeAccel construction (pbrt-v1 accelerators/kdtree.cpp:141-311)
// rebuilt for a flat-array output consumed by the kd-restart walk
// (tpuprt_torch/accel/kdtree.py). Same algorithmic ingredients — per-axis sorted
// bound-edge sweep, SAH cost with empty-space bonus, retry axes, bad-refine
// bailout, depth cap 8 + 1.3 log2(N) — but organised as an iterative
// worklist over index spans writing four SoA node columns instead of packed
// 8-byte nodes, because the consumer is a SIMD gather loop, not a pointer
// walk.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Edge {
  float t;
  int prim;
  bool start;
};

struct Task {
  float blo[3];    // node bounds
  float bhi[3];
  int first, count;  // span into the per-task prim scratch
  int depth;
  int bad_refines;
  int patch;  // parent node whose node_above <- this task's node id (-1: none)
};

inline float surface_area(const float lo[3], const float hi[3]) {
  float d0 = hi[0] - lo[0], d1 = hi[1] - lo[1], d2 = hi[2] - lo[2];
  return 2.f * (d0 * d1 + d0 * d2 + d1 * d2);
}

}  // namespace

extern "C" {

// Returns number of nodes written, or -1 if out_cap/idx_cap too small.
// Inputs:  n prim AABBs (lo/hi, row-major [n][3]).
// Params:  isect_cost=80, trav_cost=1, empty_bonus=0.5, max_prims=1,
//          max_depth<=0 -> 8 + 1.3 log2 N  (reference defaults,
//          accelerators/kdtree.cpp:489-498).
// Outputs: node_flags  (0/1/2 = split axis, 3 = leaf)
//          node_split  (split position; unused for leaves)
//          node_above  (interior: index of above child — below child is
//                       node+1; leaf: offset into prim_ids)
//          node_nprims (leaf primitive count; 0 for interior)
//          prim_ids    (concatenated leaf prim lists)
//          out_counts  [0]=n_nodes, [1]=n_prim_ids, [2]=max_leaf_prims,
//                      [3]=max depth reached
int tpuprt_kdtree_build(int n, const float* lo, const float* hi,
                        float isect_cost, float trav_cost, float empty_bonus,
                        int max_prims, int max_depth,
                        int32_t* node_flags, float* node_split,
                        int32_t* node_above, int32_t* node_nprims,
                        int32_t* prim_ids, int node_cap, int idx_cap,
                        int32_t* out_counts) {
  if (n <= 0) return -1;
  if (max_depth <= 0)
    max_depth = (int)std::round(8.0 + 1.3 * std::log2((double)n));
  if (max_depth > 60) max_depth = 60;

  int n_nodes = 0, n_ids = 0, max_leaf = 0, max_depth_seen = 0;

  // Worklist of spans into a shared prim-index pool. Children spans are
  // appended to the pool; completed spans are never revisited, so the pool
  // only grows (bounded in practice by O(N log N) duplicated straddlers).
  std::vector<int> pool(lo, lo + 0);  // empty, just to size later
  pool.reserve((size_t)n * 4);
  for (int i = 0; i < n; ++i) pool.push_back(i);

  std::vector<Task> stack;
  {
    Task root;
    root.patch = -1;
    for (int a = 0; a < 3; ++a) {
      float mn = 1e30f, mx = -1e30f;
      for (int i = 0; i < n; ++i) {
        mn = std::min(mn, lo[i * 3 + a]);
        mx = std::max(mx, hi[i * 3 + a]);
      }
      root.blo[a] = mn;
      root.bhi[a] = mx;
    }
    root.first = 0;
    root.count = n;
    root.depth = 0;
    root.bad_refines = 0;
    stack.push_back(root);
  }
  if (node_cap < 1) return -1;

  std::vector<Edge> edges;
  std::vector<int> below_tmp, above_tmp;

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    // Preorder node allocation: the below child is pushed last, popped
    // next, and therefore numbered node+1; the above child's id becomes
    // known only after the below subtree drains, so it patches its parent
    // on pop (the recursion order of kdtree.cpp:300-311, flattened).
    if (n_nodes >= node_cap) return -1;
    const int node = n_nodes++;
    if (t.patch >= 0) node_above[t.patch] = node;
    max_depth_seen = std::max(max_depth_seen, t.depth);
    const int* prims = pool.data() + t.first;
    int np = t.count;

    auto make_leaf = [&]() -> bool {
      if (n_ids + np > idx_cap) return false;
      node_flags[node] = 3;
      node_split[node] = 0.f;
      node_above[node] = n_ids;
      node_nprims[node] = np;
      // NOTE: `prims` may dangle if pool reallocated — copy via offset.
      for (int i = 0; i < np; ++i) prim_ids[n_ids + i] = pool[t.first + i];
      n_ids += np;
      max_leaf = std::max(max_leaf, np);
      return true;
    };

    if (np <= max_prims || t.depth >= max_depth) {
      if (!make_leaf()) return -1;
      continue;
    }

    // SAH sweep: best (axis, edge) minimizing cost, retrying other axes
    // when an axis yields no valid split.
    float inv_total_sa = 1.f / std::max(surface_area(t.blo, t.bhi), 1e-30f);
    float d[3] = {t.bhi[0] - t.blo[0], t.bhi[1] - t.blo[1],
                  t.bhi[2] - t.blo[2]};
    float best_cost = 1e30f;
    int best_axis = -1;
    float best_t = 0.f;
    float old_cost = isect_cost * (float)np;

    int axis0 = 0;  // longest extent first
    if (d[1] > d[axis0]) axis0 = 1;
    if (d[2] > d[axis0]) axis0 = 2;

    int best_nb = 0, best_na = 0;
    for (int attempt = 0; attempt < 3; ++attempt) {
      int axis = (axis0 + attempt) % 3;
      edges.clear();
      edges.reserve((size_t)np * 2);
      for (int i = 0; i < np; ++i) {
        int p = pool[t.first + i];
        edges.push_back({lo[p * 3 + axis], p, true});
        edges.push_back({hi[p * 3 + axis], p, false});
      }
      // Starts sort before ends at ties (BoundEdge START(0) < END(1)).
      std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
        if (a.t == b.t) return (int)a.start > (int)b.start;
        return a.t < b.t;
      });
      int n_below = 0, n_above = np;
      for (size_t i = 0; i < edges.size(); ++i) {
        if (!edges[i].start) --n_above;
        float et = edges[i].t;
        if (et > t.blo[axis] && et < t.bhi[axis]) {
          int o0 = (axis + 1) % 3, o1 = (axis + 2) % 3;
          float sa_b = 2.f * (d[o0] * d[o1] +
                              (et - t.blo[axis]) * (d[o0] + d[o1]));
          float sa_a = 2.f * (d[o0] * d[o1] +
                              (t.bhi[axis] - et) * (d[o0] + d[o1]));
          float pb = sa_b * inv_total_sa, pa = sa_a * inv_total_sa;
          float eb = (n_above == 0 || n_below == 0) ? empty_bonus : 0.f;
          float cost = trav_cost +
                       isect_cost * (1.f - eb) * (pb * n_below + pa * n_above);
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_t = et;
            best_nb = n_below;
            best_na = n_above;
          }
        }
        if (edges[i].start) ++n_below;
      }
      if (best_axis != -1) break;
    }

    int bad = t.bad_refines;
    if (best_cost > old_cost) ++bad;
    if ((best_cost > 4.f * old_cost && np < 16) || best_axis == -1 ||
        bad == 3) {
      if (!make_leaf()) return -1;
      continue;
    }

    // Partition prims by the chosen plane (kdtree.cpp:292-299): straddlers
    // to both sides; planar prims exactly on the plane go below. Empty
    // children are legitimate — the empty-space bonus rewards them.
    below_tmp.clear();
    above_tmp.clear();
    for (int i = 0; i < np; ++i) {
      int p = pool[t.first + i];
      if (lo[p * 3 + best_axis] < best_t || hi[p * 3 + best_axis] <= best_t)
        below_tmp.push_back(p);
      if (hi[p * 3 + best_axis] > best_t) above_tmp.push_back(p);
    }
    (void)best_nb;
    (void)best_na;

    node_flags[node] = best_axis;
    node_split[node] = best_t;
    node_nprims[node] = 0;

    Task below, above;
    std::memcpy(below.blo, t.blo, sizeof t.blo);
    std::memcpy(below.bhi, t.bhi, sizeof t.bhi);
    below.bhi[best_axis] = best_t;
    std::memcpy(above.blo, t.blo, sizeof t.blo);
    std::memcpy(above.bhi, t.bhi, sizeof t.bhi);
    above.blo[best_axis] = best_t;

    below.patch = -1;   // below == node+1 by pop order
    above.patch = node;
    below.depth = above.depth = t.depth + 1;
    below.bad_refines = above.bad_refines = bad;

    below.first = (int)pool.size();
    below.count = (int)below_tmp.size();
    pool.insert(pool.end(), below_tmp.begin(), below_tmp.end());
    above.first = (int)pool.size();
    above.count = (int)above_tmp.size();
    pool.insert(pool.end(), above_tmp.begin(), above_tmp.end());

    // Depth-first with the below child processed next so that
    // below_node == t.node + 1 holds: push above first.
    stack.push_back(above);
    stack.push_back(below);
  }

  out_counts[0] = n_nodes;
  out_counts[1] = n_ids;
  out_counts[2] = max_leaf;
  out_counts[3] = max_depth_seen;
  return n_nodes;
}

}  // extern "C"
