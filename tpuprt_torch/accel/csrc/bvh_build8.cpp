// Host-side binned-SAH builder for the wide (8-ary) skip-link BVH.
//
// Native (C++) scene-compile component replacing the Python LBVH builder's
// Morton-radix splits (tpuprt/accel/bvh_build.py) with surface-area-
// heuristic split positions — the quality bar is the reference's SAH sweep
// (pbrt-v1 accelerators/kdtree.cpp:236-277), rebuilt as a binned
// top-down BVH because the consumer is a packet traversal over
// self-contained 96-float preorder rows (ops/bvh_pallas.py), not a kd
// pointer walk. LBVH split quality was the main weakness on the
// config4_big accelerator workload.
//
// Output format (identical to the Python builder so the Pallas kernel and
// jnp link-walk consume either):
//   row = [lo(3), hi(3), skip, nprims,
//          interior: rank-indexed child preorder ids in cols 8..15 and
//                    split-level axes in cols 16..18;
//          leaf:     8 x 9 inlined triangle vertices in cols 8..79,
//                    8 global prim ids in cols 80..87]       f32[NN, 96]
//
// Structure: binary binned-SAH build (16 bins x 3 axes, leaf at
// count <= leaf_k — the kernel's leaf visit is a constant-cost 8-wide
// unrolled Moller-Trumbore, so fat leaves are strictly cheaper than more
// node visits), then a 3-level collapse into 8-ary wide nodes emitted in
// preorder with threaded skip links (skip = first preorder id after the
// node's subtree).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr int kRowW = 96;

struct BNode {
  float lo[3], hi[3];
  int left = -1, right = -1;  // interior children (-1,-1 for leaf)
  int first = 0, count = 0;   // leaf span into the prim index array
  int axis = 0;               // interior split axis
};

struct Builder {
  int n, nq, nt, leaf_k;
  const float* lo;
  const float* hi;
  const float* tri9;
  std::vector<int> idx;
  std::vector<float> cent;  // [n][3]
  std::vector<BNode> bn;

  int build(int first, int count, int depth = 0) {
    BNode nd;
    nd.lo[0] = nd.lo[1] = nd.lo[2] = 1e30f;
    nd.hi[0] = nd.hi[1] = nd.hi[2] = -1e30f;
    float clo[3] = {1e30f, 1e30f, 1e30f};
    float chi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = first; i < first + count; ++i) {
      const int p = idx[i];
      for (int a = 0; a < 3; ++a) {
        nd.lo[a] = std::min(nd.lo[a], lo[3 * p + a]);
        nd.hi[a] = std::max(nd.hi[a], hi[3 * p + a]);
        clo[a] = std::min(clo[a], cent[3 * p + a]);
        chi[a] = std::max(chi[a], cent[3 * p + a]);
      }
    }
    if (count <= leaf_k) {
      nd.first = first;
      nd.count = count;
      bn.push_back(nd);
      return (int)bn.size() - 1;
    }

    // Binned SAH over centroids, all 3 axes.
    int best_axis = -1, best_bin = -1;
    float best_cost = 1e30f;
    float binlo[3][kBins][3], binhi[3][kBins][3];
    int bincnt[3][kBins];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < kBins; ++b) {
        bincnt[a][b] = 0;
        for (int c = 0; c < 3; ++c) {
          binlo[a][b][c] = 1e30f;
          binhi[a][b][c] = -1e30f;
        }
      }
    }
    float ext[3], inv_ext[3];
    for (int a = 0; a < 3; ++a) {
      ext[a] = chi[a] - clo[a];
      inv_ext[a] = ext[a] > 1e-12f ? (float)kBins / ext[a] : 0.f;
    }
    for (int i = first; i < first + count; ++i) {
      const int p = idx[i];
      for (int a = 0; a < 3; ++a) {
        int b = (int)((cent[3 * p + a] - clo[a]) * inv_ext[a]);
        b = std::min(std::max(b, 0), kBins - 1);
        bincnt[a][b]++;
        for (int c = 0; c < 3; ++c) {
          binlo[a][b][c] = std::min(binlo[a][b][c], lo[3 * p + c]);
          binhi[a][b][c] = std::max(binhi[a][b][c], hi[3 * p + c]);
        }
      }
    }
    auto area = [](const float* blo, const float* bhi) {
      const float d0 = std::max(bhi[0] - blo[0], 0.f);
      const float d1 = std::max(bhi[1] - blo[1], 0.f);
      const float d2 = std::max(bhi[2] - blo[2], 0.f);
      return d0 * d1 + d0 * d2 + d1 * d2;
    };
    for (int a = 0; a < 3; ++a) {
      if (inv_ext[a] == 0.f) continue;
      // Sweep: left-to-right prefix, right-to-left suffix.
      float sl[kBins], sr[kBins];
      int cl[kBins], cr[kBins];
      float acclo[3] = {1e30f, 1e30f, 1e30f};
      float acchi[3] = {-1e30f, -1e30f, -1e30f};
      int acc = 0;
      for (int b = 0; b < kBins; ++b) {
        acc += bincnt[a][b];
        for (int c = 0; c < 3; ++c) {
          acclo[c] = std::min(acclo[c], binlo[a][b][c]);
          acchi[c] = std::max(acchi[c], binhi[a][b][c]);
        }
        cl[b] = acc;
        sl[b] = acc ? area(acclo, acchi) : 0.f;
      }
      for (int c = 0; c < 3; ++c) {
        acclo[c] = 1e30f;
        acchi[c] = -1e30f;
      }
      acc = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        acc += bincnt[a][b];
        for (int c = 0; c < 3; ++c) {
          acclo[c] = std::min(acclo[c], binlo[a][b][c]);
          acchi[c] = std::max(acchi[c], binhi[a][b][c]);
        }
        cr[b] = acc;
        sr[b] = acc ? area(acclo, acchi) : 0.f;
      }
      for (int b = 0; b < kBins - 1; ++b) {
        if (cl[b] == 0 || cr[b + 1] == 0) continue;
        const float cost = sl[b] * cl[b] + sr[b + 1] * cr[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = a;
          best_bin = b;
        }
      }
    }

    int mid;
    if (depth > 60) best_axis = -1;  // lopsided-SAH recursion guard
    if (count <= 256) {
      // Packing-aware tail split: a binary SAH recursion leaves ~6.2
      // tris/leaf (measured on the 1M-tri terrain: 161K leaves where
      // ceil(n/8) = 125K suffice) and every extra leaf is one more
      // constant-cost 8-wide visit in the traversal kernel. Below this
      // threshold, order along the best axis and cut at a multiple of
      // leaf_k so one side packs FULL leaves; leaf count becomes exactly
      // ceil(count / leaf_k) for the whole tail subtree.
      int a = best_axis >= 0 ? best_axis : 0;
      if (best_axis < 0)
        for (int ax = 1; ax < 3; ++ax)
          if (ext[ax] > ext[a]) a = ax;
      const int nleaves = (count + leaf_k - 1) / leaf_k;
      const int left_n = (nleaves / 2) * leaf_k;
      mid = first + (left_n > 0 && left_n < count ? left_n : count / 2);
      std::nth_element(idx.begin() + first, idx.begin() + mid,
                       idx.begin() + first + count,
                       [&](int x, int y) {
                         return cent[3 * x + a] < cent[3 * y + a];
                       });
      nd.axis = a;
      const int me = (int)bn.size();
      bn.push_back(nd);
      const int l = build(first, mid - first, depth + 1);
      const int r = build(mid, first + count - mid, depth + 1);
      bn[me].left = l;
      bn[me].right = r;
      return me;
    }
    if (best_axis < 0) {
      // Degenerate centroids: equal-count split on the widest axis.
      best_axis = 0;
      for (int a = 1; a < 3; ++a)
        if (ext[a] > ext[best_axis]) best_axis = a;
      mid = first + count / 2;
      std::nth_element(idx.begin() + first, idx.begin() + mid,
                       idx.begin() + first + count,
                       [&](int x, int y) {
                         return cent[3 * x + best_axis] <
                                cent[3 * y + best_axis];
                       });
    } else {
      const float split =
          clo[best_axis] + (best_bin + 1) * ext[best_axis] / kBins;
      int* lo_it = idx.data() + first;
      int* hi_it = idx.data() + first + count;
      int* m = std::partition(lo_it, hi_it, [&](int p) {
        return cent[3 * p + best_axis] < split;
      });
      mid = (int)(m - idx.data());
      if (mid == first || mid == first + count) mid = first + count / 2;
    }
    nd.axis = best_axis;
    const int me = (int)bn.size();
    bn.push_back(nd);
    const int l = build(first, mid - first, depth + 1);
    const int r = build(mid, first + count - mid, depth + 1);
    bn[me].left = l;
    bn[me].right = r;
    return me;
  }
};

// Wide collapse: descendants of `b` at binary depth 3 (or earlier leaves)
// become the wide node's children; rank bits record the side taken at each
// level (level 0 = bit 2 .. level 2 = bit 0 — matches the Python builder
// and the stack kernel's Z-order descent).
struct WideChild {
  int bnode;
  int rank;
};

void collect_wide(const std::vector<BNode>& bn, int b, int depth, int rank,
                  int axes[3], std::vector<WideChild>& out) {
  const BNode& nd = bn[b];
  if (depth == 3 || nd.left < 0) {
    out.push_back({b, rank});
    return;
  }
  axes[depth] = nd.axis;
  collect_wide(bn, nd.left, depth + 1, rank, axes, out);
  collect_wide(bn, nd.right, depth + 1, rank | (4 >> depth), axes, out);
}

int wide_count(const std::vector<BNode>& bn, int b) {
  const BNode& nd = bn[b];
  if (nd.left < 0) return 1;
  int axes[3] = {0, 0, 0};
  std::vector<WideChild> kids;
  collect_wide(bn, b, 0, 0, axes, kids);
  int total = 1;
  for (const auto& k : kids) total += wide_count(bn, k.bnode);
  return total;
}

struct Emitter {
  const std::vector<BNode>* bn;
  const std::vector<int>* idx;
  const float* tri9;
  int nq, leaf_k;
  float* rows;
  int* prim_ids;
  int counter = 0;

  int emit(int b, int skip) {
    const BNode& nd = (*bn)[b];
    const int me = counter++;
    float* row = rows + (size_t)me * kRowW;
    std::memset(row, 0, kRowW * sizeof(float));
    for (int a = 0; a < 3; ++a) {
      row[a] = nd.lo[a];
      row[3 + a] = nd.hi[a];
    }
    row[6] = (float)skip;
    if (nd.left < 0) {  // leaf
      row[7] = (float)nd.count;
      for (int j = 0; j < nd.count; ++j) {
        const int gid = (*idx)[nd.first + j];
        prim_ids[(size_t)me * leaf_k + j] = gid;
        row[80 + j] = (float)gid;
        if (gid >= nq)
          std::memcpy(row + 8 + 9 * j, tri9 + (size_t)(gid - nq) * 9,
                      9 * sizeof(float));
      }
      for (int j = nd.count; j < leaf_k; ++j)
        prim_ids[(size_t)me * leaf_k + j] = -1;
      return 1;
    }
    int axes[3] = {0, 0, 0};
    std::vector<WideChild> kids;
    collect_wide(*bn, b, 0, 0, axes, kids);
    for (int j = 0; j < 8; ++j) row[8 + j] = -1.f;
    for (int a = 0; a < 3; ++a) row[16 + a] = (float)axes[a];
    std::vector<int> sizes(kids.size());
    for (size_t i = 0; i < kids.size(); ++i)
      sizes[i] = wide_count(*bn, kids[i].bnode);
    int child_id = me + 1;
    int total = 1;
    for (size_t i = 0; i < kids.size(); ++i) {
      const int child_skip =
          (i + 1 < kids.size()) ? child_id + sizes[i] : skip;
      row[8 + kids[i].rank] = (float)child_id;
      emit(kids[i].bnode, child_skip);
      child_id += sizes[i];
      total += sizes[i];
    }
    return total;
  }
};

}  // namespace

extern "C" {

// Build the wide skip-link BVH over n prim AABBs with binned-SAH splits.
//   lo/hi:   [n][3] prim bounds (global prim id order: quadrics then tris)
//   tri9:    [nt][9] packed world-space triangle vertices
//   rows:    out f32[rows_cap][96]; prim_ids: out i32[rows_cap][leaf_k]
// Returns the number of wide nodes written, or -1 if rows_cap too small
// (caller retries with a larger buffer).
int tpuprt_bvh_build8(int n, const float* lo, const float* hi, int nq,
                      int nt, const float* tri9, int leaf_k, float* rows,
                      int rows_cap, int* prim_ids) {
  if (n <= 0) return 0;
  Builder bd;
  bd.n = n;
  bd.nq = nq;
  bd.nt = nt;
  bd.leaf_k = leaf_k;
  bd.lo = lo;
  bd.hi = hi;
  bd.tri9 = tri9;
  bd.idx.resize(n);
  bd.cent.resize(3 * (size_t)n);
  for (int i = 0; i < n; ++i) {
    bd.idx[i] = i;
    for (int a = 0; a < 3; ++a)
      bd.cent[3 * (size_t)i + a] = 0.5f * (lo[3 * i + a] + hi[3 * i + a]);
  }
  bd.bn.reserve(2 * (size_t)n / leaf_k + 16);
  const int root = bd.build(0, n);
  const int nn = wide_count(bd.bn, root);
  if (nn > rows_cap) return -1;
  Emitter em;
  em.bn = &bd.bn;
  em.idx = &bd.idx;
  em.tri9 = tri9;
  em.nq = nq;
  em.leaf_k = leaf_k;
  em.rows = rows;
  em.prim_ids = prim_ids;
  em.emit(root, nn);
  return em.counter == nn ? nn : -2;
}

}  // extern "C"
