// Nearest / any-hit traversal of the row-format skip-link BVH, for one
// scene BVH and for the instanced prototype BLAS tables.
//
// Replaces the TPU kernels of tpuprt/ops/bvh_pallas.py:
//   bvh_rows_kernel      <- traverse (:457, _kernel, the whole table) and
//                           traverse_chunked (:558, _kernel_chunked, 8192-row
//                           chunks): the table sits in device memory at any
//                           size, so one kernel walks [0, NN) for any NN;
//   bvh_instanced_kernel <- traverse_instanced (:1182, _kernel_instanced).
// Both have the semantics of _walk_range (bvh_pallas.py:73-179).
//
// Contract (the reference's): rows f32[NNpad,128] = [lo xyz, hi xyz, skip,
// nprims, interior: the children's preorder ids by slot in cols 8..15 (-1
// = empty slot; slots in preorder), leaf: 8 x (p0, p1, p2) xyz (cols
// 8..79), 8 prim ids (cols 80..87)], ids in f32 (exact below 2^24); rays
// f32[8,N] = o xyz, d xyz, mint, maxt (an empty window mint > maxt hits
// nothing). Output t f32[N], id i32[N] (-1 = miss), and for the instanced
// walk the instance i32[N].
//
// Kept for id parity with the reference: the slab window clipped at
// min(maxt, best_t) * (1 + 1e-6); leaf slot j valid only for j < nprims
// and pid >= 0 (rows of later prototypes carry -1 + t_ofs >= 0 in unused
// slots); the strict t < best_t update in slot order, so the first slot
// wins at equal t (leaf_test). Built with -fmad=false so every product and
// sum rounds as the plain torch version's separate ops do.
//
// Row walk (bvh_rows_kernel): one thread per ray, a descent driven by the
// parent's hit mask, in preorder. An entered node's own box passes the
// slab test against the best so far. An entered interior node reads its
// children's ids from its own cols 8..15 (the 64-byte line its box is in)
// and their boxes from their own rows (cols 0-5, up to 8 loads that do
// not depend on each other), slab-tests them, pushes (node << 8) | the
// slots still to enter, and goes to the lowest hit slot; after a leaf or
// an empty mask it pops the deepest entry's next slot, whose id it reads
// again from the parent's row. A child is tested again on entry, against
// the best at that moment: best_t only falls, the slab test is monotone
// in it, so a child that fails at the parent fails at entry too, and
// entry is exactly the skip-link walk's per-visit test. The walk
// therefore enters the same nodes in the same order as the skip-link walk
// of traverse_rows_ref and takes the same hits, bit for bit. The stack
// takes trees of any depth: kLocalLevels (32) levels in local memory,
// which hold every tree accel/bvh_build8.cpp can build (its recursion
// guard bounds the wide depth near 28), and past them a scratch tensor
// the wrapper sizes from the tree's recorded depth
// (ops/bvh_cuda.rows_stack_scratch). A push past the stack's capacity
// (a depth the wrapper was not told) traps instead of writing past it.
//
// Instanced walk: each thread walks a top-level BVH over the E entries
// (instance, prototype block): skip-link rows f32[NN_top,16] = [lo xyz,
// hi xyz, skip, nprims, 8 entry ids] (accel/instances.build_top), with
// the same slab test and skip logic. At a leaf each listed entry's own
// world box is tested against the current window; for an entry that
// passes, the ray moves into object space by the instance's w2o rows
// (direction not renormalized, so t stays the world t) and walks the
// block's node range at row entry_block * cap + (node - start). Entries
// are visited out of their table order, which defines the result
// (the earliest entry wins at equal t), so a walk into entry e may also
// take its first hit at exactly the best t when e is below the best's
// entry (eq_first of walk_range); inside one entry the strict < in slot
// order stays. The entry and instance of the best follow the walk's "hit
// taken" flag. A node or entry box that holds a hit at the best t passes
// the clip at best_t * (1 + 1e-6), and a node's box contains its
// entries' boxes (the builder's min/max are exact; the slab test is
// monotone in the box), so no hit that could win is pruned.
//
// What bounds it on this card. Both walks: the dependent load chain per
// thread and the scattered row reads of a warp (the rays of a warp read
// different rows; the main BVH's front end sorts the rays so that
// neighbours take similar paths). The row walk's descent enters 3.5 nodes
// per camera ray of config4_big where the skip-link walk it replaces
// tested 20.2 boxes one dependent load after another, but it reads as
// many rows: the row format keeps a node's children's boxes in the
// children's own rows, so an entered interior node still reads every
// child's first 32 bytes (8 scattered loads, in parallel now), and a pop
// reads the popped child's columns again. Its device time is therefore
// close to the skip-link walk's on config4_big and 14% above it on the
// 1M-triangle terrain (PERF.md), where the tile walk, whose children's
// boxes sit in the parent's row, gains a third. Reading the child ids
// from a separate table instead of the row's cols 8..15 took the same
// time. Pushing each child on the stack instead of the parent's mask,
// carrying the first child's columns down, and skipping the re-test while
// the best is unchanged all ran slower, and are not done. The instanced
// walk visits O(log E) top-level nodes and the few entries whose box meets
// the ray's window, where the previous design slab-tested all E entry
// boxes for every ray; its walks behind the tests are short (one 2048-row
// block per entry). That halves the walk's device time in the rocks
// render (PERF.md). The lanes of a warp may enter different entries' walks
// one after another, which the previous design's lock-step entry order
// avoided, so incoherent shadow rays gain less; sorting the rays did not
// pay.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
constexpr int kLeafK = 8;
constexpr int kTopCols = 16;
// Stack levels of the row walk's descent held in local memory; a deeper
// tree's further levels go to the wrapper's scratch.
constexpr int kLocalLevels = 32;
constexpr float kBig = (float)1e30;
constexpr float kTiny = (float)1e-12;
constexpr float kClip = (float)(1.0 + 1e-6);

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -kTiny : kTiny;
  return 1.0f / (fabsf(v) < kTiny ? tiny : v);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, mint, maxt;
};

// Slab test of box [lo, hi] against the ray's window [mint, clip].
__device__ __forceinline__ bool slab(const Ray& r, float lox, float loy,
                                     float loz, float hix, float hiy,
                                     float hiz, float best_t) {
  const float tx0 = (lox - r.ox) * r.ix, tx1 = (hix - r.ox) * r.ix;
  const float ty0 = (loy - r.oy) * r.iy, ty1 = (hiy - r.oy) * r.iy;
  const float tz0 = (loz - r.oz) * r.iz, tz1 = (hiz - r.oz) * r.iz;
  const float t0 = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fmaxf(fminf(tz0, tz1), r.mint));
  const float t1 =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
            fminf(fmaxf(tz0, tz1), fminf(r.maxt, best_t) * kClip));
  return t0 <= t1;
}

// The 8 Moller-Trumbore tests of the leaf at `row` (cols 8..79: 8 x (p0,
// p1, p2) xyz, cols 80..87: ids), in slot order against the running best:
// slot j is valid only for j < nprims and pid >= 0, and replaces the best
// when strictly nearer (with eq_first, also the first hit at exactly
// best_t). Returns whether it took a hit.
__device__ __forceinline__ bool leaf_test(const float4* __restrict__ row,
                                          int nprims, const Ray& r,
                                          int any_hit, float& best_t,
                                          int& best_id, bool eq_first) {
  bool taken = false;
  float v[80];  // cols 8..87: 8 triangles x 9 floats, then 8 ids
#pragma unroll
  for (int k = 0; k < 20; ++k) {
    const float4 c = __ldg(row + 2 + k);
    v[4 * k] = c.x; v[4 * k + 1] = c.y;
    v[4 * k + 2] = c.z; v[4 * k + 3] = c.w;
  }
#pragma unroll
  for (int j = 0; j < kLeafK; ++j) {
    const float* p = v + 9 * j;
    const int pid = (int)v[72 + j];
    const float e1x = p[3] - p[0], e1y = p[4] - p[1], e1z = p[5] - p[2];
    const float e2x = p[6] - p[0], e2y = p[7] - p[1], e2z = p[8] - p[2];
    const float s1x = r.dy * e2z - r.dz * e2y;
    const float s1y = r.dz * e2x - r.dx * e2z;
    const float s1z = r.dx * e2y - r.dy * e2x;
    const float div = s1x * e1x + s1y * e1y + s1z * e1z;
    const bool ok = fabsf(div) > kTiny;
    const float inv = 1.0f / (ok ? div : 1.0f);
    const float sx = r.ox - p[0], sy = r.oy - p[1], sz = r.oz - p[2];
    const float b1 = (sx * s1x + sy * s1y + sz * s1z) * inv;
    const float s2x = sy * e1z - sz * e1y;
    const float s2y = sz * e1x - sx * e1z;
    const float s2z = sx * e1y - sy * e1x;
    const float b2 = (r.dx * s2x + r.dy * s2y + r.dz * s2z) * inv;
    const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv;
    const bool nearer = t < fminf(r.maxt, best_t) ||
                        (eq_first && t == best_t && t < r.maxt);
    const bool valid = ok && b1 >= 0.0f && b2 >= 0.0f &&
                       b1 + b2 <= 1.0f && t > r.mint && nearer &&
                       j < nprims && pid >= 0 &&
                       !(any_hit && best_id >= 0);
    if (valid) {
      best_t = t;
      best_id = pid;
      taken = true;
      eq_first = false;
    }
  }
  return taken;
}

// Skip-link walk of preorder node ids [start, stop), node n stored at
// rows[(n - start) * kCols]. Updates best_t / best_id in place on a
// strictly nearer hit; with eq_first also on the walk's first hit at
// exactly best_t. Returns whether it took a hit.
__device__ bool walk_range(const float* __restrict__ rows, int start,
                           int stop, const Ray& r, int any_hit,
                           float& best_t, int& best_id, bool eq_first) {
  bool taken = false;
  int node = start;
  while (node < stop && !(any_hit && best_id >= 0)) {
    const float4* row =
        reinterpret_cast<const float4*>(rows + (size_t)(node - start) * kCols);
    const float4 a = __ldg(row), b = __ldg(row + 1);
    const int skip = (int)b.z;
    const int nprims = (int)b.w;
    const bool hit = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best_t);
    if (hit && nprims > 0 &&
        leaf_test(row, nprims, r, any_hit, best_t, best_id, eq_first)) {
      taken = true;
      eq_first = false;
    }
    node = (hit && nprims == 0) ? node + 1 : skip;
  }
  return taken;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int n, int i) {
  Ray r;
  r.ox = rays[i]; r.oy = rays[n + i]; r.oz = rays[2 * n + i];
  r.dx = rays[3 * n + i]; r.dy = rays[4 * n + i]; r.dz = rays[5 * n + i];
  r.mint = rays[6 * n + i]; r.maxt = rays[7 * n + i];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  return r;
}

// Child id of slot r among an interior row's cols 8..15 (a.xyzw, b.xyzw),
// without indexing a local array; <= 0 where the slot is empty (-1).
__device__ __forceinline__ int slot_child(float4 a, float4 b, int r) {
  const float4 v = r < 4 ? a : b;
  const int q = r & 3;
  return (int)(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w);
}

// The descent's stack, one entry a level, (node << 8) | child slots still
// to enter: levels below kLocalLevels in local memory and, in a walk of a
// deeper tree (kDeep), the others in the wrapper's scratch, laid out by
// ray (level L of ray i at (L - kLocalLevels) * n + i).
template <bool kDeep>
struct Stack {
  unsigned local[kLocalLevels];
  unsigned* scratch;
  int n, i;
  __device__ __forceinline__ unsigned get(int level) const {
    return !kDeep || level < kLocalLevels
               ? local[level]
               : scratch[(size_t)(level - kLocalLevels) * n + i];
  }
  __device__ __forceinline__ void set(int level, unsigned v) {
    if (!kDeep || level < kLocalLevels)
      local[level] = v;
    else
      scratch[(size_t)(level - kLocalLevels) * n + i] = v;
  }
};

// `levels`: the stack's capacity, kLocalLevels plus the scratch's rows. A
// tree deeper than the wrapper was told would overflow it: the kernel
// traps, and the launch's error surfaces at the next synchronization.
template <bool kDeep>
__global__ void __launch_bounds__(128)
bvh_rows_kernel(const float* __restrict__ rows,
                const float* __restrict__ rays, int n, int nn, int any_hit,
                int levels, unsigned* __restrict__ scratch,
                float* __restrict__ t_out, int* __restrict__ id_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, n, i);
  float best_t = kBig;
  int best_id = -1;
  Stack<kDeep> stack;
  stack.scratch = scratch;
  stack.n = n;
  stack.i = i;
  int level = 0;
  int node = nn > 0 ? 0 : -1;
  while (node >= 0) {
    const float4* row =
        reinterpret_cast<const float4*>(rows + (size_t)node * kCols);
    const float4 a = __ldg(row), b = __ldg(row + 1);
    const int nprims = (int)b.w;
    int hits = 0;
    float4 c0 = make_float4(-1.0f, -1.0f, -1.0f, -1.0f), c1 = c0;
    // The visit's own test, against the best so far: the parent's mask
    // was taken with a best at least as far, so this re-test makes entry
    // exactly the skip-link walk's per-visit test.
    if (slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best_t)) {
      if (nprims > 0) {
        leaf_test(row, nprims, r, any_hit, best_t, best_id, false);
        if (any_hit && best_id >= 0) break;
      } else {
        // Cols 8..15: the children's ids by slot, in the line of cols 0-7.
        c0 = __ldg(row + 2);
        c1 = __ldg(row + 3);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = slot_child(c0, c1, j);
          if (c <= 0) continue;
          const float4* cr =
              reinterpret_cast<const float4*>(rows + (size_t)c * kCols);
          const float4 ca = __ldg(cr), cb = __ldg(cr + 1);
          if (slab(r, ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, best_t))
            hits |= 1 << j;
        }
      }
    }
    if (hits) {
      const unsigned rest = hits & (hits - 1);
      if (rest) {
        if (level >= levels) __trap();
        stack.set(level++, ((unsigned)node << 8) | rest);
      }
      node = slot_child(c0, c1, __ffs(hits) - 1);
    } else if (level > 0) {
      const unsigned top = stack.get(level - 1);
      const unsigned m = top & 0xffu;
      const unsigned rest = m & (m - 1);
      if (rest)
        stack.set(level - 1, (top & ~0xffu) | rest);
      else
        --level;
      node = (int)__ldg(rows + (size_t)(top >> 8) * kCols + 8 +
                        __ffs(m) - 1);
    } else {
      node = -1;
    }
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
}

__global__ void __launch_bounds__(128)
bvh_instanced_kernel(const float* __restrict__ rows,
                     const float* __restrict__ top, int top_nn,
                     const int* __restrict__ e_block,
                     const int* __restrict__ e_inst,
                     const int* __restrict__ e_start,
                     const int* __restrict__ e_stop,
                     const float* __restrict__ e_bbox,
                     const float* __restrict__ w2o12, int cap,
                     const float* __restrict__ rays, int n, int any_hit,
                     float* __restrict__ t_out, int* __restrict__ id_out,
                     int* __restrict__ inst_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray w = load_ray(rays, n, i);
  float best_t = kBig;
  int best_id = -1, best_inst = -1, best_e = INT_MAX;
  // A ray with an empty window (mint > maxt) hits nothing and tests
  // nothing.
  int node = w.mint <= w.maxt ? 0 : top_nn;
  while (node < top_nn && !(any_hit && best_id >= 0)) {
    const float* row = top + (size_t)node * kTopCols;
    const float4 a = __ldg(reinterpret_cast<const float4*>(row));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
    const int skip = (int)b.z;
    const int nprims = (int)b.w;
    const bool hit = slab(w, a.x, a.y, a.z, a.w, b.x, b.y, best_t);
    for (int j = 0; hit && j < nprims; ++j) {
      if (any_hit && best_id >= 0) break;
      const int e = (int)__ldg(row + 8 + j);
      const float4* bb = reinterpret_cast<const float4*>(e_bbox) + 2 * e;
      const float4 lo = __ldg(bb), hi = __ldg(bb + 1);
      if (!slab(w, lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, best_t)) continue;
      const int inst = __ldg(e_inst + e);
      const float4* m4 = reinterpret_cast<const float4*>(w2o12) + 3 * inst;
      const float4 m0 = __ldg(m4), m1 = __ldg(m4 + 1), m2 = __ldg(m4 + 2);
      const float mm[12] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y,
                            m1.z, m1.w, m2.x, m2.y, m2.z, m2.w};
      Ray o;
      o.ox = mm[0] * w.ox + mm[1] * w.oy + mm[2] * w.oz + mm[3];
      o.oy = mm[4] * w.ox + mm[5] * w.oy + mm[6] * w.oz + mm[7];
      o.oz = mm[8] * w.ox + mm[9] * w.oy + mm[10] * w.oz + mm[11];
      o.dx = mm[0] * w.dx + mm[1] * w.dy + mm[2] * w.dz;
      o.dy = mm[4] * w.dx + mm[5] * w.dy + mm[6] * w.dz;
      o.dz = mm[8] * w.dx + mm[9] * w.dy + mm[10] * w.dz;
      o.ix = safe_inv(o.dx); o.iy = safe_inv(o.dy); o.iz = safe_inv(o.dz);
      o.mint = w.mint;
      o.maxt = w.maxt;
      const float* block = rows + (size_t)__ldg(e_block + e) * cap * kCols;
      if (walk_range(block, __ldg(e_start + e), __ldg(e_stop + e), o,
                     any_hit, best_t, best_id, best_id >= 0 && e < best_e)) {
        best_e = e;
        best_inst = inst;
      }
    }
    node = (hit && nprims == 0) ? node + 1 : skip;
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
  inst_out[i] = best_inst;
}

}  // namespace

// C interface for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
// bvh_rows_launch: `scratch` holds (max_depth - kLocalLevels) * n words
// when the tree is max_depth > kLocalLevels deep (ops/bvh_cuda.
// rows_stack_scratch, whose ROWS_LOCAL_LEVELS is kLocalLevels), and is
// null otherwise.

extern "C" int bvh_rows_launch(const float* rows, const float* rays, int n,
                               int nn, int any_hit, int max_depth,
                               unsigned* scratch, float* t_out, int* id_out,
                               void* stream) {
  if (n > 0) {
    const int block = 128;
    const int grid = (n + block - 1) / block;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (scratch)
      bvh_rows_kernel<true><<<grid, block, 0, st>>>(
          rows, rays, n, nn, any_hit, max_depth, scratch, t_out, id_out);
    else
      bvh_rows_kernel<false><<<grid, block, 0, st>>>(
          rows, rays, n, nn, any_hit, kLocalLevels, scratch, t_out, id_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_instanced_launch(const float* rows, const float* top,
                                    int top_nn, const int* e_block,
                                    const int* e_inst, const int* e_start,
                                    const int* e_stop, const float* e_bbox,
                                    const float* w2o12, int cap,
                                    const float* rays, int n, int any_hit,
                                    float* t_out, int* id_out, int* inst_out,
                                    void* stream) {
  if (n > 0) {
    const int block = 128;
    const int grid = (n + block - 1) / block;
    bvh_instanced_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        rows, top, top_nn, e_block, e_inst, e_start, e_stop, e_bbox, w2o12,
        cap, rays, n, any_hit, t_out, id_out, inst_out);
  }
  return static_cast<int>(cudaGetLastError());
}
