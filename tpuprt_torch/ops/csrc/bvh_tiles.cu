// Nearest / any-hit traversal of the 8-wide tile-format BVH.
//
// Replaces the TPU kernels tpuprt/ops/bvh_pallas.py traverse_tiles
// (_kernel_tiles, _walk_tiles) and traverse_tiles_chunked
// (_kernel_tiles_chunked): the node table sits in device memory whatever
// its size, so one kernel serves both contracts (any node count).
//
// Contract (the reference's tables plus the port's child-id table): tiles
// f32[NN,128] param-major rows (lanes [8k, 8k+8) = param k of the node's
// 8 slots; interior: child boxes lo xyz, hi xyz; leaf: triangles p0 xyz,
// e1 xyz, e2 xyz, pid), child i32[NN,8] (accel/bvh_build.child_table:
// [n, r] = n's child of rank r, -1 where there is none; a leaf's row is
// all -1), rays f32[8,N] = o xyz, d xyz, mint, maxt (a padding ray has
// mint 1 > maxt -1). Output t f32[N], id i32[N] (-1 = miss). The tree is
// at most MAX_TILE_DEPTH (32) deep: build_tiles rejects deeper ones.
//
// Design: one thread per ray, a descent driven by the parent's hit mask,
// in preorder. The root is always entered. An entered interior node
// slab-tests its 8 child boxes (params 0-5 of its row) and reads its child
// ids; the walk enters the child of the lowest hit among its real children
// (child[node][ffs - 1]) and, when other hits remain, pushes (node << 8) |
// those bits on a per-thread stack, one entry a level. After a leaf (which
// alone reads params 6-9), or an interior node whose mask is empty, it
// pops: the deepest entry's lowest bit gives the next child, and an entry
// with no bits left is dropped. So the walk loads only the nodes it
// enters, in the order the reference's skip-link cursor entered them (a
// node is entered iff its parent's test hit it), and takes the same hits:
// the results are bit-identical to the cursor walk of traverse_tiles_ref.
// Depth is the stack level and rank the bit, so the walk reads neither
// skip nor meta. The stack (32 words) lives in local memory; a push
// past it (a child table deeper than the tiles allow) traps.
//
// Kept for id parity with the reference: the window clip at
// best_t * (1 + 1e-6) in the slab test, the pid >= 0 guard on empty leaf
// slots, the lowest id winning among equal t inside a leaf, the strict
// tmin < best_t update, and the any-hit exit after the first leaf that
// hits. Built with -fmad=false so every product and sum rounds as the
// plain torch version's separate ops do.
//
// What bounds it on this card: the dependent load chain per thread and
// the scattered row reads of a warp. Each entered node is one row read
// (its child ids beside it) whose address depends on the previous step;
// the rays of a warp read different rows, so each 16-byte load of a warp
// touches up to 32 lines. Sorting rays by octant + Morton code
// (ops/bvh_cuda.py) keeps neighbours on similar paths. The previous design,
// a stackless cursor over every preorder node reading meta and skip at
// each, took 15.8 steps per camera ray of config4_big where this one
// enters 4.4 nodes, and about half again this design's device time
// (PERF.md). Staging the top three levels in shared memory, in a
// persistent grid, ran slower than reading them through the caches, and
// is not done.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDepth = 32;  // stack levels; build_tiles rejects deeper
// Constants rounded exactly as the Python scalars in the plain version are
// (double first, then float).
constexpr float kBig = (float)1e30;
constexpr float kTiny = (float)1e-12;
constexpr float kClip = (float)(1.0 + 1e-6);

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -kTiny : kTiny;
  return 1.0f / (fabsf(v) < kTiny ? tiny : v);
}

// Entry r of the 8 ids a.xyzw, b.xyzw, without indexing a local array.
__device__ __forceinline__ int pick(int4 a, int4 b, int r) {
  const int4 v = r < 4 ? a : b;
  const int q = r & 3;
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Bit j set where id j of a.xyzw, b.xyzw names a child.
__device__ __forceinline__ int real_children(int4 a, int4 b) {
  return (a.x >= 0) | (a.y >= 0) << 1 | (a.z >= 0) << 2 | (a.w >= 0) << 3 |
         (b.x >= 0) << 4 | (b.y >= 0) << 5 | (b.z >= 0) << 6 |
         (b.w >= 0) << 7;
}

__global__ void __launch_bounds__(128)
bvh_tiles_kernel(const float* __restrict__ tiles,
                 const int* __restrict__ child,
                 const float* __restrict__ rays, int n, int nn, int any_hit,
                 float* __restrict__ t_out, int* __restrict__ id_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx = rays[3 * n + i], dy = rays[4 * n + i],
              dz = rays[5 * n + i];
  const float mint = rays[6 * n + i], maxt = rays[7 * n + i];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  float best_t = kBig;
  int best_id = -1;
  unsigned stack[kMaxDepth];  // (node << 8) | child bits still to enter
  int level = 0;
  int node = nn > 0 ? 0 : -1;
  while (node >= 0) {
    const int4* ids = reinterpret_cast<const int4*>(child) + 2 * node;
    const int4 c0 = __ldg(ids), c1 = __ldg(ids + 1);
    const float4* row =
        reinterpret_cast<const float4*>(tiles + (size_t)node * 128);
    // Params 0-5: an interior node's child boxes; a leaf reads 6-9 too.
    float p[10][8];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float4 a = __ldg(row + 2 * k), b = __ldg(row + 2 * k + 1);
      p[k][0] = a.x; p[k][1] = a.y; p[k][2] = a.z; p[k][3] = a.w;
      p[k][4] = b.x; p[k][5] = b.y; p[k][6] = b.z; p[k][7] = b.w;
    }
    int hits = 0;
    if (c0.x < 0) {
      // Leaf: 8 Moller-Trumbore tests (p0, e1, e2, pid).
#pragma unroll
      for (int k = 6; k < 10; ++k) {
        const float4 a = __ldg(row + 2 * k), b = __ldg(row + 2 * k + 1);
        p[k][0] = a.x; p[k][1] = a.y; p[k][2] = a.z; p[k][3] = a.w;
        p[k][4] = b.x; p[k][5] = b.y; p[k][6] = b.z; p[k][7] = b.w;
      }
      const float tmax = fminf(maxt, best_t);
      float tv[8];
      float tmin = kBig;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e1x = p[3][j], e1y = p[4][j], e1z = p[5][j];
        const float e2x = p[6][j], e2y = p[7][j], e2z = p[8][j];
        const float s1x = dy * e2z - dz * e2y;
        const float s1y = dz * e2x - dx * e2z;
        const float s1z = dx * e2y - dy * e2x;
        const float div = s1x * e1x + s1y * e1y + s1z * e1z;
        const bool ok = fabsf(div) > kTiny;
        const float inv = 1.0f / (ok ? div : 1.0f);
        const float sx = ox - p[0][j], sy = oy - p[1][j], sz = oz - p[2][j];
        const float b1 = (sx * s1x + sy * s1y + sz * s1z) * inv;
        const float s2x = sy * e1z - sz * e1y;
        const float s2y = sz * e1x - sx * e1z;
        const float s2z = sx * e1y - sy * e1x;
        const float b2 = (dx * s2x + dy * s2y + dz * s2z) * inv;
        const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv;
        const bool valid = ok && b1 >= 0.0f && b2 >= 0.0f &&
                           b1 + b2 <= 1.0f && t > mint && t < tmax &&
                           p[9][j] >= 0.0f && !(any_hit && best_id >= 0);
        tv[j] = valid ? t : kBig;
        tmin = fminf(tmin, tv[j]);
      }
      float idmin = kBig;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (tv[j] < kBig && tv[j] <= tmin) idmin = fminf(idmin, p[9][j]);
      if (tmin < best_t) {
        best_t = tmin;
        best_id = (int)idmin;
      }
      if (any_hit && best_id >= 0) break;
    } else {
      // Interior: slab tests of the 8 child boxes.
      const float tclip = fminf(maxt, best_t) * kClip;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float tx0 = (p[0][j] - ox) * ix, tx1 = (p[3][j] - ox) * ix;
        const float ty0 = (p[1][j] - oy) * iy, ty1 = (p[4][j] - oy) * iy;
        const float tz0 = (p[2][j] - oz) * iz, tz1 = (p[5][j] - oz) * iz;
        const float t0 = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                               fmaxf(fminf(tz0, tz1), mint));
        const float t1 = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                               fminf(fmaxf(tz0, tz1), tclip));
        if (t0 <= t1) hits |= 1 << j;
      }
      // An empty slot's inverted box spans every slab: only real
      // children count.
      hits &= real_children(c0, c1);
    }
    if (hits) {
      // Enter the lowest hit; the others wait on the stack with their
      // parent.
      const unsigned rest = hits & (hits - 1);
      if (rest) {
        if (level >= kMaxDepth) __trap();  // a child table deeper than 32
        stack[level++] = ((unsigned)node << 8) | rest;
      }
      node = pick(c0, c1, __ffs(hits) - 1);
    } else if (level > 0) {
      // Pop: the deepest entry's lowest bit; an entry with none left goes.
      const unsigned top = stack[level - 1];
      const unsigned m = top & 0xffu;
      const unsigned rest = m & (m - 1);
      if (rest)
        stack[level - 1] = (top & ~0xffu) | rest;
      else
        --level;
      node = __ldg(child + 8 * (top >> 8) + __ffs(m) - 1);
    } else {
      node = -1;
    }
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
}

}  // namespace

// C interface for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int bvh_tiles_launch(const float* tiles, const int* child,
                                const float* rays, int n, int nn,
                                int any_hit, float* t_out, int* id_out,
                                void* stream) {
  if (n > 0) {
    const int block = 128;
    const int grid = (n + block - 1) / block;
    bvh_tiles_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        tiles, child, rays, n, nn, any_hit, t_out, id_out);
  }
  return static_cast<int>(cudaGetLastError());
}
