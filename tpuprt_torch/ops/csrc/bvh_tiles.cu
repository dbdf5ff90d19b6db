// Nearest / any-hit traversal of the 8-wide tile-format skip-link BVH.
//
// Replaces the TPU kernels tpuprt/ops/bvh_pallas.py traverse_tiles
// (_kernel_tiles, _walk_tiles) and traverse_tiles_chunked
// (_kernel_tiles_chunked): the node table sits in device memory whatever
// its size, so one kernel serves both contracts (any node count).
//
// Contract (the reference's): tiles f32[NN,128] param-major rows (lanes
// [8k, 8k+8) = param k of the node's 8 slots; interior: child boxes
// lo xyz, hi xyz; leaf: triangles p0 xyz, e1 xyz, e2 xyz, pid), skip
// i32[NN], meta i32[NN] = depth | rank<<5 | nprims<<8, rays f32[8,N] =
// o xyz, d xyz, mint, maxt (a padding ray has mint 1 > maxt -1).
// Output t f32[N], id i32[N] (-1 = miss).
//
// Design: one thread per ray, stackless. The cursor walks preorder node
// ids: a node is entered iff its parent's child test hit it (bit `rank`
// of the mask stored for its depth; the root is always entered); an
// entered interior node slab-tests its 8 child boxes and descends to
// node + 1 when any hit, every other case jumps to skip. Per-thread masks,
// one byte per depth, replace the TPU kernel's per-packet union masks and
// their owner/oend bookkeeping, which existed because a TPU packet shares
// one scalar cursor.
//
// Kept for id parity with the reference: the window clip at
// best_t * (1 + 1e-6) in the slab test, the pid >= 0 guard on empty leaf
// slots, the lowest id winning among equal t inside a leaf, and the strict
// tmin < best_t update. Built with -fmad=false so every product and sum
// rounds as the plain torch version's separate ops do.
//
// What bounds it on this card: divergent node fetches. The rays of a warp
// walk different paths, so each visit reads up to 32 different 512-byte
// rows (a dependent load chain per thread, latency bound, caches shared
// only by rays that happen to agree). Sorting rays by octant + Morton code
// (ops/bvh_cuda.py) keeps neighbours on similar paths. A later version should
// make the warp the unit of work: stage a node row in shared memory once
// per warp-wide visit (packet traversal with per-lane masks), or keep the
// upper levels of the tree in shared memory, and measure against this one.

#include <cuda_runtime.h>

namespace {

constexpr int MAXD = 32;
// Constants rounded exactly as the Python scalars in the plain version are
// (double first, then float).
constexpr float kBig = (float)1e30;
constexpr float kTiny = (float)1e-12;
constexpr float kClip = (float)(1.0 + 1e-6);

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -kTiny : kTiny;
  return 1.0f / (fabsf(v) < kTiny ? tiny : v);
}

__global__ void __launch_bounds__(128)
bvh_tiles_kernel(const float* __restrict__ tiles,
                 const int* __restrict__ skip,
                 const int* __restrict__ meta,
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
  unsigned char masks[MAXD + 1];
  int node = 0;
  while (node < nn && !(any_hit && best_id >= 0)) {
    const int mt = __ldg(meta + node);
    const int depth = mt & 31;
    const int rank = (mt >> 5) & 7;
    const bool leaf = (mt >> 8) > 0;
    const bool entered = depth == 0 || ((masks[depth] >> rank) & 1);
    const float4* row =
        reinterpret_cast<const float4*>(tiles + (size_t)node * 128);
    int next = __ldg(skip + node);
    if (entered && leaf) {
      float p[10][8];  // p0 xyz, e1 xyz, e2 xyz, pid: 8 slots each
#pragma unroll
      for (int k = 0; k < 10; ++k) {
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
    } else if (entered) {
      float b[6][8];  // lo xyz, hi xyz of the 8 children
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float4 a = __ldg(row + 2 * k), c = __ldg(row + 2 * k + 1);
        b[k][0] = a.x; b[k][1] = a.y; b[k][2] = a.z; b[k][3] = a.w;
        b[k][4] = c.x; b[k][5] = c.y; b[k][6] = c.z; b[k][7] = c.w;
      }
      const float tclip = fminf(maxt, best_t) * kClip;
      int hits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float tx0 = (b[0][j] - ox) * ix, tx1 = (b[3][j] - ox) * ix;
        const float ty0 = (b[1][j] - oy) * iy, ty1 = (b[4][j] - oy) * iy;
        const float tz0 = (b[2][j] - oz) * iz, tz1 = (b[5][j] - oz) * iz;
        const float t0 = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                               fmaxf(fminf(tz0, tz1), mint));
        const float t1 = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                               fminf(fmaxf(tz0, tz1), tclip));
        if (t0 <= t1) hits |= 1 << j;
      }
      masks[depth + 1] = (unsigned char)hits;
      if (hits) next = node + 1;
    }
    node = next;
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
}

}  // namespace

// C interface for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int bvh_tiles_launch(const float* tiles, const int* skip,
                                const int* meta, const float* rays, int n,
                                int nn, int any_hit, float* t_out,
                                int* id_out, void* stream) {
  if (n > 0) {
    const int block = 128;
    const int grid = (n + block - 1) / block;
    bvh_tiles_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        tiles, skip, meta, rays, n, nn, any_hit, t_out, id_out);
  }
  return static_cast<int>(cudaGetLastError());
}
