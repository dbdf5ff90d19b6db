// Nearest (or first) hit of N rays over T triangles, all pairs
// (Moller-Trumbore).
//
// Replaces the TPU kernel tpuprt/ops/mt_pallas.py mt_best (_kernel): the
// dense brute-force test a scene without an accelerator runs for every
// camera and shadow ray.
//
// Contract (the reference's): rays f32[8,N] = o xyz, d xyz, mint, maxt;
// triangles f32[9,T] = v0 xyz, e1 xyz, e2 xyz (e1 = v1 - v0, e2 = v2 - v0),
// rows of T floats. Output t f32[N] (1e30 = miss), id i32[N] (-1 = miss).
// A pair is a hit when |div| > 1e-12, b1 >= 0, b2 >= 0, b1 + b2 <= 1 and
// mint < t < maxt (shapes/trianglemesh.cpp:213-278); the window is never
// clipped while the loop runs. Nearest mode: among equal t the lowest
// triangle index wins, as the TPU kernel's argmin-then-strict-< order gives.
// Any-hit mode: the lowest-index hit of each ray (its t and id); a ray stops
// there. The ragged ends are masked here: neither N nor T is padded.
//
// Design. One thread per ray. The block stages triangles in tiles of
// kTile (9 floats padded to 12: three 16-byte loads; the tile padded with
// zero triangles, never a hit, to a multiple of kTris) in shared memory;
// every thread reads the same triangle at once (a broadcast). A thread
// keeps its (best_t, best_id) in registers and replaces it only on a
// strictly smaller t, in triangle order. Nothing crosses blocks: no
// atomics, no second pass. Rays with an empty window (mint > maxt: the
// pool's lanes with nothing to trace) test nothing; for any-hit calls the
// front end (mt_cuda.intersect_packed) sorts them last, so blocks of them
// skip the loop. In any-hit mode a ray stops at its first hit and a block leaves
// the triangle loop once all its rays have one (__syncthreads_and at the
// tile barrier).
//
// Staged rejects, exact. Stage 1 forms div = (d x e2) . e1 and b1's
// numerator n1 = (o - v0) . (d x e2) for kTris triangles at once, as one
// straight-line block with no branch, so the compiler interleaves the
// kTris independent chains. A pair goes on only while the full rule could
// still accept it: stage 1 drops it on !ok or when b1 is settled negative;
// behind one branch, stage 2 forms s2 = (o - v0) x e1, b2's numerator d .
// s2 and t's e2 . s2, and drops the pair when b2 is settled negative or
// when mint >= 0 and t is; behind a second branch, the IEEE reciprocal is
// taken and b1, b2, t are formed from the same numerators, so a surviving
// pair's arithmetic is bit for bit the one-step version's. "Settled
// negative" (mt_cuda.neg_settled) means num with div's sign bit folded in
// is <= -kNumMin while |div| <= kDivMax. The argument: ok gives |div| >
// 1e-12, so inv = fl(1/div) has div's sign and, with |div| <= 1e20, |inv|
// >= 1e-20; then |num * inv| >= 1e-40, far above half the least subnormal
// (2^-150), so the rounded product is nonzero with the sign of num * div,
// i.e. < 0, and b >= 0 (or t > mint >= 0) fails. Without the guards a
// product could round to -0, and -0 >= 0 holds: a pair the signs would
// drop could pass. Zero or NaN numerators and |div| > 1e20 fail the guard
// and take the full test. The strict <, and so the tie rule, are those of
// the one-step kernel.
//
// What bounds it on this card: operations, issued one instruction each.
// The triangles (36 bytes each) are read once per block from L2 and the
// rays once from memory; a pair costs 24 float operations when stage 1
// drops it, 39 at b2's sign, 45 at t's and 56 through the full test (the
// bound counts the pairs each stage settles, mt_cuda.mt_best_ref(
// with_counts=True)). Built with -fmad=false and IEEE division (no fast
// math) so that every product, sum and quotient rounds as the plain torch
// version's separate ops do: t then equals the plain version's bit for
// bit. That costs the FMA's factor two: the floor is the operation count
// at 128 lanes a clock on each SM. The dense loop of the one-step version
// ran near the card's issue rate, so a pair drops only what it does not
// issue: a branch per stage and pair cost more in lost overlap than it
// saved (PERF.md), hence the straight-line first stage, which about half
// the pairs never leave, and two branches behind it, which coherent warps
// take together. Two or four rays a thread, or 2 or 8 triangles in the
// first stage, measured slower. On config4_big's 99,458 triangles this
// design beats the one-step loop; on config2's 1,282 it is slower, for a
// reason not yet measured (PERF.md).
//
// Left out on purpose. A Pluecker or bilinear rewrite on the tensor cores
// ([N x 10] . [10 x 4T] in TF32 or a 3xTF32 split) cancels badly in o x d
// far from the origin and gives up bit parity with the plain version and
// the edge behaviour the tests hold. Culling tiles of triangles by their
// boxes would turn the dense test into an accelerator, which `Accelerator
// "none"` does not ask for (the grid and kd-tree are ported as their own
// accelerators).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTris = 4;    // triangles per first-stage block
constexpr int kTile = 256;  // a multiple of kTris
// Constants rounded exactly as the Python scalars in the plain version are
// (double first, then float).
constexpr float kBig = (float)1e30;
constexpr float kTiny = (float)1e-12;
// The guards of the sign test (mt_cuda.NUM_MIN, DIV_MAX).
constexpr float kNumMin = (float)1e-20;
constexpr float kDivMax = (float)1e20;

// The sign test of mt_cuda.neg_settled for |div| <= kDivMax: `num` with
// div's sign bit `sign` folded in (xor, exact) is at most -kNumMin.
__device__ __forceinline__ bool settled(float num, uint32_t sign) {
  return __uint_as_float(__float_as_uint(num) ^ sign) <= -kNumMin;
}

__global__ void __launch_bounds__(kBlock)
mt_best_kernel(const float* __restrict__ rays, int n,
               const float* __restrict__ tris, int n_tris, int any_hit,
               float* __restrict__ t_out, int* __restrict__ id_out) {
  __shared__ float4 s_tri[kTile * 3];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const size_t r = i < n ? i : 0, N = (size_t)n;
  const float ox = rays[r], oy = rays[N + r], oz = rays[2 * N + r];
  const float dx = rays[3 * N + r], dy = rays[4 * N + r],
              dz = rays[5 * N + r];
  const float mint = rays[6 * N + r], maxt = rays[7 * N + r];
  bool act = i < n && mint <= maxt;
  bool done = !act;
  float best_t = kBig;
  int best_id = -1;
  // Uniform across the block: every thread reaches every barrier below.
  if (!__syncthreads_and(done)) {
    for (int base = 0; base < n_tris; base += kTile) {
      const int count = min(kTile, n_tris - base);
      // Pad the tile to a multiple of kTris with zero triangles (div = 0:
      // never a hit).
      const int padded = (count + kTris - 1) / kTris * kTris;
      for (int k = threadIdx.x; k < padded; k += kBlock) {
        const size_t j = (size_t)base + k;
        const size_t T = (size_t)n_tris;
        const bool real = k < count;
        s_tri[3 * k] = real ? make_float4(tris[j], tris[T + j],
                                          tris[2 * T + j], tris[3 * T + j])
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        s_tri[3 * k + 1] = real ? make_float4(tris[4 * T + j],
                                              tris[5 * T + j],
                                              tris[6 * T + j],
                                              tris[7 * T + j])
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        s_tri[3 * k + 2] = make_float4(real ? tris[8 * T + j] : 0.0f, 0.0f,
                                       0.0f, 0.0f);
      }
      __syncthreads();
      for (int k0 = 0; k0 < padded && !done; k0 += kTris) {
        float v0x[kTris], v0y[kTris], v0z[kTris];
        float e1x[kTris], e1y[kTris], e1z[kTris];
        float e2x[kTris], e2y[kTris], e2z[kTris];
#pragma unroll
        for (int q = 0; q < kTris; ++q) {
          const float4 a = s_tri[3 * (k0 + q)], b = s_tri[3 * (k0 + q) + 1],
                       c = s_tri[3 * (k0 + q) + 2];
          v0x[q] = a.x; v0y[q] = a.y; v0z[q] = a.z;
          e1x[q] = a.w; e1y[q] = b.x; e1z[q] = b.y;
          e2x[q] = b.z; e2y[q] = b.w; e2z[q] = c.x;
        }
        // Stage 1, straight-line over kTris triangles: the steps of
        // shapes/triangle.py intersect_edges, in its order, up to b1's
        // numerator.
        float div[kTris], n1[kTris];
        bool go[kTris];
#pragma unroll
        for (int q = 0; q < kTris; ++q) {
          const float s1x = dy * e2z[q] - dz * e2y[q];
          const float s1y = dz * e2x[q] - dx * e2z[q];
          const float s1z = dx * e2y[q] - dy * e2x[q];
          const float dv = s1x * e1x[q] + s1y * e1y[q] + s1z * e1z[q];
          const float sx = ox - v0x[q], sy = oy - v0y[q], sz = oz - v0z[q];
          n1[q] = sx * s1x + sy * s1y + sz * s1z;
          div[q] = dv;
          go[q] = fabsf(dv) > kTiny &&
                  !(fabsf(dv) <= kDivMax &&
                    settled(n1[q], __float_as_uint(dv) & 0x80000000u));
        }
        // Stages 2-3 and the full test, in triangle order.
#pragma unroll
        for (int q = 0; q < kTris; ++q) {
          if (!(go[q] && act)) continue;
          const float dv = div[q];
          const uint32_t sign = __float_as_uint(dv) & 0x80000000u;
          const float sx = ox - v0x[q], sy = oy - v0y[q], sz = oz - v0z[q];
          const float s2x = sy * e1z[q] - sz * e1y[q];
          const float s2y = sz * e1x[q] - sx * e1z[q];
          const float s2z = sx * e1y[q] - sy * e1x[q];
          const float n2 = dx * s2x + dy * s2y + dz * s2z;
          const float nt = e2x[q] * s2x + e2y[q] * s2y + e2z[q] * s2z;
          if (fabsf(dv) <= kDivMax &&
              (settled(n2, sign) || (mint >= 0.0f && settled(nt, sign))))
            continue;
          // The full test, as the one-step version forms it.
          const float inv = 1.0f / dv;
          const float b1 = n1[q] * inv;
          const float b2 = n2 * inv;
          const float t = nt * inv;
          const bool valid = b1 >= 0.0f && b2 >= 0.0f && b1 + b2 <= 1.0f &&
                             t > mint && t < maxt;
          if (valid && t < best_t) {
            best_t = t;
            best_id = base + k0 + q;
            act = !any_hit;
          }
        }
        if (any_hit) done = !act;
      }
      // The tile's barrier; in any-hit mode the block leaves once every
      // thread is done.
      if (__syncthreads_and(done)) break;
    }
  }
  if (i < n) {
    t_out[i] = best_t;
    id_out[i] = best_id;
  }
}

}  // namespace

// C interface for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int mt_best_launch(const float* rays, int n, const float* tris,
                              int n_tris, int any_hit, float* t_out,
                              int* id_out, void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    mt_best_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, n, tris, n_tris, any_hit, t_out, id_out);
  }
  return static_cast<int>(cudaGetLastError());
}
