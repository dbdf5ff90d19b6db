// Nearest hit of N rays over T triangles, all pairs (Moller-Trumbore).
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
// clipped while the loop runs. Among equal t the lowest triangle index wins,
// as the TPU kernel's argmin-then-strict-< order gives. The ragged ends are
// masked here: neither N nor T is padded.
//
// Design: one thread per ray, in blocks of 256. The block stages triangles
// in tiles of kTile (9 floats each, padded to 12 so one triangle is three
// 16-byte loads) into shared memory; every thread then reads the same
// triangle at once, which the hardware serves as a broadcast. Each thread
// keeps its running (best_t, best_id) in registers and replaces it only on
// a strictly smaller t, in triangle order. Nothing crosses blocks, so there
// are no atomics and no second pass. A ray with an empty window
// (mint > maxt: the pool's lanes with nothing to trace) tests nothing, and
// a block whose rays all have one skips the triangle loop.
//
// What bounds it on this card: operations. The triangles (36 bytes each)
// are read once per block from L2 and the rays once from memory, so bytes
// are small beside the 56 float operations of each pair. Built with
// -fmad=false and IEEE division (no fast math) so that every product, sum
// and quotient rounds as the plain torch version's separate ops do: t then
// equals the plain version's bit for bit, and ids differ only where it does.
// A later version should test several rays per thread against each staged
// triangle, so that a shared-memory load feeds more than one pair.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 256;
// Constants rounded exactly as the Python scalars in the plain version are
// (double first, then float).
constexpr float kBig = (float)1e30;
constexpr float kTiny = (float)1e-12;

__global__ void __launch_bounds__(kBlock)
mt_best_kernel(const float* __restrict__ rays, int n,
               const float* __restrict__ tris, int n_tris,
               float* __restrict__ t_out, int* __restrict__ id_out) {
  __shared__ float4 s_tri[kTile * 3];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool in_range = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float mint = 1.0f, maxt = -1.0f;
  if (in_range) {
    ox = rays[i];
    oy = rays[(size_t)n + i];
    oz = rays[2 * (size_t)n + i];
    dx = rays[3 * (size_t)n + i];
    dy = rays[4 * (size_t)n + i];
    dz = rays[5 * (size_t)n + i];
    mint = rays[6 * (size_t)n + i];
    maxt = rays[7 * (size_t)n + i];
  }
  const bool live = in_range && mint <= maxt;
  float best_t = kBig;
  int best_id = -1;
  // Uniform across the block: every thread reaches every barrier below.
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_tris; base += kTile) {
      const int count = min(kTile, n_tris - base);
      for (int k = threadIdx.x; k < count; k += kBlock) {
        const size_t j = (size_t)base + k;
        const size_t T = (size_t)n_tris;
        s_tri[3 * k] = make_float4(tris[j], tris[T + j], tris[2 * T + j],
                                   tris[3 * T + j]);
        s_tri[3 * k + 1] = make_float4(tris[4 * T + j], tris[5 * T + j],
                                       tris[6 * T + j], tris[7 * T + j]);
        s_tri[3 * k + 2] = make_float4(tris[8 * T + j], 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < count; ++k) {
          const float4 a = s_tri[3 * k], b = s_tri[3 * k + 1],
                       c = s_tri[3 * k + 2];
          const float v0x = a.x, v0y = a.y, v0z = a.z;
          const float e1x = a.w, e1y = b.x, e1z = b.y;
          const float e2x = b.z, e2y = b.w, e2z = c.x;
          // The steps of shapes/triangle.py intersect_edges, in its order.
          const float s1x = dy * e2z - dz * e2y;
          const float s1y = dz * e2x - dx * e2z;
          const float s1z = dx * e2y - dy * e2x;
          const float div = s1x * e1x + s1y * e1y + s1z * e1z;
          const bool ok = fabsf(div) > kTiny;
          const float inv = 1.0f / (ok ? div : 1.0f);
          const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
          const float b1 = (sx * s1x + sy * s1y + sz * s1z) * inv;
          const float s2x = sy * e1z - sz * e1y;
          const float s2y = sz * e1x - sx * e1z;
          const float s2z = sx * e1y - sy * e1x;
          const float b2 = (dx * s2x + dy * s2y + dz * s2z) * inv;
          const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv;
          const bool valid = ok && b1 >= 0.0f && b2 >= 0.0f &&
                             b1 + b2 <= 1.0f && t > mint && t < maxt;
          if (valid && t < best_t) {
            best_t = t;
            best_id = base + k;
          }
        }
      }
      __syncthreads();
    }
  }
  if (in_range) {
    t_out[i] = best_t;
    id_out[i] = best_id;
  }
}

}  // namespace

// C interface for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int mt_best_launch(const float* rays, int n, const float* tris,
                              int n_tris, float* t_out, int* id_out,
                              void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    mt_best_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        rays, n, tris, n_tris, t_out, id_out);
  }
  return static_cast<int>(cudaGetLastError());
}
