// K1: dense exact nearest-neighbour search, CUDA C++ for sm_90a.
//
// Replaces tpuslam/kernels/pallas_nn.py::nearest_neighbors_pallas_batch
// (kernel body _nn_kernel_batch; nearest_neighbors_pallas is its B=1 form).
// For every source row of every pair b: the index and squared distance of
// the nearest of the first count[b] target rows.
//
// Contract, bit for bit the JAX oracle's (tpuslam.ops.nn.nearest_neighbors_ref
// on the CPU):
//   * d = fma(dz, dz, fma(dx, dx, dy * dy)) with d_ = t_ - s_, each step
//     rounded once to float32 (tpuslam::sq_dist in nn_fold.cuh, shared
//     with K3).
//   * targets are folded in ascending order with a strict '<', so the
//     first (lowest) index wins a tie (common.cpp:416 in the reference).
//   * no valid target gives (idx 0, dist 3.4e38f).  A distance at or
//     above 3.4e38f, or NaN, never wins.
//
// Design: one thread per source row, blockIdx.y is the pair.  A block
// stages kTile target rows at a time in shared memory as SoA x/y/z and
// every thread scans the whole tile against its own source (the reads are
// broadcasts, four targets per 16-byte load).  Rows past count[b] are
// staged as +inf, whose distance never wins, so the inner loop has a fixed
// trip count.  count is read from device memory: the host never needs it.
//
// Bound: at 102,400 x 102,400 the scan is 1.05e10 pairs of about 9
// float32 instructions each (3 sub, 1 mul, 2 fma, compare, 2 selects),
// plus 3 shared loads per 4 pairs; device-memory traffic is a few MB, so
// the kernel is bound by the fp32 pipes.  This first version keeps one
// source per thread; register tiling of several sources per thread (to
// cut the shared loads per pair) is left to a later change.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "nn_fold.cuh"

namespace {

using tpuslam::kBig;

constexpr int kThreads = 256;  // source rows per block, one per thread
constexpr int kTile = kThreads;  // target rows staged per step, one per thread

__device__ __forceinline__ void fold(float tx, float ty, float tz, float sx,
                                     float sy, float sz, int j, float& best,
                                     int& best_j) {
  const float d = tpuslam::sq_dist(tx, ty, tz, sx, sy, sz);
  if (d < best) {
    best = d;
    best_j = j;
  }
}

__global__ void __launch_bounds__(kThreads)
    nn_dense_kernel(const float* __restrict__ src,
                    const float* __restrict__ tgt,
                    const int* __restrict__ count, int n, int m,
                    int* __restrict__ idx_out, float* __restrict__ dist_out) {
  __shared__ __align__(16) float tx[kTile];
  __shared__ __align__(16) float ty[kTile];
  __shared__ __align__(16) float tz[kTile];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* s = src + static_cast<size_t>(b) * n * 3;
  const float* t = tgt + static_cast<size_t>(b) * m * 3;
  const int valid = min(max(count[b], 0), m);

  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (i < n) {
    sx = s[3 * static_cast<size_t>(i)];
    sy = s[3 * static_cast<size_t>(i) + 1];
    sz = s[3 * static_cast<size_t>(i) + 2];
  }

  float best = kBig;
  int best_j = 0;
  for (int base = 0; base < valid; base += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    const int j = base + threadIdx.x;
    if (j < valid) {
      tx[threadIdx.x] = t[3 * static_cast<size_t>(j)];
      ty[threadIdx.x] = t[3 * static_cast<size_t>(j) + 1];
      tz[threadIdx.x] = t[3 * static_cast<size_t>(j) + 2];
    } else {
      tx[threadIdx.x] = CUDART_INF_F;
      ty[threadIdx.x] = CUDART_INF_F;
      tz[threadIdx.x] = CUDART_INF_F;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTile; k += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(&tx[k]);
      const float4 y4 = *reinterpret_cast<const float4*>(&ty[k]);
      const float4 z4 = *reinterpret_cast<const float4*>(&tz[k]);
      fold(x4.x, y4.x, z4.x, sx, sy, sz, base + k, best, best_j);
      fold(x4.y, y4.y, z4.y, sx, sy, sz, base + k + 1, best, best_j);
      fold(x4.z, y4.z, z4.z, sx, sy, sz, base + k + 2, best, best_j);
      fold(x4.w, y4.w, z4.w, sx, sy, sz, base + k + 3, best, best_j);
    }
  }
  if (i < n) {
    idx_out[static_cast<size_t>(b) * n + i] = best_j;
    dist_out[static_cast<size_t>(b) * n + i] = best;
  }
}

}  // namespace

// src f32[batch, n, 3], tgt f32[batch, m, 3], count i32[batch] (device),
// idx i32[batch, n] and dist f32[batch, n] (device, written here), all
// contiguous.  Returns a cudaError_t as int: 0 when the launch was taken.
extern "C" int tpuslam_nn_dense(const float* src, const float* tgt,
                                const int* count, int batch, int n, int m,
                                int* idx, float* dist, void* stream) {
  if (batch <= 0 || n <= 0) return 0;  // nothing to launch
  if (batch > 65535 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  nn_dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, count, n, m, idx, dist);
  return static_cast<int>(cudaGetLastError());
}
