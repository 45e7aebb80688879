// K3: the candidate rescore of the hierarchical exact nearest-neighbour
// search, CUDA C++ for sm_90a.
//
// Replaces tpuslam/kernels/pallas_nn_cand.py::nearest_neighbors_cand
// (kernel body from _make_kernel) and its batch form
// nearest_neighbors_cand_batch.  Each group of gsrc Morton-sorted sources
// of pair b owns a row of the candidate table, cand[b, group, :], of
// target-tile ids (g sorted target rows each), of which the first
// counts[b, group] are live.  For every source: the exact nearest of the
// rows of its group's live tiles.
//
// Contract, bit for bit K1's and the JAX oracle's on every source whose
// nearest neighbour lies in an admitted tile:
//   * the distance is K1's (tpuslam::sq_dist in nn_fold.cuh);
//   * tgt_packed rows are (x, y, z, original index as float32); the fold
//     is lexicographic on (distance, original index), so the lowest
//     original index wins a tie whatever order the tiles are visited in;
//   * a distance >= 1e37 (sentinel rows past the target count sit at
//     1e19, no live slot at all) reports (idx 0, dist 3.4e38f).  A NaN
//     distance never wins.
//
// Design: one thread per source; a group spans ceil(gsrc / kThreads)
// blocks, each of which reads its group's count and table row from device
// memory and walks only the live slots: dead slots cost nothing (the TPU
// kernel needed them to repeat the last id so their DMA deduplicated).
// The live rows of the group (count x g of them, g being a runtime
// argument, so one kernel serves the fine arm at g and the coarse arm at
// g2) are staged kThreads rows at a time in shared memory as SoA
// x/y/z/index and every thread folds the staged rows against its source
// (four rows per 16-byte broadcast load).  Rows past the live ones are
// staged as +inf, whose distance never wins, so the inner loop has a
// fixed trip count.  A tile id outside [0, m / g) is skipped.  No SMEM
// segmentation of the table is needed: it stays in device memory.
//
// Bound: (live rows) x gsrc pairs per group of ~12 float32 instructions
// each; at 100k with ~60 live tiles of 128 rows per group that is about
// 8e8 pairs, a few MB of traffic, so the fp32 pipes bound it, as K1.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "nn_fold.cuh"

namespace {

using tpuslam::kBig;

constexpr int kThreads = 128;  // sources per block; rows staged per step
constexpr float kNoMatch = 1e37f;

__device__ __forceinline__ void fold(float tx, float ty, float tz, float tw,
                                     float sx, float sy, float sz,
                                     float& best, float& best_w) {
  const float d = tpuslam::sq_dist(tx, ty, tz, sx, sy, sz);
  const bool better = d < best || (d == best && tw < best_w);
  best = better ? d : best;
  best_w = better ? tw : best_w;
}

__global__ void __launch_bounds__(kThreads)
    nn_cand_kernel(const float* __restrict__ src,
                   const float4* __restrict__ packed,
                   const int* __restrict__ cand,
                   const int* __restrict__ counts, int n, int m, int ts,
                   int width, int g, int gsrc, int* __restrict__ idx_out,
                   float* __restrict__ dist_out) {
  __shared__ __align__(16) float tx[kThreads];
  __shared__ __align__(16) float ty[kThreads];
  __shared__ __align__(16) float tz[kThreads];
  __shared__ __align__(16) float tw[kThreads];

  const int b = blockIdx.y;
  const int per_group = (gsrc + kThreads - 1) / kThreads;
  const int group = blockIdx.x / per_group;
  const int r = (blockIdx.x % per_group) * kThreads + threadIdx.x;
  const bool active = r < gsrc;
  const size_t i = static_cast<size_t>(b) * n +
                   static_cast<size_t>(group) * gsrc + r;

  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (active) {
    sx = src[3 * i];
    sy = src[3 * i + 1];
    sz = src[3 * i + 2];
  }
  const size_t grow = static_cast<size_t>(b) * ts + group;
  const int live = min(max(counts[grow], 0), width);
  const int* slots = cand + grow * width;
  const float4* tb = packed + static_cast<size_t>(b) * m;
  const int tiles = m / g;
  const int rows = live * g;

  float best = kBig, best_w = kBig;
  for (int base = 0; base < rows; base += kThreads) {
    __syncthreads();  // every thread is done with the previous rows
    const int q = base + threadIdx.x;
    float4 v = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, kBig);
    if (q < rows) {
      const int slot = q / g;
      const int t = slots[slot];
      if (t >= 0 && t < tiles) {
        v = tb[static_cast<size_t>(t) * g + (q - slot * g)];
      }
    }
    tx[threadIdx.x] = v.x;
    ty[threadIdx.x] = v.y;
    tz[threadIdx.x] = v.z;
    tw[threadIdx.x] = v.w;
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kThreads; k += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(&tx[k]);
      const float4 y4 = *reinterpret_cast<const float4*>(&ty[k]);
      const float4 z4 = *reinterpret_cast<const float4*>(&tz[k]);
      const float4 w4 = *reinterpret_cast<const float4*>(&tw[k]);
      fold(x4.x, y4.x, z4.x, w4.x, sx, sy, sz, best, best_w);
      fold(x4.y, y4.y, z4.y, w4.y, sx, sy, sz, best, best_w);
      fold(x4.z, y4.z, z4.z, w4.z, sx, sy, sz, best, best_w);
      fold(x4.w, y4.w, z4.w, w4.w, sx, sy, sz, best, best_w);
    }
  }
  if (active) {
    const bool none = best >= kNoMatch;
    idx_out[i] = none ? 0 : static_cast<int>(best_w);
    dist_out[i] = none ? kBig : best;
  }
}

}  // namespace

// src f32[batch, n, 3], packed f32[batch, m, 4] (16-byte aligned),
// cand i32[batch, ts, width], counts i32[batch, ts], all on the device and
// contiguous, n = ts * gsrc, m a multiple of g; idx i32[batch, n] and
// dist f32[batch, n] written here.  Returns a cudaError_t as int: 0 when
// the launch was taken.
extern "C" int tpuslam_nn_cand(const float* src, const float* packed,
                               const int* cand, const int* counts, int batch,
                               int n, int m, int ts, int width, int g,
                               int gsrc, int* idx, float* dist,
                               void* stream) {
  if (batch <= 0 || n <= 0) return 0;  // nothing to launch
  if (batch > 65535 || g <= 0 || gsrc <= 0 || width < 0 || m < 0 ||
      m % g != 0 || static_cast<long long>(ts) * gsrc != n ||
      static_cast<long long>(width) * g >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_group = (gsrc + kThreads - 1) / kThreads;
  const dim3 grid(ts * per_group, batch);
  nn_cand_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, reinterpret_cast<const float4*>(packed), cand, counts, n, m, ts,
      width, g, gsrc, idx, dist);
  return static_cast<int>(cudaGetLastError());
}
