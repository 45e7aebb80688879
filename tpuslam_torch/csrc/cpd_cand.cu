// K5: the candidate (block-skipping) CPD E-step, CUDA C++ for sm_90a.
//
// Replaces tpuslam/kernels/pallas_cpd_cand.py::cpd_estep_cand (kernel
// bodies _denom_cand_kernel and _moments_cand_kernel).  With truncation on,
// a block pair (1024 target rows x 1024 moving rows) whose rigorous minimum
// distance puts every pair past the cutoff contributes exactly +0.0; the
// wrapper (kernels/cpd_cand.py) proves which pairs those are and hands each
// block a table of the blocks it must visit, in ascending order:
//
//   pass 1: denom[n] = c + sum over cand_m[i, :counts_n[i]] of the block
//           partials of cpd_gauss.cuh  (i = the target block of n);
//   pass 2: acc[:, m] = sum over cand_n[j, :counts_m[j]] likewise
//           (j = the moving block of m).
//
// The partials and their order are K4's (cpd_dense.cu), from the shared
// header, so the result is bit-identical to K4 on the same inputs: a
// skipped block would only have added +0.0.  Blocks whose candidate sets
// overflow the table ("fat" blocks) get count 0 here and are served by K4
// on a gathered subset, as in the JAX package.
//
// Design: one output row per thread, kThreads rows per thread block, so
// each 1024-row block is served by 1024 / kThreads thread blocks; each reads
// its block's count and table row from device memory and walks only the
// live slots (dead slots cost nothing; the TPU kernel needed them to repeat
// the last id).  A table id outside [0, blocks) is skipped.  The tables stay
// in device memory: no SMEM segmentation, one block per slot.
//
// Bound: as K4's, times the admitted fraction of block pairs, plus one
// 12 KB (28 KB) staging per visited block per thread block.
//
// The C entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "cpd_gauss.cuh"

namespace {

using tpuslam::kCpdTile;

constexpr int kThreads = 128;
constexpr int kPerBlock = kCpdTile / kThreads;  // thread blocks per 1024 rows

__global__ void __launch_bounds__(kThreads)
    cpd_denom_cand_kernel(const float* __restrict__ scalars,
                          const float* __restrict__ ty,
                          const float* __restrict__ target,
                          const int* __restrict__ cand,
                          const int* __restrict__ counts, int n, int m,
                          int width, float* __restrict__ denom) {
  __shared__ __align__(16) float mx[kCpdTile];
  __shared__ __align__(16) float my[kCpdTile];
  __shared__ __align__(16) float mz[kCpdTile];

  const int blk = blockIdx.x / kPerBlock;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const tpuslam::CpdScalars s = tpuslam::load_scalars(scalars);
  const float px = target[3 * static_cast<size_t>(i)];
  const float py = target[3 * static_cast<size_t>(i) + 1];
  const float pz = target[3 * static_cast<size_t>(i) + 2];
  const int live = min(max(counts[blk], 0), width);
  const int* slots = cand + static_cast<size_t>(blk) * width;
  const int blocks = m / kCpdTile;

  float run = s.c;
  for (int r = 0; r < live; ++r) {
    const int j = slots[r];  // the same for every thread of the block
    if (j < 0 || j >= blocks) continue;
    __syncthreads();
    tpuslam::stage_xyz<kThreads>(ty + static_cast<size_t>(j) * kCpdTile * 3,
                                 mx, my, mz);
    __syncthreads();
    run = __fadd_rn(run, tpuslam::denom_block(mx, my, mz, px, py, pz, s));
  }
  denom[i] = run;
}

__global__ void __launch_bounds__(kThreads)
    cpd_moments_cand_kernel(const float* __restrict__ scalars,
                            const float* __restrict__ ty,
                            const float* __restrict__ target,
                            const float4* __restrict__ weights4,
                            const int* __restrict__ cand,
                            const int* __restrict__ counts, int n, int m,
                            int width, float* __restrict__ acc) {
  __shared__ __align__(16) float tx[kCpdTile];
  __shared__ __align__(16) float tyy[kCpdTile];
  __shared__ __align__(16) float tz[kCpdTile];
  __shared__ __align__(16) float w0[kCpdTile];
  __shared__ __align__(16) float w1[kCpdTile];
  __shared__ __align__(16) float w2[kCpdTile];
  __shared__ __align__(16) float w3[kCpdTile];

  const int blk = blockIdx.x / kPerBlock;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const tpuslam::CpdScalars s = tpuslam::load_scalars(scalars);
  const float qx = ty[3 * static_cast<size_t>(j)];
  const float qy = ty[3 * static_cast<size_t>(j) + 1];
  const float qz = ty[3 * static_cast<size_t>(j) + 2];
  const int live = min(max(counts[blk], 0), width);
  const int* slots = cand + static_cast<size_t>(blk) * width;
  const int blocks = n / kCpdTile;

  float run[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < live; ++r) {
    const int i = slots[r];
    if (i < 0 || i >= blocks) continue;
    __syncthreads();
    tpuslam::stage_xyz<kThreads>(
        target + static_cast<size_t>(i) * kCpdTile * 3, tx, tyy, tz);
    tpuslam::stage_w4<kThreads>(weights4 + static_cast<size_t>(i) * kCpdTile,
                                w0, w1, w2, w3);
    __syncthreads();
    float part[4];
    tpuslam::moments_block(tx, tyy, tz, w0, w1, w2, w3, qx, qy, qz, s, part);
#pragma unroll
    for (int c = 0; c < 4; ++c) run[c] = __fadd_rn(run[c], part[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[static_cast<size_t>(c) * m + j] = run[c];
}

bool bad_shape(int n, int m, int width) {
  return n < 0 || m < 0 || width < 0 || n % kCpdTile != 0 ||
         m % kCpdTile != 0;
}

}  // namespace

// One pair: scalars f32[4], ty f32[m, 3], target f32[n, 3], cand
// i32[n / 1024, width] (moving block ids), counts i32[n / 1024], all on the
// device and contiguous, n and m multiples of 1024; denom f32[n] is written
// here.  Returns a cudaError_t as int.
extern "C" int tpuslam_cpd_denom_cand(const float* scalars, const float* ty,
                                      const float* target, const int* cand,
                                      const int* counts, int n, int m,
                                      int width, float* denom, void* stream) {
  if (n == 0) return 0;  // nothing to launch
  if (bad_shape(n, m, width)) return static_cast<int>(cudaErrorInvalidValue);
  cpd_denom_cand_kernel<<<n / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      scalars, ty, target, cand, counts, n, m, width, denom);
  return static_cast<int>(cudaGetLastError());
}

// weights4 f32[n, 4] (16-byte aligned), cand i32[m / 1024, width] (target
// block ids), counts i32[m / 1024] beside the above; acc f32[4, m] is
// written here.  Returns a cudaError_t as int.
extern "C" int tpuslam_cpd_moments_cand(const float* scalars, const float* ty,
                                        const float* target,
                                        const float* weights4,
                                        const int* cand, const int* counts,
                                        int n, int m, int width, float* acc,
                                        void* stream) {
  if (m == 0) return 0;  // nothing to launch
  if (bad_shape(n, m, width)) return static_cast<int>(cudaErrorInvalidValue);
  cpd_moments_cand_kernel<<<m / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      scalars, ty, target, reinterpret_cast<const float4*>(weights4), cand,
      counts, n, m, width, acc);
  return static_cast<int>(cudaGetLastError());
}
