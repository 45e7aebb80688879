// K4: the dense two-pass CPD E-step, CUDA C++ for sm_90a.
//
// Replaces tpuslam/kernels/pallas_cpd.py::denom_pass_batch (kernel body
// _denom_kernel_batch) and ::moments_pass_batch (body _moments_kernel_batch),
// the two passes behind cpd_estep_pallas_batch / cpd_estep_pallas.  For each
// pair b, with scalars[b] = (-0.5 / sigma^2, c, truncation flag,
// log(truncate)) and g(y, x) the Gaussian of cpd_gauss.cuh:
//
//   pass 1: denom[b, n] = c + sum_m g(ty_m, x_n)                 (all M rows)
//   pass 2: acc[b, :, m] = sum_n g(ty_m, x_n) * weights4[b, n, :] (all N rows)
//
// M and N are multiples of kCpdTile (1024); padded moving rows sit at a far
// sentinel (their Gaussian underflows to 0), padded target rows carry zero
// weights.  Each running total starts at c (pass 1) or 0 (pass 2) and adds
// one partial per block of 1024 rows in ascending block order, as the TPU
// kernel's sequential grid axis does; the partials come from
// cpd_gauss.cuh, shared with K5, which is therefore bit-identical to K4.
//
// Design: one output row per thread (kThreads per block, blockIdx.y the
// pair); each 1024-row block of the other cloud is staged once per thread
// block in shared memory (SoA, 12 KB in pass 1; 28 KB with the four weights
// in pass 2) and every thread folds all of it into its row.  No atomics and
// no split of a row's reduction across thread blocks, so the order is fixed.
//
// Bound: the fp32 pipes.  One pair costs ~14 instructions in pass 1 (three
// subtractions, the two-FMA distance, the exponent product, the accurate
// expf, the truncation select and the add) and ~18 in pass 2 (four FMAs
// instead of the add); shared loads are warp broadcasts, one float4 per four
// pairs per array.  At 376,401^2 one E-step is 2 x 1.42e11 pairs; device
// memory traffic is a few MB.  At 20,480 rows a pass launches only 160
// thread blocks of 128 for 132 SMs, so it is bound by occupancy there.
//
// The C entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "cpd_gauss.cuh"

namespace {

using tpuslam::kCpdTile;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    cpd_denom_kernel(const float* __restrict__ scalars,
                     const float* __restrict__ ty,
                     const float* __restrict__ target, int n, int m,
                     float* __restrict__ denom) {
  __shared__ __align__(16) float mx[kCpdTile];
  __shared__ __align__(16) float my[kCpdTile];
  __shared__ __align__(16) float mz[kCpdTile];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const tpuslam::CpdScalars s = tpuslam::load_scalars(scalars + 4 * b);
  const float* x = target + static_cast<size_t>(b) * n * 3;
  const float* tyb = ty + static_cast<size_t>(b) * m * 3;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < n) {
    px = x[3 * static_cast<size_t>(i)];
    py = x[3 * static_cast<size_t>(i) + 1];
    pz = x[3 * static_cast<size_t>(i) + 2];
  }
  float run = s.c;
  for (int j = 0; j < m / kCpdTile; ++j) {
    __syncthreads();  // every thread is done with the previous block
    tpuslam::stage_xyz<kThreads>(tyb + static_cast<size_t>(j) * kCpdTile * 3,
                                 mx, my, mz);
    __syncthreads();
    run = __fadd_rn(run, tpuslam::denom_block(mx, my, mz, px, py, pz, s));
  }
  if (i < n) denom[static_cast<size_t>(b) * n + i] = run;
}

__global__ void __launch_bounds__(kThreads)
    cpd_moments_kernel(const float* __restrict__ scalars,
                       const float* __restrict__ ty,
                       const float* __restrict__ target,
                       const float4* __restrict__ weights4, int n, int m,
                       float* __restrict__ acc) {
  __shared__ __align__(16) float tx[kCpdTile];
  __shared__ __align__(16) float tyy[kCpdTile];
  __shared__ __align__(16) float tz[kCpdTile];
  __shared__ __align__(16) float w0[kCpdTile];
  __shared__ __align__(16) float w1[kCpdTile];
  __shared__ __align__(16) float w2[kCpdTile];
  __shared__ __align__(16) float w3[kCpdTile];

  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const tpuslam::CpdScalars s = tpuslam::load_scalars(scalars + 4 * b);
  const float* x = target + static_cast<size_t>(b) * n * 3;
  const float4* w = weights4 + static_cast<size_t>(b) * n;
  const float* q = ty + static_cast<size_t>(b) * m * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (j < m) {
    qx = q[3 * static_cast<size_t>(j)];
    qy = q[3 * static_cast<size_t>(j) + 1];
    qz = q[3 * static_cast<size_t>(j) + 2];
  }
  float run[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n / kCpdTile; ++i) {
    __syncthreads();
    tpuslam::stage_xyz<kThreads>(x + static_cast<size_t>(i) * kCpdTile * 3,
                                 tx, tyy, tz);
    tpuslam::stage_w4<kThreads>(w + static_cast<size_t>(i) * kCpdTile, w0, w1,
                                w2, w3);
    __syncthreads();
    float part[4];
    tpuslam::moments_block(tx, tyy, tz, w0, w1, w2, w3, qx, qy, qz, s, part);
#pragma unroll
    for (int c = 0; c < 4; ++c) run[c] = __fadd_rn(run[c], part[c]);
  }
  if (j < m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[(static_cast<size_t>(b) * 4 + c) * m + j] = run[c];
    }
  }
}

bool bad_shape(int batch, int n, int m) {
  return batch > 65535 || n < 0 || m < 0 || n % kCpdTile != 0 ||
         m % kCpdTile != 0;
}

}  // namespace

// scalars f32[batch, 4], ty f32[batch, m, 3], target f32[batch, n, 3], all
// on the device and contiguous, n and m multiples of 1024; denom
// f32[batch, n] is written here.  Returns a cudaError_t as int.
extern "C" int tpuslam_cpd_denom(const float* scalars, const float* ty,
                                 const float* target, int batch, int n, int m,
                                 float* denom, void* stream) {
  if (batch <= 0 || n == 0) return 0;  // nothing to launch
  if (bad_shape(batch, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kThreads, batch);
  cpd_denom_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scalars, ty, target, n, m, denom);
  return static_cast<int>(cudaGetLastError());
}

// weights4 f32[batch, n, 4] (16-byte aligned) beside the above; acc
// f32[batch, 4, m] is written here.  Returns a cudaError_t as int.
extern "C" int tpuslam_cpd_moments(const float* scalars, const float* ty,
                                   const float* target, const float* weights4,
                                   int batch, int n, int m, float* acc,
                                   void* stream) {
  if (batch <= 0 || m == 0) return 0;  // nothing to launch
  if (bad_shape(batch, n, m)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(m / kThreads, batch);
  cpd_moments_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      scalars, ty, target, reinterpret_cast<const float4*>(weights4), n, m,
      acc);
  return static_cast<int>(cudaGetLastError());
}
