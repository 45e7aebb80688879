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
// Bound: instruction issue, with the special-function units close behind
// (one MUFU.EX2 a pair takes a quarter-SM's 4 SFU lanes 8 cycles a warp).
// One pair costs 9 lane-instructions in pass 1 without truncation (three
// subtractions, the product and two FMAs of the distance, the scaled
// exponent, one MUFU.EX2, the add) and 12 with it (the exponent rounded
// for the decision, a compare and a select); pass 2 has four FMAs instead
// of the add.  Shared loads are warp broadcasts: 3 float4 (pass 2: 7) per
// 4 pairs, shared by the kR rows a thread holds.  At
// 376,401^2 one E-step is 2 x 1.42e11 pairs; device memory traffic is a few
// MB.  Design: cpd_gauss.cuh::cpd_cta, kThreads = 64 threads a CTA, kR rows a
// thread (the wrapper's cpd_geometry: 2 where the grid still fills the card,
// else 1), blockIdx.y the pair; each CTA walks the blocks of the other cloud
// in 128-row segments through a cp.async ring.  Where the rows are too few
// to fill the card (20,480, or K5's fat blocks: a few thousand rows against
// 368 blocks, each thread otherwise a chain of 376k pairs), the geometry
// splits the other cloud's blocks over blockIdx.z: each CTA stores its
// blocks' partials and a second kernel adds them per row in ascending block
// order, the additions the unsplit CTA makes, so the bits do not change.
// No atomics; the order is fixed.
//
// The C entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "cpd_gauss.cuh"

namespace {

using tpuslam::kCpdThreads;
using tpuslam::kCpdTile;

// blockIdx = (CTA, pair, split): split z of `splits` walks blocks
// [z * B / splits, (z + 1) * B / splits) of the other cloud's B; with one
// split it keeps the running totals itself, with more it stores per-block
// partials into `parts` [batch, B, kC, n_rows] for cpd_combine_kernel.
template <bool kMoments, int kR>
__global__ void __launch_bounds__(kCpdThreads)
    cpd_dense_kernel(const float* __restrict__ scalars,
                     const float* __restrict__ rows,
                     const float* __restrict__ other,
                     const float4* __restrict__ weights4, int n_rows,
                     int n_other, float* __restrict__ out,
                     float* __restrict__ parts) {
  __shared__ __align__(16) tpuslam::CpdRing<kMoments> ring;
  constexpr int kC = kMoments ? 4 : 1;
  const int b = blockIdx.y;
  const int blocks = n_other / kCpdTile;
  const int first = static_cast<int>(static_cast<long long>(blockIdx.z) *
                                     blocks / gridDim.z);
  const int last = static_cast<int>(
      static_cast<long long>(blockIdx.z + 1) * blocks / gridDim.z);
  const tpuslam::CpdScalars s = tpuslam::load_scalars(scalars + 4 * b);
  const tpuslam::DenseWalk walk{first, last - first};
  tpuslam::cpd_cta<kMoments, kR, kCpdThreads>(
      ring, walk, s, rows + static_cast<size_t>(b) * n_rows * 3,
      other + static_cast<size_t>(b) * n_other * 3,
      kMoments ? weights4 + static_cast<size_t>(b) * n_other : nullptr, n_rows,
      blockIdx.x, out + static_cast<size_t>(b) * kC * n_rows,
      parts == nullptr
          ? nullptr
          : parts + static_cast<size_t>(b) * blocks * kC * n_rows);
}

template <int kC>
__global__ void __launch_bounds__(256)
    cpd_combine_kernel(const float* __restrict__ scalars,
                       const float* __restrict__ parts, int n_rows,
                       int blocks, float* __restrict__ out) {
  tpuslam::cpd_combine<kC>(scalars, parts, n_rows, blocks, out);
}

bool bad_shape(int batch, int n, int m, int threads, int rows_per_thread,
               int splits, int other_blocks, const float* parts) {
  return batch > 65535 || n < 0 || m < 0 || n % kCpdTile != 0 ||
         m % kCpdTile != 0 || threads != kCpdThreads ||
         (rows_per_thread != 1 && rows_per_thread != 2) || splits < 1 ||
         splits > 65535 || (splits > 1 && (splits > other_blocks || parts == nullptr));
}

template <bool kMoments>
int launch(const float* scalars, const float* rows, const float* other,
           const float* weights4, int batch, int n_rows, int n_other,
           int rows_per_thread, int splits, float* parts, float* out,
           void* stream) {
  const dim3 grid(n_rows / (kCpdThreads * rows_per_thread), batch, splits);
  const auto w4 = reinterpret_cast<const float4*>(weights4);
  const auto st = static_cast<cudaStream_t>(stream);
  float* p = splits > 1 ? parts : nullptr;
  if (rows_per_thread == 2) {
    cpd_dense_kernel<kMoments, 2><<<grid, kCpdThreads, 0, st>>>(
        scalars, rows, other, w4, n_rows, n_other, out, p);
  } else {
    cpd_dense_kernel<kMoments, 1><<<grid, kCpdThreads, 0, st>>>(
        scalars, rows, other, w4, n_rows, n_other, out, p);
  }
  if (p != nullptr) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 cgrid((n_rows + 255) / 256, batch);
    cpd_combine_kernel<kMoments ? 4 : 1><<<cgrid, 256, 0, st>>>(
        scalars, p, n_rows, n_other / kCpdTile, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scalars f32[batch, 4], ty f32[batch, m, 3], target f32[batch, n, 3], all
// on the device and contiguous, n and m multiples of 1024; threads,
// rows_per_thread and splits the wrapper's geometry (64, 1 or 2, and at
// most m / 1024 splits of the moving blocks), parts f32[batch, m / 1024, n]
// device scratch where splits > 1; denom f32[batch, n] is written here.
// Returns a cudaError_t as int.
extern "C" int tpuslam_cpd_denom(const float* scalars, const float* ty,
                                 const float* target, int batch, int n, int m,
                                 int threads, int rows_per_thread, int splits,
                                 float* parts, float* denom, void* stream) {
  if (batch <= 0 || n == 0) return 0;  // nothing to launch
  if (bad_shape(batch, n, m, threads, rows_per_thread, splits, m / kCpdTile,
                parts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(scalars, target, ty, nullptr, batch, n, m,
                       rows_per_thread, splits, parts, denom, stream);
}

// weights4 f32[batch, n, 4] (16-byte aligned) beside the above; splits of
// the target blocks, parts f32[batch, n / 1024, 4, m] where splits > 1; acc
// f32[batch, 4, m] is written here.  Returns a cudaError_t as int.
extern "C" int tpuslam_cpd_moments(const float* scalars, const float* ty,
                                   const float* target, const float* weights4,
                                   int batch, int n, int m, int threads,
                                   int rows_per_thread, int splits,
                                   float* parts, float* acc, void* stream) {
  if (batch <= 0 || m == 0) return 0;  // nothing to launch
  if (bad_shape(batch, n, m, threads, rows_per_thread, splits, n / kCpdTile,
                parts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(scalars, ty, target, weights4, batch, m, n,
                      rows_per_thread, splits, parts, acc, stream);
}
