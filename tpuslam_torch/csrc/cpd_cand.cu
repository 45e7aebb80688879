// K5: the candidate (segment-skipping) CPD E-step, CUDA C++ for sm_90a.
//
// Replaces tpuslam/kernels/pallas_cpd_cand.py::cpd_estep_cand (kernel
// bodies _denom_cand_kernel and _moments_cand_kernel).  With truncation on,
// a 128-row segment of the other cloud whose rigorous minimum distance to a
// CTA's rows puts every pair past the cutoff contributes exactly +0.0; the
// wrapper (kernels/cpd_cand.py) proves which those are from the sub-tile
// bounds and hands each CTA a table of the blocks it must visit, ascending,
// each with a mask of its segments to fold:
//
//   pass 1: denom[n] = c + sum over table_m[t, :counts_n[t]] of the block
//           partials of cpd_gauss.cuh  (t = the CTA of target row n);
//   pass 2: acc[:, m] = sum over table_n[t, :counts_m[t]] likewise
//           (t = the CTA of moving row m).
//
// An entry is (block << 8) | mask, bit s of the mask standing for rows
// [128 s, 128 s + 128) of the block.  The partials and their order are
// K4's (cpd_dense.cu), from the shared header, so the result is
// bit-identical to K4 on the same inputs: a skipped block or segment would
// only have added +0.0 to each accumulator.  CTAs of "fat" blocks (whose
// block-level candidate sets overflow the table) get count 0 here and are
// served by K4 on a gathered subset, as in the JAX package.
//
// Design: K4's CTA (cpd_gauss.cuh::cpd_cta: 64 threads, kR rows a thread,
// a cp.async ring of 128-row segments) walking its own table, which it
// first copies into shared memory; a CTA holds 64 * kR rows, one 128-row
// sub-tile at the main path's kR = 2, and visits only the segments admitted
// against its own rows.
//
// Bound: as K4's, on the pairs of the masked segments, plus one staging of
// 1.5 KB (3.5 KB) per visited segment per CTA.
//
// Predication, as K4's (cpd_dense.cu): given a device route code `pred`, a
// launch runs only where *pred == pred_value (K5's route: the admission did
// not overflow), else every CTA returns at once and writes nothing; the
// tally (tally.cuh) counts each launch, and such a one as skipped.  The EM
// loop captured as a CUDA graph launches K5 and K4 both, each predicated on
// the same code.
//
// The C entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstddef>

#include "cpd_gauss.cuh"
#include "tally.cuh"

namespace {

using tpuslam::kCpdThreads;
using tpuslam::kCpdTile;

constexpr int kMaxWidth = 8192;  // table entries a CTA (32 KB of shared memory)

template <bool kMoments, int kR>
__global__ void __launch_bounds__(kCpdThreads)
    cpd_cand_kernel(const float* __restrict__ scalars,
                    const float* __restrict__ rows,
                    const float* __restrict__ other,
                    const float4* __restrict__ weights4,
                    const int* __restrict__ table,
                    const int* __restrict__ counts, int n_rows, int n_other,
                    int width, const int* __restrict__ pred, int pred_value,
                    int* __restrict__ tally, float* __restrict__ out) {
  __shared__ __align__(16) tpuslam::CpdRing<kMoments> ring;
  extern __shared__ int tab[];
  const bool skipped = pred != nullptr && *pred != pred_value;
  tally_launch(tally, skipped);
  if (skipped) return;
  const int cta = blockIdx.x;
  const tpuslam::CpdScalars s = tpuslam::load_scalars(scalars);
  const int live = min(max(counts[cta], 0), width);
  const int* row = table + static_cast<size_t>(cta) * width;
  const int blocks = n_other / kCpdTile;
  // an entry whose block lies outside [0, blocks) gets an empty mask: the
  // walk steps over it
  for (int e = threadIdx.x; e < live; e += kCpdThreads) {
    const int v = row[e];
    tab[e] = (v >> 8) >= 0 && (v >> 8) < blocks ? v : 0;
  }
  __syncthreads();
  const tpuslam::TableWalk walk{tab, live};
  tpuslam::cpd_cta<kMoments, kR, kCpdThreads>(ring, walk, s, rows, other,
                                              weights4, n_rows, cta, out);
}

bool bad_shape(int n, int m, int width, int threads, int rows_per_thread) {
  return n < 0 || m < 0 || width < 0 || width > kMaxWidth ||
         n % kCpdTile != 0 || m % kCpdTile != 0 || threads != kCpdThreads ||
         (rows_per_thread != 1 && rows_per_thread != 2);
}

template <bool kMoments>
int launch(const float* scalars, const float* rows, const float* other,
           const float* weights4, const int* table, const int* counts,
           int n_rows, int n_other, int width, int rows_per_thread,
           const int* pred, int pred_value, int* tally, float* out,
           void* stream) {
  const int grid = n_rows / (kCpdThreads * rows_per_thread);
  const size_t smem = sizeof(int) * static_cast<size_t>(width);
  const auto w4 = reinterpret_cast<const float4*>(weights4);
  const auto st = static_cast<cudaStream_t>(stream);
  if (rows_per_thread == 2) {
    cpd_cand_kernel<kMoments, 2><<<grid, kCpdThreads, smem, st>>>(
        scalars, rows, other, w4, table, counts, n_rows, n_other, width,
        pred, pred_value, tally, out);
  } else {
    cpd_cand_kernel<kMoments, 1><<<grid, kCpdThreads, smem, st>>>(
        scalars, rows, other, w4, table, counts, n_rows, n_other, width,
        pred, pred_value, tally, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One pair: scalars f32[4], ty f32[m, 3], target f32[n, 3], table
// i32[n / (threads * rows_per_thread), width] (moving blocks and their
// segment masks), counts i32[n / (threads * rows_per_thread)], all on the
// device and contiguous, n and m multiples of 1024, threads and
// rows_per_thread the wrapper's geometry (64, and 1 or 2); denom f32[n] is
// written here.  pred (device i32[1], or null: always run), pred_value and
// tally (device i32[2], or null) as the header says.  Returns a cudaError_t
// as int.
extern "C" int tpuslam_cpd_denom_cand(const float* scalars, const float* ty,
                                      const float* target, const int* table,
                                      const int* counts, int n, int m,
                                      int width, int threads,
                                      int rows_per_thread, const int* pred,
                                      int pred_value, int* tally, float* denom,
                                      void* stream) {
  if (n == 0) return 0;  // nothing to launch
  if (bad_shape(n, m, width, threads, rows_per_thread)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(scalars, target, ty, nullptr, table, counts, n, m,
                       width, rows_per_thread, pred, pred_value, tally, denom,
                       stream);
}

// weights4 f32[n, 4] (16-byte aligned), table i32[m / (threads *
// rows_per_thread), width] (target blocks and masks), counts, pred and
// tally beside the above; acc f32[4, m] is written here.  Returns a
// cudaError_t as int.
extern "C" int tpuslam_cpd_moments_cand(const float* scalars, const float* ty,
                                        const float* target,
                                        const float* weights4,
                                        const int* table, const int* counts,
                                        int n, int m, int width, int threads,
                                        int rows_per_thread, const int* pred,
                                        int pred_value, int* tally, float* acc,
                                        void* stream) {
  if (m == 0) return 0;  // nothing to launch
  if (bad_shape(n, m, width, threads, rows_per_thread)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(scalars, ty, target, weights4, table, counts, m, n,
                      width, rows_per_thread, pred, pred_value, tally, acc,
                      stream);
}
