// P: weighted Procrustes with a 3x3 SVD, the ICP error sum and the CPD
// M-step's moments, on the device, CUDA C++ for sm_90a.
//
// Port-only: the JAX package computes these with jnp outside any Pallas
// kernel (tpuslam/ops/procrustes.py:47-67, the error at
// tpuslam/algorithms/icp.py:173-174, the M-step's sums at
// tpuslam/algorithms/cpd.py:408), and XLA keeps them inside the loops' one
// device program.  Eager PyTorch would call cuSOLVER's svd and det, which
// read the host twice a query; these kernels read nothing back.
//
// Per pair b of before, after f32[B, N, 3] and w f32[B, N], the JAX
// formula:
//   total = max(sum w, 1e-12), mu_b = sum w b / total, mu_a = sum w a / total,
//   H = sum w (a - mu_a)(b - mu_b)^T   (two passes, centred: never the
//                                       one-pass sum w a b^T - total mu_a mu_b^T),
//   R = U diag(1, 1, det(U V^T)) V^T,  t = mu_a - R mu_b.
//
// Reductions run in a fixed order that does not depend on B: a pair's rows
// are cut into chunks of chunk_rows rows, one block a chunk, each block
// sums its rows in float64 in a fixed thread-and-tree order and writes its
// partial.  The block that finishes a pair last (a device counter a pair,
// "arrivals", bumped after a __threadfence) then adds all of the pair's
// partials, thread t taking chunks t, t + 256, ... in turn and a fixed
// tree after, and resets the counter to 0 for the next launch.  Which block
// finishes last depends on scheduling; the order of the additions does
// not, so a pair of a batch gets the bits of its solo call, and two runs
// the same bits.  No atomics touch a sum.
//
// Launches: Procrustes 2 (pass 1, whose last block writes the means; pass
// 2, whose last block adds H, solves its SVD and writes R and t), the error
// 1, the M-step's moments 1, the SVD entry 1.  Chunks of 512 rows give 200
// blocks at 102,400 rows, two blocks an SM on the H100's 132; the partition
// depends on N alone.
//
// The SVD: one-sided Jacobi (Hestenes) on the columns of H in float64
// registers, one thread a pair, fully unrolled (the three column pairs are
// compile-time indices, so nothing spills to local memory), on H scaled by
// a power of two so that its largest entry lies in [1, 2) (exact; undone on
// the singular values).  A rotation is skipped where the columns are
// orthogonal to float64 round-off (|a_p . a_q| <= eps |a_p| |a_q|), and the
// sweeps stop at the first in which every rotation was skipped (at most 12):
// deterministic for a given H, and 3 to 5 sweeps where 12 were always run.
// Singular values sorted descending (stable), as LAPACK's.  R is built as
// u0 v0^T + u1 v1^T + (u0 x u1)(v0 x v1)^T, which equals
// U diag(1, 1, det(U V^T)) V^T and stays defined where the third singular
// value is 0 (rank 2: R is still unique).  det(U V^T) is the sign of
// det(H) (+1 where det(H) is 0).  A non-finite H gives NaN R, s and det.
//
// Bound on this card: the bytes.  Procrustes reads 28 bytes a row (before,
// after, w) once from HBM; pass 2 re-reads them from L2 (2.9 MB at 102,400
// rows, in the 50 MB).  The M-step's moments read 28 bytes a moving row
// (p1, moving, px) and 16 a target row (pt1, target).  The float64 adds
// (7 and 9 a row; 14 and 4) are far below the card's float64 rate.  Every
// read is coalesced (three floats of a row are 12 contiguous bytes,
// neighbouring threads neighbouring rows).
//
// The C entry points launch on the caller's stream, allocate nothing
// (the wrapper passes the partials' scratch and the arrival counters), do
// not synchronise, and return the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tally.cuh"

namespace {

constexpr int kThreads = 256;   // threads of a pass block
constexpr int kMaxSweeps = 12;  // Jacobi sweeps at most: three rotations each
constexpr double kEps = 2.220446049250313e-16;  // float64's epsilon
constexpr int kMoments1 = 7;    // sum w, sum w b, sum w a
constexpr int kMoments2 = 9;    // H, row-major
constexpr int kErr = 1;         // sum w |diff|^2
// the CPD M-step's sums: sum p1, sum p1 y (3), sum pt1 x (3), sum px y^T
// (9, row-major), sum pt1 |x|^2, sum p1 |y|^2 (y moving, x target rows)
constexpr int kMstep = 18;

// The block's per-thread values summed in a fixed tree order; thread 0
// holds the result.  s has kThreads * K doubles.
template <int K>
__device__ void block_sum(double (&v)[K], double* s) {
#pragma unroll
  for (int k = 0; k < K; ++k) s[k * kThreads + threadIdx.x] = v[k];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s[k * kThreads + threadIdx.x] += s[k * kThreads + threadIdx.x + half];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = s[k * kThreads];
}

// Thread 0 stores the block's K partials; then the block learns whether it
// is the last of the pair's `blocks` to do so.  In that block every thread
// returns true and the partials of all blocks are visible to it.
template <int K>
__device__ bool store_and_arrive(const double (&v)[K], double* part, int* arrivals,
                                 int blocks) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[k] = v[k];
    __threadfence();  // the partial is seen before the arrival
    last = atomicAdd(arrivals, 1) == blocks - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last block: the pair's partials part[blocks][K] added in a fixed
// order (thread t takes blocks t, t + kThreads, ... in turn, then the
// block's tree), and the arrival counter reset.  Thread 0 holds the sums.
template <int K>
__device__ void sum_partials(const double* part, int blocks, int* arrivals, double (&v)[K],
                             double* s) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.0;
  for (int c = threadIdx.x; c < blocks; c += kThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __ldcg(part + static_cast<size_t>(c) * K + k);
  }
  block_sum(v, s);
  if (threadIdx.x == 0) *arrivals = 0;
}

// pass 1: per chunk, sum w, sum w b (3), sum w a (3); the last block of a
// pair writes means f32[B, 8] = (total, mu_b, mu_a, 0)
__global__ void __launch_bounds__(kThreads)
    moments1_kernel(const float* __restrict__ before, const float* __restrict__ after,
                    const float* __restrict__ w, int n, int chunk_rows, int nchunks,
                    double* __restrict__ part, float* __restrict__ means,
                    int* __restrict__ arrivals, int* __restrict__ tally) {
  tally_launch(tally, false);
  __shared__ double s[kMoments1 * kThreads];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * chunk_rows;
  const int r1 = min(r0 + chunk_rows, n);
  const size_t base = static_cast<size_t>(b) * n;
  double v[kMoments1] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const size_t i = base + r;
    const float wi = w[i];
    v[0] += static_cast<double>(wi);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // before * w and after * w rounded to float32, as the plain version
      v[1 + c] += static_cast<double>(__fmul_rn(before[3 * i + c], wi));
      v[4 + c] += static_cast<double>(__fmul_rn(after[3 * i + c], wi));
    }
  }
  block_sum(v, s);
  double* pair_part = part + static_cast<size_t>(b) * nchunks * kMoments1;
  if (!store_and_arrive(v, pair_part + static_cast<size_t>(blockIdx.x) * kMoments1,
                        arrivals + b, nchunks)) {
    return;
  }
  sum_partials(pair_part, nchunks, arrivals + b, v, s);
  if (threadIdx.x == 0) {
    const float total = fmaxf(static_cast<float>(v[0]), 1e-12f);
    float* out = means + 8 * static_cast<size_t>(b);
    out[0] = total;
#pragma unroll
    for (int k = 1; k < kMoments1; ++k) out[k] = __fdiv_rn(static_cast<float>(v[k]), total);
    out[7] = 0.0f;
  }
}

__device__ __forceinline__ double dot3(const double (&a)[3], const double (&b)[3]) {
  return fma(a[2], b[2], fma(a[1], b[1], a[0] * b[0]));
}

__device__ __forceinline__ void cross3(const double (&a)[3], const double (&b)[3],
                                       double (&c)[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ bool normalize3(double (&a)[3]) {
  const double len2 = dot3(a, a);
  if (!(len2 > 0.0)) return false;
  const double inv = rsqrt(len2);
  a[0] *= inv;
  a[1] *= inv;
  a[2] *= inv;
  return true;
}

// One Jacobi rotation of columns p and q of A (and of V) that makes them
// orthogonal; false (and nothing changed) where they already are to
// float64 round-off.  The rotation's tangent needs no accuracy of its own:
// c = 1/sqrt(1 + t^2) and s = c t keep it orthogonal whatever t is.
__device__ __forceinline__ bool jacobi_rotate(double (&ap)[3], double (&aq)[3],
                                              double (&vp)[3], double (&vq)[3]) {
  const double alpha = dot3(ap, ap);
  const double beta = dot3(aq, aq);
  const double gamma = dot3(ap, aq);
  if (!(fabs(gamma) > kEps * sqrt(alpha * beta))) return false;
  const double zeta = (beta - alpha) * (0.5 * __drcp_rn(gamma));
  const double t = copysign(__drcp_rn(fabs(zeta) + sqrt(fma(zeta, zeta, 1.0))), zeta);
  const double c = rsqrt(fma(t, t, 1.0));
  const double sn = c * t;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double a_p = ap[i], a_q = aq[i];
    ap[i] = c * a_p - sn * a_q;
    aq[i] = sn * a_p + c * a_q;
    const double v_p = vp[i], v_q = vq[i];
    vp[i] = c * v_p - sn * v_q;
    vq[i] = sn * v_p + c * v_q;
  }
  return true;
}

// swap columns i and j (and their singular values) where sv_i < sv_j
__device__ __forceinline__ void order2(double& si, double& sj, double (&ai)[3], double (&aj)[3],
                                       double (&vi)[3], double (&vj)[3]) {
  if (si < sj) {
    const double ts = si;
    si = sj;
    sj = ts;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      double tmp = ai[e];
      ai[e] = aj[e];
      aj[e] = tmp;
      tmp = vi[e];
      vi[e] = vj[e];
      vj[e] = tmp;
    }
  }
}

// The proper rotation nearest to h (row-major 3x3, float64): r (row-major),
// the singular values s (descending) and det(U V^T).  Returns false for a
// non-finite h (the outputs are then unset).
__device__ bool svd3_rotation(const double (&h)[9], double (&r)[9], double (&s)[3],
                              double* det) {
  double hmax = 0.0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (!isfinite(h[k])) return false;
    hmax = fmax(hmax, fabs(h[k]));
  }
  // a power of two that brings the largest entry into [1, 2): exact
  int e2 = 0;
  if (hmax > 0.0) frexp(hmax, &e2);
  const int shift = 1 - e2;
  // the columns of A = H 2^shift, and of V
  double a0[3], a1[3], a2[3];
  double v0[3] = {1.0, 0.0, 0.0}, v1[3] = {0.0, 1.0, 0.0}, v2[3] = {0.0, 0.0, 1.0};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a0[i] = ldexp(h[3 * i], shift);
    a1[i] = ldexp(h[3 * i + 1], shift);
    a2[i] = ldexp(h[3 * i + 2], shift);
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    const bool r01 = jacobi_rotate(a0, a1, v0, v1);
    const bool r02 = jacobi_rotate(a0, a2, v0, v2);
    const bool r12 = jacobi_rotate(a1, a2, v1, v2);
    if (!(r01 || r02 || r12)) break;
  }
  double sv0 = sqrt(dot3(a0, a0)), sv1 = sqrt(dot3(a1, a1)), sv2 = sqrt(dot3(a2, a2));
  // stable descending sort of the columns
  order2(sv0, sv1, a0, a1, v0, v1);
  order2(sv1, sv2, a1, a2, v1, v2);
  order2(sv0, sv1, a0, a1, v0, v1);
  // U's first two columns; where a singular value is 0 the column is
  // completed orthonormally (R is then not unique for sigma_1 = 0)
  double u0[3] = {a0[0], a0[1], a0[2]};
  double u1[3] = {a1[0], a1[1], a1[2]};
  if (!normalize3(u0)) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      u0[e] = v0[e];  // H = 0: U = V, R = I
      u1[e] = v1[e];
    }
  } else {
    const double proj = dot3(u0, u1);
#pragma unroll
    for (int e = 0; e < 3; ++e) u1[e] -= proj * u0[e];
    if (!(sv1 > 0.0) || !normalize3(u1)) {
      // any unit vector orthogonal to u0: the axis least along u0, crossed
      int k = 0;
      if (fabs(u0[1]) < fabs(u0[k])) k = 1;
      if (fabs(u0[2]) < fabs(u0[k])) k = 2;
      const double axis[3] = {k == 0 ? 1.0 : 0.0, k == 1 ? 1.0 : 0.0, k == 2 ? 1.0 : 0.0};
      cross3(u0, axis, u1);
      normalize3(u1);
    }
  }
  double u2[3], w2[3];
  cross3(u0, u1, u2);
  cross3(v0, v1, w2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[3 * i + j] = u0[i] * v0[j] + u1[i] * v1[j] + u2[i] * w2[j];
    }
  }
  const double dh = h[0] * (h[4] * h[8] - h[5] * h[7]) - h[1] * (h[3] * h[8] - h[5] * h[6]) +
                    h[2] * (h[3] * h[7] - h[4] * h[6]);
  *det = dh < 0.0 ? -1.0 : 1.0;
  s[0] = ldexp(sv0, -shift);
  s[1] = ldexp(sv1, -shift);
  s[2] = ldexp(sv2, -shift);
  return true;
}

// pass 2: per chunk, H = sum (w (a - mu_a)) (b - mu_b)^T, row-major; the
// last block of a pair adds H, solves its SVD and writes R f32[B, 3, 3] and
// t f32[B, 3]
__global__ void __launch_bounds__(kThreads)
    moments2_kernel(const float* __restrict__ before, const float* __restrict__ after,
                    const float* __restrict__ w, const float* __restrict__ means, int n,
                    int chunk_rows, int nchunks, double* __restrict__ part,
                    int* __restrict__ arrivals, float* __restrict__ r_out,
                    float* __restrict__ t_out) {
  __shared__ double s[kMoments2 * kThreads];
  const int b = blockIdx.y;
  const float* mu = means + 8 * static_cast<size_t>(b);
  const float mb0 = mu[1], mb1 = mu[2], mb2 = mu[3];
  const float ma0 = mu[4], ma1 = mu[5], ma2 = mu[6];
  const int r0 = blockIdx.x * chunk_rows;
  const int r1 = min(r0 + chunk_rows, n);
  const size_t base = static_cast<size_t>(b) * n;
  double v[kMoments2] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const size_t i = base + r;
    const float wi = w[i];
    const double bc[3] = {static_cast<double>(__fsub_rn(before[3 * i], mb0)),
                          static_cast<double>(__fsub_rn(before[3 * i + 1], mb1)),
                          static_cast<double>(__fsub_rn(before[3 * i + 2], mb2))};
    const double acw[3] = {
        static_cast<double>(__fmul_rn(__fsub_rn(after[3 * i], ma0), wi)),
        static_cast<double>(__fmul_rn(__fsub_rn(after[3 * i + 1], ma1), wi)),
        static_cast<double>(__fmul_rn(__fsub_rn(after[3 * i + 2], ma2), wi))};
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) v[3 * rr + cc] += acw[rr] * bc[cc];  // exact product
    }
  }
  block_sum(v, s);
  double* pair_part = part + static_cast<size_t>(b) * nchunks * kMoments2;
  if (!store_and_arrive(v, pair_part + static_cast<size_t>(blockIdx.x) * kMoments2,
                        arrivals + b, nchunks)) {
    return;
  }
  sum_partials(pair_part, nchunks, arrivals + b, v, s);
  if (threadIdx.x != 0) return;
  double r[9], sv[3], det;
  float rf[9];
  if (svd3_rotation(v, r, sv, &det)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) rf[k] = static_cast<float>(r[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) rf[k] = CUDART_NAN_F;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) r_out[9 * static_cast<size_t>(b) + k] = rf[k];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float rm = __fadd_rn(__fadd_rn(__fmul_rn(rf[3 * i], mb0), __fmul_rn(rf[3 * i + 1], mb1)),
                               __fmul_rn(rf[3 * i + 2], mb2));
    t_out[3 * static_cast<size_t>(b) + i] = __fsub_rn(mu[4 + i], rm);
  }
}

// svd_rotation_det on a batch of float32 3x3 matrices, one thread a pair
__global__ void svd_kernel(const float* __restrict__ h, int batch, float* __restrict__ r_out,
                           float* __restrict__ s_out, float* __restrict__ det_out,
                           int* __restrict__ tally) {
  tally_launch(tally, false);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  double hd[9], r[9], s[3], det;
#pragma unroll
  for (int k = 0; k < 9; ++k) hd[k] = static_cast<double>(h[9 * static_cast<size_t>(b) + k]);
  const bool ok = svd3_rotation(hd, r, s, &det);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    r_out[9 * static_cast<size_t>(b) + k] = ok ? static_cast<float>(r[k]) : CUDART_NAN_F;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s_out[3 * static_cast<size_t>(b) + k] = ok ? static_cast<float>(s[k]) : CUDART_NAN_F;
  }
  det_out[b] = ok ? static_cast<float>(det) : CUDART_NAN_F;
}

// the ICP error: per chunk, sum over rows of w * (dx*dx + dy*dy + dz*dz),
// the row's sum rounded to float32 as the plain version rounds it; the last
// block of a pair writes err[b] = sum / max(n_corr[b], 1)
__global__ void __launch_bounds__(kThreads)
    sq_error_kernel(const float* __restrict__ diff, const float* __restrict__ w, int n,
                    int chunk_rows, int nchunks, const float* __restrict__ n_corr,
                    double* __restrict__ part, int* __restrict__ arrivals,
                    float* __restrict__ err, int* __restrict__ tally) {
  tally_launch(tally, false);
  __shared__ double s[kErr * kThreads];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * chunk_rows;
  const int r1 = min(r0 + chunk_rows, n);
  const size_t base = static_cast<size_t>(b) * n;
  double v[kErr] = {0.0};
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const size_t i = base + r;
    const float dx = diff[3 * i], dy = diff[3 * i + 1], dz = diff[3 * i + 2];
    const float row = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    v[0] += static_cast<double>(__fmul_rn(row, w[i]));
  }
  block_sum(v, s);
  double* pair_part = part + static_cast<size_t>(b) * nchunks * kErr;
  if (!store_and_arrive(v, pair_part + blockIdx.x, arrivals + b, nchunks)) return;
  sum_partials(pair_part, nchunks, arrivals + b, v, s);
  if (threadIdx.x == 0) {
    err[b] = __fdiv_rn(static_cast<float>(v[0]), fmaxf(n_corr[b], 1.0f));
  }
}

// the CPD M-step's sums (kMstep): blocks [0, chunks_m) sum the moving rows
// (p1 f32[B, M], y f32[B, M, 3], px f32[B, M, 3]), blocks [chunks_m,
// chunks_m + chunks_n) the target rows (pt1 f32[B, N], x f32[B, N, 3]);
// every product of two floats is exact in float64.  The last block of a
// pair writes sums f64[B, kMstep].
__global__ void __launch_bounds__(kThreads)
    mstep_moments_kernel(const float* __restrict__ p1, const float* __restrict__ y,
                         const float* __restrict__ px, int m, const float* __restrict__ pt1,
                         const float* __restrict__ x, int n, int chunk_rows, int chunks_m,
                         int chunks_n, double* __restrict__ part, int* __restrict__ arrivals,
                         double* __restrict__ sums, int* __restrict__ tally) {
  tally_launch(tally, false);
  __shared__ double s[kMstep * kThreads];
  const int b = blockIdx.y;
  double v[kMstep];
#pragma unroll
  for (int k = 0; k < kMstep; ++k) v[k] = 0.0;
  if (static_cast<int>(blockIdx.x) < chunks_m) {
    const int r0 = blockIdx.x * chunk_rows;
    const int r1 = min(r0 + chunk_rows, m);
    const size_t base = static_cast<size_t>(b) * m;
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
      const size_t i = base + r;
      const double p = static_cast<double>(p1[i]);
      const double yy[3] = {static_cast<double>(y[3 * i]), static_cast<double>(y[3 * i + 1]),
                            static_cast<double>(y[3 * i + 2])};
      const double xx[3] = {static_cast<double>(px[3 * i]), static_cast<double>(px[3 * i + 1]),
                            static_cast<double>(px[3 * i + 2])};
      v[0] += p;
#pragma unroll
      for (int c = 0; c < 3; ++c) v[1 + c] += p * yy[c];
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) v[7 + 3 * rr + cc] += xx[rr] * yy[cc];
      }
      v[17] += p * dot3(yy, yy);
    }
  } else {
    const int r0 = (blockIdx.x - chunks_m) * chunk_rows;
    const int r1 = min(r0 + chunk_rows, n);
    const size_t base = static_cast<size_t>(b) * n;
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
      const size_t i = base + r;
      const double q = static_cast<double>(pt1[i]);
      const double xx[3] = {static_cast<double>(x[3 * i]), static_cast<double>(x[3 * i + 1]),
                            static_cast<double>(x[3 * i + 2])};
#pragma unroll
      for (int c = 0; c < 3; ++c) v[4 + c] += q * xx[c];
      v[16] += q * dot3(xx, xx);
    }
  }
  block_sum(v, s);
  const int blocks = chunks_m + chunks_n;
  double* pair_part = part + static_cast<size_t>(b) * blocks * kMstep;
  if (!store_and_arrive(v, pair_part + static_cast<size_t>(blockIdx.x) * kMstep,
                        arrivals + b, blocks)) {
    return;
  }
  sum_partials(pair_part, blocks, arrivals + b, v, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMstep; ++k) sums[kMstep * static_cast<size_t>(b) + k] = v[k];
  }
}

int chunks_of(int n, int chunk_rows) {
  return n > chunk_rows ? (n + chunk_rows - 1) / chunk_rows : 1;
}

bool bad_shape(int batch, int n, int chunk_rows, int nchunks) {
  return batch <= 0 || batch > 65535 || n < 0 || chunk_rows <= 0 ||
         chunk_rows % kThreads != 0 || nchunks != chunks_of(n, chunk_rows);
}

}  // namespace

// before, after f32[batch, n, 3], w f32[batch, n]; scratch part1
// f64[batch, nchunks, 7], means f32[batch, 8], part2 f64[batch, nchunks, 9];
// arrivals i32[batch], all 0 (each launch leaves them 0); r f32[batch, 3, 3]
// and t f32[batch, 3] written here.  All on the device and contiguous;
// nchunks = max(1, ceil(n / chunk_rows)), chunk_rows a multiple of 256
// (kernels/procrustes.py::CHUNK_ROWS).  Two launches: pass 1 (its last
// block writes the means), pass 2 (its last block solves).  tally (device
// i32[2], or null) counts the entry's call once (tally.cuh), from pass 1.
// Returns a cudaError_t as int: 0 when every launch was taken.
extern "C" int tpuslam_procrustes(const float* before, const float* after, const float* w,
                                  int batch, int n, int chunk_rows, int nchunks,
                                  double* part1, float* means, double* part2, int* arrivals,
                                  float* r, float* t, int* tally, void* stream) {
  if (bad_shape(batch, n, chunk_rows, nchunks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunks, batch);
  moments1_kernel<<<grid, kThreads, 0, st>>>(before, after, w, n, chunk_rows, nchunks, part1,
                                             means, arrivals, tally);
  moments2_kernel<<<grid, kThreads, 0, st>>>(before, after, w, means, n, chunk_rows, nchunks,
                                             part2, arrivals, r, t);
  return static_cast<int>(cudaGetLastError());
}

// h f32[batch, 3, 3]; r f32[batch, 3, 3], s f32[batch, 3] (descending) and
// det f32[batch] written here; tally as tpuslam_procrustes's.  Returns a
// cudaError_t as int.
extern "C" int tpuslam_svd_rotation_det(const float* h, int batch, float* r, float* s,
                                        float* det, int* tally, void* stream) {
  if (batch <= 0) return batch == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  constexpr int kPairsPerBlock = 128;
  svd_kernel<<<(batch + kPairsPerBlock - 1) / kPairsPerBlock, kPairsPerBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(h, batch, r, s, det, tally);
  return static_cast<int>(cudaGetLastError());
}

// diff f32[batch, n, 3], w f32[batch, n], n_corr f32[batch]; scratch part
// f64[batch, nchunks], arrivals as tpuslam_procrustes's; err f32[batch] =
// sum_rows w |diff|^2 / max(n_corr, 1) written here.  One launch; tally as
// tpuslam_procrustes's.  Returns a cudaError_t as int.
extern "C" int tpuslam_masked_sq_error(const float* diff, const float* w, const float* n_corr,
                                       int batch, int n, int chunk_rows, int nchunks,
                                       double* part, int* arrivals, float* err, int* tally,
                                       void* stream) {
  if (bad_shape(batch, n, chunk_rows, nchunks)) return static_cast<int>(cudaErrorInvalidValue);
  sq_error_kernel<<<dim3(nchunks, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      diff, w, n, chunk_rows, nchunks, n_corr, part, arrivals, err, tally);
  return static_cast<int>(cudaGetLastError());
}

// The CPD M-step's sums: p1 f32[batch, m], y f32[batch, m, 3], px
// f32[batch, m, 3], pt1 f32[batch, n], x f32[batch, n, 3]; scratch part
// f64[batch, chunks_m + chunks_n, 18], arrivals as tpuslam_procrustes's;
// sums f64[batch, 18] written here (kMstep's order).  One launch; tally as
// tpuslam_procrustes's.  Returns a cudaError_t as int.
extern "C" int tpuslam_mstep_moments(const float* p1, const float* y, const float* px, int m,
                                     const float* pt1, const float* x, int n, int batch,
                                     int chunk_rows, int chunks_m, int chunks_n, double* part,
                                     int* arrivals, double* sums, int* tally, void* stream) {
  if (bad_shape(batch, m, chunk_rows, chunks_m) || bad_shape(batch, n, chunk_rows, chunks_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mstep_moments_kernel<<<dim3(chunks_m + chunks_n, batch), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p1, y, px, m, pt1, x, n, chunk_rows, chunks_m, chunks_n, part, arrivals, sums, tally);
  return static_cast<int>(cudaGetLastError());
}
