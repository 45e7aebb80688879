// P: weighted Procrustes with a 3x3 SVD, and the ICP error sum, on the
// device, CUDA C++ for sm_90a.
//
// Port-only: the JAX package computes this with jnp outside any Pallas
// kernel (tpuslam/ops/procrustes.py:47-67, the error at
// tpuslam/algorithms/icp.py:173-174), and XLA keeps it inside the ICP
// loop's one device program.  Eager PyTorch would call cuSOLVER's svd and
// det, which read the host twice a query; this kernel reads nothing back.
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
// partial; a second stage sums a pair's partials in index order (one warp
// a pair, lane-strided, then a fixed shuffle tree).  No atomics: a pair
// of a batch gets the bits of its solo call, and two runs the same bits.
//
// The SVD: one-sided Jacobi (Hestenes) on the columns of H in float64
// registers, one thread a pair, a fixed number of sweeps; singular values
// sorted descending (stable), as LAPACK's.  R is built as
// u0 v0^T + u1 v1^T + (u0 x u1)(v0 x v1)^T, which equals
// U diag(1, 1, det(U V^T)) V^T and stays defined where the third singular
// value is 0 (rank 2: R is still unique).  det(U V^T) is the sign of
// det(H) (+1 where det(H) is 0).  A non-finite H gives NaN R, s and det.
//
// Bound on this card: the bytes.  Each pass reads 28 bytes a row (before,
// after, w), so 56 bytes a row in all: 5.7 MB at 102,400 rows, 1.7 us at
// 3.35 TB/s.  The float64 adds (7 and 9 a row) are far below the card's
// float64 rate.  The design keeps every read coalesced (three floats of a
// row are 12 contiguous bytes, neighbouring threads neighbouring rows) and
// spends no atomics; the SVD is a few hundred float64 operations a pair.
//
// The C entry points launch on the caller's stream, allocate nothing
// (the wrapper passes the partials' scratch), do not synchronise, and
// return the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tally.cuh"

namespace {

constexpr int kThreads = 256;  // threads of a pass block
constexpr int kSweeps = 12;    // Jacobi sweeps: three rotations each
constexpr int kMoments1 = 7;   // sum w, sum w b, sum w a
constexpr int kMoments2 = 9;   // H, row-major
constexpr int kErr = 1;        // sum w |diff|^2

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

// A pair's K partials over nchunks chunks summed in index order by one
// warp: lane l takes chunks l, l + 32, ... in turn, then a fixed shuffle
// tree.  Lane 0 holds the result.
template <int K>
__device__ void warp_sum_partials(const double* part, int nchunks, double (&v)[K]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.0;
  for (int c = lane; c < nchunks; c += 32) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += part[static_cast<size_t>(c) * K + k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
}

// pass 1: per chunk, sum w, sum w b (3), sum w a (3)
__global__ void __launch_bounds__(kThreads)
    moments1_kernel(const float* __restrict__ before, const float* __restrict__ after,
                    const float* __restrict__ w, int n, int chunk_rows, int nchunks,
                    double* __restrict__ part) {
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
  if (threadIdx.x == 0) {
    double* out = part + (static_cast<size_t>(b) * nchunks + blockIdx.x) * kMoments1;
#pragma unroll
    for (int k = 0; k < kMoments1; ++k) out[k] = v[k];
  }
}

// stage 2 of pass 1: per pair, means f32[B, 8] = (total, mu_b, mu_a, 0)
__global__ void means_kernel(const double* __restrict__ part, int nchunks,
                             float* __restrict__ means, int* __restrict__ tally) {
  tally_launch(tally, false);
  const int b = blockIdx.x;
  double v[kMoments1];
  warp_sum_partials(part + static_cast<size_t>(b) * nchunks * kMoments1, nchunks, v);
  if (threadIdx.x == 0) {
    const float total = fmaxf(static_cast<float>(v[0]), 1e-12f);
    float* out = means + 8 * static_cast<size_t>(b);
    out[0] = total;
#pragma unroll
    for (int k = 1; k < kMoments1; ++k) out[k] = __fdiv_rn(static_cast<float>(v[k]), total);
    out[7] = 0.0f;
  }
}

// pass 2: per chunk, H = sum (w (a - mu_a)) (b - mu_b)^T, row-major
__global__ void __launch_bounds__(kThreads)
    moments2_kernel(const float* __restrict__ before, const float* __restrict__ after,
                    const float* __restrict__ w, const float* __restrict__ means, int n,
                    int chunk_rows, int nchunks, double* __restrict__ part) {
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
  if (threadIdx.x == 0) {
    double* out = part + (static_cast<size_t>(b) * nchunks + blockIdx.x) * kMoments2;
#pragma unroll
    for (int k = 0; k < kMoments2; ++k) out[k] = v[k];
  }
}

__device__ double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ void cross3(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ bool normalize3(double* a) {
  const double len = sqrt(dot3(a, a));
  if (!(len > 0.0)) return false;
  a[0] /= len;
  a[1] /= len;
  a[2] /= len;
  return true;
}

// The proper rotation nearest to h (row-major 3x3, float64): r (row-major),
// the singular values s (descending) and det(U V^T).  Returns false for a
// non-finite h (the outputs are then unset).
__device__ bool svd3_rotation(const double* h, double* r, double* s, double* det) {
  for (int k = 0; k < 9; ++k) {
    if (!isfinite(h[k])) return false;
  }
  // columns of A = H, and of V, stored column by column: a[j][i] = A[i][j]
  double a[3][3], v[3][3];
  for (int j = 0; j < 3; ++j) {
    for (int i = 0; i < 3; ++i) {
      a[j][i] = h[3 * i + j];
      v[j][i] = i == j ? 1.0 : 0.0;
    }
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0;
      const int q = pq == 0 ? 1 : 2;
      const double alpha = dot3(a[p], a[p]);
      const double beta = dot3(a[q], a[q]);
      const double gamma = dot3(a[p], a[q]);
      if (gamma == 0.0) continue;  // already orthogonal
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double t = copysign(1.0, zeta) / (fabs(zeta) + hypot(1.0, zeta));
      const double c = 1.0 / sqrt(1.0 + t * t);
      const double sn = c * t;
      for (int i = 0; i < 3; ++i) {
        const double ap = a[p][i], aq = a[q][i];
        a[p][i] = c * ap - sn * aq;
        a[q][i] = sn * ap + c * aq;
        const double vp = v[p][i], vq = v[q][i];
        v[p][i] = c * vp - sn * vq;
        v[q][i] = sn * vp + c * vq;
      }
    }
  }
  double sv[3] = {sqrt(dot3(a[0], a[0])), sqrt(dot3(a[1], a[1])), sqrt(dot3(a[2], a[2]))};
  // stable descending sort of the columns
  const int order[3][2] = {{0, 1}, {1, 2}, {0, 1}};
  for (int k = 0; k < 3; ++k) {
    const int i = order[k][0], j = order[k][1];
    if (sv[i] < sv[j]) {
      const double ts = sv[i];
      sv[i] = sv[j];
      sv[j] = ts;
      for (int e = 0; e < 3; ++e) {
        double tmp = a[i][e];
        a[i][e] = a[j][e];
        a[j][e] = tmp;
        tmp = v[i][e];
        v[i][e] = v[j][e];
        v[j][e] = tmp;
      }
    }
  }
  // U's first two columns; where a singular value is 0 the column is
  // completed orthonormally (R is then not unique for sigma_1 = 0)
  double u0[3], u1[3];
  for (int e = 0; e < 3; ++e) {
    u0[e] = a[0][e];
    u1[e] = a[1][e];
  }
  if (!normalize3(u0)) {
    for (int e = 0; e < 3; ++e) u0[e] = v[0][e];  // H = 0: U = V, R = I
    for (int e = 0; e < 3; ++e) u1[e] = v[1][e];
  } else {
    const double proj = dot3(u0, u1);
    for (int e = 0; e < 3; ++e) u1[e] -= proj * u0[e];
    if (!(sv[1] > 0.0) || !normalize3(u1)) {
      // any unit vector orthogonal to u0: the axis least along u0, crossed
      int k = 0;
      for (int e = 1; e < 3; ++e) {
        if (fabs(u0[e]) < fabs(u0[k])) k = e;
      }
      const double axis[3] = {k == 0 ? 1.0 : 0.0, k == 1 ? 1.0 : 0.0, k == 2 ? 1.0 : 0.0};
      cross3(u0, axis, u1);
      normalize3(u1);
    }
  }
  double u2[3], v2[3];
  cross3(u0, u1, u2);
  cross3(v[0], v[1], v2);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      r[3 * i + j] = u0[i] * v[0][j] + u1[i] * v[1][j] + u2[i] * v2[j];
    }
  }
  const double dh = h[0] * (h[4] * h[8] - h[5] * h[7]) - h[1] * (h[3] * h[8] - h[5] * h[6]) +
                    h[2] * (h[3] * h[7] - h[4] * h[6]);
  *det = dh < 0.0 ? -1.0 : 1.0;
  for (int k = 0; k < 3; ++k) s[k] = sv[k];
  return true;
}

// stage 2 of pass 2: per pair, H, its SVD, R f32[B, 3, 3] and t f32[B, 3]
__global__ void solve_kernel(const double* __restrict__ part, int nchunks,
                             const float* __restrict__ means, float* __restrict__ r_out,
                             float* __restrict__ t_out) {
  const int b = blockIdx.x;
  double h[kMoments2];
  warp_sum_partials(part + static_cast<size_t>(b) * nchunks * kMoments2, nchunks, h);
  if (threadIdx.x != 0) return;
  double r[9], s[3], det;
  float rf[9];
  if (svd3_rotation(h, r, s, &det)) {
    for (int k = 0; k < 9; ++k) rf[k] = static_cast<float>(r[k]);
  } else {
    for (int k = 0; k < 9; ++k) rf[k] = CUDART_NAN_F;
  }
  const float* mu = means + 8 * static_cast<size_t>(b);
  for (int k = 0; k < 9; ++k) r_out[9 * static_cast<size_t>(b) + k] = rf[k];
  for (int i = 0; i < 3; ++i) {
    const float rm = __fadd_rn(__fadd_rn(__fmul_rn(rf[3 * i], mu[1]), __fmul_rn(rf[3 * i + 1], mu[2])),
                               __fmul_rn(rf[3 * i + 2], mu[3]));
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
  for (int k = 0; k < 9; ++k) hd[k] = static_cast<double>(h[9 * static_cast<size_t>(b) + k]);
  const bool ok = svd3_rotation(hd, r, s, &det);
  for (int k = 0; k < 9; ++k) {
    r_out[9 * static_cast<size_t>(b) + k] = ok ? static_cast<float>(r[k]) : CUDART_NAN_F;
  }
  for (int k = 0; k < 3; ++k) {
    s_out[3 * static_cast<size_t>(b) + k] = ok ? static_cast<float>(s[k]) : CUDART_NAN_F;
  }
  det_out[b] = ok ? static_cast<float>(det) : CUDART_NAN_F;
}

// the ICP error: per chunk, sum over rows of w * (dx*dx + dy*dy + dz*dz),
// the row's sum rounded to float32 as the plain version rounds it
__global__ void __launch_bounds__(kThreads)
    sq_error_kernel(const float* __restrict__ diff, const float* __restrict__ w, int n,
                    int chunk_rows, int nchunks, double* __restrict__ part) {
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
  if (threadIdx.x == 0) part[static_cast<size_t>(b) * nchunks + blockIdx.x] = v[0];
}

__global__ void sq_error_final_kernel(const double* __restrict__ part, int nchunks,
                                      const float* __restrict__ n_corr,
                                      float* __restrict__ err, int* __restrict__ tally) {
  tally_launch(tally, false);
  const int b = blockIdx.x;
  double v[kErr];
  warp_sum_partials(part + static_cast<size_t>(b) * nchunks, nchunks, v);
  if (threadIdx.x == 0) {
    err[b] = __fdiv_rn(static_cast<float>(v[0]), fmaxf(n_corr[b], 1.0f));
  }
}

bool bad_shape(int batch, int n, int chunk_rows, int nchunks) {
  return batch <= 0 || batch > 65535 || n < 0 || chunk_rows <= 0 ||
         chunk_rows % kThreads != 0 ||
         nchunks != (n + chunk_rows - 1) / chunk_rows;
}

}  // namespace

// before, after f32[batch, n, 3], w f32[batch, n]; scratch part1
// f64[batch, nchunks, 7], means f32[batch, 8], part2 f64[batch, nchunks, 9];
// r f32[batch, 3, 3] and t f32[batch, 3] written here.  All on the device
// and contiguous; nchunks = ceil(n / chunk_rows), chunk_rows a multiple of
// 256 (kernels/procrustes.py::CHUNK_ROWS).  Four launches: pass 1, means,
// pass 2, solve.  tally (device i32[2], or null) counts the entry's call
// once (tally.cuh), from the means kernel, which always runs.  Returns a
// cudaError_t as int: 0 when every launch was taken.
extern "C" int tpuslam_procrustes(const float* before, const float* after, const float* w,
                                  int batch, int n, int chunk_rows, int nchunks,
                                  double* part1, float* means, double* part2, float* r,
                                  float* t, int* tally, void* stream) {
  if (bad_shape(batch, n, chunk_rows, nchunks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nchunks > 0) {
    moments1_kernel<<<dim3(nchunks, batch), kThreads, 0, st>>>(before, after, w, n, chunk_rows,
                                                               nchunks, part1);
  }
  means_kernel<<<batch, 32, 0, st>>>(part1, nchunks, means, tally);
  if (nchunks > 0) {
    moments2_kernel<<<dim3(nchunks, batch), kThreads, 0, st>>>(before, after, w, means, n,
                                                               chunk_rows, nchunks, part2);
  }
  solve_kernel<<<batch, 32, 0, st>>>(part2, nchunks, means, r, t);
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
// f64[batch, nchunks]; err f32[batch] = sum_rows w |diff|^2 / max(n_corr, 1)
// written here.  Two launches; tally as tpuslam_procrustes's, from the
// second.  Returns a cudaError_t as int.
extern "C" int tpuslam_masked_sq_error(const float* diff, const float* w, const float* n_corr,
                                       int batch, int n, int chunk_rows, int nchunks,
                                       double* part, float* err, int* tally, void* stream) {
  if (bad_shape(batch, n, chunk_rows, nchunks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nchunks > 0) {
    sq_error_kernel<<<dim3(nchunks, batch), kThreads, 0, st>>>(diff, w, n, chunk_rows, nchunks,
                                                               part);
  }
  sq_error_final_kernel<<<batch, 32, 0, st>>>(part, nchunks, n_corr, err, tally);
  return static_cast<int>(cudaGetLastError());
}
