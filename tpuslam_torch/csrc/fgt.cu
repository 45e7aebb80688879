// K6 and K7: the Fast Gauss Transform's prediction and expansion, CUDA C++
// for sm_90a.
//
// They replace no Pallas kernel: the JAX package's FGT (tpuslam/ops/fgt.py,
// fgt_predict_multi and compute_fgt_model_multi) is jnp left to XLA, and the
// port's plain version (kernels/fgt.py::predict_plain, expand_plain) is its
// torch composition, which forms every Taylor monomial dy^alpha of every
// (row, centre) pair as a float32 tensor in device memory before one
// contraction.  Here the monomials live in registers (K6) or are formed from
// per-row powers in shared memory (K7) and are contracted where they are made.
// With dy = (y - c) / h, the Taylor terms alpha in the reference's graded-lex
// order (fgt.cpp:122-137; ops/fgt.py::_alpha_table), C_alpha = 2^|alpha| /
// alpha! and g = exp(-|dy|^2):
//
//   K6  out[m, w] = sum_k [s_mk <= e] g(y_m, c_k) sum_alpha dy^alpha ak[k, alpha, w]
//   K7  ak[k, alpha, w] = C_alpha sum_{n in cluster k} g(x_n, c_k) mask_n w_nw dy^alpha
//
// A centre past the far-field radius (s = |dy|^2 > e) adds exactly 0 in the
// plain version (a `where`), so K6 skips it.  dy, s, g and each monomial are
// rounded as the plain version rounds them (a subtraction, an IEEE division,
// the squares added x, y then z, powers by repeated products from 1, the
// monomial (x^a * y^b) * z^c); only the sums differ.  K6 adds a centre's
// terms of one degree in one running sum, the degrees in order (at the
// run-time order a compensated sum over the terms), and the centres'
// contributions g * sum in a compensated sum; the plain version's matrix
// product adds (g * monomial) * ak over all (centre, term) pairs, and a
// running float32 sum over them is measurably less accurate than that
// product on the Taylor series' cancelling terms.  K7 adds a cluster's rows
// in four interleaved groups combined in order.  Every order is fixed, with
// no atomics, so two calls give the same bits.
//
// Bound: float32 arithmetic.  K6 spends per (target, centre) pair inside the cut a
// handful of operations on dy, s and g, p^2 / 2 products for the x^a y^b
// table and, per term, one product and W FMAs: at p = 8 and K = 128 a
// 100,000-row prediction is 1.28e7 pairs x 120 terms x (1 + 2 W) float32
// operations, an FMA counted as two (0.07 ms at W = 1, 0.21 ms at W = 4 on
// 67 TFLOP/s); it reads its rows once and each block stages ak (K x pd x W
// floats) through shared memory in groups of centres.  K7 is (N x pd) x (2 + W) operations, a few
// microseconds of arithmetic, bounded in practice by its largest cluster,
// which one block walks.
//
// Design.  K6: one target a thread, 128 threads a block, one launch for all
// M targets.  For the compiled orders (6 and 8: the configurations' and the
// tests') the per-dimension powers, the x^a y^b table and the running sums
// (p x W) are registers and the term loop is unrolled at compile time through
// an integer sequence, so no register array is indexed at run time; ak and
// the centres come through shared memory 16 (W = 4) or 32 centres at a time.
// Any other order takes the run-time instance (P = 0): the multi-indices from
// the device table, each power by repeated products, ak read through L1
// (every thread of a warp reads the same address).  K7: one block a cluster, its rows
// in the SegmentOrder the loop keeps (the rows sorted by cluster, a cluster's
// start the sum of the lengths before it); 512 threads, a lane a Taylor term
// and four groups of lanes, each group adding every fourth row of a chunk
// whose powers and weights the block stages in shared memory; the groups'
// sums are combined in order and scaled by C_alpha.  No [N, pd, W] summand is
// written.
//
// The C entry points launch on the caller's stream, allocate nothing, read
// sigma from the device (no host read: both run inside captured CUDA graphs),
// count themselves in the tally (tally.cuh) and return cudaGetLastError()
// after the launch.

#include <cuda_runtime.h>

#include <utility>

#include "tally.cuh"

namespace {

constexpr int kPredictThreads = 128;
constexpr int kExpandLanes = 128;  // Taylor terms a pass of K7
constexpr int kExpandGroups = 4;   // row groups of K7, combined in order
constexpr int kExpandThreads = kExpandLanes * kExpandGroups;
constexpr int kMaxCompiledOrder = 8;
// the largest order taken: its pd(p) x 3 multi-indices stay int-indexed
constexpr int kMaxOrder = 1024;

__host__ __device__ constexpr int pd_of(int p) {
  return p * (p + 1) * (p + 2) / 6;
}

// Component `dim` of term `index` of order p (p <= kMaxCompiledOrder) in the
// graded-lex order of ops/fgt.py::_alpha_table: per degree, for each
// dimension i, the previous degree's terms whose leading dimension is >= i,
// each raised by one in dimension i.  Evaluated by the compiler only.
__host__ __device__ constexpr int alpha_of(int p, int index, int dim) {
  int e[pd_of(kMaxCompiledOrder)][3] = {};
  int heads[3] = {0, 0, 0};
  int t = 1;
  int tail = 1;
  for (int degree = 1; degree < p; ++degree) {
    const int end = tail;
    for (int i = 0; i < 3; ++i) {
      const int head = heads[i];
      heads[i] = t;
      for (int j = head; j < end; ++j) {
        e[t][0] = e[j][0];
        e[t][1] = e[j][1];
        e[t][2] = e[j][2];
        e[t][i] += 1;
        ++t;
      }
    }
    tail = t;
  }
  return e[index][dim];
}

// dy = (y - c) / h and s = |dy|^2, rounded as the plain version rounds them
__device__ __forceinline__ float scaled_offset(float y0, float y1, float y2,
                                               float c0, float c1, float c2,
                                               float h, float* d) {
  d[0] = __fdiv_rn(__fsub_rn(y0, c0), h);
  d[1] = __fdiv_rn(__fsub_rn(y1, c1), h);
  d[2] = __fdiv_rn(__fsub_rn(y2, c2), h);
  return __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                   __fmul_rn(d[2], d[2]));
}

// d^a as the plain version's power table makes it: products from 1
__device__ __forceinline__ float power(float d, int a) {
  float v = 1.0f;
  for (int i = 0; i < a; ++i) v = __fmul_rn(v, d);
  return v;
}

template <int W>
__device__ __forceinline__ void load_w(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = p[w];
  }
}

// a compensated running sum (Kahan): s + c holds the sum of what was added
// to within a rounding of s
template <int W>
struct Compensated {
  float s[W];
  float c[W];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = c[w] = 0.0f;
  }
  // s += a * b[w]
  __device__ __forceinline__ void add(float a, const float (&b)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float y = fmaf(a, b[w], -c[w]);
      const float t = __fadd_rn(s[w], y);
      c[w] = __fsub_rn(__fsub_rn(t, s[w]), y);
      s[w] = t;
    }
  }
};

// a centre's sum over the terms of a compiled order: one running sum per
// degree (terms of one degree are of one size), the degrees added in order
template <int P, int W>
struct DegreeSums {
  float s[P][W];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int d = 0; d < P; ++d)
#pragma unroll
      for (int w = 0; w < W; ++w) s[d][w] = 0.0f;
  }
  template <int D>
  __device__ __forceinline__ void add(float mono, const float (&v)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) s[D][w] = fmaf(mono, v[w], s[D][w]);
  }
  __device__ __forceinline__ void result(float (&acc)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float t = s[0][w];
#pragma unroll
      for (int d = 1; d < P; ++d) t = __fadd_rn(t, s[d][w]);
      acc[w] = t;
    }
  }
};

// one Taylor term of a compiled order: sum += dy^alpha * a[I]
template <int P, int W, int I>
__device__ __forceinline__ void add_term(const float (&xy)[P][P],
                                         const float (&pz)[P],
                                         const float* a, DegreeSums<P, W>& sum) {
  constexpr int a0 = alpha_of(P, I, 0);
  constexpr int a1 = alpha_of(P, I, 1);
  constexpr int a2 = alpha_of(P, I, 2);
  const float mono = __fmul_rn(xy[a0][a1], pz[a2]);
  float v[W];
  load_w<W>(a + I * W, v);
  sum.template add<a0 + a1 + a2>(mono, v);
}

template <int P, int W, int... I>
__device__ __forceinline__ void add_terms(std::integer_sequence<int, I...>,
                                          const float (&xy)[P][P],
                                          const float (&pz)[P], const float* a,
                                          DegreeSums<P, W>& sum) {
  (add_term<P, W, I>(xy, pz, a, sum), ...);
}

// sum_alpha dy^alpha a[alpha, :] for a compiled order, a[] in shared memory
template <int P, int W>
__device__ __forceinline__ void contract(const float (&d)[3], const float* a,
                                         float (&acc)[W]) {
  float px[P], py[P], pz[P];
  px[0] = py[0] = pz[0] = 1.0f;
#pragma unroll
  for (int i = 1; i < P; ++i) {
    px[i] = __fmul_rn(px[i - 1], d[0]);
    py[i] = __fmul_rn(py[i - 1], d[1]);
    pz[i] = __fmul_rn(pz[i - 1], d[2]);
  }
  float xy[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; i + j < P; ++j) xy[i][j] = __fmul_rn(px[i], py[j]);
  }
  DegreeSums<P, W> sum;
  sum.zero();
  add_terms<P, W>(std::make_integer_sequence<int, pd_of(P)>{}, xy, pz, a, sum);
  sum.result(acc);
}

// the same for any order: multi-indices from the device table, a[] anywhere
template <int W>
__device__ __forceinline__ void contract_any(const float (&d)[3], const float* a,
                                             const long long* alpha, int pd,
                                             float (&acc)[W]) {
  Compensated<W> sum;
  sum.zero();
  for (int i = 0; i < pd; ++i) {
    const float mono = __fmul_rn(
        __fmul_rn(power(d[0], static_cast<int>(alpha[3 * i])),
                  power(d[1], static_cast<int>(alpha[3 * i + 1]))),
        power(d[2], static_cast<int>(alpha[3 * i + 2])));
    float v[W];
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = a[i * W + w];
    sum.add(mono, v);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = sum.s[w];
}

// centres of ak staged at once by a block of K6
template <int P, int W>
struct PredictGroup {
  static constexpr int kCentres = W == 4 ? 16 : 32;
  static constexpr int kFloats = kCentres * pd_of(P) * W;
};

// K6: out f32[m, W]; ak f32[k, pd, W]; P = 0 is the run-time order p
template <int P, int W>
__global__ void __launch_bounds__(kPredictThreads)
    fgt_predict_kernel(const float* __restrict__ targets,
                       const float* __restrict__ centers,
                       const float* __restrict__ ak,
                       const float* __restrict__ sigma,
                       const long long* __restrict__ alpha, int m, int k,
                       int pd, float e_param, int* __restrict__ tally,
                       float* __restrict__ out) {
  tally_launch(tally, false);
  const int row = blockIdx.x * kPredictThreads + threadIdx.x;
  const bool valid = row < m;
  const float h = *sigma;
  float y[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    y[0] = targets[3 * row];
    y[1] = targets[3 * row + 1];
    y[2] = targets[3 * row + 2];
  }
  Compensated<W> total;
  total.zero();
  if constexpr (P > 0) {
    using Group = PredictGroup<P, W>;
    constexpr int kPd = pd_of(P);
    __shared__ __align__(16) float s_ak[Group::kFloats];
    __shared__ float s_c[Group::kCentres * 3];
    for (int k0 = 0; k0 < k; k0 += Group::kCentres) {
      const int n = min(Group::kCentres, k - k0);
      __syncthreads();  // the previous group is consumed
      const float* src = ak + static_cast<size_t>(k0) * kPd * W;
      for (int i = threadIdx.x; i < n * kPd * W; i += kPredictThreads) {
        s_ak[i] = src[i];
      }
      for (int i = threadIdx.x; i < n * 3; i += kPredictThreads) {
        s_c[i] = centers[3 * k0 + i];
      }
      __syncthreads();
      if (!valid) continue;
      for (int j = 0; j < n; ++j) {
        float d[3];
        const float s = scaled_offset(y[0], y[1], y[2], s_c[3 * j],
                                      s_c[3 * j + 1], s_c[3 * j + 2], h, d);
        if (s > e_param) continue;  // past the far field: exactly 0
        const float g = expf(-s);
        float acc[W];
        contract<P, W>(d, s_ak + j * kPd * W, acc);
        total.add(g, acc);
      }
    }
  } else {
    if (valid) {
      for (int j = 0; j < k; ++j) {
        float d[3];
        const float s =
            scaled_offset(y[0], y[1], y[2], centers[3 * j], centers[3 * j + 1],
                          centers[3 * j + 2], h, d);
        if (s > e_param) continue;
        const float g = expf(-s);
        float acc[W];
        contract_any<W>(d, ak + static_cast<size_t>(j) * pd * W, alpha, pd,
                        acc);
        total.add(g, acc);
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int w = 0; w < W; ++w) out[static_cast<size_t>(row) * W + w] = total.s[w];
  }
}

// K7: ak f32[k, pd, W], block `cluster` from rows order[start, start + len)
// with start the sum of lengths[0, cluster); dynamic shared memory holds a
// chunk of rows' weights [chunk][W] (first, so that a row's W = 4 floats
// are one aligned float4) and powers [chunk][3][p], then the groups' sums
// [kExpandThreads][W]
template <int W>
__global__ void __launch_bounds__(kExpandThreads)
    fgt_expand_kernel(const float* __restrict__ points,
                      const float* __restrict__ weights,
                      const float* __restrict__ mask,
                      const float* __restrict__ centers,
                      const long long* __restrict__ order,
                      const long long* __restrict__ lengths,
                      const float* __restrict__ sigma,
                      const long long* __restrict__ alpha,
                      const float* __restrict__ coeff, int p, int pd,
                      int chunk_rows, int* __restrict__ tally,
                      float* __restrict__ ak) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long s_start;
  __shared__ int s_len;
  tally_launch(tally, false);
  const int cluster = blockIdx.x;
  if (threadIdx.x < 32) {  // the cluster's first row: exact integer sum
    long long part = 0;
    for (int j = threadIdx.x; j < cluster; j += 32) part += lengths[j];
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_down_sync(0xffffffffu, part, off);
    }
    if (threadIdx.x == 0) {
      s_start = part;
      s_len = static_cast<int>(lengths[cluster]);
    }
  }
  __syncthreads();
  const long long start = s_start;
  const int len = s_len;
  const float h = *sigma;
  const float c0 = centers[3 * cluster];
  const float c1 = centers[3 * cluster + 1];
  const float c2 = centers[3 * cluster + 2];
  float* s_gw = smem;
  float* s_pow = smem + chunk_rows * W;
  const int lane = threadIdx.x % kExpandLanes;
  const int group = threadIdx.x / kExpandLanes;
  for (int base = 0; base < pd; base += kExpandLanes) {
    const int term = base + lane;
    const bool live = term < pd;
    int a0 = 0, a1 = 0, a2 = 0;
    if (live) {
      a0 = static_cast<int>(alpha[3 * term]);
      a1 = static_cast<int>(alpha[3 * term + 1]);
      a2 = static_cast<int>(alpha[3 * term + 2]);
    }
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    for (int r0 = 0; r0 < len; r0 += chunk_rows) {
      const int rows = min(chunk_rows, len - r0);
      __syncthreads();  // the previous chunk is consumed
      if (static_cast<int>(threadIdx.x) < rows) {
        const long long src = order[start + r0 + threadIdx.x];
        float d[3];
        const float s =
            scaled_offset(points[3 * src], points[3 * src + 1],
                          points[3 * src + 2], c0, c1, c2, h, d);
        const float g = __fmul_rn(expf(-s), mask[src]);
        float* pw = s_pow + threadIdx.x * 3 * p;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float v = 1.0f;
          pw[i * p] = v;
          for (int a = 1; a < p; ++a) {
            v = __fmul_rn(v, d[i]);
            pw[i * p + a] = v;
          }
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          s_gw[threadIdx.x * W + w] = __fmul_rn(g, weights[src * W + w]);
        }
      }
      __syncthreads();
      for (int r = group; r < rows; r += kExpandGroups) {
        const float* pw = s_pow + r * 3 * p;
        const float mono =
            __fmul_rn(__fmul_rn(pw[a0], pw[p + a1]), pw[2 * p + a2]);
        float v[W];
        load_w<W>(s_gw + r * W, v);
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = fmaf(mono, v[w], acc[w]);
      }
    }
    __syncthreads();  // every group is done with the staged rows
#pragma unroll
    for (int w = 0; w < W; ++w) smem[threadIdx.x * W + w] = acc[w];
    __syncthreads();
    if (group == 0 && live) {
      const float c = coeff[term];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float sum = smem[lane * W + w];
        for (int g = 1; g < kExpandGroups; ++g) {
          sum = __fadd_rn(sum, smem[(g * kExpandLanes + lane) * W + w]);
        }
        ak[(static_cast<size_t>(cluster) * pd + term) * W + w] =
            __fmul_rn(sum, c);
      }
    }
    __syncthreads();  // the sums are read before the next pass stages rows
  }
}

template <int P>
void predict_launch(int w, dim3 grid, cudaStream_t st, const float* targets,
                    const float* centers, const float* ak, const float* sigma,
                    const long long* alpha, int m, int k, int pd, float e_param,
                    int* tally, float* out) {
  if (w == 4) {
    fgt_predict_kernel<P, 4><<<grid, kPredictThreads, 0, st>>>(
        targets, centers, ak, sigma, alpha, m, k, pd, e_param, tally, out);
  } else {
    fgt_predict_kernel<P, 1><<<grid, kPredictThreads, 0, st>>>(
        targets, centers, ak, sigma, alpha, m, k, pd, e_param, tally, out);
  }
}

}  // namespace

// targets f32[m, 3], centers f32[k, 3], ak f32[k, pd(p), w] with w 1 or 4,
// sigma f32[1] and alpha i64[pd(p), 3] (the order's multi-indices, read by
// the run-time instance only), all on the device and contiguous; out f32[m,
// w] is written here; tally a device i32[2] or null.  Orders 6 and 8 take
// their compiled instances, any other order 1 <= p <= 1024 the run-time one.
// Returns a cudaError_t as int.
extern "C" int tpuslam_fgt_predict(const float* targets, const float* centers,
                                   const float* ak, const float* sigma,
                                   const long long* alpha, int m, int k, int p,
                                   int w, float e_param, int* tally, float* out,
                                   void* stream) {
  if (m < 0 || k < 0 || p < 1 || p > kMaxOrder || (w != 1 && w != 4) ||
      alpha == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;  // nothing to launch
  const int pd = pd_of(p);
  const dim3 grid((m + kPredictThreads - 1) / kPredictThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  if (p == 8) {
    predict_launch<8>(w, grid, st, targets, centers, ak, sigma, alpha, m, k, pd,
                      e_param, tally, out);
  } else if (p == 6) {
    predict_launch<6>(w, grid, st, targets, centers, ak, sigma, alpha, m, k, pd,
                      e_param, tally, out);
  } else {
    predict_launch<0>(w, grid, st, targets, centers, ak, sigma, alpha, m, k, pd,
                      e_param, tally, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// points f32[n, 3], weights f32[n, w] with w 1 or 4, mask f32[n], centers
// f32[k, 3], order i64[n] (the rows sorted by cluster) and lengths i64[k]
// (each cluster's rows: ops/fgt.py::SegmentOrder), sigma f32[1], alpha
// i64[pd(p), 3] and coeff f32[pd(p)] (ops/fgt.py::fgt_tables), all on the
// device and contiguous; chunk_rows rows staged at a time (at most 512) and
// smem_bytes the wrapper's dynamic shared memory, re-checked here; ak f32[k,
// pd(p), w] is written here; tally as above.  Returns a cudaError_t as int.
extern "C" int tpuslam_fgt_expand(const float* points, const float* weights,
                                  const float* mask, const float* centers,
                                  const long long* order,
                                  const long long* lengths, const float* sigma,
                                  const long long* alpha, const float* coeff,
                                  int n, int k, int p, int w, int chunk_rows,
                                  int smem_bytes, int* tally, float* ak,
                                  void* stream) {
  const long long staged = static_cast<long long>(chunk_rows) * (3 * p + w);
  const long long sums = static_cast<long long>(kExpandThreads) * w;
  if (n < 0 || k < 0 || p < 1 || p > kMaxOrder || (w != 1 && w != 4) ||
      chunk_rows < 1 || chunk_rows > kExpandThreads ||
      smem_bytes != 4 * (staged > sums ? staged : sums) ||
      smem_bytes > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 0) return 0;  // nothing to launch
  const int pd = pd_of(p);
  const auto st = static_cast<cudaStream_t>(stream);
  if (w == 4) {
    fgt_expand_kernel<4><<<k, kExpandThreads, smem_bytes, st>>>(
        points, weights, mask, centers, order, lengths, sigma, alpha, coeff, p,
        pd, chunk_rows, tally, ak);
  } else {
    fgt_expand_kernel<1><<<k, kExpandThreads, smem_bytes, st>>>(
        points, weights, mask, centers, order, lengths, sigma, alpha, coeff, p,
        pd, chunk_rows, tally, ak);
  }
  return static_cast<int>(cudaGetLastError());
}
