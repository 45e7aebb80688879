// K2: the bound pass of the hierarchical exact nearest-neighbour search,
// CUDA C++ for sm_90a.
//
// Replaces tpuslam/kernels/pallas_bound.py::bound_pass_pallas (kernel body
// _bound_kernel) and its batch form bound_pass_pallas_batch.  For every
// group of gsrc Morton-sorted sources of pair b it decides which of the C
// target tiles may hold a group member's nearest neighbour:
//
//   dc2[s,j] = s2[s] + sum_k saug[s,k] * caug[k,j]   (squared distance of
//              source s to tile centre j, error at most eps)
//   ub[s]    = min_j (sqrt(max(dc2,0) + eps) + r_j), then min with the
//              warm bound aux[s,1] when warm, then ub * (1 + 1e-5) + 1e-6
//   adm[group, j] = any valid s of the group (aux[s,2] > 0) with
//              dc2[s,j] <= (ub[s] + r_j)^2 + eps.
//
// The contract is rigour: admission is a superset of the tiles that hold
// a true nearest neighbour.  saug (bf16[N,12]) and caug (bf16[12,C]) are
// the JAX package's hi/lo split operands (nn_hier.py::_split_hi_lo).  Each
// bf16 x bf16 product is exact in float32, and the kernel sums the twelve
// products in the fixed order k = 0..11 with one rounding each, then adds
// s2: the plain PyTorch version (tpuslam_torch/kernels/bound.py) sums in
// the same order, so the two admit identical sets.
//
// Design: one thread per source; a group spans ceil(gsrc / kThreads)
// blocks, so at 102,400 sources (100 groups of 1,024) the grid has 800
// blocks for the 132 SMs.  Tiles are staged kChunk at a time in shared
// memory (12 centre terms and the radius), read as broadcasts.  Pass 1
// folds the per-source upper bound over all C tiles; pass 2 recomputes
// dc2, takes a warp vote (__any_sync) per tile, ORs the warps' votes in
// shared memory, and stores a 1 for every admitted tile into adm, which
// the wrapper zeroed: the blocks of one group only ever store 1s, so the
// result does not depend on their order.  Nothing of the TPU layout is
// kept (no 128-lane padding of C, no re-grouping of rows for VMEM).
//
// Bound: 2 x N x C (source, tile) pairs of ~12 FMAs each plus a correctly
// rounded sqrt in pass 1: 1.6e8 pairs at 100k (C = 800), 4.3e9 at 1M
// (C = 2,048); device traffic is N x 64 bytes in and ts x C bytes out, so
// the kernel is bound by the fp32 pipes and shared-memory loads.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // sources per block, one per thread
constexpr int kChunk = 256;    // tiles staged per step
constexpr int kK = 12;         // depth of the centre-distance product
constexpr float kInflMul = 1.00001f;  // float32(1 + 1e-5)
constexpr float kInflAdd = 1e-6f;

// s2 + sum_k a[k] * cs[k], k ascending, one rounding per term
__device__ __forceinline__ float center_dist2(const float (&a)[kK],
                                             const float* cs, float s2) {
  const float4 c0 = *reinterpret_cast<const float4*>(cs);
  const float4 c1 = *reinterpret_cast<const float4*>(cs + 4);
  const float4 c2 = *reinterpret_cast<const float4*>(cs + 8);
  float acc = __fmul_rn(a[0], c0.x);
  acc = __fmaf_rn(a[1], c0.y, acc);
  acc = __fmaf_rn(a[2], c0.z, acc);
  acc = __fmaf_rn(a[3], c0.w, acc);
  acc = __fmaf_rn(a[4], c1.x, acc);
  acc = __fmaf_rn(a[5], c1.y, acc);
  acc = __fmaf_rn(a[6], c1.z, acc);
  acc = __fmaf_rn(a[7], c1.w, acc);
  acc = __fmaf_rn(a[8], c2.x, acc);
  acc = __fmaf_rn(a[9], c2.y, acc);
  acc = __fmaf_rn(a[10], c2.z, acc);
  acc = __fmaf_rn(a[11], c2.w, acc);
  return __fadd_rn(acc, s2);
}

__global__ void __launch_bounds__(kThreads)
    bound_kernel(const __nv_bfloat16* __restrict__ saug,
                 const float4* __restrict__ aux,
                 const __nv_bfloat16* __restrict__ caug,
                 const float* __restrict__ radii,
                 const float* __restrict__ eps,
                 const unsigned char* __restrict__ warm, int n, int c,
                 int gsrc, unsigned char* __restrict__ adm) {
  __shared__ __align__(16) float cs[kChunk * kK];  // tile-major centre terms
  __shared__ float rs[kChunk];
  __shared__ int hit[kChunk];

  const int b = blockIdx.y;
  const int per_group = (gsrc + kThreads - 1) / kThreads;
  const int group = blockIdx.x / per_group;
  const int r = (blockIdx.x % per_group) * kThreads + threadIdx.x;
  const bool active = r < gsrc;
  const size_t row = static_cast<size_t>(b) * n +
                     static_cast<size_t>(group) * gsrc + r;
  const int lane = threadIdx.x & 31;

  float a[kK];
  float s2 = 0.f, ub_warm = 0.f;
  bool valid = false;
  if (active) {
    const __nv_bfloat16* sa = saug + row * kK;
#pragma unroll
    for (int k = 0; k < kK; ++k) a[k] = __bfloat162float(sa[k]);
    const float4 x = aux[row];
    s2 = x.x;
    ub_warm = x.y;
    valid = x.z > 0.f;
  } else {
#pragma unroll
    for (int k = 0; k < kK; ++k) a[k] = 0.f;
  }
  const float e = eps[b];
  const bool is_warm = warm[b] != 0;
  const __nv_bfloat16* cb = caug + static_cast<size_t>(b) * kK * c;
  const float* rb = radii + static_cast<size_t>(b) * c;

  auto stage = [&](int base, int cnt) {
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        cs[t * kK + k] = __bfloat162float(cb[static_cast<size_t>(k) * c + base + t]);
      }
      rs[t] = rb[base + t];
      hit[t] = 0;
    }
  };

  // pass 1: the per-source upper bound over every tile
  float ub = CUDART_INF_F;
  for (int base = 0; base < c; base += kChunk) {
    const int cnt = min(kChunk, c - base);
    __syncthreads();
    stage(base, cnt);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float dc2 = center_dist2(a, &cs[j * kK], s2);
      const float u =
          __fadd_rn(__fsqrt_rn(__fadd_rn(fmaxf(dc2, 0.f), e)), rs[j]);
      ub = fminf(ub, u);
    }
  }
  if (is_warm) ub = fminf(ub, ub_warm);
  ub = __fadd_rn(__fmul_rn(ub, kInflMul), kInflAdd);

  // pass 2: admission, OR-ed over the group's valid sources
  unsigned char* out =
      adm + (static_cast<size_t>(b) * (n / gsrc) + group) * c;
  for (int base = 0; base < c; base += kChunk) {
    const int cnt = min(kChunk, c - base);
    __syncthreads();
    stage(base, cnt);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float dc2 = center_dist2(a, &cs[j * kK], s2);
      const float t = __fadd_rn(ub, rs[j]);
      const bool in = valid && dc2 <= __fadd_rn(__fmul_rn(t, t), e);
      if (__any_sync(0xffffffffu, in) && lane == 0) hit[j] = 1;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
      if (hit[t]) out[base + t] = 1;
    }
  }
}

}  // namespace

// saug bf16[batch, n, 12], aux f32[batch, n, 4] (16-byte aligned),
// caug bf16[batch, 12, c], radii f32[batch, c], eps f32[batch],
// warm bool[batch] (one byte each), all on the device and contiguous;
// adm bool[batch, n / gsrc, c] zeroed by the caller and written here.
// Returns a cudaError_t as int: 0 when the launch was taken.
extern "C" int tpuslam_bound_pass(const void* saug, const float* aux,
                                  const void* caug, const float* radii,
                                  const float* eps, const unsigned char* warm,
                                  int batch, int n, int c, int gsrc,
                                  unsigned char* adm, void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return 0;  // nothing to launch
  if (batch > 65535 || gsrc <= 0 || n % gsrc != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_group = (gsrc + kThreads - 1) / kThreads;
  const dim3 grid((n / gsrc) * per_group, batch);
  bound_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(saug),
      reinterpret_cast<const float4*>(aux),
      static_cast<const __nv_bfloat16*>(caug), radii, eps, warm, n, c, gsrc,
      adm);
  return static_cast<int>(cudaGetLastError());
}
