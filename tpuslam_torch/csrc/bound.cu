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
// Bound on this card: N x C (source, tile) pairs, each a 12-term chain
// (24 flops, an FMA counted as two) with its bound term and admission
// test (6 more), against N x 40 bytes in and ts x C bytes out: the fp32
// rate bounds it, 8.2e7 pairs x 30 / 67 TFLOP/s = 0.037 ms at 100k
// (C = 800), 0.96 ms at 1M (2.1e9 pairs, C = 2,048).  Issued, a pair
// takes ~25 instructions in pass 1 (13 for the chain, 6 for the skip
// test, 5 for the mark), so 0.06 ms at 100k is what full issue allows.
//
// Design (the launch geometry is chosen in kernels/bound.py and checked
// here):
//   * kR = 4 sources per thread: one broadcast load of a tile's 12 centre
//     terms and radius serves 4 pairs, and the 4 chains interleave (the
//     first version had one source per thread, one dependent chain).  Each
//     chain keeps the order k = 0..11, one rounding per term, then + s2;
//   * a block serves kChunk = 512 sources of a group against one range of
//     tiles; a group's `chunks` x `splits` blocks form one thread-block
//     cluster.  Pass 1 folds each source's bound over the block's tiles;
//     the cluster then takes the minimum over the splits through
//     distributed shared memory (a minimum is exact in any order).  Pass 2
//     tests admission on the block's tiles; the cluster ORs the chunks'
//     votes, and each tile's byte is stored once, 0 or 1, so the caller
//     need not zero adm (one launch fewer per query than the first
//     version);
//   * the bound starts at the warm bound (fminf is a minimum, so folding it
//     first gives the same value), and the correctly rounded square root
//     is skipped where it cannot lower the running bound ub: with
//     x = max(dc2, 0) + eps and d = max(RU(ub - r_j), 0), x >= RU(d * d)
//     gives sqrt_rn(x) >= d and so RN(sqrt_rn(x) + r_j) >= ub;
//   * pass 1 also marks each tile that some valid source would admit under
//     its running bound.  Every operation of the admission test is
//     non-decreasing in the bound, and the final bound is at most any
//     running one, so the marked tiles are a superset of the admitted
//     ones: pass 2 recomputes dc2 only on them (the first version
//     recomputed every pair);
//   * tiles are staged as float32 in shared memory, up to `stage` at a
//     time, once for both passes when the range fits.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;          // threads per block
constexpr int kR = 4;                  // sources per thread
constexpr int kChunk = kThreads * kR;  // sources per block
constexpr int kK = 12;                 // depth of the centre-distance product
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr float kInflMul = 1.00001f;   // float32(1 + 1e-5)
constexpr float kInflAdd = 1e-6f;

// s2 + sum_k a[k] * cs[k], k ascending, one rounding per term
__device__ __forceinline__ float center_dist2(const float* a, float4 c0,
                                             float4 c1, float4 c2, float s2) {
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

__device__ __forceinline__ float inflate(float ub) {
  return __fadd_rn(__fmul_rn(ub, kInflMul), kInflAdd);
}

// the admission test of one (source, tile) pair
__device__ __forceinline__ bool admits(float dc2, float ub_inflated, float r,
                                       float e) {
  const float t = __fadd_rn(ub_inflated, r);
  return dc2 <= __fadd_rn(__fmul_rn(t, t), e);
}

// the register cap (96) keeps 5 blocks on an SM: 10 % faster than the 4
// that 128 registers allow, for an 8-byte spill
__global__ void __launch_bounds__(kThreads, 5)
    bound_kernel(const __nv_bfloat16* __restrict__ saug,
                 const float4* __restrict__ aux,
                 const __nv_bfloat16* __restrict__ caug,
                 const float* __restrict__ radii,
                 const float* __restrict__ eps,
                 const unsigned char* __restrict__ warm, int n, int c,
                 int gsrc, int chunks, int splits, int span, int stage,
                 unsigned char* __restrict__ adm) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);  // [stage][12], tile-major
  float* rs = cs + stage * kK;                 // [stage]
  float* ubp = rs + stage;                     // [kChunk] partial bounds
  int* flag = reinterpret_cast<int*>(ubp + kChunk);  // [span] 0, 1 marked, 2 in

  const int b = blockIdx.y;
  const int per_group = chunks * splits;  // = the cluster size
  const int group = blockIdx.x / per_group;
  const int rank = blockIdx.x % per_group;  // = the block's rank in its cluster
  const int chunk = rank / splits;
  const int split = rank % splits;
  const int first = chunk * kChunk;  // first source in the group
  const size_t row0 = static_cast<size_t>(b) * n +
                      static_cast<size_t>(group) * gsrc + first;
  const int j0 = split * span;
  const int len = max(0, min(c, j0 + span) - j0);
  const float e = eps[b];
  const bool is_warm = warm[b] != 0;
  const __nv_bfloat16* cb = caug + static_cast<size_t>(b) * kK * c;
  const float* rb = radii + static_cast<size_t>(b) * c;

  for (int k = threadIdx.x; k < len; k += kThreads) flag[k] = 0;

  float a[kR][kK];
  float s2[kR], ub[kR], ubi[kR];
  bool valid[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int j = r * kThreads + threadIdx.x;
    const bool active = first + j < gsrc;
    const __nv_bfloat16* sa = saug + (row0 + j) * kK;
#pragma unroll
    for (int k = 0; k < kK; ++k) a[r][k] = active ? __bfloat162float(sa[k]) : 0.f;
    const float4 x = active ? aux[row0 + j] : make_float4(0.f, 0.f, 0.f, 0.f);
    s2[r] = x.x;
    valid[r] = x.z > 0.f;
    ub[r] = is_warm ? fminf(CUDART_INF_F, x.y) : CUDART_INF_F;
    ubi[r] = inflate(ub[r]);
  }

  auto stage_tiles = [&](int base, int cnt) {
    for (int t = threadIdx.x; t < cnt; t += kThreads) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        cs[t * kK + k] =
            __bfloat162float(cb[static_cast<size_t>(k) * c + j0 + base + t]);
      }
      rs[t] = rb[j0 + base + t];
    }
  };
  auto tile = [&](int t, float4& c0, float4& c1, float4& c2) {
    c0 = *reinterpret_cast<const float4*>(cs + t * kK);
    c1 = *reinterpret_cast<const float4*>(cs + t * kK + 4);
    c2 = *reinterpret_cast<const float4*>(cs + t * kK + 8);
  };

  // pass 1: the running bound of every source, and the marked tiles
  for (int base = 0; base < len; base += stage) {
    const int cnt = min(stage, len - base);
    __syncthreads();
    stage_tiles(base, cnt);
    __syncthreads();
    for (int t = 0; t < cnt; ++t) {
      float4 c0, c1, c2;
      tile(t, c0, c1, c2);
      const float rj = rs[t];
      // the kR chains first, with no branch between them, so they
      // interleave
      float dc2[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) dc2[r] = center_dist2(a[r], c0, c1, c2, s2[r]);
      bool mark = false;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float x = __fadd_rn(fmaxf(dc2[r], 0.f), e);
        const float d = fmaxf(__fsub_ru(ub[r], rj), 0.f);
        if (!(x >= __fmul_ru(d, d))) {
          const float u = __fadd_rn(__fsqrt_rn(x), rj);
          if (u < ub[r]) {
            ub[r] = u;
            ubi[r] = inflate(u);
          }
        }
        mark |= valid[r] && admits(dc2[r], ubi[r], rj, e);
      }
      if (mark) flag[base + t] = 1;
    }
  }

  // the bound over every tile: the minimum over the cluster's splits
#pragma unroll
  for (int r = 0; r < kR; ++r) ubp[r * kThreads + threadIdx.x] = ub[r];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float u = CUDART_INF_F;
    for (int p = 0; p < splits; ++p) {
      u = fminf(u, *cluster.map_shared_rank(ubp + r * kThreads + threadIdx.x,
                                            chunk * splits + p));
    }
    ubi[r] = inflate(u);
  }

  // pass 2: admission on the marked tiles
  for (int base = 0; base < len; base += stage) {
    const int cnt = min(stage, len - base);
    if (len > stage) {  // else the one staged range is still in place
      __syncthreads();
      stage_tiles(base, cnt);
      __syncthreads();
    }
    for (int t = 0; t < cnt; ++t) {
      if (flag[base + t] == 0) continue;  // the same for the whole block
      float4 c0, c1, c2;
      tile(t, c0, c1, c2);
      const float rj = rs[t];
      float dc2[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) dc2[r] = center_dist2(a[r], c0, c1, c2, s2[r]);
      bool in = false;
#pragma unroll
      for (int r = 0; r < kR; ++r) in |= valid[r] && admits(dc2[r], ubi[r], rj, e);
      if (in) flag[base + t] = 2;
    }
  }

  // OR over the chunks; each tile of the range is stored by one block
  cluster.sync();
  unsigned char* out =
      adm + (static_cast<size_t>(b) * (n / gsrc) + group) * c + j0;
  for (int k = chunk * kThreads + threadIdx.x; k < len;
       k += chunks * kThreads) {
    bool in = false;
    for (int q = 0; q < chunks; ++q) {
      in |= *cluster.map_shared_rank(flag + k, q * splits + split) == 2;
    }
    out[k] = in ? 1 : 0;
  }
  cluster.sync();  // the peers' shared memory stays alive until read
}

}  // namespace

// saug bf16[batch, n, 12], aux f32[batch, n, 4] (16-byte aligned),
// caug bf16[batch, 12, c], radii f32[batch, c], eps f32[batch],
// warm bool[batch] (one byte each), all on the device and contiguous;
// adm bool[batch, n / gsrc, c] written here, every byte.  The geometry
// (chunks = ceil(gsrc / 512), splits a power of two, chunks x splits <= 8,
// span = ceil(c / splits), stage and smem_bytes) comes from
// kernels/bound.py::bound_geometry and is checked here.  Returns a
// cudaError_t as int: 0 when the launch was taken.
extern "C" int tpuslam_bound_pass(const void* saug, const float* aux,
                                  const void* caug, const float* radii,
                                  const float* eps, const unsigned char* warm,
                                  int batch, int n, int c, int gsrc,
                                  int chunks, int splits, int span, int stage,
                                  int smem_bytes, unsigned char* adm,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || c <= 0) return 0;  // nothing to launch
  const long long want = 4LL * stage * (kK + 1) + 4LL * kChunk + 4LL * span;
  if (batch > 65535 || gsrc <= 0 || n % gsrc != 0 ||
      chunks != (gsrc + kChunk - 1) / kChunk || splits < 1 ||
      (splits & (splits - 1)) != 0 || chunks * splits > kMaxCluster ||
      span != (c + splits - 1) / splits || stage < 1 || stage > span ||
      smem_bytes != want ||
      static_cast<long long>(n / gsrc) * chunks * splits >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bound_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n / gsrc) * chunks * splits, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks * splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, bound_kernel, static_cast<const __nv_bfloat16*>(saug),
      reinterpret_cast<const float4*>(aux),
      static_cast<const __nv_bfloat16*>(caug), radii, eps, warm, n, c, gsrc,
      chunks, splits, span, stage, adm);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
