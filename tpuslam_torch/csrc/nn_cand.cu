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
// Bound on this card: a group's live rows times its sources, 8 flops a
// pair for the distance (an FMA counted as two) against a few MB of
// traffic: the fp32 rate bounds it.  At 100k the fine table's 87 live
// tiles of 128 rows a group make 1.14e9 pairs over 100 groups: 0.136 ms
// at 67 TFLOP/s.  Issued, a pair takes 11 instructions (3 subtractions,
// a product and 2 FMAs for the distance, 3 compares and 2 moves for the
// fold) and a quarter of a shared load: 0.39 ms at full issue.
//
// Design (the launch geometry is chosen in kernels/nn_cand.py and checked
// here):
//   * kR = 4 sources per thread, held in registers: one shared-memory
//     load of a staged row serves 4 pairs and 4 independent fold chains
//     (the first version had one source per thread and one serial chain);
//   * a block of kThreads threads serves kChunk = 512 sources of one
//     group, and the group's live slots are cut into `splits` contiguous
//     ranges, one per block of a thread-block cluster, so 100 groups still
//     fill 132 SMs.  Each block folds its range; the cluster then combines
//     the partial (distance, index) pairs through distributed shared
//     memory, each block finishing 1 / splits of the sources.  The
//     lexicographic minimum does not depend on the order, so the result is
//     exact; no scratch in device memory, no extra launch;
//   * the block's live rows are one flat list (slot = row / g, so any g
//     works, 128 fine or 512 coarse at 100k, 512 or 1,024 at 1M) staged
//     `stage_rows` at a time with 16-byte cp.async into a ring of `depth`
//     stages in dynamic shared memory: the next stages arrive while the
//     current one is folded (the first version gathered, synchronised and
//     folded in turn).  The slot ids are read once into shared memory.
//     Rows past the live ones, and the rows of a tile id outside
//     [0, m / g), are stored as +inf, whose distance never wins.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "nn_fold.cuh"

namespace cg = cooperative_groups;

namespace {

using tpuslam::kBig;

constexpr int kThreads = 128;           // threads per block
constexpr int kR = 4;                   // sources per thread
constexpr int kChunk = kThreads * kR;   // sources per block
constexpr int kMaxSplits = 8;           // portable cluster size
constexpr float kNoMatch = 1e37f;

__device__ __forceinline__ void fold_pair(float d, float w, float& best,
                                          float& best_w) {
  const bool better = d < best || (d == best && w < best_w);
  best = better ? d : best;
  best_w = better ? w : best_w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` committed groups are in flight (0..3)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

__global__ void __launch_bounds__(kThreads)
    nn_cand_kernel(const float* __restrict__ src,
                   const float4* __restrict__ packed,
                   const int* __restrict__ cand,
                   const int* __restrict__ counts, int n, int m, int ts,
                   int width, int g, int gsrc, int chunks, int splits,
                   int stage_rows, int depth, int* __restrict__ idx_out,
                   float* __restrict__ dist_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  float* part_d = reinterpret_cast<float*>(ring + depth * stage_rows);
  float* part_w = part_d + kChunk;
  int* ids = reinterpret_cast<int*>(part_w + kChunk);

  const int b = blockIdx.y;
  const int split = blockIdx.x % splits;  // = the block's rank in its cluster
  const int unit = blockIdx.x / splits;
  const int group = unit / chunks;
  const int first = (unit % chunks) * kChunk;  // first source in the group
  const size_t grow = static_cast<size_t>(b) * ts + group;
  const int live = min(max(counts[grow], 0), width);
  const int s0 = static_cast<int>(static_cast<long long>(live) * split / splits);
  const int s1 =
      static_cast<int>(static_cast<long long>(live) * (split + 1) / splits);
  const int tiles = m / g;
  const float4* tb = packed + static_cast<size_t>(b) * m;
  const size_t src0 = static_cast<size_t>(b) * n +
                      static_cast<size_t>(group) * gsrc + first;

  // this block's slot ids, -1 where out of range
  for (int k = threadIdx.x; k < s1 - s0; k += kThreads) {
    const int t = cand[grow * width + s0 + k];
    ids[k] = (t >= 0 && t < tiles) ? t : -1;
  }
  float sx[kR], sy[kR], sz[kR], best[kR], best_w[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int j = r * kThreads + threadIdx.x;
    const bool active = first + j < gsrc;
    sx[r] = active ? src[3 * (src0 + j)] : 0.f;
    sy[r] = active ? src[3 * (src0 + j) + 1] : 0.f;
    sz[r] = active ? src[3 * (src0 + j) + 2] : 0.f;
    best[r] = kBig;
    best_w[r] = kBig;
  }
  __syncthreads();  // ids

  const int rows = (s1 - s0) * g;
  const int stages = (rows + stage_rows - 1) / stage_rows;
  auto issue = [&](int st) {
    float4* dst = ring + (st % depth) * stage_rows;
    for (int q = threadIdx.x; q < stage_rows; q += kThreads) {
      const int row = st * stage_rows + q;
      const int slot = row / g;
      const int t = row < rows ? ids[slot] : -1;
      if (t >= 0) {
        cp_async16(dst + q, tb + static_cast<size_t>(t) * g + (row - slot * g));
      } else {
        dst[q] = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, kBig);
      }
    }
  };
  for (int st = 0; st < depth - 1; ++st) {
    if (st < stages) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    cp_async_wait(depth - 2);  // this thread's copies of stage st landed
    __syncthreads();           // everyone's; and stage st - 1 is folded
    if (st + depth - 1 < stages) issue(st + depth - 1);
    cp_async_commit();
    const float4* rs = ring + (st % depth) * stage_rows;
    // rows past the live ones hold +inf: round the count up to 4
    const int cnt = (min(stage_rows, rows - st * stage_rows) + 3) & ~3;
    for (int k = 0; k < cnt; k += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v = rs[k + u];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          fold_pair(tpuslam::sq_dist(v.x, v.y, v.z, sx[r], sy[r], sz[r]), v.w,
                    best[r], best_w[r]);
        }
      }
    }
  }

  auto finish = [&](size_t i, float d, float w) {
    const bool none = d >= kNoMatch;
    idx_out[i] = none ? 0 : static_cast<int>(w);
    dist_out[i] = none ? kBig : d;
  };
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int j = r * kThreads + threadIdx.x;
      if (first + j < gsrc) finish(src0 + j, best[r], best_w[r]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    part_d[r * kThreads + threadIdx.x] = best[r];
    part_w[r * kThreads + threadIdx.x] = best_w[r];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = kChunk / splits;
  for (int j = split * share + threadIdx.x; j < (split + 1) * share;
       j += kThreads) {
    float d = kBig, w = kBig;
    for (int p = 0; p < splits; ++p) {
      fold_pair(*cluster.map_shared_rank(part_d + j, p),
                *cluster.map_shared_rank(part_w + j, p), d, w);
    }
    if (first + j < gsrc) finish(src0 + j, d, w);
  }
  cluster.sync();  // the peers' shared memory stays alive until read
}

}  // namespace

// src f32[batch, n, 3], packed f32[batch, m, 4] (16-byte aligned),
// cand i32[batch, ts, width], counts i32[batch, ts], all on the device and
// contiguous, n = ts * gsrc, m a multiple of g; idx i32[batch, n] and
// dist f32[batch, n] written here.  The geometry (chunks = ceil(gsrc /
// 512), splits a power of two up to 8, stage_rows a multiple of 4, depth
// 2..4 and smem_bytes) comes from kernels/nn_cand.py::cand_geometry and is
// checked here.  Returns a cudaError_t as int: 0 when the launch was taken.
extern "C" int tpuslam_nn_cand(const float* src, const float* packed,
                               const int* cand, const int* counts, int batch,
                               int n, int m, int ts, int width, int g,
                               int gsrc, int chunks, int splits,
                               int stage_rows, int depth, int smem_bytes,
                               int* idx, float* dist, void* stream) {
  if (batch <= 0 || n <= 0) return 0;  // nothing to launch
  const long long want =
      16LL * depth * stage_rows + 8LL * kChunk + 4LL * width;
  if (batch > 65535 || g <= 0 || gsrc <= 0 || width < 0 || m < 0 ||
      m % g != 0 || static_cast<long long>(ts) * gsrc != n ||
      static_cast<long long>(width) * g >= (1LL << 31) ||
      chunks != (gsrc + kChunk - 1) / kChunk || splits < 1 ||
      splits > kMaxSplits || (splits & (splits - 1)) != 0 ||
      stage_rows <= 0 || stage_rows % 4 != 0 || depth < 2 || depth > 4 ||
      smem_bytes != want ||
      static_cast<long long>(ts) * chunks * splits >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nn_cand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ts * chunks * splits, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, nn_cand_kernel, src, reinterpret_cast<const float4*>(packed),
      cand, counts, n, m, ts, width, g, gsrc, chunks, splits, stage_rows,
      depth, idx, dist);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
