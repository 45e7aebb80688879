// K1: dense exact nearest-neighbour search, CUDA C++ for sm_90a.
//
// Replaces tpuslam/kernels/pallas_nn.py::nearest_neighbors_pallas_batch
// (kernel body _nn_kernel_batch; nearest_neighbors_pallas is its B=1 form).
// For every source row of every pair b: the index and squared distance of
// the nearest of the first count[b] target rows.
//
// Contract, bit for bit the JAX oracle's (tpuslam.ops.nn.nearest_neighbors_ref
// on the CPU):
//   * d = fma(dz, dz, fma(dx, dx, dy * dy)) with d_ = t_ - s_, each step
//     rounded once to float32 (tpuslam::sq_dist in nn_fold.cuh, shared
//     with K3).
//   * the result is that of a fold over the targets in ascending order
//     with a strict '<', so the first (lowest) index wins a tie
//     (common.cpp:416 in the reference).
//   * no valid target gives (idx 0, dist 3.4e38f).  A distance at or
//     above 3.4e38f, or NaN, never wins.
//
// Bound on this card: 8 float32 operations a pair (an FMA counted as two)
// against a few MB of traffic, so the fp32 rate bounds it: 1.25 ms at
// 102,400 x 102,400.  Issued, the distance alone is 6 instructions a pair
// (3 subtractions, a product, 2 FMAs), 1.88 ms at the card's full issue
// rate: no design on the CUDA cores goes below that.
//
// Design (the launch geometry is chosen in kernels/nn_dense.py and checked
// here):
//   * R = 2 or 4 sources a thread, held in registers: one broadcast shared
//     load of a staged target serves R pairs and R independent chains;
//   * minimum, then locate: within a segment of kSeg = 32 targets each
//     source folds only its running minimum (fminf, which drops a NaN):
//     7 instructions a pair and no branch.  After the segment, a strict
//     '<' against the minimum before it records the segment's first row.
//     The first segment that holds the final minimum is the one recorded,
//     and once the sources are done one pass over its kSeg rows finds the
//     first row whose distance (the same sq_dist, the same bits) equals
//     it: the strict-'<' ascending fold's answer, for one kSeg-row rescan
//     a source;
//   * the target range [0, count) is cut into `splits` contiguous ranges,
//     one per block of a thread-block cluster, so that small grids still
//     fill 132 SMs.  Each block folds its range for the same sources; the
//     cluster combines the partial (minimum, segment row) pairs through
//     distributed shared memory, lexicographically, each block finishing
//     1 / splits of the sources.  Segment rows ascend across the ranges,
//     so the combine gives the first segment holding the minimum whatever
//     the order of the splits: exact, with no scratch in device memory
//     and no second launch;
//   * targets are staged `stage_rows` at a time as AoS [x y z] by 4-byte
//     cp.async into a ring of `depth` stages in dynamic shared memory (any
//     row count and alignment), so the next stages arrive while the
//     current one is folded; every lane reads the same address, four rows
//     as three 16-byte loads.  Rows past the block's range are stored as
//     +inf, whose distance never wins.  count is read on the device.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>

#include "nn_fold.cuh"

namespace cg = cooperative_groups;

namespace {

using tpuslam::kBig;
using tpuslam::sq_dist;

constexpr int kThreads = 128;   // threads per block
constexpr int kSeg = 32;        // targets per segment of the running minimum
constexpr int kMaxSplits = 8;   // portable cluster size

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` committed groups are in flight (0..2)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::); break;
  }
}

// the first row of [row, min(row + kSeg, valid)) whose distance to
// (x, y, z) is d; such a row exists whenever d < kBig was recorded there.
// A plain loop that stops at the match: on the card it beat the same
// search unrolled with all its loads in flight (fewer instructions for
// the ~16 rows it reads on average).
__device__ __forceinline__ int locate(const float* __restrict__ t, int row,
                                      int valid, float x, float y, float z,
                                      float d) {
  const int end = min(row + kSeg, valid);
  for (int q = row; q < end; ++q) {
    const float* p = t + 3 * static_cast<size_t>(q);
    if (sq_dist(__ldg(p), __ldg(p + 1), __ldg(p + 2), x, y, z) == d) return q;
  }
  return 0;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    nn_dense_kernel(const float* __restrict__ src,
                    const float* __restrict__ tgt,
                    const int* __restrict__ count, int n, int m, int splits,
                    int stage_rows, int depth, int* __restrict__ idx_out,
                    float* __restrict__ dist_out) {
  constexpr int kChunk = kThreads * R;  // sources per block
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* part_d = ring + 3 * depth * stage_rows;
  int* part_row = reinterpret_cast<int*>(part_d + kChunk);

  const int b = blockIdx.y;
  const int split = blockIdx.x % splits;  // = the block's rank in its cluster
  const int first = (blockIdx.x / splits) * kChunk;  // first source
  const int valid = min(max(count[b], 0), m);
  const int r0 = static_cast<int>(static_cast<long long>(valid) * split / splits);
  const int r1 =
      static_cast<int>(static_cast<long long>(valid) * (split + 1) / splits);
  const float* s = src + static_cast<size_t>(b) * n * 3;
  const float* t = tgt + static_cast<size_t>(b) * m * 3;
  const size_t out0 = static_cast<size_t>(b) * n;

  float sx[R], sy[R], sz[R], best[R];
  int best_row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = first + r * kThreads + threadIdx.x;
    const bool active = i < n;
    sx[r] = active ? s[3 * static_cast<size_t>(i)] : 0.f;
    sy[r] = active ? s[3 * static_cast<size_t>(i) + 1] : 0.f;
    sz[r] = active ? s[3 * static_cast<size_t>(i) + 2] : 0.f;
    best[r] = kBig;
    best_row[r] = 0;
  }

  const int stages = (r1 - r0 + stage_rows - 1) / stage_rows;
  auto issue = [&](int st) {
    float* dst = ring + 3 * (st % depth) * stage_rows;
    const int row0 = r0 + st * stage_rows;
    const int live = 3 * min(stage_rows, r1 - row0);
    const float* g = t + 3 * static_cast<size_t>(row0);
    for (int e = threadIdx.x; e < 3 * stage_rows; e += kThreads) {
      if (e < live) {
        cp_async4(dst + e, g + e);
      } else {
        dst[e] = CUDART_INF_F;
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
    const float* rs = ring + 3 * (st % depth) * stage_rows;
    const int row0 = r0 + st * stage_rows;
    const int segs = (min(stage_rows, r1 - row0) + kSeg - 1) / kSeg;
    for (int q = 0; q < segs; ++q) {
      const float4* v = reinterpret_cast<const float4*>(rs + 3 * kSeg * q);
      float low[R];
#pragma unroll
      for (int r = 0; r < R; ++r) low[r] = best[r];
#pragma unroll
      for (int k = 0; k < kSeg / 4; ++k) {
        // four rows (x y z) as three 16-byte words
        const float4 a = v[3 * k], c = v[3 * k + 1], e = v[3 * k + 2];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          low[r] = fminf(low[r], sq_dist(a.x, a.y, a.z, sx[r], sy[r], sz[r]));
          low[r] = fminf(low[r], sq_dist(a.w, c.x, c.y, sx[r], sy[r], sz[r]));
          low[r] = fminf(low[r], sq_dist(c.z, c.w, e.x, sx[r], sy[r], sz[r]));
          low[r] = fminf(low[r], sq_dist(e.y, e.z, e.w, sx[r], sy[r], sz[r]));
        }
      }
      const int row = row0 + kSeg * q;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        best_row[r] = low[r] < best[r] ? row : best_row[r];
        best[r] = low[r];
      }
    }
  }

  auto finish = [&](int j, float x, float y, float z, float d, int row) {
    const bool found = d < kBig;
    idx_out[out0 + first + j] = found ? locate(t, row, valid, x, y, z, d) : 0;
    dist_out[out0 + first + j] = found ? d : kBig;
  };
  if (splits == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = r * kThreads + threadIdx.x;
      if (first + j < n) finish(j, sx[r], sy[r], sz[r], best[r], best_row[r]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    part_d[r * kThreads + threadIdx.x] = best[r];
    part_row[r * kThreads + threadIdx.x] = best_row[r];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int lo = kChunk * split / splits;
  const int hi = kChunk * (split + 1) / splits;
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    float d = kBig;
    int row = INT_MAX;
    for (int p = 0; p < splits; ++p) {
      const float pd = *cluster.map_shared_rank(part_d + j, p);
      const int pr = *cluster.map_shared_rank(part_row + j, p);
      const bool better = pd < d || (pd == d && pr < row);
      d = better ? pd : d;
      row = better ? pr : row;
    }
    const int i = first + j;
    if (i < n) {
      finish(j, s[3 * static_cast<size_t>(i)], s[3 * static_cast<size_t>(i) + 1],
             s[3 * static_cast<size_t>(i) + 2], d, row);
    }
  }
  cluster.sync();  // the peers' shared memory stays alive until read
}

}  // namespace

// src f32[batch, n, 3], tgt f32[batch, m, 3], count i32[batch] (device),
// idx i32[batch, n] and dist f32[batch, n] (device, written here), all
// contiguous.  The geometry (threads 128, rows_per_thread 2 or 4, splits
// 1..8, stage_rows a multiple of 32, depth 2..3 and smem_bytes) comes from
// kernels/nn_dense.py::dense_geometry and is checked here.  Returns a
// cudaError_t as int: 0 when the launch was taken.
extern "C" int tpuslam_nn_dense(const float* src, const float* tgt,
                                const int* count, int batch, int n, int m,
                                int threads, int rows_per_thread, int splits,
                                int stage_rows, int depth, int smem_bytes,
                                int* idx, float* dist, void* stream) {
  if (batch <= 0 || n <= 0) return 0;  // nothing to launch
  const long long chunk = static_cast<long long>(kThreads) * rows_per_thread;
  const long long blocks = (n + chunk - 1) / chunk;
  const long long want = 12LL * depth * stage_rows + 8LL * chunk;
  if (batch > 65535 || m < 0 || threads != kThreads ||
      (rows_per_thread != 2 && rows_per_thread != 4) || splits < 1 ||
      splits > kMaxSplits || stage_rows <= 0 || stage_rows % kSeg != 0 ||
      depth < 2 || depth > 3 || smem_bytes != want ||
      blocks * splits >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks * splits), batch);
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
  auto kernel = rows_per_thread == 4 ? nn_dense_kernel<4> : nn_dense_kernel<2>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, src, tgt, count, n, m,
                                           splits, stage_rows, depth, idx, dist);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
