// The distance of the exact nearest-neighbour kernels, shared by K1
// (nn_dense.cu) and K3 (nn_cand.cu) so that both round it identically.
//
// d = fma(dz, dz, fma(dx, dx, dy * dy)) with d_ = t_ - s_, each step rounded
// once to float32: the rounding XLA gives the JAX oracle on the CPU
// (tpuslam.ops.nn.nearest_neighbors_ref).  Written with the _rn intrinsics
// so that no -fmad setting can change it.

#pragma once

#include <cuda_runtime.h>

namespace tpuslam {

constexpr float kBig = 3.4e38f;  // the oracle's no-match distance

__device__ __forceinline__ float sq_dist(float tx, float ty, float tz,
                                         float sx, float sy, float sz) {
  const float dx = __fsub_rn(tx, sx);
  const float dy = __fsub_rn(ty, sy);
  const float dz = __fsub_rn(tz, sz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

}  // namespace tpuslam
