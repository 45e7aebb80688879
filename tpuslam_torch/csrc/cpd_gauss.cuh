// The Gaussian and the per-block partial sums of the CPD E-step, shared by
// K4 (cpd_dense.cu) and K5 (cpd_cand.cu) so that both compute every partial
// sum with the same instructions in the same order.
//
// The bit-identity contract of K5 against K4 (pallas_cpd_cand.py:1-16)
// rests on that order: each output row's statistic is a running total over
// blocks of kCpdTile rows of the other cloud, in ascending block order, and
// each block contributes one partial sum formed here.  A block that K5 skips
// would have contributed exactly +0.0 (every term truncated), which leaves
// the running total unchanged, so skipping it changes no bit.
//
// The Gaussian follows tpuslam/kernels/pallas_cpd.py::_gauss as XLA rounds it
// on the CPU: d = fma(dz, dz, fma(dx, dx, dy * dy)) (tpuslam::sq_dist, the
// distance of the NN kernels), expo = mult * d rounded once, g = expf(expo)
// (the accurate expf: the build uses no fast-math), and g = 0 where the
// truncation flag is set and expo < log_trunc.
//
// Inside a block the terms are summed by four interleaved accumulators over
// the rows in order (k % 4), combined as (a0 + a1) + (a2 + a3); products
// with the moment weights are fused (fma).  The plain PyTorch versions sum a
// block in torch's own order, so kernel and plain agree to a tolerance;
// K5 and K4 agree bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "nn_fold.cuh"

namespace tpuslam {

constexpr int kCpdTile = 1024;  // rows per block, the JAX package's _TILE

// The per-pair scalars of the JAX kernels' [B, 4] scalar row.
struct CpdScalars {
  float mult;       // -0.5 / sigma^2
  float c;          // the uniform-component constant
  bool trunc;       // truncation active
  float log_trunc;  // log(truncate)
};

__device__ __forceinline__ CpdScalars load_scalars(const float* sc) {
  return CpdScalars{sc[0], sc[1], sc[2] != 0.f, sc[3]};
}

__device__ __forceinline__ float cpd_gauss(float tx, float ty, float tz,
                                           float sx, float sy, float sz,
                                           const CpdScalars& s) {
  const float expo = __fmul_rn(s.mult, sq_dist(tx, ty, tz, sx, sy, sz));
  const float g = expf(expo);
  return (s.trunc && expo < s.log_trunc) ? 0.f : g;
}

// Copy kCpdTile rows of a row-major [*, 3] array into shared x/y/z arrays:
// coalesced global reads of the block's 3 * kCpdTile floats.
template <int kThreads>
__device__ __forceinline__ void stage_xyz(const float* __restrict__ rows,
                                          float* x, float* y, float* z) {
  for (int q = threadIdx.x; q < 3 * kCpdTile; q += kThreads) {
    const float v = rows[q];
    const int r = q / 3;
    const int c = q - 3 * r;
    (c == 0 ? x : (c == 1 ? y : z))[r] = v;
  }
}

// Copy kCpdTile rows of a row-major [*, 4] weight array into w0..w3.
template <int kThreads>
__device__ __forceinline__ void stage_w4(const float4* __restrict__ rows,
                                         float* w0, float* w1, float* w2,
                                         float* w3) {
  for (int r = threadIdx.x; r < kCpdTile; r += kThreads) {
    const float4 v = rows[r];
    w0[r] = v.x;
    w1[r] = v.y;
    w2[r] = v.z;
    w3[r] = v.w;
  }
}

// Denominator partial of one output row (a target point p) over one staged
// block of moving rows: sum_k g(m_k, p).
__device__ __forceinline__ float denom_block(const float* mx, const float* my,
                                             const float* mz, float px,
                                             float py, float pz,
                                             const CpdScalars& s) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 2
  for (int k = 0; k < kCpdTile; k += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(mx + k);
    const float4 y4 = *reinterpret_cast<const float4*>(my + k);
    const float4 z4 = *reinterpret_cast<const float4*>(mz + k);
    a0 = __fadd_rn(a0, cpd_gauss(x4.x, y4.x, z4.x, px, py, pz, s));
    a1 = __fadd_rn(a1, cpd_gauss(x4.y, y4.y, z4.y, px, py, pz, s));
    a2 = __fadd_rn(a2, cpd_gauss(x4.z, y4.z, z4.z, px, py, pz, s));
    a3 = __fadd_rn(a3, cpd_gauss(x4.w, y4.w, z4.w, px, py, pz, s));
  }
  return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}

// Moment partials of one output row (a moving point q) over one staged block
// of target rows with their weights [1/denom, x/denom, y/denom, z/denom]:
// out[c] = sum_k g(x_k, q) * w_c[k].
__device__ __forceinline__ void moments_block(
    const float* tx, const float* ty, const float* tz, const float* w0,
    const float* w1, const float* w2, const float* w3, float qx, float qy,
    float qz, const CpdScalars& s, float out[4]) {
  float a[4][4] = {};  // [weight][interleave]
#pragma unroll 1
  for (int k = 0; k < kCpdTile; k += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(tx + k);
    const float4 y4 = *reinterpret_cast<const float4*>(ty + k);
    const float4 z4 = *reinterpret_cast<const float4*>(tz + k);
    const float g[4] = {cpd_gauss(x4.x, y4.x, z4.x, qx, qy, qz, s),
                        cpd_gauss(x4.y, y4.y, z4.y, qx, qy, qz, s),
                        cpd_gauss(x4.z, y4.z, z4.z, qx, qy, qz, s),
                        cpd_gauss(x4.w, y4.w, z4.w, qx, qy, qz, s)};
    const float* w[4] = {w0, w1, w2, w3};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 wc = *reinterpret_cast<const float4*>(w[c] + k);
      a[c][0] = __fmaf_rn(g[0], wc.x, a[c][0]);
      a[c][1] = __fmaf_rn(g[1], wc.y, a[c][1]);
      a[c][2] = __fmaf_rn(g[2], wc.z, a[c][2]);
      a[c][3] = __fmaf_rn(g[3], wc.w, a[c][3]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[c] = __fadd_rn(__fadd_rn(a[c][0], a[c][1]), __fadd_rn(a[c][2], a[c][3]));
  }
}

}  // namespace tpuslam
