// The Gaussian and the per-block partial sums of the CPD E-step, shared by
// K4 (cpd_dense.cu) and K5 (cpd_cand.cu) so that both compute every partial
// sum with the same instructions in the same order.
//
// The bit-identity contract of K5 against K4 (pallas_cpd_cand.py:1-16)
// rests on that order: each output row's statistic is a running total over
// blocks of kCpdTile rows of the other cloud, in ascending block order, and
// each block contributes one partial sum formed here.  A block, or a
// kSegRows-row segment of one, that K5 skips would have contributed exactly
// +0.0 (every term truncated, or multiplied by a zero weight), which leaves
// every accumulator unchanged (a + 0 == a and fma(+0, w, a) == a for finite
// w; no accumulator is ever -0), so skipping it changes no bit.
//
// The Gaussian.  d = fma(dz, dz, fma(dx, dx, dy * dy)) (tpuslam::sq_dist,
// the distance of the NN kernels), rounded as XLA rounds
// tpuslam/kernels/pallas_cpd.py::_gauss on the CPU.  With truncation, expo =
// mult * d is rounded once as there, the term is 0 where expo < log_trunc
// (the JAX package's decision, bit for bit), and g = 2^(expo * log2 e) by
// one ex2.approx.ftz (MUFU.EX2).  Without truncation no decision is taken
// and g = 2^(d * (mult * log2 e)): one multiply fewer.  Error against
// exp(expo) in float32 (torch.exp): the rounding of the exponent's argument
// arg, at most |arg| * 2^-23 in log2 units, so |arg| * 2^-23 * ln 2 relative
// in g (8.3e-7 at |arg| = 10, the edge of the truncation window; more on the
// exact mode's far terms, each below 1e-3 of the nearest), plus MUFU.EX2's
// own error of about 2 ulp; chip_smoke.py phase 8 prints the measured
// maximum on a 1024 x 1024 tile.  ftz flushes results below 2^-126 (expo < -87.3) to
// +0, where expf gives a subnormal of at most 1.2e-38: over M terms a row
// total c + sum moves by at most M * 1.2e-38 / c relative, nothing for the
// CPD loop's c (> 1e-14 with its weight clamped to >= 1e-6); only c == 0
// with every term in (e^-103.3, e^-87.3) turns a subnormal denominator into
// 0.
//
// Inside a block the terms are summed by four interleaved accumulators over
// the rows in order (k % 4), combined as (a0 + a1) + (a2 + a3); products
// with the moment weights are fused (fma).  A segment holds kSegRows = 128
// rows, a multiple of 4, so every row lands in the same accumulator whether
// or not the segments before it were skipped.  The plain PyTorch versions
// sum a block in torch's own order, so kernel and plain agree to a
// tolerance; K5 and K4 agree bit for bit.  The order depends on nothing
// else: not on the rows a thread holds (kR) nor on the thread count.
//
// The pass (cpd_pass): a CTA of kThreads threads owns kThreads * kR output
// rows, row base + i * kThreads + threadIdx.x for i < kR, so one shared
// float4 broadcast serves kR rows.  It walks a list of (block, segment
// mask) entries of the other cloud, ascending (a range of blocks, mask 0xFF,
// for K4; the CTA's candidate table for K5), and stages each masked 128-row
// segment with 16-byte cp.async into a ring of kStages buffers, so later
// segments load while the current one folds.  Rows are staged as they lie
// in device memory ([*, 3] floats: 4 rows are 3 float4; weights [*, 4]: one
// float4 a row).

#pragma once

#include <cuda_runtime.h>

#include "nn_fold.cuh"

namespace tpuslam {

constexpr int kCpdTile = 1024;  // rows per block, the JAX package's _TILE
constexpr int kSegRows = 128;   // rows per staged segment (the finest sub-tile)
constexpr int kSegs = kCpdTile / kSegRows;  // segments a block: mask bits
constexpr int kCpdThreads = 64;  // threads a CTA (kernels/cpd_dense.py THREADS)
constexpr int kStages = 4;       // segments in flight a CTA
constexpr float kLog2e = 1.4426950408889634f;

// The per-pair scalars of the JAX kernels' [B, 4] scalar row.
struct CpdScalars {
  float mult;       // -0.5 / sigma^2
  float c;          // the uniform-component constant
  bool trunc;       // truncation active
  float log_trunc;  // log(truncate)
  float mult_log2e; // mult * log2(e), the exact mode's exponent scale
};

__device__ __forceinline__ CpdScalars load_scalars(const float* sc) {
  return CpdScalars{sc[0], sc[1], sc[2] != 0.f, sc[3],
                    __fmul_rn(sc[0], kLog2e)};
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kTrunc>
__device__ __forceinline__ float cpd_gauss(float tx, float ty, float tz,
                                           float sx, float sy, float sz,
                                           const CpdScalars& s) {
  const float d = sq_dist(tx, ty, tz, sx, sy, sz);
  if (kTrunc) {
    const float expo = __fmul_rn(s.mult, d);
    const float g = ex2_ftz(__fmul_rn(expo, kLog2e));
    return expo < s.log_trunc ? 0.f : g;
  }
  return ex2_ftz(__fmul_rn(d, s.mult_log2e));
}

__device__ __forceinline__ void cpd_cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}

__device__ __forceinline__ void cpd_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kStages - 2 committed groups are still in flight
__device__ __forceinline__ void cpd_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// The entries of K4's walk: blocks [first, first + blocks) of the other
// cloud, all segments.
struct DenseWalk {
  int first;
  int blocks;
  __device__ __forceinline__ int live() const { return blocks; }
  __device__ __forceinline__ int entry(int e) const {
    return ((first + e) << 8) | 0xFF;
  }
};

// The entries of K5's walk: a CTA's table, (block << 8) | segment mask,
// ascending; read into shared memory first.
struct TableWalk {
  const int* tab;
  int count;
  __device__ __forceinline__ int live() const { return count; }
  __device__ __forceinline__ int entry(int e) const { return tab[e]; }
};

// Steps through the masked segments of a walk, in order: block, segment,
// and whether the segment is the last of its block.  Every thread of a CTA
// steps alike.
template <class Walk>
struct SegCursor {
  int e = -1;         // current entry
  unsigned rem = 0u;  // its segments not yet stepped over
  int block = 0;

  __device__ __forceinline__ bool next(const Walk& w, int& blk, int& seg,
                                       bool& last) {
    while (rem == 0u) {  // entries with an empty mask are stepped over
      if (++e >= w.live()) return false;
      const int v = w.entry(e);
      block = v >> 8;
      rem = static_cast<unsigned>(v) & 0xFFu;
    }
    seg = __ffs(static_cast<int>(rem)) - 1;
    rem &= rem - 1u;
    blk = block;
    last = rem == 0u;
    return true;
  }
};

// The ring: per stage one segment's rows ([kSegRows, 3] floats = 96
// float4) and, for the moments pass, their weights (kSegRows float4).
template <bool kMoments>
struct CpdRing {
  float4 xyz[kStages][kSegRows * 3 / 4];
  float4 w[kMoments ? kStages : 1][kMoments ? kSegRows : 1];
};

template <bool kMoments, int kThreads>
__device__ __forceinline__ void stage_segment(CpdRing<kMoments>& ring,
                                              int stage,
                                              const float* __restrict__ other,
                                              const float4* __restrict__ w4,
                                              int blk, int seg) {
  const size_t row0 = static_cast<size_t>(blk) * kCpdTile +
                      static_cast<size_t>(seg) * kSegRows;
  const float4* src = reinterpret_cast<const float4*>(other + row0 * 3);
  constexpr int kXyz = kSegRows * 3 / 4;
  constexpr int kAll = kMoments ? kXyz + kSegRows : kXyz;
  for (int q = threadIdx.x; q < kAll; q += kThreads) {
    if (q < kXyz) {
      cpd_cp_async16(&ring.xyz[stage][q], src + q);
    } else {
      cpd_cp_async16(&ring.w[stage][q - kXyz], w4 + row0 + (q - kXyz));
    }
  }
}

// Fold one staged segment into the accumulators of the thread's kR rows:
// acc[r][k % 4] (denominator) or acc[r][c][k % 4] (moment c).
template <bool kMoments, bool kTrunc, int kR>
__device__ __forceinline__ void fold_segment(const CpdRing<kMoments>& ring,
                                             int stage, const float (&px)[kR],
                                             const float (&py)[kR],
                                             const float (&pz)[kR],
                                             const CpdScalars& s,
                                             float (&acc)[kR][4][4]) {
#pragma unroll 2
  for (int q = 0; q < kSegRows / 4; ++q) {
    const float4 a = ring.xyz[stage][3 * q];
    const float4 b = ring.xyz[stage][3 * q + 1];
    const float4 c = ring.xyz[stage][3 * q + 2];
    const float ox[4] = {a.x, a.w, b.z, c.y};
    const float oy[4] = {a.y, b.x, b.w, c.z};
    const float oz[4] = {a.z, b.y, c.x, c.w};
    if (kMoments) {
      float4 w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = ring.w[stage][4 * q + k];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float g =
              cpd_gauss<kTrunc>(ox[k], oy[k], oz[k], px[r], py[r], pz[r], s);
          acc[r][0][k] = __fmaf_rn(g, w[k].x, acc[r][0][k]);
          acc[r][1][k] = __fmaf_rn(g, w[k].y, acc[r][1][k]);
          acc[r][2][k] = __fmaf_rn(g, w[k].z, acc[r][2][k]);
          acc[r][3][k] = __fmaf_rn(g, w[k].w, acc[r][3][k]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[r][0][k] = __fadd_rn(
              acc[r][0][k],
              cpd_gauss<kTrunc>(ox[k], oy[k], oz[k], px[r], py[r], pz[r], s));
        }
      }
    }
  }
}

// One pass for the kR rows of this thread: run[r][c] (c < 1 for the
// denominator, < 4 for the moments) starts at its initial value and adds one
// partial per block of the walk, in the walk's order.  Where `parts` is
// given, each block's partial is stored there instead, at [(block * kC + c)
// * n_rows + row] (rows from `row0`, kThreads apart), for cpd_combine.
template <bool kMoments, bool kTrunc, int kR, int kThreads, class Walk>
__device__ __forceinline__ void cpd_pass(CpdRing<kMoments>& ring,
                                         const Walk& walk,
                                         const float* __restrict__ other,
                                         const float4* __restrict__ w4,
                                         const float (&px)[kR],
                                         const float (&py)[kR],
                                         const float (&pz)[kR],
                                         const CpdScalars& s,
                                         float (&run)[kR][4],
                                         float* __restrict__ parts,
                                         int n_rows, int row0) {
  constexpr int kC = kMoments ? 4 : 1;
  float acc[kR][4][4];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][c][k] = 0.f;

  SegCursor<Walk> ld, cp;
  int blk, seg;
  bool last;
  // prologue: the first kStages - 1 segments, one commit group each
#pragma unroll 1
  for (int p = 0; p < kStages - 1; ++p) {
    if (ld.next(walk, blk, seg, last)) {
      stage_segment<kMoments, kThreads>(ring, p, other, w4, blk, seg);
    }
    cpd_cp_async_commit();
  }
  int stage = 0;
#pragma unroll 1
  while (cp.next(walk, blk, seg, last)) {
    cpd_cp_async_wait();  // this thread's copies of the segment landed
    __syncthreads();      // everyone's did; everyone folded the last one
    int lblk, lseg;
    bool llast;
    if (ld.next(walk, lblk, lseg, llast)) {
      stage_segment<kMoments, kThreads>(ring, (stage + kStages - 1) % kStages,
                                        other, w4, lblk, lseg);
    }
    cpd_cp_async_commit();
    fold_segment<kMoments, kTrunc, kR>(ring, stage, px, py, pz, s, acc);
    if (last) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float part = __fadd_rn(__fadd_rn(acc[r][c][0], acc[r][c][1]),
                                       __fadd_rn(acc[r][c][2], acc[r][c][3]));
          if (parts != nullptr) {
            parts[(static_cast<size_t>(blk) * kC + c) * n_rows + row0 +
                  r * kThreads] = part;
          } else {
            run[r][c] = __fadd_rn(run[r][c], part);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][c][k] = 0.f;
        }
      }
    }
    stage = (stage + 1) % kStages;
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// The whole of one CTA's work: load its kR rows, run the pass under the
// pair's truncation flag (the flag picks one of two compiled variants, the
// same for every thread of the CTA), store the totals, or with `parts` the
// per-block partials.  `rows` [n_rows, 3] are the output rows of this pair,
// `other` [*, 3] and `w4` [*] (moments) the other cloud; out is [n_rows]
// (denominator) or [4, n_rows].
template <bool kMoments, int kR, int kThreads, class Walk>
__device__ __forceinline__ void cpd_cta(CpdRing<kMoments>& ring,
                                        const Walk& walk,
                                        const CpdScalars& s,
                                        const float* __restrict__ rows,
                                        const float* __restrict__ other,
                                        const float4* __restrict__ w4,
                                        int n_rows, int cta,
                                        float* __restrict__ out,
                                        float* __restrict__ parts = nullptr) {
  const int base = cta * kThreads * kR + threadIdx.x;
  float px[kR], py[kR], pz[kR], run[kR][4];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const size_t i = static_cast<size_t>(base + r * kThreads);
    px[r] = rows[3 * i];
    py[r] = rows[3 * i + 1];
    pz[r] = rows[3 * i + 2];
    run[r][0] = kMoments ? 0.f : s.c;
    run[r][1] = run[r][2] = run[r][3] = 0.f;
  }
  if (s.trunc) {
    cpd_pass<kMoments, true, kR, kThreads>(ring, walk, other, w4, px, py, pz,
                                           s, run, parts, n_rows, base);
  } else {
    cpd_pass<kMoments, false, kR, kThreads>(ring, walk, other, w4, px, py,
                                            pz, s, run, parts, n_rows, base);
  }
  if (parts != nullptr) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const size_t i = static_cast<size_t>(base + r * kThreads);
    if (kMoments) {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c * static_cast<size_t>(n_rows) + i] = run[r][c];
    } else {
      out[i] = run[r][0];
    }
  }
}

// The running totals from stored per-block partials, one thread a row and
// pair: run starts at c (denominator) or 0 and adds the partials of blocks
// 0, 1, ... in order, so the totals equal cpd_cta's unsplit ones bit for
// bit.  parts [batch, blocks, kC, n_rows]; out [batch, kC, n_rows].
template <int kC>
__device__ __forceinline__ void cpd_combine(const float* __restrict__ scalars,
                                            const float* __restrict__ parts,
                                            int n_rows, int blocks,
                                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n_rows) return;
  const float* p = parts + static_cast<size_t>(b) * blocks * kC * n_rows;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float run = kC == 1 ? scalars[4 * b + 1] : 0.f;
    for (int j = 0; j < blocks; ++j) {
      run = __fadd_rn(run, p[(static_cast<size_t>(j) * kC + c) * n_rows + i]);
    }
    out[(static_cast<size_t>(b) * kC + c) * n_rows + i] = run;
  }
}

}  // namespace tpuslam
