// K5's per-call plan: the admission, the per-CTA tables and the fat subsets
// of one candidate CPD E-step, CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: the JAX package builds its admission with jnp
// inside the E-step's program (tpuslam/kernels/pallas_cpd_cand.py:257-311),
// and XLA fuses it there.  In the port the same composition ran as some 240
// small PyTorch kernels a call (kernels/cpd_cand.py::cand_plan_ref, kept as
// the plain version), launch-bound at every size the benchmark serves.  This
// file writes what K5's passes, K4's fat-subset passes and the route read,
// bit-equal to that composition, in three launches and without reading the
// host, so the CPD loop's CUDA graphs capture it as it is:
//
//   1. plan_bounds_kernel: the operands padded to 1024 rows (moving rows at
//      the sentinel), the scalars row, and one warp a sub-tile of either
//      cloud: its bounding sphere (ops/spatial.py::tile_bounds);
//   2. plan_pairs_kernel: one thread a (target sub-tile, moving block): its
//      f_sub sub-tile pairs tested against the cutoff, the admitted bits
//      spread to 128-row segment masks in both directions, and integer
//      counts of the admitted block pairs (atomics, so order-free); the
//      block that arrives last (a counter in the workspace, zeroed by
//      launch 1) derives the fat blocks, the overflow, the route, the
//      ordered fat block ids and the served flags;
//   3. plan_tables_kernel: one warp a CTA row of either pass compacting its
//      nonzero masks into its table by ballot, ascending; the fat subsets'
//      row lists and valid masks.
//
// Roundings, as the composition takes them on the card: tile_bounds'
// (lo + hi) * 0.5 and 0.5 * sqrt(sx*sx + sy*sy + sz*sz), each operation
// rounded; sq_norm_xla's fma(z, z, fma(y, y, x*x)) as it emulates it
// (products exact in float64, one float64 add, rounded to float32 each
// step); the correctly rounded square root; cdist - r_n - r_m left to right,
// clamped at 0, times float(1 - 1e-5); lb * lb <= cut * sigma^2.
//
// With the truncation flag false every pair is admitted: launch 1 skips the
// bounds, launch 2 the pairs, and the plan follows from the block counts
// alone (every mask full).  The behaviour follows the shape: the same three
// launches serve 4 blocks a side and the 64M sub-tile pairs of
// SUB_BOUND_MAX, f_sub 8, 4, 2 or 1.
//
// Bound on this card: the bytes, both clouds read once (16 bytes a row)
// plus the padded copies and the tables written; the float64 arithmetic of
// the pairs (under 10 operations a sub-tile pair) is far below the card's
// rate up to 64M pairs.  At the benchmark's sizes every launch is a few
// microseconds: the plan is three graph nodes where it was ~240.
//
// The C entry point launches on the caller's stream, allocates nothing (the
// wrapper passes a workspace of tpuslam_cpd_plan_workspace bytes and the
// outputs), does not synchronise, and returns the last launch's
// cudaError_t.  Each launch counts itself in the tally (tally.cuh).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "tally.cuh"

namespace {

constexpr int kTile = 1024;      // rows of a block (cpd_dense.TILE)
constexpr int kSegs = 8;         // 128-row segments of a block (cpd_cand.SEGS)
constexpr int kThreads = 256;    // launches 1 and 3: eight warps a CTA
constexpr int kCols = 32;        // launch 2: moving blocks a CTA (x) ...
constexpr int kRows = 8;         // ... by target sub-tiles (y)
constexpr int kMaxGrid = 4096;   // grid-stride launches: CTAs at most
constexpr float kSentinel = 1e15f;  // padded moving rows (cpd_dense.SENTINEL)
constexpr float kFar = 1e15f;       // centre of a sub-tile with no valid row
constexpr float kBig = 3.4e38f;     // spatial.BIG
constexpr float kShrink = static_cast<float>(1.0 - 1e-5);

struct Params {
  // inputs: unpadded clouds and masks, their rows, the scalars on the device
  const float* mov;
  const float* mov_mask;
  const float* tgt;
  const float* tgt_mask;
  int m0, n0, m, n, tm, tn, f, sub;
  const float* sigma2;
  const float* constant;
  const unsigned char* trunc;
  float cut, log_t;
  int checked;
  int cta_rows_n, cta_rows_m, ctas_n, ctas_m;
  int width_m, width_n, budget_n, budget_m, cap_n, cap_m;
  // workspace
  float4* bounds_n;  // [tn * f] target sub-tiles: centre, radius
  float4* bounds_m;  // [tm * f]
  int* count_n;      // [tn] admitted moving blocks a target block
  int* count_m;      // [tm]
  int* ids_n;        // [cap_n] fat target blocks first, each group ascending
  int* ids_m;        // [cap_m]
  int* arrival;      // launch 2's counter of finished CTAs
  unsigned char* serve_n;  // [tn] a target block's CTAs get a table
  unsigned char* serve_m;  // [tm]
  unsigned char* seg_n;    // [tn * f, tm] segment masks: target sub-tile x moving block
  unsigned char* seg_m;    // [tm * f, tn]
  // outputs
  float* ty;
  float* tgt_p;
  float* mov_mask_p;
  float* tgt_mask_p;
  float* scalars;
  int* route;
  int* table_m;
  int* counts_n;
  int* table_n;
  int* counts_m;
  long long* rows_n;
  int* live_n;
  unsigned char* valid_n;
  long long* rows_m;
  int* live_m;
  unsigned char* valid_m;
  long long* read;
  int* tally;
};

size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// The workspace's sections, in bytes from its start (16-byte aligned).
struct Layout {
  size_t bounds_n, bounds_m, count_n, count_m, ids_n, ids_m, arrival, serve_n,
      serve_m, seg_n, seg_m, bytes;
};

Layout layout(int tn, int tm, int f, int cap_n, int cap_m) {
  Layout l{};
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += align16(bytes);
    return here;
  };
  const size_t sn = static_cast<size_t>(tn) * f, sm = static_cast<size_t>(tm) * f;
  l.bounds_n = take(sizeof(float4) * sn);
  l.bounds_m = take(sizeof(float4) * sm);
  l.count_n = take(sizeof(int) * tn);
  l.count_m = take(sizeof(int) * tm);
  l.ids_n = take(sizeof(int) * cap_n);
  l.ids_m = take(sizeof(int) * cap_m);
  l.arrival = take(sizeof(int));
  l.serve_n = take(tn);
  l.serve_m = take(tm);
  l.seg_n = take(sn * tm);
  l.seg_m = take(sm * tn);
  l.bytes = at;
  return l;
}

// f sub-tile bits spread to kSegs segment bits: bit b covers segments
// [b e, (b + 1) e), e = kSegs / f
__device__ __forceinline__ int spread(unsigned bits, int f) {
  const int e = kSegs / f;
  int out = 0;
  for (int b = 0; b < f; ++b) {
    if ((bits >> b) & 1u) out |= ((1 << e) - 1) << (b * e);
  }
  return out;
}

// sq_norm_xla's step: fl(y*y + acc) with y*y exact and one float64 add
__device__ __forceinline__ float fma_emul(float y, float acc) {
  const double yy = __dmul_rn(static_cast<double>(y), static_cast<double>(y));
  return __double2float_rn(__dadd_rn(yy, static_cast<double>(acc)));
}

// whether a sub-tile pair may hold a term above the cutoff (block_admission)
__device__ __forceinline__ bool admitted(float4 a, float4 b, float d2_cut) {
  const float dx = __fsub_rn(a.x, b.x), dy = __fsub_rn(a.y, b.y), dz = __fsub_rn(a.z, b.z);
  const float d2 = fma_emul(dz, fma_emul(dy, __fmul_rn(dx, dx)));
  float lb = __fsub_rn(__fsub_rn(__fsqrt_rn(d2), a.w), b.w);
  if (lb < 0.0f) lb = 0.0f;  // clamp_min; a NaN stays
  lb = __fmul_rn(lb, kShrink);
  return __fmul_rn(lb, lb) <= d2_cut;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Launch 1: padded copies, scalars, zeroed counts; the sub-tile bounds.
__global__ void __launch_bounds__(kThreads) plan_bounds_kernel(Params p) {
  tally_launch(p.tally, false);
  const bool trunc = *p.trunc != 0;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  if (tid == 0) {
    const float s2 = *p.sigma2;
    p.scalars[0] = __fmul_rn(__frcp_rn(s2), -0.5f);  // -0.5 / sigma2 as torch takes it
    p.scalars[1] = *p.constant;
    p.scalars[2] = trunc ? 1.0f : 0.0f;
    p.scalars[3] = p.log_t;
    *p.arrival = 0;
  }
  for (int i = tid; i < p.tn; i += stride) p.count_n[i] = 0;
  for (int j = tid; j < p.tm; j += stride) p.count_m[j] = 0;
  const int rows = max(p.m, p.n);
  for (int r = tid; r < rows; r += stride) {
    if (r < p.m) {
      const float w = r < p.m0 ? p.mov_mask[r] : 0.0f;
      p.mov_mask_p[r] = w;
      for (int k = 0; k < 3; ++k) {
        p.ty[3 * r + k] = w > 0.0f ? p.mov[3 * r + k] : kSentinel;
      }
    }
    if (r < p.n) {
      const bool in = r < p.n0;
      p.tgt_mask_p[r] = in ? p.tgt_mask[r] : 0.0f;
      for (int k = 0; k < 3; ++k) p.tgt_p[3 * r + k] = in ? p.tgt[3 * r + k] : 0.0f;
    }
  }
  if (!trunc) return;  // every pair admitted: no bounds needed
  const int lane = threadIdx.x & 31;
  const int warps = stride / 32;
  const int sn = p.tn * p.f, total = sn + p.tm * p.f;
  for (int w = tid / 32; w < total; w += warps) {
    const bool target = w < sn;
    const int s = target ? w : w - sn;
    const float* pts = target ? p.tgt : p.mov;
    const float* mask = target ? p.tgt_mask : p.mov_mask;
    const int valid_rows = target ? p.n0 : p.m0;
    float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
    bool any = false;
    for (int r = s * p.sub + lane; r < (s + 1) * p.sub; r += 32) {
      if (r < valid_rows && mask[r] > 0.0f) {
        any = true;
        for (int k = 0; k < 3; ++k) {
          const float v = pts[3 * r + k];
          lo[k] = fminf(lo[k], v);
          hi[k] = fmaxf(hi[k], v);
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], o));
        hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], o));
      }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) {
      float4 b = make_float4(kFar, kFar, kFar, 0.0f);
      if (any) {
        float c[3], sq = 0.0f;
        for (int k = 0; k < 3; ++k) {
          c[k] = __fmul_rn(__fadd_rn(lo[k], hi[k]), 0.5f);
          const float span = __fsub_rn(hi[k], lo[k]);
          sq = k == 0 ? __fmul_rn(span, span) : __fadd_rn(sq, __fmul_rn(span, span));
        }
        b = make_float4(c[0], c[1], c[2], __fmul_rn(0.5f, __fsqrt_rn(sq)));
      }
      (target ? p.bounds_n : p.bounds_m)[s] = b;
    }
  }
}

// The block-wide exclusive prefix of one flag a thread (kThreads threads)
// and the total; `warp_sums` holds kThreads / 32 ints.
__device__ int flag_prefix(bool flag, int* warp_sums, int* total) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const unsigned vote = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_sums[warp] = __popc(vote);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  __syncthreads();
  *total = all;
  return before + __popc(vote & lanes_below());
}

// One side's fat blocks, in _block_rows' order (flagged first, each group
// ascending: the first `cap` ids), and its served flags.
__device__ void order_side(const int* count, bool trunc, int blocks, int other, int width,
                           int n_fat, int cap, bool dense, int* ids,
                           unsigned char* serve, int* warp_sums) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  int seen = 0;  // flagged blocks before this chunk
  for (int i0 = 0; i0 < blocks; i0 += kThreads) {
    const int i = i0 + t;
    const bool fat = i < blocks && (trunc ? __ldcg(count + i) : other) > width;
    int chunk;
    const int before = seen + flag_prefix(fat, warp_sums, &chunk);
    if (i < blocks) {
      const int pos = fat ? before : n_fat + (i - before);
      if (pos < cap) ids[pos] = i;
      serve[i] = !fat && !dense;
    }
    seen += chunk;
  }
}

// The last CTA of launch 2: fat blocks, overflow, route, the values the
// eager route reads back, live rows, ordered ids and served flags.
__device__ void finalize(const Params& p, bool trunc) {
  __shared__ int warp_sums[kThreads / 32];
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  int fat_n = 0, fat_m = 0;
  for (int i0 = 0; i0 < p.tn; i0 += kThreads) {
    const int i = i0 + t;
    fat_n += __syncthreads_count(i < p.tn && (trunc ? __ldcg(p.count_n + i) : p.tm) > p.width_m);
  }
  for (int j0 = 0; j0 < p.tm; j0 += kThreads) {
    const int j = j0 + t;
    fat_m += __syncthreads_count(j < p.tm && (trunc ? __ldcg(p.count_m + j) : p.tn) > p.width_n);
  }
  const bool overflow = fat_n > p.budget_n || fat_m > p.budget_m;
  const bool dense = p.checked ? overflow : (overflow || !trunc);
  if (t == 0) {
    *p.route = dense ? 1 : 0;
    p.read[0] = dense ? 1 : 0;
    p.read[1] = fat_n;
    p.read[2] = fat_m;
    *p.live_n = dense ? 0 : min(fat_n, p.cap_n) * kTile;
    *p.live_m = dense ? 0 : min(fat_m, p.cap_m) * kTile;
  }
  order_side(p.count_n, trunc, p.tn, p.tm, p.width_m, fat_n, p.cap_n, dense, p.ids_n,
             p.serve_n, warp_sums);
  order_side(p.count_m, trunc, p.tm, p.tn, p.width_n, fat_m, p.cap_m, dense, p.ids_m,
             p.serve_m, warp_sums);
}

// Launch 2: the sub-tile pairs of (kRows target sub-tiles) x (kCols moving
// blocks) a CTA, one thread a (sub-tile, block); then the last CTA's plan.
__global__ void __launch_bounds__(kCols * kRows) plan_pairs_kernel(Params p) {
  __shared__ float4 mov_b[kCols][kSegs];
  __shared__ unsigned char bits[kRows][kCols];
  __shared__ unsigned char adm[kRows][kCols];
  __shared__ bool last;
  tally_launch(p.tally, false);
  const bool trunc = *p.trunc != 0;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * kCols + tx;
  const int cols = (p.tm + kCols - 1) / kCols;
  const int j0 = (blockIdx.x % cols) * kCols, s0 = (blockIdx.x / cols) * kRows;
  const int f = p.f, sn = p.tn * f, per = kRows / f;  // target blocks a CTA
  if (trunc) {
    for (int k = t; k < kCols * f; k += kCols * kRows) {
      const int j = j0 + k / f;
      if (j < p.tm) mov_b[k / f][k % f] = p.bounds_m[j * f + k % f];
    }
    __syncthreads();
    const int s = s0 + ty, j = j0 + tx;
    unsigned own = 0;  // bit b: sub-tile pair (s, j f + b) admitted
    if (s < sn && j < p.tm) {
      const float4 cn = p.bounds_n[s];
      const float d2_cut = __fmul_rn(p.cut, *p.sigma2);
      for (int b = 0; b < f; ++b) own |= admitted(cn, mov_b[tx][b], d2_cut) ? 1u << b : 0u;
      p.seg_n[static_cast<size_t>(s) * p.tm + j] = static_cast<unsigned char>(spread(own, f));
    }
    bits[ty][tx] = static_cast<unsigned char>(own);
    __syncthreads();
    // the moving side's masks: (moving sub-tile j f + b, each target block
    // of the CTA), bit a from the target sub-tile i f + a
    if (ty < f && j < p.tm) {
      for (int il = 0; il < per; ++il) {
        const int i = s0 / f + il;
        if (i >= p.tn) break;
        unsigned col = 0;
        for (int a = 0; a < f; ++a) col |= ((bits[il * f + a][tx] >> ty) & 1u) << a;
        p.seg_m[(static_cast<size_t>(j) * f + ty) * p.tn + i] =
            static_cast<unsigned char>(spread(col, f));
      }
    }
    // admitted block pairs: the target block's count by ballot, the moving
    // block's over the CTA's target blocks
    if (ty < per) {
      const int i = s0 / f + ty;
      bool any = false;
      for (int a = 0; a < f; ++a) any |= bits[ty * f + a][tx] != 0;
      any = any && i < p.tn && j < p.tm;
      const unsigned vote = __ballot_sync(0xffffffffu, any);
      if (tx == 0 && vote != 0u) atomicAdd(p.count_n + i, __popc(vote));
      adm[ty][tx] = any;
    }
    __syncthreads();
    if (ty == 0 && j < p.tm) {
      int c = 0;
      for (int il = 0; il < per; ++il) c += adm[il][tx];
      if (c != 0) atomicAdd(p.count_m + j, c);
    }
  }
  __threadfence();  // the counts are seen before the arrival
  __syncthreads();
  if (t == 0) last = atomicAdd(p.arrival, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finalize(p, trunc);
}

// Launch 3: each CTA row's table (one warp a row, both passes) and the fat
// subsets' rows and valid masks.
__global__ void __launch_bounds__(kThreads) plan_tables_kernel(Params p) {
  tally_launch(p.tally, false);
  const bool trunc = *p.trunc != 0;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (int w = tid / 32; w < p.ctas_n + p.ctas_m; w += stride / 32) {
    const bool target = w < p.ctas_n;
    const int c = target ? w : w - p.ctas_n;
    const int row0 = c * (target ? p.cta_rows_n : p.cta_rows_m);
    const int other = target ? p.tm : p.tn;
    const int width = target ? p.width_m : p.width_n;
    const unsigned char* seg =
        (target ? p.seg_n : p.seg_m) + static_cast<size_t>(row0 / p.sub) * other;
    int* out = (target ? p.table_m : p.table_n) + static_cast<size_t>(c) * width;
    int live = 0;
    if ((target ? p.serve_n : p.serve_m)[row0 / kTile]) {
      for (int j0 = 0; j0 < other; j0 += 32) {
        const int j = j0 + lane;
        const int mask = j < other ? (trunc ? seg[j] : (1 << kSegs) - 1) : 0;
        const unsigned vote = __ballot_sync(0xffffffffu, mask != 0);
        const int slot = live + __popc(vote & lanes_below());
        if (mask != 0 && slot < width) out[slot] = (j << 8) | mask;
        live += __popc(vote);
      }
    }
    for (int k = min(live, width) + lane; k < width; k += 32) out[k] = 0;
    if (lane == 0) (target ? p.counts_n : p.counts_m)[c] = live;
  }
  const int rows_n = p.cap_n * kTile, live_n = *p.live_n, live_m = *p.live_m;
  for (int e = tid; e < rows_n + p.cap_m * kTile; e += stride) {
    const bool target = e < rows_n;
    const int k = target ? e : e - rows_n;
    const int id = (target ? p.ids_n : p.ids_m)[k / kTile];
    (target ? p.rows_n : p.rows_m)[k] = static_cast<long long>(id) * kTile + k % kTile;
    (target ? p.valid_n : p.valid_m)[k] = k < (target ? live_n : live_m);
  }
}

int grid_of(long long items, int per_cta) {
  const long long g = (items + per_cta - 1) / per_cta;
  return static_cast<int>(g < 1 ? 1 : (g > kMaxGrid ? kMaxGrid : g));
}

}  // namespace

// Bytes of the workspace a plan of n target and m moving rows (multiples of
// 1024) at f_sub sub-tiles a block takes, with fat capacities cap_n, cap_m.
extern "C" long long tpuslam_cpd_plan_workspace(int n, int m, int f_sub, int cap_n,
                                                int cap_m) {
  return static_cast<long long>(layout(n / kTile, m / kTile, f_sub, cap_n, cap_m).bytes);
}

// One plan (kernels/cpd_cand.py::cand_plan): mov f32[m0, 3], mov_mask
// f32[m0], tgt f32[n0, 3], tgt_mask f32[n0] (contiguous), padded to m and n
// rows; sigma2, constant (f32[1]) and trunc (bool[1]) on the device; cut =
// cut_factor(truncate), log_t = float32(log(truncate)); checked: the route
// is the overflow alone.  The geometry (f_sub, CTA rows of each pass, table
// widths, fat budgets and capacities) is the wrapper's.  work: the
// workspace.  Outputs as cand_plan's Plan; tally as tally.cuh.  Returns a
// cudaError_t as int.
extern "C" int tpuslam_cpd_plan(
    const float* mov, const float* mov_mask, const float* tgt, const float* tgt_mask, int m0,
    int n0, int m, int n, const float* sigma2, const float* constant,
    const unsigned char* trunc, float cut, float log_t, int checked, int f_sub,
    int cta_rows_n, int cta_rows_m, int width_m, int width_n, int budget_n, int budget_m,
    int cap_n, int cap_m, void* work, float* ty, float* tgt_p, float* mov_mask_p,
    float* tgt_mask_p, float* scalars, int* route, int* table_m, int* counts_n, int* table_n,
    int* counts_m, long long* rows_n, int* live_n, unsigned char* valid_n, long long* rows_m,
    int* live_m, unsigned char* valid_m, long long* read, int* tally, void* stream) {
  const int tn = n / kTile, tm = m / kTile;
  const bool f_ok = f_sub == 1 || f_sub == 2 || f_sub == 4 || f_sub == 8;
  if (n % kTile != 0 || m % kTile != 0 || tn < 2 || tm < 2 || m0 < 0 || m0 > m ||
      n0 < 0 || n0 > n || !f_ok || width_m < 1 || width_n < 1 || cap_n < 1 ||
      cap_n > tn || cap_m < 1 || cap_m > tm || (cta_rows_n != 64 && cta_rows_n != 128) ||
      (cta_rows_m != 64 && cta_rows_m != 128) || (kTile / f_sub) % cta_rows_n != 0 ||
      (kTile / f_sub) % cta_rows_m != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout l = layout(tn, tm, f_sub, cap_n, cap_m);
  auto at = [&](size_t off) { return static_cast<char*>(work) + off; };
  Params p{};
  p.mov = mov;
  p.mov_mask = mov_mask;
  p.tgt = tgt;
  p.tgt_mask = tgt_mask;
  p.m0 = m0;
  p.n0 = n0;
  p.m = m;
  p.n = n;
  p.tm = tm;
  p.tn = tn;
  p.f = f_sub;
  p.sub = kTile / f_sub;
  p.sigma2 = sigma2;
  p.constant = constant;
  p.trunc = trunc;
  p.cut = cut;
  p.log_t = log_t;
  p.checked = checked;
  p.cta_rows_n = cta_rows_n;
  p.cta_rows_m = cta_rows_m;
  p.ctas_n = n / cta_rows_n;
  p.ctas_m = m / cta_rows_m;
  p.width_m = width_m;
  p.width_n = width_n;
  p.budget_n = budget_n;
  p.budget_m = budget_m;
  p.cap_n = cap_n;
  p.cap_m = cap_m;
  p.bounds_n = reinterpret_cast<float4*>(at(l.bounds_n));
  p.bounds_m = reinterpret_cast<float4*>(at(l.bounds_m));
  p.count_n = reinterpret_cast<int*>(at(l.count_n));
  p.count_m = reinterpret_cast<int*>(at(l.count_m));
  p.ids_n = reinterpret_cast<int*>(at(l.ids_n));
  p.ids_m = reinterpret_cast<int*>(at(l.ids_m));
  p.arrival = reinterpret_cast<int*>(at(l.arrival));
  p.serve_n = reinterpret_cast<unsigned char*>(at(l.serve_n));
  p.serve_m = reinterpret_cast<unsigned char*>(at(l.serve_m));
  p.seg_n = reinterpret_cast<unsigned char*>(at(l.seg_n));
  p.seg_m = reinterpret_cast<unsigned char*>(at(l.seg_m));
  p.ty = ty;
  p.tgt_p = tgt_p;
  p.mov_mask_p = mov_mask_p;
  p.tgt_mask_p = tgt_mask_p;
  p.scalars = scalars;
  p.route = route;
  p.table_m = table_m;
  p.counts_n = counts_n;
  p.table_n = table_n;
  p.counts_m = counts_m;
  p.rows_n = rows_n;
  p.live_n = live_n;
  p.valid_n = valid_n;
  p.rows_m = rows_m;
  p.live_m = live_m;
  p.valid_m = valid_m;
  p.read = read;
  p.tally = tally;
  const auto st = static_cast<cudaStream_t>(stream);
  const long long sub_tiles = static_cast<long long>(tn + tm) * f_sub;
  const int g1 =
      std::max(grid_of(sub_tiles, kThreads / 32), grid_of(std::max(m, n), kThreads));
  plan_bounds_kernel<<<g1, kThreads, 0, st>>>(p);
  const long long g2 = static_cast<long long>((tm + kCols - 1) / kCols) *
                       ((static_cast<long long>(tn) * f_sub + kRows - 1) / kRows);
  if (g2 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  plan_pairs_kernel<<<static_cast<unsigned>(g2), dim3(kCols, kRows), 0, st>>>(p);
  const int g3 = std::max(grid_of(p.ctas_n + p.ctas_m, kThreads / 32),
                          grid_of(static_cast<long long>(cap_n + cap_m) * kTile, kThreads));
  plan_tables_kernel<<<g3, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
