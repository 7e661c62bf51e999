// Fused SQS edge step and top-K threshold, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of repro/kernels/sqs_fused.py:
//   sqs_fused_kernel      <- sqs_fused_call / _sqs_kernel + _select_n
//   topk_threshold_kernel <- topk_threshold_call / _topk_kernel, with the
//                            temperature softmax that repro.kernels.ops.sqs_topk
//                            computes in jnp before the call fused in, and
//                            the exact K-th largest where the TPU kernel
//                            brackets it by a 40-step float bisection.
//
// What bounds it on this card.  Per row the work is a few flops per vocab
// entry, so the floor is bytes: 4 B of logits read and 8 B of (b, mask)
// written per entry for sqs_fused, 4 B read for topk_threshold: 2.2 and
// 0.7 microseconds at the main path's 4 rows of 151936.  What a call costs
// in practice is the launch, a few passes over each block's slice (exp and
// IEEE division a value) and the dependent steps between them (block
// reductions, cluster barriers, the two bisections).
//
// Layout.  The TPU kernel keeps a whole f32 row (608 KB at V = 151936) in
// VMEM.  One SM's 227 KB cannot, so a row goes to one thread-block cluster
// of C blocks (grid (C, B), cluster (C, 1, 1); C from plan_cluster in
// kernels/sqs_fused.py, a function of Vp alone, so both kernels split a row
// the same way).  Block r of a cluster holds slice [r * L, min((r + 1) * L,
// Vp)) of the row in dynamic shared memory, one f32 and one flag byte an
// entry: the logits, overwritten in place by e = exp(x - m), then q, then
// (sqs_fused, on the support) ell * q / sm; the flags hold x >= m, then the
// support.  The row is read from device memory once; every later pass
// reads shared memory.  Blocks swap
// partial results through distributed shared memory: each block PUSHES its
// partials into a slot of every block of the cluster, then one cluster
// barrier, then each block folds all slots from its own shared memory.  The
// slots are double-buffered by an exchange parity, so one barrier per
// exchange suffices, and no block reads another's memory after the last
// barrier, so blocks may exit without a closing barrier.
//
// Sum order.  Float partials are summed per thread in slice order, then
// over the block (warp butterflies, warp partials by warp 0), then over
// the cluster in rank order.  The order differs from the plain twin's but
// is fixed, so results repeat from run to run; no float atomics anywhere.
// Both kernels compute q = e / s from the one function row_stats, so they
// see bit-identical q (K-SQS chains topk_threshold's lo into sqs_fused's
// q >= lo and then needs K == exact_k).
//
// Bisections with few barriers.  A bisection loop sets mid from [lo, hi] (the
// +-1 select: 40 steps of mid = 0.5f * (lo + hi), the reference's; the top-K
// search: one sweep of those, then the midpoint of the float32 bit patterns
// down to adjacent ones, see topk_threshold_kernel) and moves lo or hi by
// count(v >= mid) >= n.  Its midpoints form a fixed tree; one SWEEP computes
// the next 2^LEVELS - 1 of them exactly as the loop would, in order (each mid
// lies in its [lo, hi]), bins every value against them, and replays LEVELS
// steps from the bins' suffix counts: the same mids and the same decisions, so
// the same [lo, hi].  A sweep over the cluster costs one cluster barrier (the
// bins are exchanged).  A value's bin is estimated from the even grid the mids
// lie near and corrected against the mids; the bins most values fall in (below
// lo, below the first mid, above the last, at or above hi) are counted in
// registers, the rest through shared atomics.  Values below lo never count
// again and values at or above hi always do, so once the values in [lo, hi) fit
// a buffer of CAP they are COMPACTED into block 0, which finishes the remaining
// steps alone with count = (count >= hi) + (buffer values >= mid): one warp
// runs the loop itself over up to WARP_MAX values held in registers, block
// sweeps take more.  topk_threshold sweeps the cluster once and compacts at
// once in the usual row (more sweeps where many values crowd the K-th one, as
// at low temperature).  The select compacts its eligible keys at once when they
// fit (K-SQS: K of them; C-SQS: the support) and falls back to cluster sweeps
// when they do not (near-uniform rows with K = V); there the steps whose mid is
// at most the least eligible key, which count every key, are taken without a
// sweep.  The ties then go to the earliest indices, through an exclusive prefix
// over ranks of the ties per block and a block scan in the one block where the
// cut falls.  The K-SQS trim (of the ties at lo, the earliest kept up to
// exact_k) works the same way.
//
// Numerics mirror the Pallas kernel: IEEE division and expf, no FMA contraction
// (the file is built with --fmad=false and the rounding points are spelled with
// __fmul_rn/__fadd_rn), the select's bisection with f32 midpoints,
// earliest-index tie breaking, and e and q with subnormals flushed to 0 as
// XLA's are (ftz; the file is otherwise built without -ftz).  Only the order of the f32 sums (softmax
// denominator, retained mass) differs from the plain twin.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifndef NT
#define NT 1024
#endif
#define NWARP (NT / 32)
#define TILE (NT * 4)
#define SLICE_MAX 20480                       // entries of one block's slice
#define LOAD_TILES 5                          // float4 loads in flight per thread
#define CLUSTER_MAX 16
#define LEVELS 8                              // bisection steps per sweep
#define NTHR ((1 << LEVELS) - 1)              // midpoints per sweep
#define NBIN (NTHR + 3)                       // bins: < lo, between mids, >= hi
#define CAP 8192                              // compaction buffer (values)
#define WARP_MAX 256                          // buffers up to this: one-warp finish
#define SELECT_ITERS 40
#define NEG_V -2.0f   // ineligible marker of the select (keys lie in (-1, 1))
#define MAX_SMEM 232448
#define ERR_CLUSTER 1000   // the card cannot place one cluster of this shape
#define ERR_PLAN 1001      // cluster size or slice outside this file's limits

// One thread's partials for block_reduce: s summed, x, y, z and w maxed,
// i and j summed.
struct Part {
  float s, x, y, z, w;
  int i, j;
};

struct Red {
  Part p[NWARP];
  int i[NWARP + 1];
};

// What the other blocks of the cluster write into this block.
struct __align__(16) Box {
  float f[2][CLUSTER_MAX][4];   // [parity][rank] float partials
  int i[2][CLUSTER_MAX][4];     // [parity][rank] int partials
  int seg[CLUSTER_MAX][2];      // block 0 only: (offset, count) of each rank's
                                // values in its compaction buffer
  float v_lo, v_hi;             // the select's verdict, pushed by block 0
  int v_room;
  int v_tie[CLUSTER_MAX + 1];   // ties in [lo, hi) of lower ranks
};

struct Sweep {
  float thr[NTHR + 1];          // thr[1..NTHR]: the sweep's midpoints, in order
  int tot[NBIN];                // cluster-wide bin counts
  int excl[NBIN];               // bin counts of lower ranks
  int sfx[NBIN + 1];            // sfx[j] = sum of tot[j..]
  int ties[CLUSTER_MAX];
  int claimed;                  // compaction: values placed by this block
  float fin[2];                 // the one-warp finish's [lo, hi]
};

// A bisection's state, identical in every thread of the cluster.
struct Bis {
  float lo, hi;
  int cnt_lo, cnt_hi;           // count(v >= lo), count(v >= hi) (cluster sweeps)
  int lo_bin, hi_bin;           // their bins in the last cluster histogram
  int done;                     // steps taken
};

// Built with -DSQS_PROFILE (sqs_sweep.py does), block 0 of each row writes
// the SM clock, counted from the kernel's start, at these marks into info
// row [4 + mark] (info rows are then INFO_STRIDE ints): 0 slice loaded and
// max reduced, 1 first exchange, 2 exp pass, 3 second exchange, 4 q and
// support (sqs_fused) or q (topk_threshold), 5 rounding exchange; for the
// first three cluster sweeps s, 6 + 4s start, 7 + 4s mids, 8 + 4s bins,
// 9 + 4s barrier, 10 + 4s replay; 19 compaction written, 20 its barrier,
// 21 block 0's finish, 22 the select's verdict, 23 the end.
#ifdef SQS_PROFILE
#define INFO_STRIDE 32
#define PROF(c, k) \
  if ((c).prof && (c).rank == 0 && threadIdx.x == 0 && (k) < 28) \
    (c).prof[4 + (k)] = (int)(clock64() - (c).t0)
#else
#define INFO_STRIDE 4
#define PROF(c, k) ((void)0)
#endif

struct Ctx {
#ifdef SQS_PROFILE
  int* prof;
  long long t0;
#endif
  int rank, C, len, ph;         // ph: exchange parity
  int barriers, sweeps, nbuf, local_steps;   // what ran (written to info)
  float* xs;                    // the slice: logits, e, q, then ell * q / sm
  float* buf;                   // compaction buffer (used in block 0)
  int* hist;                    // [parity][rank][NBIN] bin counts
  uint8_t* fl;                  // flags of the slice: x >= m, then the support
  Red* red;
  Box* box;
  Sweep* sw;
};

__host__ __device__ constexpr size_t dyn_smem(int C, int L) {
  return (size_t)L * 4 + (size_t)CAP * 4 + (size_t)2 * C * NBIN * 4 + (size_t)L;
}

// ---------------------------------------------------------------- block level
__device__ __forceinline__ Part warp_reduce(Part p) {
  for (int o = 16; o > 0; o >>= 1) {
    p.s = __fadd_rn(p.s, __shfl_xor_sync(0xffffffffu, p.s, o));
    p.x = fmaxf(p.x, __shfl_xor_sync(0xffffffffu, p.x, o));
    p.y = fmaxf(p.y, __shfl_xor_sync(0xffffffffu, p.y, o));
    p.z = fmaxf(p.z, __shfl_xor_sync(0xffffffffu, p.z, o));
    p.w = fmaxf(p.w, __shfl_xor_sync(0xffffffffu, p.w, o));
    p.i += __shfl_xor_sync(0xffffffffu, p.i, o);
    p.j += __shfl_xor_sync(0xffffffffu, p.j, o);
  }
  return p;
}

// Block-wide reduction of every thread's partials; every thread gets the
// block's values.  The float sum takes a fixed order: warp butterflies,
// then warp 0 over the warp sums.
__device__ __forceinline__ Part block_reduce(Part p, Red& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  p = warp_reduce(p);
  __syncthreads();
  if (lane == 0) sh.p[warp] = p;
  __syncthreads();
  if (warp == 0) {
    Part q = lane < NWARP ? sh.p[lane] : Part{0.0f, -INFINITY, -INFINITY, -INFINITY, -INFINITY, 0, 0};
    q = warp_reduce(q);
    if (lane == 0) sh.p[0] = q;
  }
  __syncthreads();
  return sh.p[0];
}

__device__ __forceinline__ int block_count(int v, Red& sh) {
  return block_reduce(Part{0.0f, -INFINITY, -INFINITY, -INFINITY, -INFINITY, v, 0}, sh).i;
}

// Exclusive prefix sum of c over threads in thread order; *total gets the
// block's sum.  Thread t owns tile entries [4t, 4t + 4), so thread order is
// index order within a tile.
__device__ __forceinline__ int block_excl_scan(int c, Red& sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = c;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) sh.i[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < NWARP ? sh.i[lane] : 0;
    int incl = t;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane < NWARP) sh.i[lane] = incl - t;
    if (lane == NWARP - 1) sh.i[NWARP] = incl;
  }
  __syncthreads();
  *total = sh.i[NWARP];
  return sh.i[warp] + x - c;
}

// Sum of a[lo..hi) over bins (NBIN <= NT), returned to every thread.
__device__ __forceinline__ int bin_range_sum(const int* a, int lo, int hi, Red& sh) {
  const int t = threadIdx.x;
  return block_count(t >= lo && t < hi ? a[t] : 0, sh);
}

// hist[bin] += 1 for every lane with bin >= 0: one atomic for the warp when
// all its bins agree (values piled in one bin), else one a lane (spread
// values rarely collide).  Called by all 32 lanes.
__device__ __forceinline__ void hist_add(int* hist, int bin) {
  const unsigned act = __ballot_sync(0xffffffffu, bin >= 0);
  if (act == 0) return;
  const int lead = __ffs(act) - 1;
  const int b0 = __shfl_sync(0xffffffffu, bin, lead);
  if (__all_sync(0xffffffffu, bin < 0 || bin == b0)) {
    if ((int)(threadIdx.x & 31) == lead) atomicAdd(hist + b0, __popc(act));
  } else if (bin >= 0) {
    atomicAdd(hist + bin, 1);
  }
}

// sfx[j] = sum of tot[j..NBIN), sfx[NBIN] = 0.  Warp 0.
__device__ __forceinline__ void suffix_sums(const int* tot, int* sfx) {
  constexpr int PER = (NBIN + 31) / 32;
  const int lane = threadIdx.x & 31;
  int part = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = lane * PER + k;
    if (b < NBIN) part += tot[b];
  }
  int x = part;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, x, o);
    if (lane + o < 32) x += y;
  }
  int run = x - part;
#pragma unroll
  for (int k = PER - 1; k >= 0; --k) {
    const int b = lane * PER + k;
    if (b < NBIN) {
      run += tot[b];
      sfx[b] = run;
    }
  }
  if (lane == 0) sfx[NBIN] = 0;
}

// ------------------------------------------------------------- cluster level
__device__ __forceinline__ void csync(Ctx& c) {
  cg::this_cluster().sync();
  ++c.barriers;
}

// Push this block's partials (held by every thread) to slot [ph][rank] of
// every block, then one cluster barrier.  Returns the slot's parity.
__device__ int exchange(Ctx& c, float4 f, int4 i) {
  if ((int)threadIdx.x < c.C) {
    Box* dst = cg::this_cluster().map_shared_rank(c.box, (int)threadIdx.x);
    *reinterpret_cast<float4*>(dst->f[c.ph][c.rank]) = f;
    *reinterpret_cast<int4*>(dst->i[c.ph][c.rank]) = i;
  }
  csync(c);
  const int slot = c.ph;
  c.ph ^= 1;
  return slot;
}

__device__ __forceinline__ float fold_max(const Ctx& c, int slot, int k) {
  float v = c.box->f[slot][0][k];
  for (int r = 1; r < c.C; ++r) v = fmaxf(v, c.box->f[slot][r][k]);
  return v;
}

__device__ __forceinline__ float fold_sum(const Ctx& c, int slot, int k) {
  float v = c.box->f[slot][0][k];
  for (int r = 1; r < c.C; ++r) v = __fadd_rn(v, c.box->f[slot][r][k]);
  return v;
}

// Sum of int partial k over ranks [0, upto).
__device__ __forceinline__ int fold_count(const Ctx& c, int slot, int k, int upto) {
  int v = 0;
  for (int r = 0; r < upto; ++r) v += c.box->i[slot][r][k];
  return v;
}

// -------------------------------------------------------------- bisections
// The midpoint rule of a bisection, and where a value sits on the even grid
// over [lo, hi) that a sweep's midpoints lie near (in units of a grid step:
// place(v, lo, scale(lo, hi))).
//   FloatTree: the loop's float midpoint 0.5f * (lo + hi) (the +-1 select,
//     and the top-K search's first sweep).
//   BitTree: the midpoint of the float32 bit patterns of lo <= hi, both
//     non-negative, whose patterns order as their values do.  Steps on
//     integers end at adjacent patterns, so the search's lo is then a value
//     of the row exactly, however small (the top-K search's later steps).
struct FloatTree {
  static __device__ __forceinline__ float mid(float lo, float hi) {
    return __fmul_rn(0.5f, __fadd_rn(lo, hi));
  }
  static __device__ __forceinline__ float scale(float lo, float hi) {
    return __fdiv_rn((float)(NTHR + 1), __fsub_rn(hi, lo));
  }
  static __device__ __forceinline__ float place(float v, float lo, float scale) {
    return __fmul_rn(__fsub_rn(v, lo), scale);
  }
};

struct BitTree {
  static __device__ __forceinline__ float mid(float lo, float hi) {
    const unsigned a = __float_as_uint(lo);
    return __uint_as_float(a + ((__float_as_uint(hi) - a) >> 1));
  }
  static __device__ __forceinline__ float scale(float lo, float hi) {
    return __fdiv_rn((float)(NTHR + 1), __uint2float_rn(__float_as_uint(hi) - __float_as_uint(lo)));
  }
  static __device__ __forceinline__ float place(float v, float lo, float scale) {
    return __fmul_rn(__uint2float_rn(__float_as_uint(v) - __float_as_uint(lo)), scale);
  }
};

// Steps a BitTree bisection takes from [lo, hi) to adjacent patterns: each
// step leaves at most ceil(span / 2) patterns.
__device__ __forceinline__ int bit_steps(float lo, float hi) {
  const unsigned span = __float_as_uint(hi) - __float_as_uint(lo);
  return span > 1 ? 32 - __clz((int)(span - 1)) : 0;
}

// thr[1..NTHR] = the midpoints of the next LEVELS bisection steps from
// (lo, hi), in order: thr[2^(LEVELS-1)] is the next mid, and each node's
// mid is T::mid of the bounds on its path, as the loop computes it.  In a
// BitTree whose span runs out before LEVELS steps the deeper mids repeat
// their bounds; they stay in order, and such a step moves nothing.
template <class T>
__device__ __forceinline__ void fill_thresholds(float lo, float hi, float* thr) {
  const int j = threadIdx.x + 1;
  if (j > NTHR) return;
  int p = 1 << (LEVELS - 1), d = p >> 1;
  while (true) {
    const float mid = T::mid(lo, hi);
    if (j == p) {
      thr[j] = mid;
      return;
    }
    if (j > p) {
      lo = mid;
      p += d;
    } else {
      hi = mid;
      p -= d;
    }
    d >>= 1;
  }
}

// A sweep's bins: 0 below lo, NTHR + 2 at or above hi, else 1 + the
// number of mids <= v.  The mids lie within rounding of an even grid over
// [lo, hi] (of values, or of bit patterns), so a value's place is estimated
// from the grid and corrected against the mids themselves: the count is
// exact however far off the estimate is, and it takes one or two reads of
// the mids.
struct Bins {
  float lo, hi, first, last, scale;   // first, last: thr[1], thr[NTHR]
  const float* thr;
};

template <class T>
__device__ __forceinline__ Bins make_bins(float lo, float hi, const float* thr) {
  return Bins{lo, hi, thr[1], thr[NTHR], T::scale(lo, hi), thr};
}

template <class T>
__device__ __forceinline__ int inner_bin(float v, const Bins& g) {
  const float e = fminf(fmaxf(T::place(v, g.lo, g.scale), 0.0f), (float)NTHR);
  int pos = (int)e;
  while (pos < NTHR && g.thr[pos + 1] <= v) ++pos;
  while (pos > 0 && g.thr[pos] > v) --pos;
  return pos + 1;
}

// Per-thread counts of the bins most values fall in: below lo, in
// [lo, thr[1]), in [thr[NTHR], hi) and at or above hi, so only the values
// between the first and the last mid take an atomic.
struct Common {
  int below, first, last, top;
};

__device__ __forceinline__ void hist_common(int* hist, Common cm) {
  for (int o = 16; o > 0; o >>= 1) {
    cm.below += __shfl_xor_sync(0xffffffffu, cm.below, o);
    cm.first += __shfl_xor_sync(0xffffffffu, cm.first, o);
    cm.last += __shfl_xor_sync(0xffffffffu, cm.last, o);
    cm.top += __shfl_xor_sync(0xffffffffu, cm.top, o);
  }
  if ((threadIdx.x & 31) == 0) {
    if (cm.below) atomicAdd(hist + 0, cm.below);
    if (cm.first) atomicAdd(hist + 1, cm.first);
    if (cm.last) atomicAdd(hist + NTHR + 1, cm.last);
    if (cm.top) atomicAdd(hist + NTHR + 2, cm.top);
  }
}

// Replay `steps` loop steps from the suffix counts: count(v >= thr[p]) =
// sfx[p + 1] + above + (n_floor values equal to floor_v, counted when
// mid <= floor_v).
__device__ __forceinline__ void replay(Bis& b, int steps, const float* thr, const int* sfx,
                                       int n, int above, float floor_v, int n_floor) {
  int p = 1 << (LEVELS - 1), d = p >> 1;
  for (int s = 0; s < steps; ++s) {
    const float mid = thr[p];
    const int cnt = sfx[p + 1] + above + (mid <= floor_v ? n_floor : 0);
    if (cnt >= n) {
      b.lo = mid;
      b.cnt_lo = cnt;
      b.lo_bin = p + 1;
      p += d;
    } else {
      b.hi = mid;
      b.cnt_hi = cnt;
      b.hi_bin = p + 1;
      p -= d;
    }
    d >>= 1;
  }
  b.done += steps;
}

// Bins four values (ok: they exist) into `hist`: the common bins are
// counted per thread (Common), the others through shared atomics, taken
// only when some lane of the warp has one: one for the warp when all its
// bins agree (values piled in one bin), else one a value (spread values
// rarely collide).  Called by all 32 lanes.
template <class T>
__device__ __forceinline__ void bin4(int* hist, bool ok, float4 v4, const Bins& g, Common& cm) {
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  int bin[4] = {-1, -1, -1, -1};
  int first = -1, cnt = 0;
  if (ok) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] < g.lo) {
        ++cm.below;
      } else if (v[j] >= g.hi) {
        ++cm.top;
      } else if (v[j] < g.first) {
        ++cm.first;
      } else if (v[j] >= g.last) {
        ++cm.last;
      } else {
        bin[j] = inner_bin<T>(v[j], g);
        if (first < 0) first = bin[j];
        ++cnt;
      }
    }
  }
  const unsigned act = __ballot_sync(0xffffffffu, cnt > 0);
  if (act == 0) return;
  const int lead = __ffs(act) - 1;
  const int b0 = __shfl_sync(0xffffffffu, first, lead);
  bool same = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) same &= bin[j] < 0 || bin[j] == b0;
  if (__all_sync(0xffffffffu, same)) {
    const int tot = __reduce_add_sync(0xffffffffu, cnt);
    if ((int)(threadIdx.x & 31) == lead) atomicAdd(hist + b0, tot);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (bin[j] >= 0) atomicAdd(hist + bin[j], 1);
    }
  }
}

// One sweep of the whole cluster over the slices' values (val4(i): the four
// values at i): bins, exchange, replay of `steps` <= LEVELS steps.  One
// cluster barrier.
template <class T, class V4>
__device__ void cluster_sweep(Ctx& c, Bis& b, int steps, int n, V4 val4) {
  Sweep& sw = *c.sw;
  int* own = c.hist + (c.ph * c.C + c.rank) * NBIN;
  __syncthreads();
  if (c.sweeps < 3) PROF(c, 6 + 4 * c.sweeps);
  fill_thresholds<T>(b.lo, b.hi, sw.thr);
  for (int k = threadIdx.x; k < NBIN; k += NT) own[k] = 0;
  __syncthreads();
  if (c.sweeps < 3) PROF(c, 7 + 4 * c.sweeps);
  const Bins g = make_bins<T>(b.lo, b.hi, sw.thr);
  Common cm = {0, 0, 0, 0};
  for (int base = 0; base < c.len; base += TILE) {
    const int i = base + threadIdx.x * 4;
    const bool ok = i < c.len;
    bin4<T>(own, ok, ok ? val4(i) : make_float4(0.f, 0.f, 0.f, 0.f), g, cm);
  }
  hist_common(own, cm);
  __syncthreads();
  if (c.sweeps < 3) PROF(c, 8 + 4 * c.sweeps);
  for (int k = threadIdx.x; k < NBIN * c.C; k += NT) {
    const int r = k / NBIN, bin = k - r * NBIN;
    if (r != c.rank) cg::this_cluster().map_shared_rank(own, r)[bin] = own[bin];
  }
  csync(c);
  if (c.sweeps < 3) PROF(c, 9 + 4 * c.sweeps);
  if (threadIdx.x < NBIN) {
    int t = 0, e = 0;
    for (int r = 0; r < c.C; ++r) {
      const int v = c.hist[(c.ph * c.C + r) * NBIN + threadIdx.x];
      t += v;
      if (r < c.rank) e += v;
    }
    sw.tot[threadIdx.x] = t;
    sw.excl[threadIdx.x] = e;
  }
  c.ph ^= 1;
  __syncthreads();
  if (threadIdx.x < 32) suffix_sums(sw.tot, sw.sfx);
  __syncthreads();
  b.cnt_lo = sw.sfx[1];
  b.cnt_hi = sw.sfx[NTHR + 2];
  b.lo_bin = 1;
  b.hi_bin = NTHR + 2;
  replay(b, steps, sw.thr, sw.sfx, n, 0, 0.0f, 0);
  if (c.sweeps < 3) PROF(c, 10 + 4 * c.sweeps);
  ++c.sweeps;
}

// Copy the slice's values with keep(v) into block 0's buffer, this block's
// at [off0, off0 + count), and record (off0, count) in block 0's Box; one
// pass (warps claim their places with one shared atomic each) and one
// cluster barrier.  Only counts are ever taken from the buffer, so the
// order inside a block's segment does not matter.
template <class V4, class P>
__device__ void compact(Ctx& c, V4 val4, P keep, int off0) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) c.sw->claimed = 0;
  __syncthreads();
  float* dst = cg::this_cluster().map_shared_rank(c.buf, 0);
  for (int base = 0; base < c.len; base += TILE) {
    const int i = base + threadIdx.x * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    int kb = 0;
    if (i < c.len) {
      const float4 v4 = val4(i);
      v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) kb |= keep(v[j]) << j;
    }
    if (__any_sync(0xffffffffu, kb != 0)) {
      const int nk = __popc(kb);
      int x = nk;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      int wbase = lane == 31 ? atomicAdd(&c.sw->claimed, x) : 0;
      wbase = __shfl_sync(0xffffffffu, wbase, 31);
      int o = off0 + wbase + x - nk;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kb >> j & 1) dst[o++] = v[j];
      }
    }
  }
  __syncthreads();
  PROF(c, 19);
  if (threadIdx.x == 0) {
    int* s = cg::this_cluster().map_shared_rank(&c.box->seg[c.rank][0], 0);
    s[0] = off0;
    s[1] = c.sw->claimed;
  }
  csync(c);
  PROF(c, 20);
}

// Block 0 alone, one warp: the loop itself over a buffer of nb <= 32 * R
// values held in registers, one ballot per 32 values and step.
template <class T, int R>
__device__ void warp_finish(Ctx& c, Bis& b, int iters, int n, int nb, int above, float floor_v,
                            int n_floor) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * 32 + lane;
      v[r] = i < nb ? c.buf[i] : -INFINITY;   // -inf >= mid never holds
    }
    float lo = b.lo, hi = b.hi;
    for (int s = b.done; s < iters; ++s) {
      const float mid = T::mid(lo, hi);
      int cnt = above + (mid <= floor_v ? n_floor : 0);
#pragma unroll
      for (int r = 0; r < R; ++r) cnt += __popc(__ballot_sync(0xffffffffu, v[r] >= mid));
      if (cnt >= n) lo = mid; else hi = mid;
    }
    if (lane == 0) {
      c.sw->fin[0] = lo;
      c.sw->fin[1] = hi;
    }
  }
  __syncthreads();
  b.lo = c.sw->fin[0];
  b.hi = c.sw->fin[1];
}

// Block 0 alone: the remaining steps over its buffer of nb values, `above`
// values >= hi kept out of it and n_floor values equal to floor_v kept out.
// Up to WARP_MAX values one warp runs the loop; more take block sweeps.
template <class T>
__device__ void local_finish(Ctx& c, Bis& b, int iters, int n, int nb, int above,
                             float floor_v, int n_floor) {
  Sweep& sw = *c.sw;
  c.nbuf = nb;
  if (b.done >= iters) return;
  c.local_steps = iters - b.done;
  if (nb <= 32) {
    warp_finish<T, 1>(c, b, iters, n, nb, above, floor_v, n_floor);
  } else if (nb <= 64) {
    warp_finish<T, 2>(c, b, iters, n, nb, above, floor_v, n_floor);
  } else if (nb <= 128) {
    warp_finish<T, 4>(c, b, iters, n, nb, above, floor_v, n_floor);
  } else if (nb <= WARP_MAX) {
    warp_finish<T, WARP_MAX / 32>(c, b, iters, n, nb, above, floor_v, n_floor);
  } else {
    while (b.done < iters) {
      __syncthreads();
      fill_thresholds<T>(b.lo, b.hi, sw.thr);
      for (int k = threadIdx.x; k < NBIN; k += NT) sw.tot[k] = 0;
      __syncthreads();
      const Bins g = make_bins<T>(b.lo, b.hi, sw.thr);
      Common cm = {0, 0, 0, 0};
      for (int base = 0; base < nb; base += TILE) {
        const int i = base + threadIdx.x * 4;
        float4 v4 = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        if (i < nb) v4 = *reinterpret_cast<const float4*>(c.buf + i);
        if (i + 3 >= nb) {               // the ragged end: past nb, below lo
          if (i + 1 >= nb) v4.y = -INFINITY;
          if (i + 2 >= nb) v4.z = -INFINITY;
          if (i + 3 >= nb) v4.w = -INFINITY;
        }
        bin4<T>(sw.tot, i < nb, v4, g, cm);
      }
      hist_common(sw.tot, cm);
      __syncthreads();
      if (threadIdx.x < 32) suffix_sums(sw.tot, sw.sfx);
      __syncthreads();
      replay(b, min(LEVELS, iters - b.done), sw.thr, sw.sfx, n, above, floor_v, n_floor);
    }
  }
  b.done = iters;
  PROF(c, 21);
}

// ------------------------------------------------------------ softmax rows

__device__ void setup(Ctx& c, Red& red, Box& box, Sweep& sw, int L, int Vp) {
  extern __shared__ __align__(16) unsigned char dsm[];
  c.rank = (int)cg::this_cluster().block_rank();
  c.C = (int)cg::this_cluster().num_blocks();
  c.len = min(L, Vp - c.rank * L);
  c.ph = 0;
  c.barriers = c.sweeps = c.local_steps = 0;
  c.nbuf = -1;
  c.xs = reinterpret_cast<float*>(dsm);
  c.buf = c.xs + L;
  c.hist = reinterpret_cast<int*>(c.buf + CAP);
  c.fl = reinterpret_cast<uint8_t*>(c.hist + 2 * c.C * NBIN);
  c.red = &red;
  c.box = &box;
  c.sw = &sw;
}

// A non-negative e or q with float32 subnormals set to 0, as XLA's CPU code
// and the TPU compute them (the twin's core.sqs.flush_subnormal): at low
// temperature they decide which value is the K-th largest.
__device__ __forceinline__ float ftz(float v) {
  return v < 1.17549435e-38f ? 0.0f : v;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uchar4 ldfl(const uint8_t* p) {
  return *reinterpret_cast<const uchar4*>(p);
}

// Load this block's slice of the row (from `slice`); m = the row's max of
// x = logits * it, s = sum e and emax = max e over e = exp(x - m), all
// cluster-wide.  Leaves e in xs and the flag x >= m (the argmax rule of
// C-SQS, which e alone cannot decide: expf of a tiny negative rounds to 1)
// in fl.  Shared by both kernels, so both see bit-identical probabilities
// q = e / s; max q = emax / s since IEEE division by s > 0 is monotone.
// Two cluster barriers.
__device__ void row_stats(Ctx& c, const float* slice, float it, float* m_out, float* s_out,
                          float* emax_out) {
  float mx = -INFINITY;
  for (int base = 0; base < c.len; base += LOAD_TILES * TILE) {
    float4 r[LOAD_TILES];
#pragma unroll
    for (int t = 0; t < LOAD_TILES; ++t) {
      const int i = base + t * TILE + threadIdx.x * 4;
      if (i < c.len) r[t] = __ldg(reinterpret_cast<const float4*>(slice + i));
    }
#pragma unroll
    for (int t = 0; t < LOAD_TILES; ++t) {
      const int i = base + t * TILE + threadIdx.x * 4;
      if (i < c.len) {
        *reinterpret_cast<float4*>(c.xs + i) = r[t];
        mx = fmaxf(mx, fmaxf(fmaxf(__fmul_rn(r[t].x, it), __fmul_rn(r[t].y, it)),
                             fmaxf(__fmul_rn(r[t].z, it), __fmul_rn(r[t].w, it))));
      }
    }
  }
  mx = block_reduce(Part{0.0f, mx, -INFINITY, -INFINITY, -INFINITY, 0, 0}, *c.red).x;
  PROF(c, 0);
  int slot = exchange(c, make_float4(mx, 0.f, 0.f, 0.f), make_int4(0, 0, 0, 0));
  PROF(c, 1);
  const float m = fold_max(c, slot, 0);
  float se = 0.0f, em = 0.0f;
  for (int base = 0; base < c.len; base += TILE) {
    const int i = base + threadIdx.x * 4;
    if (i < c.len) {
      const float4 x4 = lds4(c.xs + i);
      const float x[4] = {__fmul_rn(x4.x, it), __fmul_rn(x4.y, it), __fmul_rn(x4.z, it),
                          __fmul_rn(x4.w, it)};
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j] = ftz(expf(__fsub_rn(x[j], m)));
        se = __fadd_rn(se, e[j]);
        em = fmaxf(em, e[j]);
      }
      *reinterpret_cast<float4*>(c.xs + i) = make_float4(e[0], e[1], e[2], e[3]);
      *reinterpret_cast<uchar4*>(c.fl + i) = make_uchar4(x[0] >= m, x[1] >= m, x[2] >= m, x[3] >= m);
    }
  }
  const Part p = block_reduce(Part{se, em, -INFINITY, -INFINITY, -INFINITY, 0, 0}, *c.red);
  PROF(c, 2);
  slot = exchange(c, make_float4(p.s, p.x, 0.f, 0.f), make_int4(0, 0, 0, 0));
  PROF(c, 3);
  *m_out = m;
  *s_out = fold_sum(c, slot, 0);
  *emax_out = fold_max(c, slot, 1);
}

__device__ __forceinline__ void write_info(int* info, size_t row, const Ctx& c) {
  if (info != nullptr && c.rank == 0 && threadIdx.x == 0)
    *reinterpret_cast<int4*>(info + row * INFO_STRIDE) =
        make_int4(c.barriers, c.sweeps, c.nbuf, c.local_steps);
}

// K-SQS trim: keep every flagged entry with q >= hi, and of the flagged
// entries below hi (the ties at lo) the first `limit` in index order, given
// `before` such ties in lower ranks and `mine` in this block (block-uniform).
// xs holds q.
__device__ void trim_ties(Ctx& c, int before, int mine, int limit, float hi) {
  if (before + mine <= limit) return;
  const bool none = before >= limit;   // this block keeps none of its ties
  int carry = before;
  for (int base = 0; base < c.len; base += TILE) {
    const int i = base + threadIdx.x * 4;
    const bool act = i < c.len;
    uchar4 f = make_uchar4(0, 0, 0, 0);
    float4 q4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (act) {
      f = ldfl(c.fl + i);
      q4 = lds4(c.xs + i);
    }
    const int t0 = f.x && !(q4.x >= hi), t1 = f.y && !(q4.y >= hi);
    const int t2 = f.z && !(q4.z >= hi), t3 = f.w && !(q4.w >= hi);
    int run = carry, total = 0;
    if (!none) run += block_excl_scan(t0 + t1 + t2 + t3, *c.red, &total);
    if (act) {
      if (t0) f.x = !none && (++run) <= limit;
      if (t1) f.y = !none && (++run) <= limit;
      if (t2) f.z = !none && (++run) <= limit;
      if (t3) f.w = !none && (++run) <= limit;
      *reinterpret_cast<uchar4*>(c.fl + i) = f;
    }
    carry += total;
  }
  __syncthreads();
}

// Lattice rounding of one support entry from lq = ell * q~ (q~ = q / sm):
// b = floor(lq + 0.5) and zeta = b - lq.
__device__ __forceinline__ float round_b(float lq, float* zeta) {
  const float bf = floorf(__fadd_rn(lq, 0.5f));
  *zeta = __fsub_rn(bf, lq);
  return bf;
}

// The select's keys of four entries from their lq: zeta (dec) or -zeta
// (inc) on the eligible entries (the support, and b > 0 for dec), NEG_V
// elsewhere.
__device__ __forceinline__ float4 sel_keys(float4 lq, uchar4 f, bool dec) {
  const float lv[4] = {lq.x, lq.y, lq.z, lq.w};
  const int fv[4] = {f.x, f.y, f.z, f.w};
  float k[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    k[j] = NEG_V;
    if (fv[j]) {
      float z;
      const float bf = round_b(lv[j], &z);
      if (!dec) k[j] = -z;
      else if (bf > 0.0f) k[j] = z;
    }
  }
  return make_float4(k[0], k[1], k[2], k[3]);
}

// Block 0, after its finish: count(eligible >= hi) and the ties in [lo, hi)
// of each rank from its buffer (segments in rank order), and push
// [lo, hi, room, tie prefix] to every block.  The caller's cluster barrier
// follows.
__device__ void push_verdict(Ctx& c, const Bis& b, int n, int nb, int above) {
  Sweep& sw = *c.sw;
  __syncthreads();
  if (threadIdx.x < CLUSTER_MAX) sw.ties[threadIdx.x] = 0;
  __syncthreads();
  int chi = 0;
  for (int base = 0; base < nb; base += NT) {
    const int i = base + threadIdx.x;
    int r = -1;
    if (i < nb) {
      const float v = c.buf[i];
      if (v != NEG_V) {
        if (v >= b.hi) {
          ++chi;
        } else if (v >= b.lo) {
          r = 0;
          while (i >= c.box->seg[r][0] + c.box->seg[r][1]) ++r;
        }
      }
    }
    hist_add(sw.ties, r);
  }
  chi = above + block_count(chi, *c.red);
  if ((int)threadIdx.x < c.C) {
    Box* dst = cg::this_cluster().map_shared_rank(c.box, (int)threadIdx.x);
    dst->v_lo = b.lo;
    dst->v_hi = b.hi;
    dst->v_room = n - chi;
    int acc = 0;
    for (int r = 0; r < c.C; ++r) {
      dst->v_tie[r] = acc;
      acc += sw.ties[r];
    }
    dst->v_tie[c.C] = acc;
  }
}

// --------------------------------------------------------------- kernels
// One cluster per row.  b_out gets the lattice counts with sum == ell
// exactly, mask_out the support, stats [dropped, K, sum_b_raw, max_logit];
// info (optional) [cluster barriers, cluster sweeps, buffer size or -1,
// steps finished in block 0].
__global__ void __launch_bounds__(NT, 1)
sqs_fused_kernel(const float* __restrict__ logits, const float* __restrict__ beta,
                 int* __restrict__ b_out, int* __restrict__ mask_out,
                 float* __restrict__ stats, int* __restrict__ info, int V, int Vp, int L,
                 float it, int ell, int exact_k) {
  __shared__ Red red;
  __shared__ Box box;
  __shared__ Sweep sw;
  Ctx c;
  setup(c, red, box, sw, L, Vp);
  const size_t row = blockIdx.y;
#ifdef SQS_PROFILE
  c.prof = info ? info + row * INFO_STRIDE : nullptr;
  c.t0 = clock64();
#endif
  const size_t off = row * Vp + (size_t)c.rank * L;
  const float ellf = (float)ell;
  const float thr = beta[row * 2], thr_hi = beta[row * 2 + 1];

  float m, s, emax;
  row_stats(c, logits + off, it, &m, &s, &emax);

  // support: C-SQS q >= beta plus every maximum, of the V true tokens (a
  // padded lane has q = 0, which beta <= 0 would keep); K-SQS every q >= hi
  // and the ties in [lo, hi), trimmed to exact_k by index (lax.top_k's set,
  // which never reaches a padded lane: V >= K).
  float smp = 0.0f;
  int kp = 0, ap = 0;
  for (int base = 0; base < c.len; base += TILE) {
    const int i = base + threadIdx.x * 4;
    if (i < c.len) {
      const float4 e4 = lds4(c.xs + i);
      const uchar4 a4 = ldfl(c.fl + i);
      const float e[4] = {e4.x, e4.y, e4.z, e4.w};
      const int am[4] = {a4.x, a4.y, a4.z, a4.w};
      float q[4];
      int f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j] = ftz(__fdiv_rn(e[j], s));
        f[j] = exact_k > 0 ? (q[j] >= thr)
                           : (((q[j] >= thr) || am[j]) && c.rank * L + i + j < V);
        if (f[j]) {
          smp = __fadd_rn(smp, q[j]);
          ++kp;
          ap += exact_k > 0 && q[j] >= thr_hi;
        }
      }
      *reinterpret_cast<float4*>(c.xs + i) = make_float4(q[0], q[1], q[2], q[3]);
      *reinterpret_cast<uchar4*>(c.fl + i) = make_uchar4(f[0], f[1], f[2], f[3]);
    }
  }
  Part p = block_reduce(Part{smp, -INFINITY, -INFINITY, -INFINITY, -INFINITY, kp, ap}, red);
  kp = p.i;
  ap = p.j;
  int slot = exchange(c, make_float4(p.s, 0.f, 0.f, 0.f), make_int4(kp, ap, 0, 0));
  int K = fold_count(c, slot, 0, c.C);
  if (exact_k > 0 && K > exact_k) {
    trim_ties(c, fold_count(c, slot, 0, c.rank) - fold_count(c, slot, 1, c.rank), kp - ap,
              exact_k - fold_count(c, slot, 1, c.C), thr_hi);
    smp = 0.0f;
    kp = 0;
    for (int base = 0; base < c.len; base += TILE) {
      const int i = base + threadIdx.x * 4;
      if (i < c.len) {
        const float4 q4 = lds4(c.xs + i);
        const uchar4 f4 = ldfl(c.fl + i);
        const float q[4] = {q4.x, q4.y, q4.z, q4.w};
        const int f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (f[j]) {
            smp = __fadd_rn(smp, q[j]);
            ++kp;
          }
        }
      }
    }
    p = block_reduce(Part{smp, -INFINITY, -INFINITY, -INFINITY, -INFINITY, kp, 0}, red);
    kp = p.i;
    slot = exchange(c, make_float4(p.s, 0.f, 0.f, 0.f), make_int4(kp, 0, 0, 0));
    K = fold_count(c, slot, 0, c.C);
  }
  const float sm = fold_sum(c, slot, 0);
  PROF(c, 4);

  // lattice rounding b = floor(ell * q / sm + 0.5) on the support, with
  // what either direction of the +-1 fix needs: the largest key and the
  // eligible count per rank.  lq = ell * q / sm replaces q in xs on the
  // support, so the later passes round without dividing again.
  int sbp = 0, ndp = 0;
  float vdec = NEG_V, vinc = NEG_V, ndec = -INFINITY, ninc = -INFINITY;   // n*: -(least key)
  for (int base = 0; base < c.len; base += TILE) {
    const int i = base + threadIdx.x * 4;
    if (i < c.len) {
      const float4 q4 = lds4(c.xs + i);
      const uchar4 f4 = ldfl(c.fl + i);
      float q[4] = {q4.x, q4.y, q4.z, q4.w};
      const int f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (f[j]) {
          q[j] = __fmul_rn(ellf, __fdiv_rn(q[j], sm));
          float z;
          const float bf = round_b(q[j], &z);
          sbp += (int)bf;
          vinc = fmaxf(vinc, -z);
          ninc = fmaxf(ninc, z);
          if (bf > 0.0f) {
            ++ndp;
            vdec = fmaxf(vdec, z);
            ndec = fmaxf(ndec, -z);
          }
        }
      }
      if (f[0] | f[1] | f[2] | f[3])
        *reinterpret_cast<float4*>(c.xs + i) = make_float4(q[0], q[1], q[2], q[3]);
    }
  }
  p = block_reduce(Part{0.0f, vdec, vinc, ndec, ninc, sbp, ndp}, red);
  slot = exchange(c, make_float4(p.x, p.y, p.z, p.w), make_int4(p.i, p.j, kp, 0));
  const int sum_b = fold_count(c, slot, 0, c.C);
  PROF(c, 5);
  const int delta = sum_b - ell;

  // Algorithm 2 exact-sum fix: delta > 0 decrements the delta largest-zeta
  // entries with b > 0; delta < 0 increments the |delta| smallest-zeta
  // entries; ties to the earliest index.
  const bool dec = delta > 0;
  const int n = dec ? delta : -delta;
  float lo = 0.0f, hi = 0.0f;
  int room = 0, t0 = 0, t1 = 0;
  if (delta != 0) {
    const int ke = dec ? 1 : 2;
    const int n_elig = fold_count(c, slot, ke, c.C);
    Bis b = {NEG_V, __fadd_rn(fold_max(c, slot, dec ? 0 : 1), 1e-6f), 0, 0, 0, 0, 0};
    auto keys = [&](int i) { return sel_keys(lds4(c.xs + i), ldfl(c.fl + i), dec); };
    bool verdict = false;
    if (n_elig <= CAP) {
      compact(c, keys, [](float v) { return v != NEG_V; }, fold_count(c, slot, ke, c.rank));
      if (c.rank == 0) {
        local_finish<FloatTree>(c, b, SELECT_ITERS, n, n_elig, 0, NEG_V, Vp - n_elig);
        push_verdict(c, b, n, n_elig, 0);
      }
      csync(c);
      verdict = true;
    } else {
      // steps whose mid is at most the least eligible key count every
      // eligible key (and the ineligible ones at NEG_V where mid <= NEG_V):
      // they need no sweep.  At least one step is left to a sweep, whose
      // histogram the ties are read from if no compaction follows.
      const float kmin = -fold_max(c, slot, dec ? 2 : 3);
      while (b.done < SELECT_ITERS - 1) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(b.lo, b.hi));
        if (!(mid <= kmin) || n_elig + (mid <= NEG_V ? Vp - n_elig : 0) < n) break;
        b.lo = mid;
        ++b.done;
      }
      while (b.done < SELECT_ITERS) {
        cluster_sweep<FloatTree>(c, b, min(LEVELS, SELECT_ITERS - b.done), n, keys);
        if (b.done < SELECT_ITERS && b.cnt_lo - b.cnt_hi <= CAP) {
          const float clo = b.lo, chi = b.hi;
          const int nb = b.cnt_lo - b.cnt_hi, above = b.cnt_hi;
          compact(c, keys, [=](float v) { return !(v < clo) && !(v >= chi); },
                  bin_range_sum(sw.excl, b.lo_bin, b.hi_bin, red));
          if (c.rank == 0) {
            local_finish<FloatTree>(c, b, SELECT_ITERS, n, nb, above, 0.0f, 0);
            push_verdict(c, b, n, nb, above);
          }
          csync(c);
          verdict = true;
          break;
        }
      }
    }
    if (verdict) {
      lo = box.v_lo;
      hi = box.v_hi;
      room = box.v_room;
      t0 = box.v_tie[c.rank];
      t1 = box.v_tie[c.rank + 1];
    } else {
      // every step ran over the cluster: the ties are the values in bins
      // [lo_bin, hi_bin) of the last histogram
      const int* own = c.hist + ((c.ph ^ 1) * c.C + c.rank) * NBIN;
      lo = b.lo;
      hi = b.hi;
      room = n - b.cnt_hi;
      t0 = bin_range_sum(sw.excl, b.lo_bin, b.hi_bin, red);
      t1 = t0 + bin_range_sum(own, b.lo_bin, b.hi_bin, red);
    }
  }
  PROF(c, 22);

  // final pass: b with the +-1 fix, ties to the earliest index (a block
  // scan only in the block where the cut falls), and the support.
  const bool scan = delta != 0 && t0 < room && t1 > room;
  const bool take_all = t1 <= room;
  const int d = dec ? -1 : 1;
  int carry = t0;
  int* brow = b_out + off;
  int* mrow = mask_out + off;
  for (int base = 0; base < c.len; base += TILE) {
    const int i = base + threadIdx.x * 4;
    const bool act = i < c.len;
    int bb[4] = {0, 0, 0, 0}, mk[4] = {0, 0, 0, 0}, sel[4] = {0, 0, 0, 0}, tie[4] = {0, 0, 0, 0};
    if (act) {
      const float4 l4 = lds4(c.xs + i);
      const uchar4 f4 = ldfl(c.fl + i);
      const float lq[4] = {l4.x, l4.y, l4.z, l4.w};
      mk[0] = f4.x; mk[1] = f4.y; mk[2] = f4.z; mk[3] = f4.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mk[j]) {
          float z;
          bb[j] = (int)round_b(lq[j], &z);
          if (delta != 0 && (!dec || bb[j] > 0)) {
            const float v = dec ? z : -z;
            sel[j] = v >= hi;
            tie[j] = !sel[j] && v >= lo;
          }
        }
      }
    }
    if (scan) {
      int total;
      int run = carry + block_excl_scan(tie[0] + tie[1] + tie[2] + tie[3], red, &total);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tie[j]) sel[j] = (++run) <= room;
      }
      carry += total;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tie[j]) sel[j] = take_all;
      }
    }
    if (act) {
      *reinterpret_cast<int4*>(brow + i) =
          make_int4(bb[0] + d * sel[0], bb[1] + d * sel[1], bb[2] + d * sel[2], bb[3] + d * sel[3]);
      *reinterpret_cast<int4*>(mrow + i) = make_int4(mk[0], mk[1], mk[2], mk[3]);
    }
  }
  if (c.rank == 0 && threadIdx.x == 0) {
    stats[row * 4 + 0] = __fsub_rn(1.0f, sm);
    stats[row * 4 + 1] = (float)K;
    stats[row * 4 + 2] = (float)sum_b;
    stats[row * 4 + 3] = m;
  }
  PROF(c, 23);
  write_info(info, row, c);
}

// One cluster per row: [lo, hi] with lo the exact K-th largest probability
// (0 where it underflows) and hi the float32 after it, so count(q >= lo) >= K
// and count(q >= hi) < K.  The search starts from [0, the float after max q]
// (valid for 1 <= K <= Vp), narrows it by one cluster sweep of the float
// loop's midpoints (LEVELS steps: in the usual row a bracket max q / 256
// wide around the K-th value, holding few values, which compact at once),
// and bisects the bit patterns of what is left down to adjacent ones: at
// most 23 steps when that bracket lies above 0, 30 from 0.  The reference's
// 40-step float loop cannot go below max q * 2^-40, so where (x_max - x_K)
// / T exceeds 40 ln 2 its lo stays 0 (ROADMAP Queue 3 item 12); this
// search has no such floor.  info (optional) as for sqs_fused_kernel.
__global__ void __launch_bounds__(NT, 1)
topk_threshold_kernel(const float* __restrict__ logits, float* __restrict__ tau,
                      int* __restrict__ info, int Vp, int L, float it, int K) {
  __shared__ Red red;
  __shared__ Box box;
  __shared__ Sweep sw;
  Ctx c;
  setup(c, red, box, sw, L, Vp);
  const size_t row = blockIdx.y;
#ifdef SQS_PROFILE
  c.prof = info ? info + row * INFO_STRIDE : nullptr;
  c.t0 = clock64();
#endif
  float m, s, emax;
  row_stats(c, logits + row * Vp + (size_t)c.rank * L, it, &m, &s, &emax);
  PROF(c, 4);
  Bis b = {0.0f, __uint_as_float(__float_as_uint(__fdiv_rn(emax, s)) + 1u), 0, 0, 0, 0, 0};
  // the first sweep turns e into q = e / s as it reads it
  bool first = true;
  auto q = [&](int i) {
    float4 v = lds4(c.xs + i);
    if (first) {
      v = make_float4(ftz(__fdiv_rn(v.x, s)), ftz(__fdiv_rn(v.y, s)), ftz(__fdiv_rn(v.z, s)),
                      ftz(__fdiv_rn(v.w, s)));
      *reinterpret_cast<float4*>(c.xs + i) = v;
    }
    return v;
  };
  cluster_sweep<FloatTree>(c, b, LEVELS, K, q);
  first = false;
  const int steps = bit_steps(b.lo, b.hi);
  b.done = 0;
  while (b.done < steps) {
    if (b.cnt_lo - b.cnt_hi <= CAP) {
      const float clo = b.lo, chi = b.hi;
      const int nb = b.cnt_lo - b.cnt_hi, above = b.cnt_hi;
      compact(c, q, [=](float v) { return !(v < clo) && !(v >= chi); },
              bin_range_sum(sw.excl, b.lo_bin, b.hi_bin, red));
      if (c.rank == 0) local_finish<BitTree>(c, b, steps, K, nb, above, 0.0f, 0);
      break;
    }
    cluster_sweep<BitTree>(c, b, min(LEVELS, steps - b.done), K, q);
  }
  if (c.rank == 0 && threadIdx.x == 0) {
    tau[row * 2 + 0] = b.lo;
    tau[row * 2 + 1] = b.hi;
  }
  PROF(c, 23);
  write_info(info, row, c);
}

// ---------------------------------------------------------------- launch
// Grid (C, B) in clusters of (C, 1, 1).  The kernel's attributes are set,
// and the card asked whether one cluster of this shape can be placed, once
// per cluster size and shared-memory size (before any graph capture: the
// wrappers' callers warm up first).
template <typename... A, typename... P>
static int launch_cluster(void (*kern)(A...), int C, int L, int B, cudaStream_t stream,
                          P... args) {
  if (C < 1 || C > CLUSTER_MAX || L < 128 || L > SLICE_MAX || L % 128) return ERR_PLAN;
  static size_t max_dyn = 0;
  static size_t placed[CLUSTER_MAX + 1] = {0};
  if (max_dyn == 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    const size_t dyn = MAX_SMEM - fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    max_dyn = dyn;
  }
  const size_t smem = dyn_smem(C, L);
  if (smem > max_dyn) return ERR_PLAN;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (placed[C] < smem) {
    int n = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return ERR_CLUSTER;
    placed[C] = smem;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int sqs_fused_launch(const float* logits, const float* beta, int* b_out,
                                int* mask_out, float* stats, int* info, int B, int V, int Vp,
                                int C, int L, float inv_temp, int ell, int exact_k,
                                void* stream) {
  return launch_cluster(sqs_fused_kernel, C, L, B, (cudaStream_t)stream, logits, beta, b_out,
                        mask_out, stats, info, V, Vp, L, inv_temp, ell, exact_k);
}

extern "C" int topk_threshold_launch(const float* logits, float* tau, int* info, int B, int Vp,
                                     int C, int L, float inv_temp, int K, void* stream) {
  return launch_cluster(topk_threshold_kernel, C, L, B, (cudaStream_t)stream, logits, tau, info,
                        Vp, L, inv_temp, K);
}
