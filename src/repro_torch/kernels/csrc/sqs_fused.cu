// Fused SQS edge step and top-K threshold, hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of repro/kernels/sqs_fused.py:
//   sqs_fused_kernel      <- sqs_fused_call / _sqs_kernel + _select_n
//   topk_threshold_kernel <- topk_threshold_call / _topk_kernel, with the
//                            temperature softmax that repro.kernels.ops.sqs_topk
//                            computes in jnp before the call fused in.
//
// What bounds it on this card.  Per row the work is a few flops per vocab
// entry, so the floor is bytes: 4 B of logits read and 8 B of (b, mask)
// written per entry for sqs_fused, 4 B read for topk_threshold.  The TPU
// design keeps the whole f32 row in VMEM; at V = 151936 a row is 608 KB,
// more than an SM's 227 KB of shared memory.  So one thread block owns one
// row and sweeps it several times: the row (and the per-row scratch below)
// stays in the 50 MB L2 between sweeps, and only the first read comes from
// device memory.  What this costs: the two 40-step bisections (the top-K
// threshold, and the Algorithm-2 +-1 correction's select) are 40 sweeps of
// an L2-resident row by ONE SM each, so at B = 4 rows only 4 of 132 SMs
// work and the kernel sits far above the device-memory bound.  Splitting a
// row over a thread-block cluster (distributed shared memory) is the next
// step; this version is the simple one that is right.
//
// Numerics mirror the Pallas kernel: IEEE division and expf, no FMA
// contraction (the file is built with --fmad=false and the rounding points
// are spelled with __fmul_rn/__fadd_rn), 40-step bisections with f32
// midpoints, earliest-index tie breaking through a block-wide prefix scan
// carried across tiles in index order.  Only the order of the f32 sums
// (softmax denominator, retained mass) differs from the plain twin.
#include <cuda_runtime.h>
#include <math.h>

#define NT 1024
#define NWARP (NT / 32)
#define TILE (NT * 4)
#define BISECT_ITERS 40
#define NEG_V -2.0f   // ineligible marker of the select (values lie in [-0.5, 0.5])

struct Shared {
  float f[NWARP];
  int i[NWARP + 1];
};

__device__ __forceinline__ float block_max(float v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) sh.f[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NWARP ? sh.f[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) sh.f[0] = v;
  }
  __syncthreads();
  return sh.f[0];
}

__device__ __forceinline__ float block_sum(float v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) sh.f[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NWARP ? sh.f[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) sh.f[0] = v;
  }
  __syncthreads();
  return sh.f[0];
}

__device__ __forceinline__ int block_count(int v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) sh.i[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NWARP ? sh.i[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sh.i[0] = v;
  }
  __syncthreads();
  return sh.i[0];
}

// Exclusive prefix sum of c over threads in thread order; *total gets the
// block's sum.  Thread t owns tile elements [4t, 4t + 4), so thread order is
// index order within a tile.
__device__ __forceinline__ int block_excl_scan(int c, Shared& sh, int* total) {
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void as_array(float4 v, float* a) {
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

// Row max m of x = logits * inv_temp and s = sum exp(x - m).  Shared by both
// kernels, so both see bit-identical probabilities q = exp(x - m) / s.
__device__ void row_softmax_stats(const float* xrow, int Vp, float it, Shared& sh,
                                  float* m_out, float* s_out) {
  float mx = -INFINITY;
  for (int i = threadIdx.x * 4; i < Vp; i += TILE) {
    float a[4];
    as_array(ld4(xrow + i), a);
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, __fmul_rn(a[j], it));
  }
  const float m = block_max(mx, sh);
  float se = 0.0f;
  for (int i = threadIdx.x * 4; i < Vp; i += TILE) {
    float a[4];
    as_array(ld4(xrow + i), a);
#pragma unroll
    for (int j = 0; j < 4; ++j) se = __fadd_rn(se, expf(__fsub_rn(__fmul_rn(a[j], it), m)));
  }
  *m_out = m;
  *s_out = block_sum(se, sh);
}

__device__ __forceinline__ float prob(float logit, float it, float m, float s) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(logit, it), m)), s);
}

// One block per row.  b_out gets the lattice counts with sum == ell exactly,
// mask_out the support, stats [dropped, K, sum_b_raw, max_logit].  scratch
// (B, Vp) f32 holds the select's keys between the bisection sweeps.
__global__ void __launch_bounds__(NT)
sqs_fused_kernel(const float* __restrict__ logits, const float* __restrict__ beta,
                 int* __restrict__ b_out, int* __restrict__ mask_out,
                 float* __restrict__ stats, float* __restrict__ scratch, int Vp,
                 float it, int ell, int exact_k) {
  __shared__ Shared sh;
  const size_t row = blockIdx.x;
  const float* xrow = logits + row * Vp;
  int* brow = b_out + row * Vp;
  int* mrow = mask_out + row * Vp;
  float* vrow = scratch + row * Vp;
  const float ellf = (float)ell;
  const float thr = beta[row * 2];

  float m, s;
  row_softmax_stats(xrow, Vp, it, sh, &m, &s);

  // support: C-SQS q >= beta plus every maximum; K-SQS q >= lo, first
  // exact_k candidates by index (prefix count carried across tiles).
  float sm_part = 0.0f;
  int k_part = 0, carry = 0;
  for (int base = 0; base < Vp; base += TILE) {
    const int i = base + threadIdx.x * 4;
    const bool act = i < Vp;
    float q[4] = {0.f, 0.f, 0.f, 0.f};
    int mk[4] = {0, 0, 0, 0};
    if (act) {
      float a[4];
      as_array(ld4(xrow + i), a);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j] = prob(a[j], it, m, s);
        mk[j] = exact_k > 0 ? (q[j] >= thr) : ((q[j] >= thr) || (__fmul_rn(a[j], it) >= m));
      }
    }
    if (exact_k > 0) {
      int total;
      int run = carry + block_excl_scan(mk[0] + mk[1] + mk[2] + mk[3], sh, &total);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mk[j]) mk[j] = (++run) <= exact_k;
      }
      carry += total;
    }
    if (act) {
      *reinterpret_cast<int4*>(mrow + i) = make_int4(mk[0], mk[1], mk[2], mk[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mk[j]) {
          sm_part = __fadd_rn(sm_part, q[j]);
          ++k_part;
        }
      }
    }
  }
  const float sm = block_sum(sm_part, sh);
  const int K = block_count(k_part, sh);

  // lattice rounding b = floor(ell * q / sm + 0.5) on the support
  int sb_part = 0;
  for (int i = threadIdx.x * 4; i < Vp; i += TILE) {
    float a[4];
    as_array(ld4(xrow + i), a);
    const int4 mv = *reinterpret_cast<const int4*>(mrow + i);
    const int mk[4] = {mv.x, mv.y, mv.z, mv.w};
    int bb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bb[j] = 0;
      if (mk[j]) {
        const float qt = __fdiv_rn(prob(a[j], it, m, s), sm);
        bb[j] = (int)floorf(__fadd_rn(__fmul_rn(ellf, qt), 0.5f));
      }
      sb_part += bb[j];
    }
    *reinterpret_cast<int4*>(brow + i) = make_int4(bb[0], bb[1], bb[2], bb[3]);
  }
  const int sum_b = block_count(sb_part, sh);
  const int delta = sum_b - ell;

  if (delta != 0) {
    // Algorithm 2 exact-sum fix: delta > 0 decrements the delta largest-zeta
    // entries with b > 0; delta < 0 increments the |delta| smallest-zeta
    // entries.  Keys vv (ineligible = NEG_V) go to scratch for the sweeps.
    const bool dec = delta > 0;
    const int n = dec ? delta : -delta;
    float vmax = NEG_V;
    for (int i = threadIdx.x * 4; i < Vp; i += TILE) {
      float a[4];
      as_array(ld4(xrow + i), a);
      const int4 mv = *reinterpret_cast<const int4*>(mrow + i);
      const int4 bv = *reinterpret_cast<const int4*>(brow + i);
      const int mk[4] = {mv.x, mv.y, mv.z, mv.w};
      const int bb[4] = {bv.x, bv.y, bv.z, bv.w};
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = NEG_V;
        if (mk[j] && (!dec || bb[j] > 0)) {
          const float qt = __fdiv_rn(prob(a[j], it, m, s), sm);
          const float zeta = __fsub_rn((float)bb[j], __fmul_rn(ellf, qt));
          v[j] = dec ? zeta : -zeta;
        }
        vmax = fmaxf(vmax, v[j]);
      }
      *reinterpret_cast<float4*>(vrow + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
    float lo = NEG_V;
    float hi = __fadd_rn(block_max(vmax, sh), 1e-6f);
    const float nf = (float)n;
    for (int step = 0; step < BISECT_ITERS; ++step) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      int c = 0;
      for (int i = threadIdx.x * 4; i < Vp; i += TILE) {
        float v[4];
        as_array(*reinterpret_cast<const float4*>(vrow + i), v);
#pragma unroll
        for (int j = 0; j < 4; ++j) c += v[j] >= mid;
      }
      if ((float)block_count(c, sh) >= nf) lo = mid; else hi = mid;
    }
    int c_hi = 0;
    for (int i = threadIdx.x * 4; i < Vp; i += TILE) {
      float v[4];
      as_array(*reinterpret_cast<const float4*>(vrow + i), v);
#pragma unroll
      for (int j = 0; j < 4; ++j) c_hi += (v[j] >= hi) && (v[j] != NEG_V);
    }
    const int room = n - block_count(c_hi, sh);   // ties to take, earliest first
    carry = 0;
    for (int base = 0; base < Vp; base += TILE) {
      const int i = base + threadIdx.x * 4;
      const bool act = i < Vp;
      float v[4] = {NEG_V, NEG_V, NEG_V, NEG_V};
      if (act) as_array(*reinterpret_cast<const float4*>(vrow + i), v);
      int sel[4], tie[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool elig = v[j] != NEG_V;
        sel[j] = elig && v[j] >= hi;
        tie[j] = elig && !sel[j] && v[j] >= lo;
      }
      int total;
      int run = carry + block_excl_scan(tie[0] + tie[1] + tie[2] + tie[3], sh, &total);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tie[j]) sel[j] = (++run) <= room;
      }
      carry += total;
      if (act) {
        int4 bv = *reinterpret_cast<const int4*>(brow + i);
        const int d = dec ? -1 : 1;
        bv.x += d * sel[0];
        bv.y += d * sel[1];
        bv.z += d * sel[2];
        bv.w += d * sel[3];
        *reinterpret_cast<int4*>(brow + i) = bv;
      }
    }
  }
  if (threadIdx.x == 0) {
    stats[row * 4 + 0] = __fsub_rn(1.0f, sm);
    stats[row * 4 + 1] = (float)K;
    stats[row * 4 + 2] = (float)sum_b;
    stats[row * 4 + 3] = m;
  }
}

// One block per row: bracket [lo, hi] around the K-th largest probability,
// count(q >= lo) >= K and count(q >= hi) < K, by 40-step bisection.  The
// probabilities are written to scratch once and swept from L2.
__global__ void __launch_bounds__(NT)
topk_threshold_kernel(const float* __restrict__ logits, float* __restrict__ tau,
                      float* __restrict__ scratch, int Vp, float it, int K, int iters) {
  __shared__ Shared sh;
  const size_t row = blockIdx.x;
  const float* xrow = logits + row * Vp;
  float* qrow = scratch + row * Vp;
  float m, s;
  row_softmax_stats(xrow, Vp, it, sh, &m, &s);
  float qmax = 0.0f;
  for (int i = threadIdx.x * 4; i < Vp; i += TILE) {
    float a[4];
    as_array(ld4(xrow + i), a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = prob(a[j], it, m, s);
      qmax = fmaxf(qmax, a[j]);
    }
    *reinterpret_cast<float4*>(qrow + i) = make_float4(a[0], a[1], a[2], a[3]);
  }
  float lo = 0.0f;
  float hi = block_max(qmax, sh);
  for (int step = 0; step < iters; ++step) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int i = threadIdx.x * 4; i < Vp; i += TILE) {
      float q[4];
      as_array(*reinterpret_cast<const float4*>(qrow + i), q);
#pragma unroll
      for (int j = 0; j < 4; ++j) c += q[j] >= mid;
    }
    if (block_count(c, sh) >= K) lo = mid; else hi = mid;
  }
  if (threadIdx.x == 0) {
    tau[row * 2 + 0] = lo;
    tau[row * 2 + 1] = hi;
  }
}

extern "C" int sqs_fused_launch(const float* logits, const float* beta, int* b_out,
                                int* mask_out, float* stats, float* scratch, int B, int Vp,
                                float inv_temp, int ell, int exact_k, void* stream) {
  sqs_fused_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(logits, beta, b_out, mask_out, stats,
                                                      scratch, Vp, inv_temp, ell, exact_k);
  return (int)cudaGetLastError();
}

extern "C" int topk_threshold_launch(const float* logits, float* tau, float* scratch, int B,
                                     int Vp, float inv_temp, int K, int iters, void* stream) {
  topk_threshold_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(logits, tau, scratch, Vp, inv_temp,
                                                           K, iters);
  return (int)cudaGetLastError();
}
