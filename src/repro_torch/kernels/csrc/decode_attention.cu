// Flash-decode GQA attention over a contiguous or a paged KV cache,
// hand-written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of repro/kernels/decode_attention.py:
//   flash_gqa_decode_kernel       <- flash_gqa_decode_call / _kernel
//   paged_flash_gqa_decode_kernel <- paged_flash_gqa_decode_call / _paged_kernel
//
// Both compute, per batch row b and query head h (KV head h / qpk):
//   s_i = (q_h * scale) . k_i  over cache positions i <= pos[b],
//   out = sum_i softmax(s)_i v_i                 (f32 output),
// with int8 K/V multiplied by their per-(position, head) f32 scales before
// use.  The paged kernel reads a slot's logical page j from pool row
// page_table[b, j]; the block loads its own table entries and pos, which
// takes the place of the TPU kernel's scalar prefetch.
//
// What bounds it on this card.  One query token reads the slot's whole
// cache up to pos: 2 * (pos + 1) * hd elements per KV head against about
// 4 * qpk * hd flops per position, i.e. qpk / 2 to qpk flops per byte in
// bf16 -- far below the H100's ~295 flops per byte, so the floor is the
// bytes of K and V (and scales) over device memory.  The design moves each
// byte once: one thread block per (batch row, KV head) stages a tile of K
// and V in shared memory (widened to f32, scale applied in f32 as the TPU
// kernel does) and the qpk query heads of that KV head all read it there,
// as the TPU grid (B, nkv, blocks) shares a block among them.  The online
// softmax (running max m, sum l, accumulator acc) lives in shared memory.
// The block stops at the tile that holds pos: in the TPU kernel the later
// blocks give exp(-1e30 - m) = 0 and alpha = 1 and change nothing, so
// skipping them gives the same result and never reads stale or trash-page
// rows.  What this costs: at B = 4 and nkv = 2 only 8 blocks run, on 8 of
// 132 SMs, each streaming its row with plain loads; splitting the
// positions over several blocks with a combine pass (flash-decoding), TMA
// loads and tensor-core products are the next steps.
//
// Numerics: the tile is fixed (dense) or one page (paged), not the TPU's
// 512-position block, so the f32 sums of the online softmax are taken in
// another order; results agree with the plain twin within the reference
// tests' tolerances.  expf is the full-precision one (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 128
#define NWARP (NT / 32)
#define NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one block, in floats: q (qpk*hd), K and V tiles
// (tile rows of hd + 1, the pad keeps the score loop free of bank
// conflicts), scores/probabilities (qpk*tile), acc (qpk*hd), m, l, alpha.
__host__ __device__ inline size_t smem_floats(int qpk, int hd, int tile) {
  return (size_t)qpk * hd * 2 + (size_t)2 * tile * (hd + 1) + (size_t)qpk * tile + 3 * qpk;
}

// One (batch row, KV head) of either layout.  page_table == nullptr: the
// contiguous cache (B, n_rows, nkv, hd), walked in tiles of `tile`
// positions.  Otherwise a pool (P, tile, nkv, hd) whose row
// page_table[b * maxp + j] holds the slot's positions [j*tile, (j+1)*tile);
// n_rows = maxp * tile.
template <typename QT, typename KT, bool QUANT>
__device__ __forceinline__ void decode_body(const QT* __restrict__ q, const KT* __restrict__ k,
                                            const KT* __restrict__ v,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs,
                                            const int32_t* __restrict__ page_table,
                                            const int32_t* __restrict__ pos,
                                            float* __restrict__ out, int nq, int nkv, int hd,
                                            int tile, int n_rows, int maxp, float scale) {
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int qpk = nq / nkv, ld = hd + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + qpk * hd;
  float* v_s = k_s + tile * ld;
  float* p_s = v_s + tile * ld;
  float* acc = p_s + qpk * tile;
  float* m_s = acc + qpk * hd;
  float* l_s = m_s + qpk;
  float* a_s = l_s + qpk;

  const size_t qoff = ((size_t)b * nq + (size_t)kvh * qpk) * hd;
  for (int i = tid; i < qpk * hd; i += NT) {
    q_s[i] = to_f32(q[qoff + i]) * scale;
    acc[i] = 0.0f;
  }
  for (int g = tid; g < qpk; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.0f;
  }
  const int p_last = pos[b];
  const int n_pos = min(p_last + 1, n_rows);
  const int n_tiles = (n_pos + tile - 1) / tile;
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int start = t * tile;
    const int rows = min(tile, n_rows - start);        // ragged end (dense)
    const int live = min(rows, p_last - start + 1);    // positions <= pos
    const size_t row0 = page_table ? (size_t)page_table[(size_t)b * maxp + t] * tile
                                   : (size_t)b * n_rows + start;
    for (int i = tid; i < rows * hd; i += NT) {
      const int r = i / hd, d = i - r * hd;
      const size_t e = ((row0 + r) * nkv + kvh) * hd + d;
      float kf = to_f32(k[e]), vf = to_f32(v[e]);
      if (QUANT) {
        const size_t se = (row0 + r) * nkv + kvh;
        kf = kf * ks[se];
        vf = vf * vs[se];
      }
      k_s[r * ld + d] = kf;
      v_s[r * ld + d] = vf;
    }
    __syncthreads();
    for (int i = tid; i < qpk * tile; i += NT) {
      const int g = i / tile, j = i - g * tile;
      float s = NEG_INF;
      if (j < live) {
        const float* qg = q_s + g * hd;
        const float* kj = k_s + j * ld;
        float a = 0.0f;
        for (int d = 0; d < hd; ++d) a += qg[d] * kj[d];
        s = a;
      }
      p_s[i] = s;
    }
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    for (int g = warp; g < qpk; g += NWARP) {
      float* pg = p_s + g * tile;
      float mx = NEG_INF;
      for (int j = lane; j < tile; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < tile; j += 32) {
        const float p = expf(pg[j] - m_new);
        pg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < qpk * hd; i += NT) {
      const int g = i / hd, d = i - g * hd;
      const float* pg = p_s + g * tile;
      float o = 0.0f;
      for (int j = 0; j < live; ++j) o += pg[j] * v_s[j * ld + d];
      acc[i] = acc[i] * a_s[g] + o;
    }
    __syncthreads();
  }
  for (int i = tid; i < qpk * hd; i += NT) {
    out[qoff + i] = acc[i] / fmaxf(l_s[i / hd], 1e-30f);
  }
}

template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(NT)
flash_gqa_decode_kernel(const QT* q, const KT* k, const KT* v, const float* ks, const float* vs,
                        const int32_t* page_table, const int32_t* pos, float* out, int nq,
                        int nkv, int hd, int tile, int n_rows, int maxp, float scale) {
  decode_body<QT, KT, QUANT>(q, k, v, ks, vs, nullptr, pos, out, nq, nkv, hd, tile, n_rows, maxp,
                             scale);
}

template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(NT)
paged_flash_gqa_decode_kernel(const QT* q, const KT* k, const KT* v, const float* ks,
                              const float* vs, const int32_t* page_table, const int32_t* pos,
                              float* out, int nq, int nkv, int hd, int tile, int n_rows, int maxp,
                              float scale) {
  decode_body<QT, KT, QUANT>(q, k, v, ks, vs, page_table, pos, out, nq, nkv, hd, tile, n_rows,
                             maxp, scale);
}

template <typename QT, typename KT, bool QUANT>
static int launch_typed(bool paged, const void* q, const void* k, const void* v, const float* ks,
                        const float* vs, const int32_t* page_table, const int32_t* pos,
                        float* out, int B, int nq, int nkv, int hd, int tile, int n_rows,
                        int maxp, float scale, cudaStream_t stream) {
  auto kern = paged ? paged_flash_gqa_decode_kernel<QT, KT, QUANT>
                    : flash_gqa_decode_kernel<QT, KT, QUANT>;
  const size_t smem = smem_floats(nq / nkv, hd, tile) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nkv, B);
  kern<<<grid, NT, smem, stream>>>((const QT*)q, (const KT*)k, (const KT*)v, ks, vs, page_table,
                                   pos, out, nq, nkv, hd, tile, n_rows, maxp, scale);
  return (int)cudaGetLastError();
}

// dtype codes: q 0 = f32, 1 = bf16; kv 0 = f32, 1 = bf16, 2 = int8 (with scales)
static int launch(bool paged, const void* q, const void* k, const void* v, const float* ks,
                  const float* vs, const int32_t* page_table, const int32_t* pos, float* out,
                  int B, int nq, int nkv, int hd, int tile, int n_rows, int maxp, int q_dtype,
                  int kv_dtype, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ARGS paged, q, k, v, ks, vs, page_table, pos, out, B, nq, nkv, hd, tile, n_rows, maxp, scale, s
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_typed<float, float, false>(ARGS);
    if (kv_dtype == 1) return launch_typed<float, __nv_bfloat16, false>(ARGS);
    if (kv_dtype == 2) return launch_typed<float, int8_t, true>(ARGS);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_typed<__nv_bfloat16, float, false>(ARGS);
    if (kv_dtype == 1) return launch_typed<__nv_bfloat16, __nv_bfloat16, false>(ARGS);
    if (kv_dtype == 2) return launch_typed<__nv_bfloat16, int8_t, true>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v, const float* ks,
                                 const float* vs, const int32_t* pos, float* out, int B, int S,
                                 int nq, int nkv, int hd, int tile, int q_dtype, int kv_dtype,
                                 float scale, void* stream) {
  return launch(false, q, k, v, ks, vs, nullptr, pos, out, B, nq, nkv, hd, tile, S, 0, q_dtype,
                kv_dtype, scale, stream);
}

extern "C" int paged_gqa_decode_launch(const void* q, const void* k, const void* v,
                                       const float* ks, const float* vs,
                                       const int32_t* page_table, const int32_t* pos, float* out,
                                       int B, int page_size, int maxp, int nq, int nkv, int hd,
                                       int q_dtype, int kv_dtype, float scale, void* stream) {
  return launch(true, q, k, v, ks, vs, page_table, pos, out, B, nq, nkv, hd, page_size,
                maxp * page_size, maxp, q_dtype, kv_dtype, scale, stream);
}
