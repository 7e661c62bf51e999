// Flash-decode GQA attention over a contiguous or a paged KV cache,
// hand-written for Hopper (sm_90a): positions split over blocks, K/V
// tiles copied asynchronously in their storage type, and a combine pass.
//
// Replaces the two Pallas TPU kernels of repro/kernels/decode_attention.py:
//   dense  (gqa_decode_launch)       <- flash_gqa_decode_call / _kernel
//   paged  (paged_gqa_decode_launch) <- paged_flash_gqa_decode_call / _paged_kernel
//
// Both compute, per batch row b and query head h (KV head h / qpk):
//   s_i = (q_h * scale) . k_i  over cache positions i <= pos[b],
//   out = sum_i softmax(s)_i v_i                 (f32 output),
// with int8 K/V multiplied by their per-(position, head) f32 scales.  The
// paged layout reads a slot's position i from pool row
// page_table[b, i / ps] * ps + i % ps.  pos >= 0; positions at or past
// the capacity (S, or max_pages * ps) do not exist.
//
// What bounds it on this card.  One query token reads its row's cache up
// to pos once: 2 * (pos + 1) * hd elements per KV head (plus two f32
// scales per position in int8) for 4 * qpk * hd flops per position, i.e.
// qpk flops per byte in bf16 and 2 * qpk in int8 -- 8 and 16 at the
// served qpk of 8.  That is below the ~20 flops per byte at which the
// card's 67 TFLOP/s of float32 on the CUDA cores meets its 3.35 TB/s, so
// the floor is the bytes of K and V over device memory, and f32 FMAs keep
// up with it.  Tensor cores are not used: a bf16 mma for P.V would round
// p to bf16 and break the 2e-5 to which int8-vs-twin and paged-vs-dense
// are held, and the CUDA cores are not what bounds the kernel.
//
// The design.
//  - Split.  The grid is (nkv * head groups, chunks, B): a block owns one
//    chunk of `chunk` positions of one row and KV head, for up to 8 of its
//    query heads (qpk padded to 1, 2, 4 or 8; wider qpk is split into
//    head groups).  The wrapper plans the chunk from the shapes alone
//    (kernels/decode_attention.py:plan_chunks) so that the grid holds
//    about two waves of blocks; a chunk is a multiple of the page size,
//    so no page straddles two chunks.  A block whose chunk starts past
//    pos[b] exits at once.  The KV heads of a chunk are neighbours in the
//    grid, so the blocks that read the two halves of the same cache rows
//    run at the same time.
//  - Async tiles.  The block walks its chunk in tiles of TILE positions
//    through a ring of STAGES shared-memory stages, filled by 16-byte
//    cp.async.cg copies (int8 scales by 4-byte cp.async.ca) in the cache's
//    own type, so bf16 and int8 tiles cost their own bytes.  The next
//    STAGES - 1 tiles are in flight while one tile computes, with one
//    block-wide barrier per tile.  Positions past pos (or past the
//    capacity) are zero-filled, never read: no stale row and no trash
//    page is touched.  A paged block reads its chunk's page-table entries
//    into shared memory once.  Each thread looks up the source rows of
//    its copies one tile ahead of issuing them, so the lookups overlap
//    the math instead of delaying the copies after each barrier.
//  - Math in f32 on the CUDA cores, online softmax in registers.  Each
//    lane holds 8 dims of q * scale * log2(e) for all its heads and the
//    matching 8 dims of their accumulators.  LPR = hd / 8 lanes share a
//    row; a warp takes 32 / LPR rows of the tile at a time.  Scores are
//    summed over the row's lanes by a reduce-scatter butterfly (each lane
//    stores its heads permuted by the head it will own, so a step is one
//    shuffle and one add), after which each lane owns one head: it keeps
//    that head's running max and sum (in base 2, exp2f) and hands p and
//    the rescale factor back to the other lanes by shuffles; a tile that
//    moves no head's max skips the rescale.  No thread loops over hd in
//    shared memory.  Each (warp, row group) keeps its own softmax state;
//    at the chunk's end the block merges them in shared memory.
//  - Combine.  A row whose live positions fit in one chunk is written
//    directly.  Otherwise each live block writes its heads' running max
//    m, sum l and unnormalised accumulator to f32 scratch and a second
//    kernel, launched by the same C entry point on the same stream,
//    merges the row's live chunks in chunk order:
//      m* = max_c m_c,  out = sum_c 2^(m_c - m*) acc_c
//                             / max(sum_c 2^(m_c - m*) l_c, 1e-30).
//
// Numerics.  Softmax in base 2 with log2(e) folded into q; exp2f is the
// full-precision one (no fast math).  Within a tile a lane sums its 8
// products per head, then the butterfly sums the lanes; the softmax state
// advances tile by tile; the (warp, row group) states merge in their
// index order and the chunks in chunk order.  int8 scales multiply the
// reduced score and p (not each element).  Results agree with the plain
// twin within the reference tests' tolerances.  The dense and paged
// layouts differ only in the address of a row, and over the same capacity
// the wrapper gives them the same plan, so on gathered pages their
// outputs are equal bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 128
#define NWARP (NT / 32)
#define TILE 32
#define STAGES 4
#define EPL 8
#define NEG_INF (-1e30f)
#define FULL 0xffffffffu
#define MAX_SMEM 232448

struct Params {
  const void* q;
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  const int32_t* page_table;   // nullptr: dense
  const int32_t* pos;
  float* out;
  float* scratch;              // nullptr: one chunk per row
  int nq, nkv, qpk, n_hg, cap, chunk, page_size, page_shift, maxp, q_bf16;
  float qscale;                // 1/sqrt(hd) * log2(e)
};

// Shared memory of one block, in bytes: the ring of tiles, reused at the
// chunk's end for the (warp, row group) states; then the chunk's page-
// table entries (paged).  Mirrored by smem_bytes in decode_attention.py.
__host__ __device__ inline size_t smem_bytes(int kv_bytes, int hd, int qpk_t, int chunk,
                                             int page_size) {
  const size_t ring =
      (size_t)STAGES * (2 * TILE * hd * kv_bytes + (kv_bytes == 1 ? 2 * TILE * 4 : 0));
  const size_t nsub = (size_t)NWARP * (32 / (hd / EPL));
  const size_t merge = 4 * (nsub * qpk_t * (hd + 2) + 2 * qpk_t);
  const size_t pt = page_size ? 4 * (size_t)((chunk + page_size - 1) / page_size) : 0;
  return (ring > merge ? ring : merge) + pt;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The dim of a lane's element e (lane slot sl of LPR): 8 consecutive
// dims for bf16 and int8 (one 16- or 8-byte read), two runs of 4 half a
// row apart for f32 (two 16-byte reads, conflict-free across the warp).
template <typename KT, int HD>
__device__ __forceinline__ int dim_of(int sl, int e) {
  if (sizeof(KT) == 4) return (e >> 2) * (HD / 2) + sl * 4 + (e & 3);
  return sl * 8 + e;
}

__device__ __forceinline__ void bf16x2(unsigned w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void i8x4(unsigned w, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = (float)(int8_t)(w >> (8 * i));
}

// A lane's EPL = 8 elements of one row of a tile in shared memory, as f32.
template <typename KT, int HD>
__device__ __forceinline__ void load_row(const KT* row, int sl, float (&f)[EPL]) {
  if constexpr (sizeof(KT) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + dim_of<KT, HD>(sl, 0));
    const float4 b = *reinterpret_cast<const float4*>(row + dim_of<KT, HD>(sl, 4));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if constexpr (sizeof(KT) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + sl * 8);
    bf16x2(u.x, f); bf16x2(u.y, f + 2); bf16x2(u.z, f + 4); bf16x2(u.w, f + 6);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(row + sl * 8);
    i8x4(u.x, f); i8x4(u.y, f + 4);
  }
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// Reduce-scatter over the LPR lanes of a row group.  Slot g of v holds
// this lane's partial sum of head g ^ head_of(lane): the lanes store their
// heads permuted by the head they will own, so that at each step a lane
// keeps the lower half of its slots and adds the partner's upper half,
// which holds the same heads.  Once one slot is left, plain butterfly
// steps finish.  Returns the group's full sum of head head_of(lane).
// NV <= LPR.
template <int NV, int LPR>
__device__ __forceinline__ float reduce_scatter(float (&v)[NV]) {
#pragma unroll
  for (int k = 0; k < ilog2(LPR); ++k) {
    const int o = LPR >> (k + 1);
    const int n = NV >> k;
    if (n > 1) {
#pragma unroll
      for (int i = 0; i < n / 2; ++i) v[i] += __shfl_xor_sync(FULL, v[i + n / 2], o);
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], o);
    }
  }
  return v[0];
}

template <int NV, int LPR>
__device__ __forceinline__ int head_of(int lane) {
  int h = 0;
#pragma unroll
  for (int k = 0; k < ilog2(LPR); ++k) {
    const int n = NV >> k;
    if (n > 1 && (lane & (LPR >> (k + 1)))) h += n / 2;
  }
  return h;
}

// The lane of this lane's row group that owns head g (the one whose
// remaining bits are 0).
template <int NV, int LPR>
__device__ __forceinline__ int owner_of(int g, int lane) {
  int src = lane & ~(LPR - 1);
#pragma unroll
  for (int k = 0; k < ilog2(LPR); ++k) {
    const int n = NV >> k;
    if (n > 1 && (g & (n / 2))) src += LPR >> (k + 1);
  }
  return src;
}

template <typename KT, int HD, int QPK>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const Params p) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int LPR = HD / EPL;                  // lanes per row
  constexpr int RPW = 32 / LPR;                  // rows per warp step
  constexpr int R = TILE / (NWARP * RPW);        // rows per lane per tile
  constexpr int NSUB = NWARP * RPW;              // softmax states per block
  constexpr int ROW = HD * (int)sizeof(KT);      // bytes of one row of K
  constexpr int CPR = ROW / 16;                  // 16-byte copies per row
  static_assert(NT % CPR == 0 && TILE % (NT / CPR) == 0, "copy layout");
  constexpr int TILE_B = TILE * ROW;
  constexpr int STAGE_B = 2 * TILE_B + (QUANT ? 2 * TILE * 4 : 0);
  static_assert(QPK <= LPR && R >= 1, "layout");

  const int hgrp = blockIdx.x, chunk_id = blockIdx.y, b = blockIdx.z;
  const int kvh = hgrp / p.n_hg, hg = hgrp - kvh * p.n_hg;
  const int last = min(p.pos[b], p.cap - 1);
  const int c0 = chunk_id * p.chunk;
  if (c0 > last) return;
  const int c_end = min(c0 + p.chunk, last + 1);      // live positions [c0, c_end)
  const int n_tiles = (c_end - c0 + TILE - 1) / TILE;
  const bool direct = last < p.chunk;                   // the row has one live chunk
  const bool paged = p.page_table != nullptr;
  const int ps = p.page_size, shift = p.page_shift;

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t body = smem_bytes((int)sizeof(KT), HD, QPK, 0, 0);
  int* pt_s = reinterpret_cast<int*>(smem + body);
  // pool row of live position i (c0 <= i < c_end)
  auto row_of = [&](int i) -> size_t {
    if (!paged) return (size_t)b * p.cap + i;
    const int rel = i - c0;
    const int pg = shift >= 0 ? rel >> shift : rel / ps;
    return (size_t)pt_s[pg] * ps + (rel - pg * ps);
  };

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int grp = lane / LPR, sl = lane % LPR;
  const int own = head_of<QPK, LPR>(lane);

  if (paged) {
    const int n_pg = (c_end - c0 + ps - 1) / ps;
    const int32_t* pt = p.page_table + (size_t)b * p.maxp + c0 / ps;
    for (int i = tid; i < n_pg; i += NT) pt_s[i] = pt[i];
    __syncthreads();
  }

  // Each thread copies 16 bytes at column col of rows r0, r0 + RSTEP, ...
  // of every tile, K and V; threads 0..TILE-1 copy the int8 scales.  The
  // source offsets of a tile's copies are looked up one tile ahead of its
  // issue, so the page-table reads overlap the math of the tile before.
  constexpr int RSTEP = NT / CPR, NCP = TILE / RSTEP;
  const int r0 = tid / CPR, col = (tid % CPR) * 16;
  const size_t rstride = (size_t)p.nkv * ROW;           // bytes per position
  const unsigned char* kb = p.k + (size_t)kvh * ROW + col;
  const unsigned char* vb = p.v + (size_t)kvh * ROW + col;
  size_t off[NCP], soff = kvh;
  auto look_up = [&](int t) {
    const int t0 = c0 + t * TILE;
#pragma unroll
    for (int k = 0; k < NCP; ++k) {
      const int i = t0 + r0 + k * RSTEP;
      off[k] = i < c_end ? row_of(i) * rstride : 0;
    }
    if (QUANT && tid < TILE) soff = t0 + tid < c_end ? row_of(t0 + tid) * p.nkv + kvh : kvh;
  };
  auto issue = [&](int t) {                             // after look_up(t)
    if (t < n_tiles) {
      unsigned char* st = smem + (t % STAGES) * STAGE_B;
      const int t0 = c0 + t * TILE;
#pragma unroll
      for (int k = 0; k < NCP; ++k) {
        const int r = r0 + k * RSTEP;
        const bool ok = t0 + r < c_end;
        cp_async16(st + r * ROW + col, kb + off[k], ok);
        cp_async16(st + TILE_B + r * ROW + col, vb + off[k], ok);
      }
      if (QUANT && tid < TILE) {
        float* sc = reinterpret_cast<float*>(st + 2 * TILE_B);
        const bool ok = t0 + tid < c_end;
        cp_async4(sc + tid, p.ks + soff, ok);
        cp_async4(sc + TILE + tid, p.vs + soff, ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    look_up(t);
    issue(t);
  }
  look_up(STAGES - 1);

  // q * scale * log2(e) for this lane's dims, slot g holding head g ^ own
  // (reduce_scatter); heads past qpk are zero.  acc is in head order.
  float qr[QPK][EPL], acc[QPK][EPL];
#pragma unroll
  for (int g = 0; g < QPK; ++g) {
    const int ga = hg * QPK + (g ^ own);
    const size_t qo = ((size_t)b * p.nq + (size_t)kvh * p.qpk + ga) * HD;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float x = 0.0f;
      if (ga < p.qpk) {
        const int d = dim_of<KT, HD>(sl, e);
        x = p.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p.q)[qo + d])
                     : reinterpret_cast<const float*>(p.q)[qo + d];
      }
      qr[g][e] = x * p.qscale;
      acc[g][e] = 0.0f;
    }
  }
  float m = NEG_INF, l = 0.0f;                  // of head `own`, rows (w, grp)

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(t + STAGES - 1);
    look_up(t + STAGES);
    const unsigned char* st = smem + (t % STAGES) * STAGE_B;
    const KT* kt = reinterpret_cast<const KT*>(st);
    const KT* vt = reinterpret_cast<const KT*>(st + TILE_B);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * TILE_B);
    const int t0 = c0 + t * TILE;

    float s[R];
    bool valid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = (r * NWARP + w) * RPW + grp;
      float kf[EPL];
      load_row<KT, HD>(kt + j * HD, sl, kf);
      float part[QPK];
#pragma unroll
      for (int g = 0; g < QPK; ++g) {
        float a = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qr[g][e], kf[e], a);
        part[g] = a;
      }
      float x = reduce_scatter<QPK, LPR>(part);
      if (QUANT) x *= ksc[j];
      valid[r] = t0 + j < c_end;
      s[r] = valid[r] ? x : NEG_INF;
    }
    float mt = m;
#pragma unroll
    for (int r = 0; r < R; ++r) mt = fmaxf(mt, s[r]);
    const float alpha = exp2f(m - mt);
    float pr[R], lsum = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pr[r] = valid[r] ? exp2f(s[r] - mt) : 0.0f;
      lsum += pr[r];
    }
    l = l * alpha + lsum;
    m = mt;
    if (!__all_sync(FULL, alpha == 1.0f)) {       // some head's max moved
#pragma unroll
      for (int g = 0; g < QPK; ++g) {
        const float a = __shfl_sync(FULL, alpha, owner_of<QPK, LPR>(g, lane));
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= a;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = (r * NWARP + w) * RPW + grp;
      float vf[EPL];
      load_row<KT, HD>(vt + j * HD, sl, vf);
      const float pv = QUANT ? pr[r] * ksc[TILE + j] : pr[r];
#pragma unroll
      for (int g = 0; g < QPK; ++g) {
        const float pg = __shfl_sync(FULL, pv, owner_of<QPK, LPR>(g, lane));
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
  }

  // merge the NSUB (warp, row group) states of the chunk
  cp_async_wait<0>();
  __syncthreads();
  float* m_s = reinterpret_cast<float*>(smem);
  float* l_s = m_s + NSUB * QPK;
  float* a_s = l_s + NSUB * QPK;
  const int sub = w * RPW + grp;
  if (owner_of<QPK, LPR>(own, lane) == lane) {
    m_s[sub * QPK + own] = m;
    l_s[sub * QPK + own] = l;
  }
#pragma unroll
  for (int g = 0; g < QPK; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) a_s[(sub * QPK + g) * HD + dim_of<KT, HD>(sl, e)] = acc[g][e];
  __syncthreads();

  // per head: the max over the states, each state's weight 2^(m - max)
  // (in place of m) and the weighted sum of l, in state order
  float* mx_s = a_s + NSUB * QPK * HD;
  float* lt_s = mx_s + QPK;
  if (tid < QPK) {
    float mx = NEG_INF;
#pragma unroll
    for (int s2 = 0; s2 < NSUB; ++s2) mx = fmaxf(mx, m_s[s2 * QPK + tid]);
    float lt = 0.0f;
#pragma unroll
    for (int s2 = 0; s2 < NSUB; ++s2) {
      const float wgt = exp2f(m_s[s2 * QPK + tid] - mx);
      m_s[s2 * QPK + tid] = wgt;
      lt += wgt * l_s[s2 * QPK + tid];
    }
    mx_s[tid] = mx;
    lt_s[tid] = lt;
  }
  __syncthreads();

  const size_t base = ((size_t)b * gridDim.x + hgrp) * gridDim.y + chunk_id;
  const size_t ml_off = (size_t)gridDim.z * gridDim.y * gridDim.x * QPK * HD;
  for (int i = tid; i < QPK * HD; i += NT) {
    const int g = i / HD, d = i - g * HD;
    const int ga = hg * QPK + g;
    if (ga >= p.qpk) continue;
    float at = 0.0f;
#pragma unroll
    for (int s2 = 0; s2 < NSUB; ++s2) at += m_s[s2 * QPK + g] * a_s[(s2 * QPK + g) * HD + d];
    if (direct) {
      p.out[((size_t)b * p.nq + (size_t)kvh * p.qpk + ga) * HD + d] = at / fmaxf(lt_s[g], 1e-30f);
    } else {
      p.scratch[(base * QPK + g) * HD + d] = at;
      if (d == 0) {
        p.scratch[ml_off + (base * QPK + g) * 2] = mx_s[g];
        p.scratch[ml_off + (base * QPK + g) * 2 + 1] = lt_s[g];
      }
    }
  }
}

// Merge a row's live chunks (rows with one live chunk were written
// directly).  One block per (row, KV head group, query head), one thread
// per dim: every thread takes the head's max and weighted sum over the
// chunks in chunk order (the same loads, so the same bits), then its own
// weighted accumulator.  grid (nkv * n_hg * qpk_t, B), hd threads.
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const Params p, int qpk_t, int hd, int n_chunks) {
  const int hgrp = blockIdx.x / qpk_t, g = blockIdx.x - hgrp * qpk_t, b = blockIdx.y;
  const int kvh = hgrp / p.n_hg, hg = hgrp - kvh * p.n_hg;
  const int ga = hg * qpk_t + g, d = threadIdx.x;
  const int last = min(p.pos[b], p.cap - 1);
  if (ga >= p.qpk || last < p.chunk) return;
  const int n_live = last / p.chunk + 1;
  const size_t base = ((size_t)b * (gridDim.x / qpk_t) + hgrp) * n_chunks;
  const float* ml = p.scratch + (size_t)gridDim.y * gridDim.x * n_chunks * hd;
  float mx = NEG_INF;
  for (int c = 0; c < n_live; ++c) mx = fmaxf(mx, ml[((base + c) * qpk_t + g) * 2]);
  float lt = 0.0f, at = 0.0f;
  for (int c = 0; c < n_live; ++c) {
    const size_t e = (base + c) * qpk_t + g;
    const float wgt = exp2f(ml[e * 2] - mx);
    lt += wgt * ml[e * 2 + 1];
    at += wgt * p.scratch[e * hd + d];
  }
  p.out[((size_t)b * p.nq + (size_t)kvh * p.qpk + ga) * hd + d] = at / fmaxf(lt, 1e-30f);
}

template <typename KT, int HD, int QPK>
static int launch_typed(const Params& p, int B, int n_chunks, cudaStream_t stream) {
  auto kern = decode_split_kernel<KT, HD, QPK>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem =
      smem_bytes((int)sizeof(KT), HD, QPK, p.chunk, p.page_table ? p.page_size : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  dim3 grid(p.nkv * p.n_hg, n_chunks, B);
  kern<<<grid, NT, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  decode_combine_kernel<<<dim3(p.nkv * p.n_hg * QPK, B), HD, 0, stream>>>(p, QPK, HD, n_chunks);
  return (int)cudaGetLastError();
}

template <typename KT, int HD>
static int launch_hd(const Params& p, int qpk_t, int B, int n_chunks, cudaStream_t s) {
  switch (qpk_t) {
    case 1: return launch_typed<KT, HD, 1>(p, B, n_chunks, s);
    case 2: return launch_typed<KT, HD, 2>(p, B, n_chunks, s);
    case 4: return launch_typed<KT, HD, 4>(p, B, n_chunks, s);
    case 8: return launch_typed<KT, HD, 8>(p, B, n_chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename KT>
static int launch_kv(const Params& p, int hd, int qpk_t, int B, int n_chunks, cudaStream_t s) {
  if (hd == 64) return launch_hd<KT, 64>(p, qpk_t, B, n_chunks, s);
  if (hd == 128) return launch_hd<KT, 128>(p, qpk_t, B, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}

// dtype codes: q 0 = f32, 1 = bf16; kv 0 = f32, 1 = bf16, 2 = int8 (with
// scales).  qpk_t: query heads per block (1, 2, 4 or 8), n_hg = ceil(qpk /
// qpk_t) head groups per KV head.  scratch: f32, B * nkv * n_hg *
// n_chunks * qpk_t * (hd + 2), or null when n_chunks == 1.
static int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                  const int32_t* page_table, const int32_t* pos, float* out, float* scratch,
                  int B, int cap, int page_size, int maxp, int nq, int nkv, int hd, int qpk_t,
                  int chunk, int q_dtype, int kv_dtype, float qscale, void* stream) {
  if (q_dtype != 0 && q_dtype != 1) return (int)cudaErrorInvalidValue;
  const int qpk = nq / nkv;
  const int n_chunks = (cap + chunk - 1) / chunk;
  if (n_chunks > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = (const unsigned char*)k;
  p.v = (const unsigned char*)v;
  p.ks = ks;
  p.vs = vs;
  p.page_table = page_table;
  p.pos = pos;
  p.out = out;
  p.scratch = scratch;
  p.nq = nq;
  p.nkv = nkv;
  p.qpk = qpk;
  p.n_hg = (qpk + qpk_t - 1) / qpk_t;
  p.cap = cap;
  p.chunk = chunk;
  p.page_size = page_size;
  p.page_shift = (page_size > 0 && (page_size & (page_size - 1)) == 0) ? __builtin_ctz(page_size) : -1;
  p.maxp = maxp;
  p.q_bf16 = q_dtype;
  p.qscale = qscale;
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_dtype == 0) return launch_kv<float>(p, hd, qpk_t, B, n_chunks, s);
  if (kv_dtype == 1) return launch_kv<__nv_bfloat16>(p, hd, qpk_t, B, n_chunks, s);
  if (kv_dtype == 2) return launch_kv<int8_t>(p, hd, qpk_t, B, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v, const float* ks,
                                 const float* vs, const int32_t* pos, float* out, float* scratch,
                                 int B, int S, int nq, int nkv, int hd, int qpk_t, int chunk,
                                 int q_dtype, int kv_dtype, float qscale, void* stream) {
  return launch(q, k, v, ks, vs, nullptr, pos, out, scratch, B, S, 0, 0, nq, nkv, hd, qpk_t,
                chunk, q_dtype, kv_dtype, qscale, stream);
}

extern "C" int paged_gqa_decode_launch(const void* q, const void* k, const void* v,
                                       const float* ks, const float* vs,
                                       const int32_t* page_table, const int32_t* pos, float* out,
                                       float* scratch, int B, int page_size, int maxp, int nq,
                                       int nkv, int hd, int qpk_t, int chunk, int q_dtype,
                                       int kv_dtype, float qscale, void* stream) {
  return launch(q, k, v, ks, vs, page_table, pos, out, scratch, B, maxp * page_size, page_size,
                maxp, nq, nkv, hd, qpk_t, chunk, q_dtype, kv_dtype, qscale, stream);
}
