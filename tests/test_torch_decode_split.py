"""The flash-decode kernels' split plan and algorithm, on the CPU.

The Hopper kernels (``csrc/decode_attention.cu``) split a row's positions
into the chunks that ``decode_attention.plan_chunks`` picks, run an online
softmax over each chunk in tiles of ``TILE`` positions (base 2, positions
past ``pos`` zero-filled and masked), and merge the live chunks in a
combine pass.  The kernels run only on a card; here ``split_decode``, a
plain-torch emulation of that algorithm at the plan's chunk sizes, is
held against the reference's Pallas kernels (interpreted) and their jnp
oracles at the reference tests' tolerances (2e-5 in float32 and for int8
against its twin, 0.02 for int8 against the float oracle), and the plan
is held to its rules."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import quantize_kv as jquant  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402

NEG_INF = -1e30


def _gather(pool, pt):
    g = pool[pt.long()]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def split_decode(q, k, v, pos, k_scale=None, v_scale=None, page_table=None):
    """The kernels' algorithm in plain torch: per chunk of the plan, an
    online softmax in base 2 over tiles of TILE positions (rows past
    min(pos, capacity - 1) zero-filled, never read), int8 scales applied
    to the reduced score and to p; then the combine pass over the live
    chunks in chunk order.  Returns (B, nq, hd) f32."""
    B, nq, hd = q.shape
    ps = 1
    if page_table is not None:
        ps = k.shape[1]
        k, v = _gather(k, page_table), _gather(v, page_table)
        if k_scale is not None:
            k_scale = _gather(k_scale, page_table)
            v_scale = _gather(v_scale, page_table)
    cap, nkv = k.shape[1], k.shape[2]
    chunk, n_chunks = tda.plan_chunks(cap, B, nkv, ps)
    qs = q.float().reshape(B, nkv, nq // nkv, hd) * (tda.LOG2E / hd ** 0.5)
    last = torch.clamp(pos.long(), max=cap - 1)
    states = []
    for c in range(n_chunks):
        m = torch.full(qs.shape[:3], NEG_INF)
        l = torch.zeros(qs.shape[:3])
        acc = torch.zeros(qs.shape)
        for t0 in range(c * chunk, min((c + 1) * chunk, cap), tda.TILE):
            idx = torch.arange(t0, min(t0 + tda.TILE, (c + 1) * chunk, cap))
            valid = idx[None, :] <= last[:, None]                  # (B, T)
            keep = valid[:, :, None, None]
            kt = torch.where(keep, k[:, idx].float(), 0.0)
            vt = torch.where(keep, v[:, idx].float(), 0.0)
            s = torch.einsum("bkgh,btkh->bkgt", qs, kt)
            if k_scale is not None:
                s = s * torch.where(valid[:, :, None], k_scale[:, idx], 0.0
                                    ).permute(0, 2, 1)[:, :, None, :]
            s = torch.where(valid[:, None, None, :], s, NEG_INF)
            mt = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mt)
            p = torch.where(valid[:, None, None, :],
                            torch.exp2(s - mt[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            if v_scale is not None:
                p = p * torch.where(valid[:, :, None], v_scale[:, idx], 0.0
                                    ).permute(0, 2, 1)[:, :, None, :]
            acc = acc * alpha[..., None] + torch.einsum("bkgt,btkh->bkgh",
                                                        p, vt)
            m = mt
        states.append((m, l, acc))
    live = (torch.arange(n_chunks)[None, :] * chunk <= last[:, None]
            )[:, None, None, :]                                  # chunk <= pos
    M = torch.where(live, torch.stack([s[0] for s in states], -1), NEG_INF)
    w = torch.where(live, torch.exp2(M - M.amax(-1, keepdim=True)), 0.0)
    L = (w * torch.stack([s[1] for s in states], -1)).sum(-1)
    A = (w[..., None, :] * torch.stack([s[2] for s in states], -1)).sum(-1)
    return (A / torch.clamp(L, min=1e-30)[..., None]).reshape(B, nq, hd)


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("capacity,B,nkv", [(33, 1, 1), (640, 2, 2),
                                            (4112, 4, 2), (4096, 32, 2),
                                            (1000, 3, 4), (1 << 16, 1, 1)])
def test_plan_partitions_the_capacity(capacity, B, nkv):
    chunk, n_chunks = tda.plan_chunks(capacity, B, nkv)
    assert tda.MIN_CHUNK <= chunk <= tda.MAX_CHUNK
    assert chunk & (chunk - 1) == 0 and chunk % tda.TILE == 0
    owner = np.zeros(capacity, np.int64)
    for c in range(n_chunks):
        owner[c * chunk:min((c + 1) * chunk, capacity)] += 1
    assert (owner == 1).all() and (n_chunks - 1) * chunk < capacity
    for ps in (8, 16, 32):                       # pages never straddle
        assert tda.plan_chunks(capacity, B, nkv, ps) == (chunk, n_chunks)
        assert chunk % ps == 0


def test_plan_rounds_to_odd_page_sizes():
    for ps in (12, 24, 100):
        chunk, n = tda.plan_chunks(1200, 2, 2, ps)
        assert chunk % ps == 0 and chunk % tda.TILE == 0
        assert n == math.ceil(1200 / chunk)


@pytest.mark.parametrize("capacity,B,nkv,want", [(4112, 4, 2, 128),
                                                 (4096, 32, 2, 1024)])
def test_plan_fills_two_waves_at_the_timed_shapes(capacity, B, nkv, want):
    """(a) the served pools of chip_smoke phase 6; (b) 32 slots of 4096
    positions: the grid holds about two waves of 132 SMs
    (TARGET_BLOCKS), with the largest chunk that does."""
    chunk, n_chunks = tda.plan_chunks(capacity, B, nkv, 16)
    assert chunk == want
    assert B * nkv * n_chunks >= tda.TARGET_BLOCKS >= 1.9 * 132
    assert chunk == tda.MAX_CHUNK or \
        B * nkv * math.ceil(capacity / (2 * chunk)) < tda.TARGET_BLOCKS


def test_shared_memory_fits_every_supported_shape():
    for qpk in range(1, 17):
        qpk_t, n_hg = tda.head_groups(qpk)
        assert qpk_t in (1, 2, 4, 8) and qpk_t * n_hg >= qpk
        assert qpk_t * (n_hg - 1) < qpk
        for hd in tda.HEAD_DIMS:
            for kv_bytes in (1, 2, 4):
                for ps in (0, 8, 16, 32):
                    chunk, _ = tda.plan_chunks(4112, 1, 1, max(ps, 1))
                    tda._smem_check(qpk, hd, kv_bytes, chunk, ps)
    # bf16, hd 128, 8 heads: 4 stages of 32-position K and V tiles
    assert tda.smem_bytes(8, 128, 2) == 4 * 2 * 32 * 128 * 2
    assert tda.smem_bytes(8, 128, 2, 128, 16) == 4 * 2 * 32 * 128 * 2 + 32
    with pytest.raises(ValueError, match="shared memory"):
        tda._smem_check(8, 128, 4, 1 << 16, 1)


# ----------------------------------------------------------------------
# the algorithm against the reference
# ----------------------------------------------------------------------
def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _close(j, t, atol):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol)


@pytest.mark.parametrize("B,S,nkv,qpk,hd,pos", [
    (3, 640, 2, 8, 128, [0, 63, 64]),        # pos 0; chunk boundary -1, 0
    (3, 512, 2, 1, 64, [65, 511, 700]),      # +1; capacity - 1; past it
    (2, 520, 1, 8, 64, [100, 519]),          # chunks wholly past pos
])
def test_split_emulation_vs_reference_dense(B, S, nkv, qpk, hd, pos):
    rng = np.random.default_rng(S + qpk)
    chunk, n_chunks = tda.plan_chunks(S, B, nkv)
    assert n_chunks > 1 and chunk == tda.MIN_CHUNK
    qj, qt = _both(rng.standard_normal((B, nkv * qpk, hd)).astype(np.float32))
    kj, kt = _both(rng.standard_normal((B, S, nkv, hd)).astype(np.float32))
    vj, vt = _both(rng.standard_normal((B, S, nkv, hd)).astype(np.float32))
    pj, pt = _both(np.asarray(pos, np.int32))
    out = split_decode(qt, kt, vt, pt)
    r = jops.gqa_decode(qj, kj, vj, pj, use_ref=True)
    _close(r, out, 2e-5)
    _close(jops.gqa_decode(qj, kj, vj, pj), out, 2e-5)       # Pallas kernel
    k8j, ksj = jquant(kj)
    v8j, vsj = jquant(vj)
    k8t, kst = tda.quantize_kv(kt)
    v8t, vst = tda.quantize_kv(vt)
    out8 = split_decode(qt, k8t, v8t, pt, kst, vst)
    _close(jops.gqa_decode(qj, k8j, v8j, pj, ksj, vsj, use_ref=True), out8,
           2e-5)
    _close(jops.gqa_decode(qj, k8j, v8j, pj, ksj, vsj), out8, 2e-5)
    assert float(np.max(np.abs(out8.numpy() - np.asarray(r)))) < 0.02


@pytest.mark.parametrize("nkv,qpk,hd,ps", [(2, 8, 128, 16), (2, 1, 64, 8)])
def test_split_emulation_vs_reference_paged_with_huge_trash(nkv, qpk, hd,
                                                            ps):
    """Pages in shuffled physical order; table entries past each slot's
    pages point at a trash page of huge values, which must never reach
    the output (the kernel zero-fills rows past pos)."""
    B, maxp = 3, 192 // ps
    n_pages = B * maxp
    rng = np.random.default_rng(ps)
    q = rng.standard_normal((B, nkv * qpk, hd)).astype(np.float32)
    pk = rng.standard_normal((n_pages + 1, ps, nkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages + 1, ps, nkv, hd)).astype(np.float32)
    pk[-1] = pv[-1] = 1e30
    pos = np.asarray([0, 64, 150], np.int32)
    perm = rng.permutation(n_pages)
    table = np.full((B, maxp), n_pages, np.int32)
    used = 0
    for b in range(B):
        n = pos[b] // ps + 1
        table[b, :n] = perm[used:used + n]
        used += n
    (qj, qt), (kj, kt), (vj, vt) = _both(q), _both(pk), _both(pv)
    (tj, tt), (pj, pt) = _both(table), _both(pos)
    out = split_decode(qt, kt, vt, pt, page_table=tt)
    assert torch.isfinite(out).all()
    _close(jops.paged_gqa_decode(qj, kj, vj, tj, pj, use_ref=True), out, 2e-5)
    _close(jops.paged_gqa_decode(qj, kj, vj, tj, pj), out, 2e-5)
    # paged is the dense algorithm on the gathered pages, bit for bit
    dense = split_decode(qt, _gather(kt, tt).contiguous(),
                         _gather(vt, tt).contiguous(), pt)
    assert torch.equal(dense, out)
    k8j, ksj = jquant(kj)
    v8j, vsj = jquant(vj)
    k8t, kst = tda.quantize_kv(kt)
    v8t, vst = tda.quantize_kv(vt)
    out8 = split_decode(qt, k8t, v8t, pt, kst, vst, page_table=tt)
    _close(jops.paged_gqa_decode(qj, k8j, v8j, tj, pj, ksj, vsj), out8, 2e-5)
    _close(jops.paged_gqa_decode(qj, k8j, v8j, tj, pj, ksj, vsj,
                                 use_ref=True), out8, 2e-5)
