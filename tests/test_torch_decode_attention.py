"""The port's flash-decode wrappers against the reference's: on a CPU
tensor ``ops.gqa_decode`` / ``ops.paged_gqa_decode`` run the plain twins,
which must agree with the reference's Pallas kernels (interpreted) and
their jnp oracles at the reference's own tolerances
(tests/test_kernels.py): atol 2e-5 in float32 and for int8 against its
twin, 5e-3 for a bf16 cache, 0.02 for int8 against the float oracle.
``quantize_kv`` gives the reference's int8 values and scales exactly.
The Hopper kernels run only on a card: the ``cuda`` test holds them
against the twins there and skips elsewhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import quantize_kv as jquant  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _close(j, t, atol):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol)


@pytest.mark.parametrize("B,S,nkv,qpk,hd", [(2, 1024, 2, 4, 64),
                                            (3, 700, 4, 1, 128)])
def test_dense_decode_vs_reference(B, S, nkv, qpk, hd):
    rng = np.random.default_rng(S)
    nq = nkv * qpk
    qj, qt = _both(_normal(rng, (B, nq, hd)))
    kj, kt = _both(_normal(rng, (B, S, nkv, hd)))
    vj, vt = _both(_normal(rng, (B, S, nkv, hd)))
    pos = np.arange(B, dtype=np.int32) * 7 + S // 2
    pj, pt = _both(pos)
    out = tops.gqa_decode(qt, kt, vt, pt)
    assert out.dtype == torch.float32 and out.shape == (B, nq, hd)
    r = jops.gqa_decode(qj, kj, vj, pj, use_ref=True)
    _close(jops.gqa_decode(qj, kj, vj, pj), out, 2e-5)     # Pallas kernel
    _close(r, out, 2e-5)
    # int8: the reference's quantizer exactly, then the dequantized math
    k8j, ksj = jquant(kj)
    v8j, vsj = jquant(vj)
    k8t, kst = tda.quantize_kv(kt)
    v8t, vst = tda.quantize_kv(vt)
    np.testing.assert_array_equal(np.asarray(k8j), k8t.numpy())
    np.testing.assert_array_equal(np.asarray(vsj), vst.numpy())
    np.testing.assert_array_equal(np.asarray(ksj), kst.numpy())
    out8 = tops.gqa_decode(qt, k8t, v8t, pt, kst, vst)
    _close(jops.gqa_decode(qj, k8j, v8j, pj, ksj, vsj), out8, 2e-5)
    _close(jops.gqa_decode(qj, k8j, v8j, pj, ksj, vsj, use_ref=True), out8,
           2e-5)
    assert float(np.max(np.abs(out8.numpy() - np.asarray(r)))) < 0.02


def test_dense_decode_bf16_cache_vs_reference():
    nq, nkv, hd, B, S = 8, 2, 64, 2, 640
    rng = np.random.default_rng(0)
    q = _normal(rng, (B, nq, hd))
    kc = jnp.asarray(_normal(rng, (B, S, nkv, hd)), jnp.bfloat16)
    vc = jnp.asarray(_normal(rng, (B, S, nkv, hd)), jnp.bfloat16)
    # the same bf16 values on both sides (bf16 -> f32 is exact)
    kt = torch.from_numpy(np.asarray(kc, np.float32)).bfloat16()
    vt = torch.from_numpy(np.asarray(vc, np.float32)).bfloat16()
    pos = np.asarray([S - 1, S // 3], np.int32)
    out = tops.gqa_decode(torch.from_numpy(q), kt, vt, torch.from_numpy(pos))
    _close(jops.gqa_decode(jnp.asarray(q), kc, vc, jnp.asarray(pos)), out,
           5e-3)
    _close(jops.gqa_decode(jnp.asarray(q), kc, vc, jnp.asarray(pos),
                           use_ref=True), out, 5e-3)


def _pool_case(nkv, qpk, hd, ps, maxp, n_pages, seed):
    """Disjoint per-slot page lists in shuffled physical order; entries
    past each slot's allocation point at the trash page (row P - 1)."""
    B, P = 3, n_pages + 1
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, nkv * qpk, hd))
    pk = _normal(rng, (P, ps, nkv, hd))
    pv = _normal(rng, (P, ps, nkv, hd))
    perm = rng.permutation(n_pages)
    pt = np.full((B, maxp), n_pages, np.int32)
    used, pos = 0, []
    for b in range(B):
        npg = int(rng.integers(1, min(maxp, n_pages - used - (B - 1 - b))
                               + 1))
        pt[b, :npg] = perm[used:used + npg]
        used += npg
        pos.append(npg * ps - int(rng.integers(1, ps)))
    return q, pk, pv, pt, np.asarray(pos, np.int32)


@pytest.mark.parametrize("nkv,qpk,hd,ps,maxp,n_pages",
                         [(2, 4, 64, 16, 8, 20), (4, 1, 64, 8, 16, 40)])
def test_paged_decode_vs_reference(nkv, qpk, hd, ps, maxp, n_pages):
    q, pk, pv, pt, pos = _pool_case(nkv, qpk, hd, ps, maxp, n_pages,
                                    nkv * hd + ps)
    (qj, qt), (kj, kt), (vj, vt) = _both(q), _both(pk), _both(pv)
    (ptj, ptt), (pj, pst) = _both(pt), _both(pos)
    out = tops.paged_gqa_decode(qt, kt, vt, ptt, pst)
    r = jops.paged_gqa_decode(qj, kj, vj, ptj, pj, use_ref=True)
    _close(jops.paged_gqa_decode(qj, kj, vj, ptj, pj), out, 2e-5)
    _close(r, out, 2e-5)
    # the paged twin is the dense twin on the gathered pages, exactly
    B = q.shape[0]
    gk = kt[ptt.long()].reshape(B, maxp * ps, nkv, hd)
    gv = vt[ptt.long()].reshape(B, maxp * ps, nkv, hd)
    assert torch.equal(tops.gqa_decode(qt, gk, gv, pst), out)
    k8j, ksj = jquant(kj)
    v8j, vsj = jquant(vj)
    k8t, kst = tda.quantize_kv(kt)
    v8t, vst = tda.quantize_kv(vt)
    out8 = tops.paged_gqa_decode(qt, k8t, v8t, ptt, pst, kst, vst)
    _close(jops.paged_gqa_decode(qj, k8j, v8j, ptj, pj, ksj, vsj), out8,
           2e-5)
    assert float(np.max(np.abs(out8.numpy() - np.asarray(r)))) < 0.02


def test_trash_page_contents_never_reach_the_output():
    q, pk, pv, pt, pos = _pool_case(2, 4, 64, 16, 8, 20, 7)
    assert (pt == 20).any()                    # some entries are trash
    args = [torch.from_numpy(x) for x in (q, pk, pv, pt, pos)]
    clean = tops.paged_gqa_decode(*args)
    for t in (args[1], args[2]):
        t[-1] = torch.from_numpy(np.random.default_rng(1).standard_normal(
            t.shape[1:]).astype(np.float32) * 1e3)
    assert torch.equal(tops.paged_gqa_decode(*args), clean)


def test_wrappers_check_their_operands():
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):
        tda._check(q, k.to(torch.int8), k.to(torch.int8), pos, None, None, 2)
    with pytest.raises(ValueError, match="int32"):
        tda._check(q, k, k, pos.long(), None, None, 2)
    with pytest.raises(ValueError, match="head layout"):
        tda._check(torch.zeros(2, 3, 16), k, k, pos, None, None, 2)
    assert tda._check(q, k, k, pos, None, None, 2) == (2, 4, 16, 2)
    with pytest.raises(ValueError, match="shared memory"):
        tda._smem_check(8, 128, 4, 1 << 16, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the Hopper kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _long_pool_case(B, seed):
    """The long-pool widths of chip_smoke.py phase 7 with fewer slots: pos
    drawn from [2048, 4095], 16-position pages, 256 per slot, permuted
    over a pool of B * 256 + 1 pages; entries past a slot's pages on the
    trash page (the last row)."""
    ps, maxp, nkv, qpk, hd = 16, 256, 2, 8, 128
    rng = np.random.default_rng(seed)
    n_pages = B * maxp
    q = _normal(rng, (B, nkv * qpk, hd))
    pk = _normal(rng, (n_pages + 1, ps, nkv, hd))
    pv = _normal(rng, (n_pages + 1, ps, nkv, hd))
    pos = rng.integers(2048, 4096, B).astype(np.int32)
    perm = rng.permutation(n_pages)
    pt = np.full((B, maxp), n_pages, np.int32)
    used = 0
    for b in range(B):
        n = int(pos[b]) // ps + 1
        pt[b, :n] = perm[used:used + n]
        used += n
    return q, pk, pv, pt, pos


@pytest.mark.cuda
def test_decode_kernels_vs_twins_on_card(cuda_device):
    tda.reset_launches()
    for case in (_pool_case(2, 8, 128, 16, 8, 20, 3), _long_pool_case(4, 5)):
        q, pk, pv, pt, pos = (torch.from_numpy(x).to(cuda_device)
                              for x in case)
        B, nkv, hd = q.shape[0], pk.shape[2], pk.shape[3]
        qb, kb, vb = q.bfloat16(), pk.bfloat16(), pv.bfloat16()
        out = tops.paged_gqa_decode(qb, kb, vb, pt, pos)
        r = tref.paged_gqa_decode_ref(qb, kb, vb, pt, pos)
        gk = kb[pt.long()].reshape(B, -1, nkv, hd).contiguous()
        gv = vb[pt.long()].reshape(B, -1, nkv, hd).contiguous()
        dense = tops.gqa_decode(qb, gk, gv, pos)
        gk32 = pk[pt.long()].reshape(B, -1, nkv, hd).contiguous()
        gv32 = pv[pt.long()].reshape(B, -1, nkv, hd).contiguous()
        dense32 = tops.gqa_decode(q, gk32, gv32, pos)
        torch.cuda.synchronize()
        assert float((out - r).abs().max()) < 5e-3
        assert torch.equal(out, dense)       # paged == dense, bit for bit
        assert float((dense32 - tref.gqa_decode_ref(q, gk32, gv32, pos))
                     .abs().max()) < 2e-5
    assert tda.LAUNCHES == {"flash_gqa_decode": 4,
                            "paged_flash_gqa_decode": 2}
