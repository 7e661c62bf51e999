"""Core protocol math of the port against the JAX reference on the same
numpy inputs: lattice quantization, the SQS sparsifiers, verification,
the conformal update (all exact), the bit tables (1e-5 relative) and the
wire codecs (byte-equal)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bits as jbits  # noqa: E402
from repro.core import conformal as jconf  # noqa: E402
from repro.core import slq as jslq  # noqa: E402
from repro.core import sqs as jsqs  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro_torch.core import bits as tbits  # noqa: E402
from repro_torch.core import conformal as tconf  # noqa: E402
from repro_torch.core import slq as tslq  # noqa: E402
from repro_torch.core import sqs as tsqs  # noqa: E402
from repro_torch.core import verify as tverify  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402


def _probs(rng, B, V, scale=3.0):
    x = rng.standard_normal((B, V)) * scale
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# the reference runs these jitted inside its engine: XLA turns the
# division by the constant ℓ into a multiplication, which the port mirrors
@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


@pytest.mark.parametrize("B,V,ell,density", [(2, 64, 100, 0.3),
                                             (3, 512, 100, 0.9),
                                             (4, 1000, 7, 0.05),
                                             (2, 4096, 1000, 0.5)])
def test_lattice_quantize_exact(B, V, ell, density):
    rng = np.random.default_rng(V + ell)
    q = _probs(rng, B, V)
    mask = rng.random((B, V)) < density
    mask[:, 0] = True
    qm = np.where(mask, q, 0.0)
    qt = (qm / qm.sum(-1, keepdims=True)).astype(np.float32)
    jq, jb = _jit(jslq.lattice_quantize, 1)(qt, ell, mask)
    tq, tb = tslq.lattice_quantize(_t(qt), ell, _t(mask))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert (tb.numpy().sum(-1) == ell).all()


@pytest.mark.parametrize("B,V", [(2, 512), (3, 1000), (2, 4096)])
@pytest.mark.parametrize("K,ell", [(1, 100), (16, 100), (64, 50)])
def test_sparsify_topk_exact(B, V, K, ell):
    q = _probs(np.random.default_rng(B * V + K), B, V)
    j = _jit(jsqs.sparsify_topk, 1, 2)(q, K, ell)
    t = tsqs.sparsify_topk(_t(q), K, ell)
    np.testing.assert_array_equal(np.asarray(j.mask), t.mask.numpy())
    np.testing.assert_array_equal(np.asarray(j.K), t.K.numpy())
    np.testing.assert_array_equal(np.asarray(j.q_hat), t.q_hat.numpy())
    np.testing.assert_allclose(np.asarray(j.dropped), t.dropped.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("B,V", [(2, 512), (3, 1000), (2, 4096)])
@pytest.mark.parametrize("beta", [1e-3, 2e-3, 0.05, -1.0])
def test_sparsify_threshold_exact(B, V, beta):
    q = _probs(np.random.default_rng(B + V), B, V)
    b = np.full((B,), beta, np.float32)
    j = _jit(jsqs.sparsify_threshold, 2)(q, b, 100)
    t = tsqs.sparsify_threshold(_t(q), _t(b), 100)
    np.testing.assert_array_equal(np.asarray(j.mask), t.mask.numpy())
    np.testing.assert_array_equal(np.asarray(j.K), t.K.numpy())
    np.testing.assert_array_equal(np.asarray(j.q_hat), t.q_hat.numpy())
    np.testing.assert_allclose(np.asarray(j.dropped), t.dropped.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("V,ell", [(512, 100), (1000, 1000)])
def test_dense_qs_exact(V, ell):
    q = _probs(np.random.default_rng(V), 3, V)
    j = _jit(jsqs.dense_qs, 1)(q, ell)
    t = tsqs.dense_qs(_t(q), ell)
    np.testing.assert_array_equal(np.asarray(j.q_hat), t.q_hat.numpy())
    np.testing.assert_array_equal(np.asarray(j.K), t.K.numpy())
    assert t.mask.all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("B,L,V", [(2, 3, 512), (4, 8, 1000)])
def test_verify_per_row_keys_exact(seed, B, L, V):
    rng = np.random.default_rng(seed)
    q = _probs(rng, B * L, V, scale=1.0).reshape(B, L, V)
    qhat = np.asarray(_jit(jslq.lattice_quantize, 1)(
        q.reshape(B * L, V), 100)[0]).reshape(B, L, V)
    p = _probs(rng, B * (L + 1), V, scale=1.0).reshape(B, L + 1, V)
    # draft tokens sampled from q̂ (on its support), as the edge does
    drafts = np.stack([[rng.choice(V, p=qhat[b, i] / qhat[b, i].sum())
                        for i in range(L)] for b in range(B)])
    live = np.ones((B, L), bool)
    live[0, L // 2:] = False
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    j = _jit(jverify.verify)(keys, drafts.astype(np.int32), qhat, p, live)
    t = tverify.verify(_t(np.asarray(keys).astype(np.int64)),
                       _t(drafts), _t(qhat), _t(p), _t(live))
    np.testing.assert_array_equal(np.asarray(j.n_accept), t.n_accept.numpy())
    np.testing.assert_array_equal(np.asarray(j.new_token),
                                  t.new_token.numpy())
    np.testing.assert_array_equal(np.asarray(j.rejected), t.rejected.numpy())
    np.testing.assert_array_equal(np.asarray(j.accept_mask),
                                  t.accept_mask.numpy())
    np.testing.assert_allclose(
        np.asarray(jverify.acceptance_prob(qhat, p[:, :L])),
        tverify.acceptance_prob(_t(qhat), _t(p[:, :L])).numpy(), atol=1e-6)


@pytest.mark.parametrize("alpha,eta", [(5e-4, 1e-3), (0.01, 0.05)])
def test_conformal_update_bits(alpha, eta):
    rng = np.random.default_rng(7)
    beta = rng.uniform(-1e-3, 2e-3, 4096).astype(np.float32)
    dropped = rng.uniform(0, 1, 4096).astype(np.float32)
    j = _jit(jconf.update, 2, 3)(beta, dropped, alpha, eta)
    t = tconf.update(_t(beta), _t(dropped), alpha, eta)
    np.testing.assert_array_equal(np.asarray(j).view(np.int32),
                                  t.numpy().view(np.int32))
    fresh = rng.random(4096) < 0.3
    np.testing.assert_array_equal(
        np.asarray(jconf.admit_rows(beta, fresh, 1e-3)),
        tconf.admit_rows(_t(beta), _t(fresh), 1e-3).numpy())
    assert tconf.beta_envelope(alpha, eta) == jconf.beta_envelope(alpha, eta)
    assert tconf.backtrack_wire((0.5, 0.25), 1) == \
        jconf.backtrack_wire((0.5, 0.25), 1)


@pytest.mark.parametrize("seed", range(3))
def test_backtrack_selects_kept_updates(seed):
    """``backtrack`` against ``repro.core.conformal.backtrack``: the
    reference's own case (tests/test_conformal.py), then random (L+1, B)
    trajectories with n_keep in [-2, L + 3] (clipped to [0, L])."""
    traj = np.asarray([[0.5, 0.5], [0.4, 0.45], [0.3, 0.40], [0.2, 0.35]],
                      np.float32)
    keep = np.asarray([2, 0])
    np.testing.assert_array_equal(tconf.backtrack(_t(traj), _t(keep)).numpy(),
                                  np.asarray(jconf.backtrack(traj, keep)))
    rng = np.random.default_rng(seed)
    L, B = int(rng.integers(1, 9)), int(rng.integers(1, 6))
    traj = rng.uniform(-1e-3, 2e-3, (L + 1, B)).astype(np.float32)
    keep = rng.integers(-2, L + 4, B)
    got = tconf.backtrack(_t(traj), _t(keep))
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jconf.backtrack(traj, keep)))


@pytest.mark.parametrize("V,ell", [(512, 100), (151936, 100), (50257, 7)])
def test_token_bits_and_gap_code(V, ell):
    rng = np.random.default_rng(V)
    for K in (1.0, 16.0, 64.0, float(V)):
        np.testing.assert_allclose(
            tbits.token_bits(V, K, ell, adaptive=False),
            float(jbits.token_bits(V, K, ell, adaptive=False)), rtol=1e-5)
    Ks = rng.integers(1, V + 1, 32).astype(np.float32)
    np.testing.assert_allclose(
        tbits.token_bits(V, _t(Ks), ell, adaptive=True).numpy(),
        np.asarray(jbits.token_bits(V, jnp.asarray(Ks), ell, adaptive=True)),
        rtol=1e-5)
    np.testing.assert_allclose(
        tbits.payload_bits(_t(Ks), ell).numpy(),
        np.asarray(jbits.payload_bits(jnp.asarray(Ks), ell)), rtol=1e-5)
    np.testing.assert_allclose(tbits.dense_qs_bits(V, ell),
                               float(jbits.dense_qs_bits(V, ell)), rtol=1e-5)
    assert tbits.uncompressed_bits(V) == jbits.uncompressed_bits(V)
    Vm = min(V, 4096)
    mask = rng.random((3, Vm)) < np.array([[0.01], [0.3], [0.9]])
    np.testing.assert_allclose(
        tbits.gap_code_subset_bits(_t(mask)).numpy(),
        np.asarray(jbits.gap_code_subset_bits(jnp.asarray(mask))),
        rtol=1e-5)


def _payloads(rng, V, ell, L, raw):
    """The same random payloads in both packages' dataclasses."""
    out = []
    for n in range(L + 1):
        toks = tuple(int(t) for t in rng.integers(0, V, n))
        betas = tuple(float(b) for b in rng.uniform(-1e-3, 2e-3, n + 1)
                      .astype(np.float32))
        if raw:
            probs = tuple(tuple(float(x) for x in _probs(rng, 1, V)[0])
                          for _ in range(n))
            kw = dict(supports=((),) * n, counts=((),) * n, probs=probs)
        else:
            sups, cnts = [], []
            for _ in range(n):
                K = int(rng.choice([1, 3, V // 4, V]))
                sup = np.sort(rng.choice(V, K, replace=False))
                b = np.asarray(jslq.lattice_quantize(
                    jnp.asarray(_probs(rng, 1, K)), ell)[1])[0]
                keep = b > 0
                sups.append(tuple(int(i) for i in sup[keep]))
                cnts.append(tuple(int(c) for c in b[keep]))
            kw = dict(supports=tuple(sups), counts=tuple(cnts))
        out.append((dict(tokens=toks, betas=betas, **kw)))
    return out


@pytest.mark.parametrize("codec", ["v1", "v2"])
@pytest.mark.parametrize("mode", ["lattice", "raw"])
def test_wire_pack_byte_equal(codec, mode):
    rng = np.random.default_rng(3 if mode == "raw" else 4)
    V, ell, L = 512, 100, 4
    jf = jwire.WireFormat(V=V, ell=ell, L_max=L, mode=mode, codec=codec)
    tf = twire.WireFormat(V=V, ell=ell, L_max=L, mode=mode, codec=codec)
    for kw in _payloads(rng, V, ell, L, mode == "raw"):
        jb = jf.pack_draft(jwire.DraftPayload(**kw))
        tb = tf.pack_draft(twire.DraftPayload(**kw))
        assert jb == tb
        assert tf.unpack_draft(tb) == twire.DraftPayload(
            **{k: v for k, v in jf.unpack_draft(jb).__dict__.items()})
    items = []
    for slot in range(5):
        v = dict(n_accept=int(rng.integers(0, L + 1)),
                 new_token=int(rng.integers(0, V)),
                 beta_next=float(np.float32(rng.uniform(-1e-3, 2e-3))))
        jb = jf.pack_verdict(jwire.VerdictPayload(**v))
        tb = tf.pack_verdict(twire.VerdictPayload(**v))
        assert jb == tb
        items.append((slot * 2, v))
    jb = jf.pack_verdict_batch(
        [(s, jwire.VerdictPayload(**v)) for s, v in items], 10)
    tb = tf.pack_verdict_batch(
        [(s, twire.VerdictPayload(**v)) for s, v in items], 10)
    assert jb == tb
    assert [(s, v.__dict__) for s, v in tf.unpack_verdict_batch(tb, 10)] \
        == [(s, v) for s, v in items]
