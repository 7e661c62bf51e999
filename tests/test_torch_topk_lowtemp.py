"""K-SQS at low temperature: the port's fused path against the reference's
exact top-K rule, and the faults of the reference it repairs.

The reference's top-K search (``repro.kernels.sqs_fused._topk_kernel``
and its twin) bisects [0, max q] in 40 float steps, so it cannot go
below max q * 2^-40.  Where the K-th largest tempered probability lies
lower ((x_max - x_K) / T > 40 ln 2), its lo stays 0, every token is a
candidate, and the exact-K trim keeps tokens 0..K-1 by index: the support
loses the argmax (ROADMAP Queue 3 item 12).  The port's search returns
the exact K-th value at any temperature.

The reference's jnp rule (``repro.core.sqs.sparsify_topk``) finds the
K-th value with ``lax.top_k`` but then keeps the first K of q >= kth by
index.  Where fewer than K probabilities are nonzero in float32 (kth = 0,
as at T 0.05 and logit std 8) that keeps zeros and drops the whole mass.
The port keeps ``lax.top_k``'s index set (every q above the K-th value,
ties at it by index): it equals ``sparsify_topk`` on every row where
that rule keeps every q above the K-th value, and the reference's top-K
set with its own lattice (``lattice_quantize``) on every row.

The port's probabilities flush float32 subnormals to 0, as XLA's CPU
code does (``core.sqs.flush_subnormal``).  Counts (q̂ * ℓ) are compared
exactly; q̂ itself within one float32 ulp, since the fused paths scale b
by the float32 reciprocal of ℓ (as XLA rewrites the Pallas path's
``b / ell``) where ``lattice_quantize`` divides.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.core import sqs as jsqs  # noqa: E402
from repro.core.slq import lattice_quantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)
from repro_torch.kernels import ops as tops  # noqa: E402

V, B, ELL = 512, 4, 100
TEMPS = [1.0, 0.5, 0.2, 0.05]
STDS = [1.0, 3.0, 8.0]
KS = [1, 16, 64, V]
DROPPED_ATOL = 1e-6


def _logits(std, temp):
    rng = np.random.default_rng(int(std * 100 + temp * 1000))
    return (rng.standard_normal((B, V)) * std).astype(np.float32)


def _counts(q_hat, ell=ELL):
    return np.rint(np.asarray(q_hat, np.float64) * ell).astype(np.int64)


def _same_as(want, got, rows=slice(None)):
    """Equal mask, K and lattice counts, q̂ within an ulp, dropped mass
    within DROPPED_ATOL, on ``rows``."""
    wq, gq = np.asarray(want.q_hat)[rows], got.q_hat.numpy()[rows]
    np.testing.assert_array_equal(np.asarray(want.mask)[rows],
                                  got.mask.numpy()[rows])
    np.testing.assert_array_equal(np.asarray(want.K)[rows],
                                  got.K.numpy()[rows])
    np.testing.assert_array_equal(_counts(wq), _counts(gq))
    ulps = np.abs(wq.astype(np.float32).view(np.int32).astype(np.int64)
                  - gq.view(np.int32).astype(np.int64))
    assert (ulps <= 1).all(), ulps.max()
    np.testing.assert_allclose(np.asarray(want.dropped)[rows],
                               got.dropped.numpy()[rows], rtol=0,
                               atol=DROPPED_ATOL)


def topk_set(q, K):
    """The K largest probabilities by ``lax.top_k``'s indices (ties to the
    earliest index), renormalised and lattice-quantized as
    ``sparsify_topk`` does."""
    idx = jax.lax.top_k(q, K)[1]
    mask = jnp.zeros(q.shape, bool).at[jnp.arange(q.shape[0])[:, None],
                                       idx].set(True)
    dropped = jnp.where(mask, 0.0, q).sum(-1)
    q_hat, _ = lattice_quantize(jsqs._renormalize(q, mask), ELL, mask)
    return jsqs.SQSResult(q_hat, mask, dropped,
                          mask.sum(-1).astype(jnp.int32))


@pytest.mark.parametrize("std", STDS)
@pytest.mark.parametrize("temp", TEMPS)
def test_fused_topk_equals_sparsify_topk(temp, std):
    """Every row equals the top-K set; every row where ``sparsify_topk``
    keeps each q above its K-th value equals ``sparsify_topk``; the
    others have K-th value 0, and there ``sparsify_topk`` cuts a nonzero
    probability for a zero."""
    logits = _logits(std, temp)
    q = jsqs.softmax_temp(jnp.asarray(logits), temp)
    n_lost = 0
    for K in KS:
        got = tops.sqs_topk(torch.from_numpy(logits), K, temperature=temp,
                            ell=ELL)
        want = topk_set(q, K)
        _same_as(want, got)
        assert (got.K.numpy() == K).all()
        assert (_counts(got.q_hat).sum(-1) == ELL).all()
        jnp_rule = jsqs.sparsify_topk(q, K, ELL)
        same = (np.asarray(jnp_rule.mask) == np.asarray(want.mask)).all(-1)
        _same_as(jnp_rule, got, same)
        kth = np.asarray(jax.lax.top_k(q, K)[0][:, -1])
        assert (kth[~same] == 0).all()
        cut = (np.asarray(q) > 0) & ~np.asarray(jnp_rule.mask)
        assert cut[~same].any(-1).all()
        n_lost += int((~same).sum())
    if temp >= 0.5:
        assert n_lost == 0


def test_fused_topk_with_an_underflowing_kth_value():
    """Rows whose K-th value is 0 in float32: lo = 0; the support is the
    nonzero probabilities and then zeros by index.  ``sparsify_topk``
    agrees where the nonzero ones lie among the first K indices (row 0)
    and drops their mass where they do not (row 1)."""
    logits = np.full((2, V), -200.0, np.float32)
    logits[0, [3, 7, 11]] = [0.0, -3.0, -5.0]
    logits[1, [7, 300, 301]] = [0.0, -3.0, -5.0]
    K = 16
    q = jsqs.softmax_temp(jnp.asarray(logits), 1.0)
    assert (np.asarray(jax.lax.top_k(q, K)[0][:, -1]) == 0.0).all()
    got = tops.sqs_topk(torch.from_numpy(logits), K, ell=ELL)
    _same_as(topk_set(q, K), got)
    mask = got.mask.numpy()
    assert mask[0, [3, 7, 11]].all() and mask[1, [7, 300, 301]].all()
    assert (mask.sum(-1) == K).all()
    jnp_rule = jsqs.sparsify_topk(q, K, ELL)
    _same_as(jnp_rule, got, slice(0, 1))
    assert float(jnp_rule.dropped[1]) > 0.05 > float(got.dropped[1])


@functools.lru_cache(maxsize=None)
def _pallas_topk(K, temp):
    return jax.jit(functools.partial(jops.sqs_topk, K=K, temperature=temp,
                                     ell=ELL))


@pytest.mark.parametrize("temp", TEMPS)
def test_reference_pallas_path_equals_port_where_right(temp):
    """The reference's Pallas path (interpreted) equals the port byte for
    byte on every row where its support is the top-K set, which at T 1 is
    every row; at std 8 and T 0.2 it drops all the mass of some rows (the
    fault), where the port drops none."""
    n_right = n_rows = 0
    for std in STDS:
        logits = _logits(std, temp)
        q = jsqs.softmax_temp(jnp.asarray(logits), temp)
        for K in (16, 64):
            pallas = _pallas_topk(K, temp)(jnp.asarray(logits))
            right = (np.asarray(pallas.mask)
                     == np.asarray(topk_set(q, K).mask)).all(-1)
            got = tops.sqs_topk(torch.from_numpy(logits), K,
                                temperature=temp, ell=ELL)
            for r in np.nonzero(right)[0]:
                np.testing.assert_array_equal(np.asarray(pallas.q_hat)[r],
                                              got.q_hat.numpy()[r])
                np.testing.assert_array_equal(np.asarray(pallas.mask)[r],
                                              got.mask.numpy()[r])
                assert int(pallas.K[r]) == int(got.K[r])
                assert abs(float(pallas.dropped[r])
                           - float(got.dropped[r])) <= DROPPED_ATOL
            n_right += int(right.sum())
            n_rows += right.size
            if std == 8.0 and temp == 0.2:
                assert (np.asarray(pallas.dropped) >= 0.99).any()
                assert (got.dropped.numpy() <= 1e-6).all()
    if temp == 1.0:
        assert n_right == n_rows          # the fault needs a 27.7-nat gap
    else:
        assert n_right < n_rows


# ----------------------------------------------------------------------
# the engines: the port's default against the reference's default
# ----------------------------------------------------------------------
ROUNDS, L_MAX, K_ENGINE = 6, 3, 16


@functools.lru_cache(maxsize=None)
def _self_pair():
    """The smoke qwen2.5-3b as its own draft, so rows accept tokens."""
    tc = jconfigs.smoke_variant(jconfigs.get_config("qwen2.5-3b"))
    tp = init_params(tc, jax.random.PRNGKey(8))
    ttc = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    tm = bridge.from_jax(jax.tree.map(np.asarray, tp), ttc, device="cpu")
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(9), (2, 8),
                                            0, tc.vocab))
    return (tc, tp), (ttc, tm), prompts


def _reference_run(temp):
    (tc, tp), _, prompts = _self_pair()
    eng = RefEngine(tc, tp, tc, tp, RefMethodConfig("ksqs", K=K_ENGINE),
                    RefEngineConfig(L_max=L_MAX, temperature=temp), seed=11)
    assert not eng.m.use_kernels          # the reference's default: jnp
    packed = []
    draft = eng.edge.draft

    def record_draft(mask):
        db = draft(mask)
        packed.append(dict(db.packed))
        return db
    eng.edge.draft = record_draft
    rounds, toks = eng.run(prompts, ROUNDS)
    return rounds, toks, packed


@pytest.mark.parametrize("temp", [0.05, 0.2])
def test_default_engine_equals_reference_default_at_low_temperature(temp):
    rounds, toks, packed = _reference_run(temp)
    _, (ttc, tm), prompts = _self_pair()
    eng = EdgeCloudEngine(ttc, tm, ttc, tm, MethodConfig("ksqs", K=K_ENGINE),
                          EngineConfig(L_max=L_MAX, temperature=temp),
                          seed=11, device="cpu")
    assert eng.m.use_kernels              # the port's default: fused path
    got, got_toks = eng.run(prompts, ROUNDS)
    assert got_toks == toks, "token streams diverged"
    for i, (r, g) in enumerate(zip(rounds, got)):
        for key in ("n_accept", "L_live", "rejected"):
            np.testing.assert_array_equal(r[key], g[key], err_msg=key)
        assert g["packed"] == packed[i], f"round {i}: payload bytes differ"
    accepted = sum(int(r["n_accept"].sum()) for r in rounds)
    assert accepted > ROUNDS              # the self-pair accepts drafts
