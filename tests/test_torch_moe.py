"""The port's mixture-of-experts family against the reference's, in
float32 on the CPU: the dropless token path against
``repro.models.moe.moe_apply(dropless=True)`` (equal expert indices,
outputs to ATOL), smoke ``qwen2-moe-a2.7b`` prefill / extend / decode
logits (ATOL, as tests/test_torch_model.py), the fixed-batch engine's
streams and wire bytes (the pin of tests/test_torch_engine.py: every
integer field equal, the float32 beta trajectory within the recorded
ulps), and the per-leaf init scales of ``bridge.init_params``.
"""
import dataclasses
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
from repro.models import (decode_step, extend_step, init_params,  # noqa: E402
                          prefill)
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402

from test_torch_engine import _draft_ulps, _verdict_ulps  # noqa: E402

ATOL = 1e-4
ARCH = "qwen2-moe-a2.7b"
ROUNDS, L_MAX, K = 3, 3, 16
# the divergence measured at these seeds, per round: the largest ulp
# distance of (a payload's beta, a verdict's beta);
# every case not listed is byte-equal
ULPS = {"csqs": [(1, 1), (1, 1), (2, 1)]}


def _cfgs(**over):
    jc = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.get_config(ARCH)), **over)
    tc = dataclasses.replace(
        configs.smoke_variant(configs.get_config(ARCH)), **over)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


# the smoke variant (4 experts, top-2, 1 shared) and a wider router
# (16 experts, top-4, 2 shared), as the full config has 60 top-4 + 4
MOE_CASES = {"smoke": {}, "e16k4": dict(n_experts=16, moe_top_k=4,
                                        n_shared_experts=2)}


@pytest.mark.parametrize("T", [1, 40])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_tokens_match_reference(case, T):
    jc, tc = _cfgs(**MOE_CASES[case])
    p = jmoe.init_moe(jax.random.PRNGKey(T), jc)
    m = MoE(tc, torch.float32, "cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(m, name).copy_(torch.from_numpy(np.array(p[name])))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(m.shared, name).copy_(
                torch.from_numpy(np.array(p["shared"][name])))
    x = np.random.default_rng(T).standard_normal(
        (T, jc.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    _, ref_idx = jax.lax.top_k(probs, jc.moe_top_k)
    gate, idx, _ = m.route(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert np.allclose(gate.sum(-1).numpy(), 1.0, atol=1e-6)
    y_ref, _ = jmoe.moe_apply(jc, p, jnp.asarray(x)[None], dropless=True)
    with torch.no_grad():
        y = m(torch.from_numpy(x)[None])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)


def test_route_breaks_ties_toward_the_lower_index():
    """Equal router probabilities: ``jax.lax.top_k`` keeps the lower
    expert index first, and so does the port."""
    _, tc = _cfgs(**MOE_CASES["e16k4"])
    m = MoE(tc, torch.float32, "cpu")
    with torch.no_grad():
        m.router.zero_()
    _, idx, _ = m.route(torch.ones((3, tc.d_model)))
    assert idx.tolist() == [[0, 1, 2, 3]] * 3


def _numpy_params(cfg, seed):
    return jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _bridged(which):
    jc, tc = _cfgs()
    if which == "draft2x":
        jc, tc = jconfigs.draft_variant(jc, 2), configs.draft_variant(tc, 2)
    params = _numpy_params(jc, 21 if which == "target" else 22)
    return jc, jax.tree.map(jnp.asarray, params), \
        bridge.from_jax(params, tc, device="cpu")


@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("which", ["target", "draft2x"])
def test_prefill_extend_decode_logits(which, L):
    jc, jp, m = _bridged(which)
    rng = np.random.default_rng(L)
    toks = rng.integers(0, jc.vocab, (3, 9)).astype(np.int32)
    lj, cj = prefill(jc, jp, jnp.asarray(toks), cache_len=32)
    lt, ct = tmodel.prefill(m, torch.from_numpy(toks).long(), cache_len=32)
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    pos = np.array([9, 7, 4], np.int32)
    new = rng.integers(0, jc.vocab, (3, L)).astype(np.int32)
    lj, cj = extend_step(jc, jp, jnp.asarray(new), cj, jnp.asarray(pos))
    lt, ct, _ = tmodel.extend_step(m, torch.from_numpy(new).long(), ct,
                                   torch.from_numpy(pos).long())
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    tok = rng.integers(0, jc.vocab, (3,)).astype(np.int32)
    lj, _ = decode_step(jc, jp, jnp.asarray(tok), cj, jnp.asarray(pos + L))
    lt, _ = tmodel.decode_step(m, torch.from_numpy(tok).long(), ct,
                               torch.from_numpy(pos + L).long())
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)


@functools.lru_cache(maxsize=None)
def _engine_pair():
    tj, tp, tm = _bridged("target")
    dj, dp, dm = _bridged("draft2x")
    prompts = np.random.default_rng(5).integers(0, tj.vocab, (2, 8))
    return (dj, dp, tj, tp), (dm.cfg, dm, tm.cfg, tm), prompts


def _reference_run(method, engines):
    """Run the reference engine, recording its packed payloads and
    verdicts per round (its round records keep neither)."""
    (dc, dp, tc, tp), _, prompts = engines
    eng = RefEngine(dc, dp, tc, tp, RefMethodConfig(method, K=K),
                    RefEngineConfig(L_max=L_MAX), seed=11)
    packed, verdicts = [], []
    draft, pack_verdict = eng.edge.draft, eng.pack_verdict_slot

    def record_draft(mask):
        db = draft(mask)
        packed.append(dict(db.packed))
        verdicts.append({})
        return db

    def record_verdict(slot, v):
        verdicts[-1][slot] = pack_verdict(slot, v)
        return verdicts[-1][slot]
    eng.edge.draft = record_draft
    eng.pack_verdict_slot = record_verdict
    rounds, toks = eng.run(prompts, ROUNDS)
    for r, p, v in zip(rounds, packed, verdicts):
        r["packed"], r["verdict_packed"] = p, v
    return rounds, toks


@pytest.mark.parametrize("method", ["ksqs", "csqs"])
def test_engine_matches_reference(method):
    (dc, dp, tc, tp), (tdc, dm, ttc, tm), prompts = _engine_pair()
    rounds, toks = _reference_run(method, _engine_pair())
    eng = EdgeCloudEngine(tdc, dm, ttc, tm,
                          MethodConfig(method, K=K, use_kernels=False),
                          EngineConfig(L_max=L_MAX), seed=11, device="cpu")
    got, got_toks = eng.run(prompts, ROUNDS)
    assert got_toks == toks, "token streams diverged"
    fmt = twire.WireFormat(V=tc.vocab, ell=100, L_max=L_MAX)
    ulps = []
    for r, g in zip(rounds, got):
        for key in ("n_accept", "L_live", "rejected"):
            np.testing.assert_array_equal(r[key], g[key], err_msg=key)
        assert sorted(g["packed"]) == sorted(r["packed"])
        ulps.append((
            max(_draft_ulps(method, fmt, data, g["packed"][s])
                for s, data in r["packed"].items()),
            max(_verdict_ulps(method, fmt, data, g["verdict_packed"][s])
                for s, data in r["verdict_packed"].items())))
    assert ulps == ULPS.get(method, [(0, 0)] * ROUNDS)


def test_init_params_expert_scales():
    """Each leaf is drawn with std 1/sqrt(the fan-in the reference's
    ``init_moe`` passes): d for the router and the expert gate/up
    stacks (E, d, f), f for the down stack (E, f, d), and the shared
    MLP's own input widths."""
    _, tc = _cfgs(**MOE_CASES["e16k4"])
    m = bridge.init_params(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    d, f = tc.d_model, tc.d_expert
    moe = m.layers[0].moe
    fans = {"router": (moe.router, d), "w_gate": (moe.w_gate, d),
            "w_up": (moe.w_up, d), "w_down": (moe.w_down, f),
            "shared/w_gate": (moe.shared.w_gate, d),
            "shared/w_down": (moe.shared.w_down,
                              tc.n_shared_experts * f)}
    for name, (w, fan) in fans.items():
        assert abs(float(w.std()) * np.sqrt(fan) - 1.0) < 0.06, name
    assert torch.equal(m.layers[0].norm2, torch.ones_like(m.layers[0].norm2))
