"""Sliding-window attention against the reference, in float32 on the
CPU, at the smoke ``qwen2.5-3b`` with ``attention="sliding"``,
parameters carried across by ``bridge.from_jax``:

- ``masked_attention`` with a window (and a key-validity mask) against
  ``repro.models.attention.masked_attention``;
- the ring: a prefill longer than W leaves the reference's ring of roped
  keys (dense and int8), ``decode_step``s through the ring past W give the
  reference's logits (ATOL, as tests/test_torch_model.py) and the
  windowed teacher-forced logits (the reference's tests/test_models.py
  ring test, 2e-4), and W >= S equals full attention;
- the wrap-after-rejection fault of the reference, mirrored: a rejected
  3-token draft on a wrapped ring gives the reference's (wrong) logits,
  on a ring that has not wrapped the clean path's;
- ``INPUT_SHAPES``, ``for_shape`` and ``supports_shape`` equal to the
  reference's for every architecture the port registers;
- the engine refuses a ring that would wrap (``WindowWrapError``, target
  or draft, fixed-batch or slots) and serves one that cannot: a trace
  at cache_len <= W equal to the reference's streams and summary.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig, WindowWrapError)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ATOL = 1e-4
ORACLE_ATOL = 2e-4              # the reference's ring test
ARCH = "qwen2.5-3b"
# the reference's ring test: W 8, 24 tokens, a 12-token prefill
W, S, S0 = 8, 24, 12
CSQS = dict(name="csqs", alpha=5e-3, eta=5e-2)
TRACE = dict(n_requests=4, rate_rps=6.0, prompt_len=10, min_new_tokens=3,
             max_new_tokens=7, vocab=512, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(window, draft=False, **over):
    jc = jconfigs.smoke_variant(jconfigs.get_config(ARCH))
    tc = configs.smoke_variant(configs.get_config(ARCH))
    if draft:
        jc, tc = jconfigs.draft_variant(jc, 2), configs.draft_variant(tc, 2)
    if window:
        over = dict(over, attention="sliding", sliding_window=window)
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _bridged(window, draft=False, seed=0, **over):
    jc, tc = _cfgs(window, draft, **over)
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jc, jax.random.PRNGKey(seed)))
    return jc, jax.tree.map(jnp.asarray, params), \
        bridge.from_jax(params, tc, device="cpu")


def _tokens(vocab, n=S):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, n), 0,
                                         vocab))


@pytest.mark.parametrize("window,valid", [(0, False), (3, False), (5, True),
                                          (16, False)])
def test_masked_attention_matches_reference(window, valid):
    rng = np.random.default_rng(window)
    B, Sq, nq, nkv, hd, hdv = 2, 12, 4, 2, 16, 8
    q = rng.standard_normal((B, Sq, nq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sq, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sq, nkv, hdv)).astype(np.float32)
    pos = (np.arange(Sq)[None] + np.array([[0], [5]])).astype(np.int32)
    k_valid = rng.random((B, Sq)) < 0.8 if valid else None
    if valid:
        k_valid[:, 0] = True                    # no query sees no key
    ref = jattn.masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), causal=True, window=window,
        k_valid=None if k_valid is None else jnp.asarray(k_valid))
    got = tattn.masked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos).long(), torch.from_numpy(pos).long(),
        causal=True, window=window,
        k_valid=None if k_valid is None else torch.from_numpy(k_valid))
    assert got.shape == (B, Sq, nq, hdv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_ring_prefill_and_decode_match_reference(kv):
    jc, jp, m = _bridged(W, kv_cache_dtype=kv)
    toks = _tokens(jc.vocab)
    full = jmodel.forward_logits(jc, jp, jnp.asarray(toks))
    got_full = tmodel.forward_logits(m, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got_full.numpy(), np.asarray(full), atol=ATOL)
    lj, cj = jmodel.prefill(jc, jp, jnp.asarray(toks[:, :S0]), cache_len=S)
    lt, ct = tmodel.prefill(m, torch.from_numpy(toks[:, :S0]).long(),
                            cache_len=S)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for i, c in enumerate(ct):
        for name, t in c.items():
            ref = np.asarray(cj["body"]["p0"][name][i])
            assert t.shape == ref.shape and t.shape[1] == W   # the ring
            np.testing.assert_allclose(t.float().numpy(),
                                       ref.astype(np.float32), atol=ATOL)
    pos = np.full((1,), S0, np.int32)
    for t in range(S0, S - 1):
        lj, cj = jmodel.decode_step(jc, jp, jnp.asarray(toks[:, t]), cj,
                                    jnp.asarray(pos))
        lt, ct = tmodel.decode_step(m, torch.from_numpy(toks[:, t]).long(),
                                    ct, torch.from_numpy(pos).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
        if kv == "compute":
            np.testing.assert_allclose(lt.numpy(), got_full[:, t].numpy(),
                                       atol=ORACLE_ATOL)
        pos = pos + 1


def test_window_wider_than_sequence_is_full_attention():
    """tests/test_models.py's W >= S check, on the port."""
    _, _, full = _bridged(0)
    _, _, wide = _bridged(64)
    toks = torch.from_numpy(_tokens(512, 12)).long()
    np.testing.assert_allclose(tmodel.forward_logits(wide, toks).numpy(),
                               tmodel.forward_logits(full, toks).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("window", [W, 64], ids=["wraps", "no-wrap"])
def test_wrap_after_rejection_mirrors_reference(window):
    """Prefill 12 tokens, verify the true token plus 3 junk drafts at
    position 12, keep 1 and decode the true token 13: the port gives the
    reference's logits; once the ring has wrapped both are far from the
    clean path's (the rejected drafts overwrote keys still in the window),
    before it they are the clean path's."""
    jc, jp, m = _bridged(window)
    toks = _tokens(jc.vocab)
    clean = tmodel.forward_logits(m, torch.from_numpy(toks).long())[:, 13]
    verify = np.array([[toks[0, S0], 5, 6, 7]], np.int32)
    _, cj = jmodel.prefill(jc, jp, jnp.asarray(toks[:, :S0]), cache_len=S)
    _, cj = jmodel.extend_step(jc, jp, jnp.asarray(verify), cj,
                               jnp.asarray([S0], jnp.int32))
    ref, _ = jmodel.decode_step(jc, jp, jnp.asarray(toks[:, S0 + 1]), cj,
                                jnp.asarray([S0 + 1], jnp.int32))
    _, ct = tmodel.prefill(m, torch.from_numpy(toks[:, :S0]).long(),
                           cache_len=S)
    _, ct, _ = tmodel.extend_step(m, torch.from_numpy(verify).long(), ct,
                                  torch.tensor([S0]))
    got, _ = tmodel.decode_step(m, torch.from_numpy(toks[:, S0 + 1]).long(),
                                ct, torch.tensor([S0 + 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    gap = float((got - clean).abs().max())
    if window == W:
        assert gap > 0.5, gap                  # 2.92 in the reference
    else:
        assert gap < ORACLE_ATOL, gap


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in
            configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in
         jconfigs.INPUT_SHAPES.items()}
    for name in configs.list_configs():
        port, ref = configs.get_config(name), jconfigs.get_config(name)
        for shape in configs.INPUT_SHAPES:
            got = configs.for_shape(port, configs.INPUT_SHAPES[shape])
            want = jconfigs.for_shape(ref, jconfigs.INPUT_SHAPES[shape])
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert configs.supports_shape(
                port, configs.INPUT_SHAPES[shape]) == jconfigs.supports_shape(
                    ref, jconfigs.INPUT_SHAPES[shape])
    long = configs.for_shape(configs.get_config(ARCH),
                             configs.INPUT_SHAPES["long_500k"])
    assert (long.attention, long.sliding_window) == ("sliding", 8192)


def _engine(window_target, window_draft, method=CSQS):
    _, _, tm = _bridged(window_target, seed=1)
    _, _, dm = _bridged(window_draft, draft=True, seed=2)
    return EdgeCloudEngine(dm.cfg, dm, tm.cfg, tm, MethodConfig(**method),
                           EngineConfig(L_max=3), seed=0, device="cpu")


@pytest.mark.parametrize("window_target,window_draft",
                         [(64, 0), (0, 64), (32, 32)])
def test_engine_refuses_a_ring_that_would_wrap(window_target, window_draft):
    W_min = min(w for w in (window_target, window_draft) if w)
    prompts = _tokens(512, 10).repeat(2, 0)
    # fixed batch: the capacity is the prompt + 4096 positions
    with pytest.raises(WindowWrapError) as e:
        _engine(window_target, window_draft).run(prompts, 1)
    assert "sliding window" in str(e.value)
    with pytest.raises(WindowWrapError):
        _engine(window_target, window_draft).init_slots(2, W_min + 1)
    _engine(window_target, window_draft).init_slots(2, W_min)


def test_trace_on_a_ring_that_cannot_wrap_matches_reference():
    """cache_len == W: the ring never wraps, and the port serves the
    reference's streams and summary."""
    (jt, jtp, tm), (jd, jdp, dm) = _bridged(32, seed=1), \
        _bridged(32, draft=True, seed=2)
    ref = RefEngine(jd, jdp, jt, jtp, RefMethodConfig(**CSQS),
                    RefEngineConfig(L_max=3), seed=0)
    port = _engine(32, 32)
    cfg = dict(max_batch=2, cache_len=32, t_slm_s=0.01, t_llm_s=0.02)
    reps = [srv.ServeSession(eng, srv.ServeConfig(**cfg)).run_trace(
        srv.poisson_trace(srv.TraceConfig(**TRACE)))
        for srv, eng in ((jserve, ref), (tserve, port))]
    streams = [{r.rid: tuple(r.tokens) for r in rep.requests}
               for rep in reps]
    assert streams[0] == streams[1]
    assert reps[0].summary() == reps[1].summary()
    assert reps[1].n_finished == TRACE["n_requests"]
