"""A confirmed speculative round against another slot's replay, on the
CPU, at the smoke ``qwen2.5-3b`` pair with the reference's parameters
(``bridge.from_jax``).

Pipelined serving drafts round t+1 of a slot while round t is in flight
(``draft_speculative``), writing the slot's draft KV from pos_next =
pos + n_live + 1.  A call that drafts another slot in between replays
this slot from its registers.  The reference's registers still hold
round t, so that replay rewrites pos .. pos + L_max with round t's
drafts, and where n_live <= L_max - 2 it overwrites the speculative
round's KV: once the verdict confirms the speculative round, the round
after it reads keys of tokens that are not in the stream (ROADMAP
Queue 3 item 14).  The port's registers name the last round that wrote
the slot's cache, so the replay rewrites the speculative KV bit for bit.

- the forced interleaving (draft both slots, speculate slot 0, verify
  and redraft slot 1, confirm slot 0's premise, accept the speculative
  round, draft slot 0), dense and paged: the port's next round equals
  the round without slot 1's second draft in drafts, q̂, q and packed
  bytes, and its q equals the draft model's teacher-forced q on the
  committed stream;
- the same sequence on the reference, which still differs, and equals
  the port without the interleaving;
- the self-pair at T 0.35 served pipelined and lockstep: equal streams,
  with confirmed speculative rounds that another slot's draft replayed.
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
from repro.core import wire as jwire  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)

L_MAX = 4
ORACLE_ATOL = 2e-4              # tests/test_torch_window.py's recompute
CSQS = dict(name="csqs", alpha=5e-3, eta=5e-2)
# (method, bit budget, n_live of round t): budgets that leave round t
# n_live <= L_max - 2 drafts, and one that sends all L_max
CASES = [(CSQS, 300.0, 1), (CSQS, 800.0, 1), (CSQS, 1500.0, 2),
         (dict(name="ksqs", K=16), 300.0, 1), (CSQS, 1e9, L_MAX)]
IDS = ["csqs-300", "csqs-800", "csqs-1500", "ksqs16-300", "csqs-all-live"]
# the serving setting: the smoke target as its own draft (premises hold)
SERVE = dict(L_max=L_MAX, bit_budget=400.0, temperature=0.35)
TRACE = dict(n_requests=6, rate_rps=20.0, prompt_len=10, min_new_tokens=16,
             max_new_tokens=24, vocab=512)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair():
    """(reference (dc, dp, tc, tp), port (dc, dm, tc, tm)): the smoke
    pair of tests/test_torch_serve.py."""
    tc = jconfigs.smoke_variant(jconfigs.get_config("qwen2.5-3b"))
    dc = jconfigs.draft_variant(tc, 2)
    tp = init_params(tc, jax.random.PRNGKey(1))
    dp = init_params(dc, jax.random.PRNGKey(2))
    ttc = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    tdc = configs.draft_variant(ttc, 2)
    tm = bridge.from_jax(jax.tree.map(np.asarray, tp), ttc, device="cpu")
    dm = bridge.from_jax(jax.tree.map(np.asarray, dp), tdc, device="cpu")
    return (dc, dp, tc, tp), (tdc, dm, ttc, tm)


def _engine(port: bool, method, budget):
    (dc, dp, tc, tp), (tdc, dm, ttc, tm) = _pair()
    ecfg = dict(L_max=L_MAX, bit_budget=budget, collect_theory=True)
    if port:
        return EdgeCloudEngine(tdc, dm, ttc, tm, MethodConfig(**method),
                               EngineConfig(**ecfg), seed=0, device="cpu")
    return RefEngine(dc, dp, tc, tp, RefMethodConfig(**method),
                     RefEngineConfig(**ecfg), seed=0)


def _forced(eng, wire, interleave: bool, page_size: int = 0):
    """The forced interleaving on 2 slots; returns slot 0's next round
    (drafts, q̂, q, packed bytes), round t's n_live and the committed
    stream it continues."""
    if page_size:
        eng.init_slots(2, 64, page_size=page_size)
    else:
        eng.init_slots(2, 64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 10) for _ in range(2)]
    for s, p in enumerate(prompts):
        eng.admit_slot(s, p, seed=s + 11)
    recs = eng.draft_slots([0, 1])
    spec = eng.draft_speculative_slot(0, recs[0])
    vb = eng.verify_slots({1: recs[1].packed})
    eng.apply_verdict_slot(1, vb.verdicts[1], recs[1])
    if interleave:
        eng.draft_slots([1])              # replays slot 0
    r0 = recs[0]
    hit = wire.VerdictPayload(n_accept=r0.n_live, new_token=spec.in_x,
                              beta_next=float(r0.betas[r0.n_live]))
    assert eng.spec_premise_holds(spec, r0, hit)
    eng.apply_verdict_slot(0, hit, r0, shrink=False)
    eng.commit_speculative(spec)
    sr = spec.round
    eng.apply_verdict_slot(0, wire.VerdictPayload(
        n_accept=sr.n_live, new_token=int(sr.drafts[sr.n_live]),
        beta_next=float(sr.betas[sr.n_live])), sr)
    stream = [int(t) for t in prompts[0]] + [int(t)
                                              for t in eng.out_tokens[0]]
    got = {}
    draft = eng.edge.draft

    def keep(mask):
        got["batch"] = db = draft(mask)
        return db
    eng.edge.draft = keep
    rec = eng.draft_slots([0])[0]
    ys = got["batch"].ys
    return dict(drafts=np.asarray(rec.drafts), packed=rec.packed,
                q_hat=np.asarray(ys["q_hat"][:, 0]),
                q=np.asarray(ys["q"][:, 0]), n_live=r0.n_live,
                stream=stream)


@functools.lru_cache(maxsize=None)
def _forward():
    dc, dp = _pair()[0][:2]
    return jax.jit(functools.partial(jmodel.forward_logits, dc))


def _teacher_forced_logq(stream, drafts):
    """The draft model's log-softmax (T = 1) at each of the round's
    L_max + 1 steps: the reference's forward over the committed stream
    and the round's drafts, padded to 64 tokens."""
    seq = stream + [int(t) for t in drafts[:L_MAX]]
    toks = np.zeros((1, 64), np.int32)
    toks[0, :len(seq)] = seq
    lg = np.asarray(_forward()(_pair()[0][1], jnp.asarray(toks)))[0]
    lg = lg[len(stream) - 1:len(seq)]
    lg = lg - lg.max(-1, keepdims=True)
    return lg - np.log(np.exp(lg).sum(-1, keepdims=True))


@pytest.mark.parametrize("page_size", [0, 8], ids=["dense", "paged"])
@pytest.mark.parametrize("method,budget,n_live", CASES, ids=IDS)
def test_port_round_after_confirmed_speculation_ignores_replay(
        method, budget, n_live, page_size):
    eng = _engine(True, method, budget)
    alone = _forced(eng, twire, False, page_size)
    mixed = _forced(eng, twire, True, page_size)
    assert alone["n_live"] == n_live
    np.testing.assert_array_equal(mixed["drafts"], alone["drafts"])
    np.testing.assert_array_equal(mixed["q_hat"], alone["q_hat"])
    np.testing.assert_array_equal(mixed["q"], alone["q"])
    assert mixed["packed"] == alone["packed"]
    assert mixed["stream"] == alone["stream"]
    logq = np.log(np.maximum(mixed["q"], 1e-30))
    want = _teacher_forced_logq(mixed["stream"], mixed["drafts"])
    assert np.abs(logq - want).max() <= ORACLE_ATOL


@pytest.mark.parametrize("method,budget,n_live", CASES, ids=IDS)
def test_reference_keeps_the_fault(method, budget, n_live):
    """The reference's next round moves with the replay wherever round t
    left n_live <= L_max - 2 (its q leaves the teacher-forced q), and
    equals the port's without the interleaving: drafts, q̂, q within
    ORACLE_ATOL and the payload's size."""
    ref = _engine(False, method, budget)
    alone = _forced(ref, jwire, False)
    mixed = _forced(ref, jwire, True)
    assert mixed["stream"] == alone["stream"]
    dq = float(np.abs(mixed["q"] - alone["q"]).max())
    if n_live <= L_MAX - 2:
        assert dq > 1e-3, dq
        want = _teacher_forced_logq(mixed["stream"], mixed["drafts"])
        assert np.abs(np.log(np.maximum(mixed["q"], 1e-30))
                      - want).max() > 10 * ORACLE_ATOL
    else:
        assert dq == 0.0
    port = _forced(_engine(True, method, budget), twire, False)
    assert port["n_live"] == alone["n_live"] == n_live
    assert port["stream"] == alone["stream"]
    np.testing.assert_array_equal(port["drafts"], alone["drafts"])
    np.testing.assert_array_equal(port["q_hat"], alone["q_hat"])
    np.testing.assert_allclose(port["q"], alone["q"], atol=ORACLE_ATOL)
    # the payload's float32 β trajectory may differ in ulps between the
    # frameworks (ROADMAP Queue 3), never its size
    assert len(port["packed"]) == len(alone["packed"])


def _serve(pipeline: str, seed: int, page_size: int):
    """The self-pair served at SERVE over TRACE; returns the streams, the
    report and how many confirmed speculative rounds another slot's draft
    replayed between their drafting and their confirmation."""
    ttc, tm = _pair()[1][2:]
    eng = EdgeCloudEngine(ttc, tm, ttc, tm, MethodConfig(**CSQS),
                          EngineConfig(**SERVE), seed=0, device="cpu")
    edge, open_, n = eng.edge, {}, [0]
    spec, draft, commit = (edge.draft_speculative, edge.draft,
                           edge.commit_speculative)

    def on_spec(slot, *a):
        open_[slot] = False
        return spec(slot, *a)

    def on_draft(mask):
        for s in open_:
            open_[s] = open_[s] or not mask[s]
        for s in np.nonzero(mask)[0]:
            open_.pop(int(s), None)
        return draft(mask)

    def on_commit(sp):
        n[0] += open_.pop(sp.slot, False)
        return commit(sp)
    edge.draft_speculative, edge.draft = on_spec, on_draft
    edge.commit_speculative = on_commit
    rep = tserve.ServeSession(eng, tserve.ServeConfig(
        max_batch=4, cache_len=64, t_slm_s=0.01, t_llm_s=0.02,
        pipeline=pipeline, page_size=page_size)).run_trace(
            tserve.poisson_trace(tserve.TraceConfig(seed=seed, **TRACE)))
    assert rep.n_finished == TRACE["n_requests"]
    return {r.rid: tuple(r.tokens) for r in rep.requests}, rep, n[0]


@pytest.mark.parametrize("seed,page_size", [(5, 0), (7, 0), (7, 8)],
                         ids=["seed5-dense", "seed7-dense", "seed7-paged"])
def test_pipelined_equals_lockstep_with_confirmed_speculation(seed,
                                                             page_size):
    lock, _, _ = _serve("lockstep", seed, page_size)
    pipe, rep, replayed_hits = _serve("pipelined", seed, page_size)
    assert rep.n_spec_hits > 0 and replayed_hits > 0
    assert pipe == lock
