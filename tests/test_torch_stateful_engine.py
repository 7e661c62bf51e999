"""The SSM family through the whole slice: the port's EdgeCloudEngine and
ServeSession against the reference's on the smoke ``xlstm-1.3b`` pair
(mLSTM + sLSTM, no attention) with bridged parameters, in float32 on the
CPU.  tests/test_torch_stateful_jamba.py runs the same checks on the
hybrid ``jamba-1.5-large-398b`` pair, with this file's helpers.

- fixed-batch K-SQS and C-SQS rounds: token streams, accept counts, live
  draft counts, rejections, mean K, wire bits and end positions equal to
  the reference's; payload and verdict bytes equal but for the C-SQS
  float32 beta, whose ulp distance per round is pinned in ULPS (the pin
  of tests/test_torch_engine.py, ROADMAP Queue 3 item 3);
- rollback: after K-SQS rounds with rejections, the target's and the
  draft's rolled-back caches give the next-token logits of a fresh
  prefill of each row's verified prefix within 3e-4 (the reference's
  tests/test_engine.py::test_stateful_target_rollback_consistency), on
  the bridged pair and on a self-drafting uncompressed pair that accepts
  whole rounds (so the snapshots after the last draft step are the ones
  kept);
- a lockstep trace with more requests than slots, so requests are
  admitted into freed slots whose rows replayed outside the commit mask:
  the streams and ``ServeReport.summary()`` equal the reference's;
- the refusals: pipelined serving, the TCP server's handshake with a
  stateful target, the TCP edge with a stateful draft, the per-slot
  speculation and verdict paths, and ``launch.serve``'s argument check.
"""
import functools
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import transport as ttp  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig, StatefulModelError)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve.events import PIPELINED_REFUSAL  # noqa: E402
from repro_torch.serve import net as tnet  # noqa: E402

from test_torch_engine import _draft_ulps, _verdict_ulps  # noqa: E402

ARCH = "xlstm-1.3b"
ROUNDS, L_MAX, K = 3, 3, 16
ROLLBACK_ATOL = 3e-4            # the reference's rollback test
# the divergence measured at these seeds, per round: the largest ulp
# distance of (a payload's beta, a verdict's beta); K-SQS is byte-equal
ULPS = {"csqs": [(0, 0), (1, 1), (2, 2)]}
# a trace with more requests than slots: later requests are admitted into
# slots freed by earlier ones
TRACE = dict(n_requests=5, rate_rps=6.0, prompt_len=10, min_new_tokens=3,
             max_new_tokens=7, vocab=512, seed=3)
SERVE = dict(max_batch=2, cache_len=32, t_slm_s=0.01, t_llm_s=0.02)
CSQS = dict(name="csqs", alpha=5e-3, eta=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size models run fastest on one intra-op thread, and the test
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def pair(arch, seeds=(8, 9)):
    """(reference (dc, dp, tc, tp), port (dc, dm, tc, tm)): the smoke
    pair, the port's models bridged from the reference's parameters."""
    tc = jconfigs.smoke_variant(jconfigs.get_config(arch))
    dc = jconfigs.draft_variant(tc, 2)
    tp = init_params(tc, jax.random.PRNGKey(seeds[0]))
    dp = init_params(dc, jax.random.PRNGKey(seeds[1]))
    ttc = configs.smoke_variant(configs.get_config(arch))
    tdc = configs.draft_variant(ttc, 2)
    assert ttc.__dict__ == tc.__dict__ and tdc.__dict__ == dc.__dict__
    tm = bridge.from_jax(jax.tree.map(np.asarray, tp), ttc, device="cpu")
    dm = bridge.from_jax(jax.tree.map(np.asarray, dp), tdc, device="cpu")
    return (dc, dp, tc, tp), (tdc, dm, ttc, tm)


def prompts(vocab, B=2, S=8, seed=9):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, S),
                                         0, vocab))


@functools.lru_cache(maxsize=None)
def reference_run(arch, method):
    """The reference engine's rounds, streams, packed payloads and
    verdicts, and end positions."""
    (dc, dp, tc, tp), _ = pair(arch)
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
    rounds, toks = eng.run(prompts(tc.vocab), ROUNDS)
    return rounds, toks, packed, verdicts, np.asarray(eng.pos)


def check_engine_matches_reference(arch, method, pins):
    """``pins``: {method: per-round (payload, verdict) beta ulps}; every
    method not listed is byte-equal."""
    rounds, toks, packed, verdicts, pos = reference_run(arch, method)
    _, (tdc, dm, ttc, tm) = pair(arch)
    eng = EdgeCloudEngine(tdc, dm, ttc, tm,
                          MethodConfig(method, K=K, use_kernels=False),
                          EngineConfig(L_max=L_MAX), seed=11, device="cpu")
    got, got_toks = eng.run(prompts(ttc.vocab), ROUNDS)
    assert got_toks == toks, "token streams diverged"
    np.testing.assert_array_equal(eng.pos.numpy(), pos)
    fmt = twire.WireFormat(V=ttc.vocab, ell=100, L_max=L_MAX,
                           mode="raw" if method == "uncompressed"
                           else "lattice")
    ulps = []
    for i, (r, g) in enumerate(zip(rounds, got)):
        for key in ("n_accept", "L_live", "rejected", "wire_bits_row",
                    "verdict_bits_row"):
            np.testing.assert_array_equal(r[key], g[key], err_msg=key)
        assert r["K_mean"] == g["K_mean"]
        assert sorted(g["packed"]) == sorted(packed[i])
        ulps.append((
            max(_draft_ulps(method, fmt, data, g["packed"][slot])
                for slot, data in packed[i].items()),
            max(_verdict_ulps(method, fmt, data, g["verdict_packed"][slot])
                for slot, data in verdicts[i].items())))
    assert ulps == pins.get(method, [(0, 0)] * ROUNDS), ulps
    np.testing.assert_allclose([r["bits"] for r in rounds],
                               [g["bits"] for g in got], rtol=1e-5)
    return got


def _row_cache(cache, b):
    """Row ``b`` of a dense / stateful cache, batch-1."""
    return [{name: t[b:b + 1] for name, t in c.items()} for c in cache]


def check_rollback_matches_prefill(arch, self_draft):
    """The reference's rollback test on the port: after K-SQS rounds (or
    uncompressed rounds of a self-drafting pair), each row's rolled-back
    target and draft caches give the next-token logits of a fresh prefill
    of its verified prefix."""
    _, (tdc, dm, ttc, tm) = pair(arch, seeds=(2, 3))
    if self_draft:
        tdc, dm = ttc, tm
    # drafting from the target's own distributions, uncompressed and with
    # a budget that lets all L_MAX drafts go out, every draft is accepted
    method = MethodConfig("uncompressed") if self_draft else \
        MethodConfig("ksqs", K=8, use_kernels=False)
    budget = 1e9 if self_draft else EngineConfig.bit_budget
    eng = EdgeCloudEngine(tdc, dm, ttc, tm, method,
                          EngineConfig(L_max=L_MAX, bit_budget=budget),
                          seed=0, device="cpu")
    P = prompts(ttc.vocab, B=2, S=6, seed=4)
    eng.prefill(P)
    accepted = sum(int(eng.run_round()["n_accept"].sum())
                   for _ in range(ROUNDS))
    if self_draft:
        # a self-drafting pair keeps the last draft step's snapshot
        assert accepted == 2 * ROUNDS * L_MAX, accepted
    pos = eng.pos.numpy()
    for b in range(2):
        seq = list(P[b]) + eng.out_tokens[b]
        prefix = torch.tensor([seq[:-1]])        # x_last is not cached yet
        assert pos[b] == prefix.shape[1]
        nxt = torch.tensor([seq[-1]])
        at = torch.tensor([int(pos[b])])
        for model, cache in ((tm, eng.tcache), (dm, eng.dcache)):
            _, fresh = tmodel.prefill(model, prefix,
                                      cache_len=prefix.shape[1] + 8)
            ref, _ = tmodel.decode_step(model, nxt, fresh, at)
            got, _ = tmodel.decode_step(model, nxt, _row_cache(cache, b),
                                        at)
            np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                       atol=ROLLBACK_ATOL)
    return accepted


def streams(rep):
    return {r.rid: tuple(r.tokens) for r in rep.requests}


def serve_both(arch, method=CSQS, **serve_kw):
    """One trace through the reference's and the port's ServeSession;
    asserts equal streams and summaries; returns the port's report."""
    (dc, dp, tc, tp), (tdc, dm, ttc, tm) = pair(arch)
    ref_eng = RefEngine(dc, dp, tc, tp, RefMethodConfig(**method),
                        RefEngineConfig(L_max=L_MAX), seed=0)
    port_eng = EdgeCloudEngine(tdc, dm, ttc, tm, MethodConfig(**method),
                               EngineConfig(L_max=L_MAX), seed=0,
                               device="cpu")
    cfg = dict(SERVE, **serve_kw)
    reps = []
    for srv, eng in ((jserve, ref_eng), (tserve, port_eng)):
        reps.append(srv.ServeSession(eng, srv.ServeConfig(**cfg))
                    .run_trace(srv.poisson_trace(srv.TraceConfig(**TRACE))))
    ref, got = reps
    assert streams(got) == streams(ref), "streams diverged"
    a, b = ref.summary(), got.summary()
    bad = {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
           if a.get(k) != b.get(k)}
    assert not bad, f"summary differs: {bad}"
    # slots were reused: more requests than slots, all finished
    assert got.n_finished == TRACE["n_requests"] > SERVE["max_batch"]
    return got


def port_serve(arch, **serve_kw):
    """The port alone: per-request streams of one lockstep trace."""
    _, (tdc, dm, ttc, tm) = pair(arch)
    eng = EdgeCloudEngine(tdc, dm, ttc, tm, MethodConfig(**CSQS),
                          EngineConfig(L_max=L_MAX), seed=0, device="cpu")
    rep = tserve.ServeSession(eng, tserve.ServeConfig(
        **dict(SERVE, **serve_kw))).run_trace(
            tserve.poisson_trace(tserve.TraceConfig(**TRACE)))
    return streams(rep)


# ======================================================================
@pytest.mark.parametrize("method", ["ksqs", "csqs"])
def test_engine_matches_reference(method):
    check_engine_matches_reference(ARCH, method, ULPS)


@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["bridged-pair", "self-draft"])
def test_rollback_matches_prefill_of_verified_prefix(self_draft):
    check_rollback_matches_prefill(ARCH, self_draft)


def test_lockstep_trace_with_slot_reuse_matches_reference():
    serve_both(ARCH)


def test_pipelined_serving_refuses_stateful_models():
    _, (tdc, dm, ttc, tm) = pair(ARCH)
    eng = EdgeCloudEngine(tdc, dm, ttc, tm, MethodConfig(**CSQS),
                          EngineConfig(L_max=L_MAX), seed=0, device="cpu")
    sess = tserve.ServeSession(eng, tserve.ServeConfig(
        **dict(SERVE, pipeline="pipelined")))
    with pytest.raises(StatefulModelError) as e:
        sess.run_trace(tserve.poisson_trace(tserve.TraceConfig(**TRACE)))
    assert str(e.value) == PIPELINED_REFUSAL
    eng.init_slots(2, 32)
    eng.admit_slot(0, prompts(ttc.vocab)[0], seed=1)
    rec = eng.draft_slots([0])[0]
    assert eng.draft_speculative_slot(0, rec) is None
    with pytest.raises(StatefulModelError):
        eng.edge.draft_speculative(0, 1, 9, 1e-3)
    with pytest.raises(StatefulModelError):
        eng.apply_verdict_slot(0, twire.VerdictPayload(0, 1, 1e-3), rec)


def test_tcp_refuses_stateful_target_and_draft():
    method, ecfg = MethodConfig(**CSQS), EngineConfig(L_max=L_MAX)
    server = tnet.CloudServer(device="cpu").start()
    try:
        sock = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=30)
        conn = ttp.Conn(sock, timeout_s=30)
        try:
            conn.send_json(ttp.MSG_HELLO, {
                "proto": ttp.PROTO_VERSION, "session": "ssm", "cell": 0,
                "n_cells": 1, "config": tnet.engine_digest(
                    ARCH, True, method, ecfg, 0, 2, 32, False)})
            with pytest.raises(ttp.TransportError) as e:
                conn.recv_expect(ttp.MSG_HELLO_OK)
        finally:
            conn.close()
    finally:
        server.stop()
    assert str(e.value) == \
        f"peer error: bad config: {tnet.TCP_TARGET_REFUSAL}"
    _, (tdc, dm, _, _) = pair(ARCH)
    with pytest.raises(ttp.TransportError) as e:
        tnet.EdgeClient(tdc, dm, method, ecfg,
                        tserve.ServeConfig(**SERVE), arch=ARCH, smoke=True,
                        host="127.0.0.1", port=1, device="cpu")
    assert str(e.value) == tnet.TCP_DRAFT_REFUSAL


@pytest.mark.parametrize("flags,refusal", [
    (["--pipeline", "pipelined"], PIPELINED_REFUSAL),
    (["--transport", "tcp"], tnet.TCP_TARGET_REFUSAL),
], ids=["pipelined", "tcp"])
def test_serve_cli_refuses_stateful_models_before_building(flags, refusal,
                                                           capsys,
                                                           monkeypatch):
    """launch.serve refuses at argument time: no model is built."""
    from repro_torch.launch import serve as tlaunch
    monkeypatch.setattr(tlaunch, "load_or_init", None)
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--trace"] + flags)
    assert e.value.code == 2
    assert refusal in capsys.readouterr().err
