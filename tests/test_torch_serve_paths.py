"""More serving paths of the port against repro.serve (see
test_torch_serve.py for the comparison rule -- exact streams, exact
summary): the paged pool in both schedules, paged with preemption, int8
caches dense and paged, K-SQS and the static policy.  Then the
reference's own serving invariants inside the port (paged == dense,
pipelined == lockstep, preemption re-queues with the streams unchanged)
and the trace mode of the port's serve driver."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve as tserve  # noqa: E402
from tests.test_torch_serve import engines, serve_both  # noqa: E402

TRACE = dict(n_requests=5, rate_rps=8.0, prompt_len=10, min_new_tokens=4,
             max_new_tokens=10, vocab=512, seed=3)
# dense enough under the fixed clock that 4 slots outgrow a 9-page pool
BURST = dict(TRACE, rate_rps=20.0)


@pytest.mark.parametrize("pipe", ["lockstep", "pipelined"])
def test_paged_matches_reference(pipe):
    rep = serve_both(TRACE, max_batch=2, page_size=8, pipeline=pipe)
    assert rep.n_finished == 5 and rep.n_preempted == 0
    assert 0 < rep.peak_pages_in_use < rep.n_pages


def test_paged_preemption_matches_reference():
    rep = serve_both(BURST, page_size=8, n_pages=9)
    assert rep.n_preempted >= 1 and rep.n_finished == 5
    assert rep.peak_pages_in_use <= rep.n_pages == 9


@pytest.mark.parametrize("page_size", [0, 8])
def test_int8_kv_matches_reference(page_size):
    rep = serve_both(TRACE, engine_kw=dict(int8=True), max_batch=2,
                     page_size=page_size)
    assert rep.n_finished == 5


def test_ksqs_and_static_policy_match_reference():
    ksqs = dict(method=(("name", "ksqs"), ("K", 16)))
    serve_both(TRACE, engine_kw=ksqs, pipeline="pipelined", page_size=8)
    rep = serve_both(dict(TRACE, rate_rps=30.0), policy="static",
                     queue_cap=2)
    assert rep.n_rejected >= 1
    assert rep.n_finished == rep.n_requests - rep.n_rejected


def _port_streams(**kw):
    cfg = dict(max_batch=2, cache_len=64, t_slm_s=0.01, t_llm_s=0.02)
    cfg.update(kw)
    rep = tserve.ServeSession(engines()[1], tserve.ServeConfig(**cfg)) \
        .run_trace(tserve.poisson_trace(tserve.TraceConfig(**BURST)))
    return rep, {r.rid: tuple(r.tokens) for r in rep.requests}


def test_port_serving_invariants():
    """Paging changes memory layout, pipelining the clock and preemption
    the schedule -- never a token."""
    dense_rep, dense = _port_streams()
    _, paged = _port_streams(page_size=8)
    pipe_rep, pipe = _port_streams(pipeline="pipelined")
    _, both = _port_streams(pipeline="pipelined", page_size=8)
    tight_rep, tight = _port_streams(max_batch=4, page_size=8, n_pages=9)
    assert dense == paged == pipe == both == tight
    assert pipe_rep.makespan_s <= dense_rep.makespan_s + 1e-9
    assert tight_rep.n_preempted >= 1
    assert all(r.state == tserve.RequestState.FINISHED
               for r in tight_rep.requests if r.n_preempts > 0)


def test_serve_trace_cli():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # one thread: smoke-size ops gain nothing from more
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen2.5-3b", "--smoke", "--device", "cpu", "--trace",
           "--page-size", "8", "--pipeline", "pipelined"]
    res = subprocess.run(cmd + ["--n-requests", "4", "--min-new-tokens",
                                "4", "--max-new-tokens", "10"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "n_finished               4" in res.stdout
    # the socket transport serves dense slots only: a paged run is refused
    res = subprocess.run(cmd + ["--transport", "tcp"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 2 and "dense slots only" in res.stderr
