"""The port's Theorem-1 telemetry against the reference's: the
decomposition terms on seeded numpy inputs, the online ``DecompTracker``
over a lockstep C-SQS trace served by both frameworks on the same
(bridged) weights, obs on against obs off, and the serving entry point's
``--trace-out`` / ``--metrics-out`` artifacts.

Tolerances.  On identical float32 inputs the terms agree to 1e-6
relative (torch and XLA sum the vocabulary axis in different orders).
Over a served trace every integer of the tracker's snapshot is equal and
its floats agree to FLOAT_RTOL: the drafts' q and the target's p come
from the two frameworks' float32 softmaxes and matmuls, which differ by
a few ulps (ROADMAP Queue 3), and each record sums such terms over a
round's positions.  At these seeds the largest relative difference is
3.0e-7 (a round's mean beta).
"""
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import conformal as jconformal  # noqa: E402
from repro.core import slq as jslq  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import conformal, slq, theory  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)
from repro_torch.launch import serve as launch_serve  # noqa: E402

from test_torch_serve import pair  # noqa: E402

TERMS_RTOL = 1e-6
FLOAT_RTOL = 1e-6
ALPHA, ETA, ELL = 5e-3, 5e-2, 100
CSQS = dict(name="csqs", alpha=ALPHA, eta=ETA, use_kernels=False)
TRACE = dict(n_requests=5, rate_rps=6.0, prompt_len=10, min_new_tokens=4,
             max_new_tokens=8, vocab=512, seed=3, cells=2)


def _dists(rng, shape):
    x = rng.random(shape).astype(np.float32) ** 4
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shape", [(7, 512), (2, 3, 1000)])
def test_thm1_terms_match_reference(shape):
    rng = np.random.default_rng(shape[-1])
    q, p, q_hat = (_dists(rng, shape) for _ in range(3))
    dropped = rng.random(shape[:-1]).astype(np.float32) * 0.01
    K = rng.integers(1, 64, shape[:-1])
    ref = jtheory.thm1_terms(q, p, q_hat, dropped, K, ELL)
    got = theory.thm1_terms(q, p, q_hat, dropped, K, ELL)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=TERMS_RTOL, err_msg=name)
    for g, r in zip(theory.thm1_bound_total(got),
                    jtheory.thm1_bound_total(ref)):
        np.testing.assert_allclose(float(g), float(r), rtol=TERMS_RTOL)
    np.testing.assert_allclose(
        slq.tv_distance(torch.from_numpy(q), torch.from_numpy(p)).numpy(),
        np.asarray(jslq.tv_distance(q, p)), rtol=TERMS_RTOL)


@pytest.mark.parametrize("T", [1, 37, 100_000])
def test_thm2_bound_matches_reference(T):
    got = conformal.thm2_bound(ALPHA, ETA, 1e-3, T)
    assert got.dtype == torch.float32
    assert float(got) == float(jconformal.thm2_bound(ALPHA, ETA, 1e-3, T))


@functools.lru_cache(maxsize=None)
def _engines():
    (dc, dp, tc, tp), (tdc, dm, ttc, tm) = pair()
    ecfg = dict(L_max=3, collect_theory=True)
    return (RefEngine(dc, dp, tc, tp, RefMethodConfig(**CSQS),
                      RefEngineConfig(**ecfg), seed=0),
            EdgeCloudEngine(tdc, dm, ttc, tm, MethodConfig(**CSQS),
                            EngineConfig(**ecfg), seed=0, device="cpu"))


def _serve(srv, eng, obs):
    rep = srv.ServeSession(eng, srv.ServeConfig(
        max_batch=4, cache_len=48, n_cells=2, t_slm_s=0.01, t_llm_s=0.02),
        obs=obs).run_trace(srv.poisson_trace(srv.TraceConfig(**TRACE)))
    return {r.rid: tuple(r.tokens) for r in rep.requests}


@functools.lru_cache(maxsize=None)
def _tracked():
    ref_eng, port_eng = _engines()
    out = []
    for mod, srv, eng in ((jobs, jserve, ref_eng), (tobs, tserve, port_eng)):
        decomp = mod.DecompTracker(ALPHA, ETA, ELL)
        streams = _serve(srv, eng, mod.Obs.on(decomp=decomp))
        out.append((streams, decomp))
    return out


def _assert_close(ref, got, path="snapshot"):
    """Integers (and bools, strings) equal; floats within FLOAT_RTOL."""
    if isinstance(ref, dict):
        assert ref.keys() == got.keys(), path
        for k in ref:
            _assert_close(ref[k], got[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _assert_close(r, g, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert isinstance(got, float), path
        assert math.isclose(got, ref, rel_tol=FLOAT_RTOL, abs_tol=1e-9), \
            (path, ref, got)
    else:
        assert type(got) is type(ref) and got == ref, (path, ref, got)


def test_decomp_tracker_matches_reference():
    (ref_streams, ref), (streams, got) = _tracked()
    assert streams == ref_streams
    assert len(got.rounds) > 0 and all("bound" in r for r in got.rounds)
    _assert_close(ref.snapshot(), got.snapshot())
    _assert_close(ref.coverage(), got.coverage(), "coverage")
    ok_r, err_r = ref.reconcile()
    ok, err = got.reconcile()
    assert ok and ok_r
    assert err <= 1e-4


def test_obs_on_off_streams_identical():
    (_, _), (on_streams, _) = _tracked()
    _, port_eng = _engines()
    assert _serve(tserve, port_eng, None) == on_streams


@pytest.mark.parametrize("transport", ["sim", "tcp"])
def test_serve_cli_writes_and_checks_obs_artifacts(transport, tmp_path,
                                                   capsys):
    trace_out, metrics_out = tmp_path / "t.json", tmp_path / "m.json"
    launch_serve.main([
        "--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--trace",
        "--transport", transport, "--n-requests", "3", "--cells", "2",
        "--max-new-tokens", "6", "--min-new-tokens", "3", "--L-max", "3",
        "--trace-out", str(trace_out), "--metrics-out", str(metrics_out)])
    out = capsys.readouterr().out
    assert "[PASS-OBS]" in out and "[FAIL" not in out
    if transport == "tcp":
        assert "[PASS-TRANSPORT]" in out
    names = tobs.span_names_by_clock(json.loads(trace_out.read_text()))
    assert {"draft", "uplink", "verify", "downlink"} <= names["modeled"]
    if transport == "tcp":
        assert {"draft", "verify_rpc"} <= names["wall"]
    snap = json.loads(metrics_out.read_text())
    assert snap["decomp"]["n_rounds"] > 0
    assert snap["decomp"]["coverage"]["n_positions"] > 0
