"""The whole serving slice: the port's ServeSession against
repro.serve.ServeSession on the smoke pair with bridged parameters, a
fixed t_slm/t_llm clock and the same seeded workloads as
tests/test_fuzz_serve.py (random rate, counts, lengths, EOS, cell tags,
per-request codec overrides, downlink rate).

Every point of a stride through the {1, 2, 4 cells} x {lockstep,
pipelined} x {v1, v2} x {verdict batching off, on} grid must give
exactly the reference's per-request token streams and exactly its
``ServeReport.summary()`` -- integers and floats alike: the clock is
fixed, and the float32 wire fields that differ by a few ulps between the
frameworks (ROADMAP Queue 3) do not change any payload's size, which is
all the clock and the link counters read.  test_torch_serve_paths.py
adds the paged, preempting, int8, K-SQS and static-policy points.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.core.channel import ChannelConfig as RefChannel  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)

L_MAX = 3
MAX_BATCH = 4
CSQS = dict(name="csqs", alpha=5e-3, eta=5e-2)     # test_fuzz_serve.METHOD
GRID = [(cells, pipe, codec, batch)
        for cells in (1, 2, 4)
        for pipe in ("lockstep", "pipelined")
        for codec in ("v1", "v2")
        for batch in (False, True)]


@functools.lru_cache(maxsize=None)
def pair(int8: bool = False):
    """(reference (dc, dp, tc, tp), port (dc, dm, tc, tm)), the smoke
    pair of tests/test_serve.py with the port's models bridged from it."""
    tc = jconfigs.smoke_variant(jconfigs.get_config("qwen2.5-3b"))
    dc = jconfigs.draft_variant(tc, 2)
    tp = init_params(tc, jax.random.PRNGKey(1))
    dp = init_params(dc, jax.random.PRNGKey(2))
    ttc = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    tdc = configs.draft_variant(ttc, 2)
    if int8:
        import dataclasses
        tc, dc, ttc, tdc = (dataclasses.replace(c, kv_cache_dtype="int8")
                            for c in (tc, dc, ttc, tdc))
    tm = bridge.from_jax(jax.tree.map(np.asarray, tp), ttc, device="cpu")
    dm = bridge.from_jax(jax.tree.map(np.asarray, dp), tdc, device="cpu")
    return (dc, dp, tc, tp), (tdc, dm, ttc, tm)


@functools.lru_cache(maxsize=None)
def engines(method=tuple(CSQS.items()), codec="v1", budget="analytic",
            int8=False, downlink_bps=20e6):
    """One reference and one port engine per configuration, reused
    across sessions (``init_slots`` resets all of an engine's state; the
    reference keeps its compiled rounds)."""
    (dc, dp, tc, tp), (tdc, dm, ttc, tm) = pair(int8)
    m = dict(method)
    ecfg = dict(L_max=L_MAX, wire_codec=codec, budget_model=budget)
    ref = RefEngine(dc, dp, tc, tp, RefMethodConfig(**m),
                    RefEngineConfig(**ecfg),
                    RefChannel(downlink_bps=downlink_bps), seed=0)
    port = EdgeCloudEngine(tdc, dm, ttc, tm, MethodConfig(**m),
                           EngineConfig(**ecfg),
                           ChannelConfig(downlink_bps=downlink_bps), seed=0,
                           device="cpu")
    return ref, port


def workload(seed: int):
    """tests/test_fuzz_serve.py's seeded workload: trace config kwargs,
    per-request codec overrides and the downlink rate."""
    rng = np.random.default_rng(0xCE11 + seed)
    max_new = int(rng.integers(5, 11))
    trace = dict(
        n_requests=int(rng.integers(4, 8)),
        rate_rps=float(rng.uniform(2.0, 12.0)),
        prompt_len=10,
        min_new_tokens=int(rng.integers(3, max_new)),
        max_new_tokens=max_new,
        vocab=512,
        eos_id=int(rng.integers(0, 512)) if rng.random() < 0.3 else None,
        seed=int(rng.integers(0, 2**16)),
        cells=int(rng.integers(1, 5)))
    overrides = [None if rng.random() < 0.7
                 else ("v1" if rng.random() < 0.5 else "v2")
                 for _ in range(trace["n_requests"])]
    return trace, overrides, float(rng.choice([2e5, 1e6, 20e6]))


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def serve_both(trace, overrides=None, engine_kw=None, **serve_kw):
    """Serve one workload through both sessions; assert equal streams
    and summaries; return the port's report."""
    ref_eng, port_eng = engines(**(engine_kw or {}))
    cfg = dict(max_batch=MAX_BATCH, cache_len=64, t_slm_s=0.01,
               t_llm_s=0.02)
    cfg.update(serve_kw)
    reps = []
    for srv, eng in ((jserve, ref_eng), (tserve, port_eng)):
        tr = srv.poisson_trace(srv.TraceConfig(**trace))
        for req, c in zip(tr, overrides or []):
            req.wire_codec = c
        reps.append(srv.ServeSession(eng, srv.ServeConfig(**cfg))
                    .run_trace(tr))
    ref, got = reps
    assert {r.rid: tuple(r.tokens) for r in got.requests} == \
        {r.rid: tuple(r.tokens) for r in ref.requests}, "streams diverged"
    a, b = ref.summary(), got.summary()
    assert a.keys() == b.keys()
    bad = {k: (a[k], b[k]) for k in a if not _same(a[k], b[k])}
    assert not bad, f"summary differs: {bad}"
    return got


# the stride of tests/test_fuzz_serve.py's default sweep: across the two
# seeds every cell count, schedule, codec and batching mode appears, with
# multi-cell pipelined points in each
STRIDE = [(seed, GRID[i]) for seed in (0, 1)
          for i in range((seed * 2) % 5, len(GRID), 5)]


@pytest.mark.parametrize("seed,point", STRIDE,
                         ids=[f"seed{s}-{c}cells-{p}-{k}-batch{b}"
                              for s, (c, p, k, b) in STRIDE])
def test_serve_grid_matches_reference(seed, point):
    cells, pipe, codec, batch = point
    trace, overrides, downlink = workload(seed)
    rep = serve_both(trace, overrides,
                     dict(codec=codec, downlink_bps=downlink),
                     pipeline=pipe, n_cells=cells, verdict_batch=batch)
    assert rep.n_finished == trace["n_requests"]
    assert rep.n_cells == cells and rep.pipeline == pipe


def test_stride_covers_the_grid_axes():
    for seed in (0, 1):
        pts = [pt for s, pt in STRIDE if s == seed]
        assert any(c > 1 and p == "pipelined" for c, p, _, _ in pts)
    for axis, values in enumerate(((1, 2, 4), ("lockstep", "pipelined"),
                                   ("v1", "v2"), (False, True))):
        assert {pt[axis] for _, pt in STRIDE} == set(values)


def test_calibrated_budget_matches_reference():
    trace, overrides, downlink = workload(2)
    for pipe in ("lockstep", "pipelined"):
        serve_both(trace, overrides,
                   dict(codec="v2", budget="calibrated",
                        downlink_bps=downlink), pipeline=pipe)
