"""The whole slice: the port's EdgeCloudEngine against
repro.core.EdgeCloudEngine on the smoke pair with bridged parameters and
the seeds of tests/test_engine.py::test_engine_pallas_kernel_path_matches_jnp,
for every method, both SQS paths and both wire codecs.

Token streams, per-round accept counts, live draft counts and
rejections are equal; the analytic bits agree to 1e-5.  Packed payload
and verdict bytes are equal, except for the float32 fields that come
from float sums the two frameworks order differently (ROADMAP Queue 3):
the conformal β trajectory (C-SQS) and the raw probabilities
(uncompressed).  There every integer field is still equal, and the float
fields differ by exactly the ulps recorded in ULPS; any other byte
difference fails.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)

ROUNDS, L_MAX, K = 3, 3, 16
CASES = [("ksqs", False), ("ksqs", True), ("csqs", False), ("csqs", True),
         ("qs", False), ("uncompressed", False)]
# float32 wire fields computed from differently ordered float sums
FLOAT_FIELDS = {"csqs": "betas", "uncompressed": "probs"}
# the divergence measured at these seeds, per round: (largest ulp distance
# of a payload's float field, of a verdict's beta).  Both codecs ship the
# same floats.  Every case not listed is byte-equal: [(0, 0)] * ROUNDS.
ULPS = {("csqs", False): [(1, 0), (0, 0), (0, 0)],
        ("csqs", True): [(11, 11), (17, 15), (22, 17)],
        ("uncompressed", False): [(37, 0), (42, 0), (26, 0)]}


@functools.lru_cache(maxsize=None)
def _pair():
    tc = jconfigs.smoke_variant(jconfigs.get_config("qwen2.5-3b"))
    dc = jconfigs.draft_variant(tc, 2)
    tp = init_params(tc, jax.random.PRNGKey(8))
    dp = init_params(dc, jax.random.PRNGKey(9))
    ttc = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    tdc = configs.draft_variant(ttc, 2)
    tm = bridge.from_jax(jax.tree.map(np.asarray, tp), ttc, device="cpu")
    dm = bridge.from_jax(jax.tree.map(np.asarray, dp), tdc, device="cpu")
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(9), (2, 8),
                                            0, tc.vocab))
    return (dc, dp, tc, tp), (tdc, dm, ttc, tm), prompts


@functools.lru_cache(maxsize=None)
def _reference(method, use_kernels, codec="v1"):
    """Run the reference engine, recording its packed payloads and
    verdicts per round."""
    (dc, dp, tc, tp), _, prompts = _pair()
    eng = RefEngine(dc, dp, tc, tp,
                    RefMethodConfig(method, K=K, use_kernels=use_kernels),
                    RefEngineConfig(L_max=L_MAX, wire_codec=codec), seed=11)
    packed, verdicts = [], []
    draft, pack_verdict = eng.edge.draft, eng.pack_verdict_slot

    def record_draft(mask):
        db = draft(mask)
        packed.append(dict(db.packed))
        verdicts.append({})
        return db

    def record_verdict(slot, v):
        data = pack_verdict(slot, v)
        verdicts[-1][slot] = data
        return data
    eng.edge.draft = record_draft
    eng.pack_verdict_slot = record_verdict
    rounds, toks = eng.run(prompts, ROUNDS)
    return rounds, toks, packed, verdicts, eng.fmt


def _as_v2(fmt, packed, verdicts):
    """The reference's v2 bytes for the same round: its codecs applied to
    its own payloads (analytic budgets make streams codec-independent)."""
    return ([{s: fmt.pack_draft(fmt.unpack_draft(b), codec="v2")
              for s, b in r.items()} for r in packed],
            [{s: fmt.pack_verdict(fmt.unpack_verdict(b), codec="v2")
              for s, b in r.items()} for r in verdicts])


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _draft_ulps(method, fmt, ref, got):
    """Ulps between two payloads' float field; all else must be equal."""
    if ref == got:
        return 0
    field = FLOAT_FIELDS.get(method)
    assert field is not None, f"{method}: payload bytes differ"
    pr, pg = fmt.unpack_draft(ref), fmt.unpack_draft(got)
    assert (pr.tokens, pr.supports, pr.counts) == \
        (pg.tokens, pg.supports, pg.counts)
    if field == "betas":
        return _ulps(pr.betas, pg.betas)
    assert _ulps(pr.betas, pg.betas) == 0
    return _ulps(pr.probs, pg.probs)


def _verdict_ulps(method, fmt, ref, got):
    """Ulps between two verdicts' beta; all else must be equal."""
    if ref == got:
        return 0
    assert method == "csqs", f"{method}: verdict bytes differ"
    vr, vg = fmt.unpack_verdict(ref), fmt.unpack_verdict(got)
    assert (vr.n_accept, vr.new_token) == (vg.n_accept, vg.new_token)
    return _ulps(vr.beta_next, vg.beta_next)


@pytest.mark.parametrize("codec", ["v1", "v2"])
@pytest.mark.parametrize("method,use_kernels", CASES)
def test_engine_matches_reference(method, use_kernels, codec):
    rounds, toks, packed, verdicts, _ = _reference(method, use_kernels)
    fmt = twire.WireFormat(V=512, ell=100, L_max=L_MAX,
                           mode="raw" if method == "uncompressed"
                           else "lattice", codec=codec)
    if codec == "v2":
        packed, verdicts = _as_v2(_reference(method, use_kernels)[4],
                                  packed, verdicts)
    _, (tdc, dm, ttc, tm), prompts = _pair()
    eng = EdgeCloudEngine(tdc, dm, ttc, tm,
                          MethodConfig(method, K=K, use_kernels=use_kernels),
                          EngineConfig(L_max=L_MAX, wire_codec=codec),
                          seed=11, device="cpu")
    got, got_toks = eng.run(prompts, ROUNDS)
    assert got_toks == toks, "token streams diverged"
    ulps = []
    for i, (r, g) in enumerate(zip(rounds, got)):
        for key in ("n_accept", "L_live", "rejected"):
            np.testing.assert_array_equal(r[key], g[key], err_msg=key)
        assert sorted(g["packed"]) == sorted(packed[i])
        ulps.append((
            max(_draft_ulps(method, fmt, data, g["packed"][slot])
                for slot, data in packed[i].items()),
            max([_verdict_ulps(method, fmt, data, g["verdict_packed"][slot])
                 for slot, data in verdicts[i].items()], default=0)))
    assert ulps == ULPS.get((method, use_kernels), [(0, 0)] * ROUNDS)
    np.testing.assert_allclose([r["bits"] for r in rounds],
                               [g["bits"] for g in got], rtol=1e-5)
    np.testing.assert_allclose([r["gap_bits"] for r in rounds],
                               [g["gap_bits"] for g in got], rtol=1e-5)


def test_reference_v2_run_equals_its_repacked_v1_run():
    """Grounds _as_v2: the reference engine run with codec v2 ships its
    v1 run's payloads under the v2 codec."""
    _, toks1, packed1, verdicts1, fmt = _reference("csqs", True)
    _, toks2, packed2, verdicts2, _ = _reference("csqs", True, "v2")
    assert toks1 == toks2
    assert (packed2, verdicts2) == _as_v2(fmt, packed1, verdicts1)


def test_serve_smoke_cli():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2.5-3b", "--smoke", "--device", "cpu", "--rounds", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "resampling_rate" in res.stdout
