"""Tiny CPU runs of a whole cell on the smoke pair (the system's plain
paths): the loop, its metrics and the check; the same run with the timed
path broken underneath, which the check must refuse; and the control,
the reference in float8 in the system's place, which must fail a limit.
The card's kernels do not run here."""
import json
import pathlib
import time

import pytest
import torch

from harness import cell

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def smoke(method="ksqs", dtype="float32"):
    pair = json.loads((HERE / "data" / "smoke-pair.json").read_text())
    traffic = json.loads((HERE / "data" / "smoke-traffic.json").read_text())
    traffic["method"]["name"] = method
    for role in ("edge", "cloud"):
        pair[role]["dtype"] = dtype
    return pair, traffic


def limits(workload):
    return json.loads((HERE.parent / "limits" / f"{workload}.json").read_text())


def run(workload, method="ksqs", traced=False, seed=2 ** 31 + 99, **kw):
    pair, traffic = smoke(method, kw.pop("dtype", "float32"))
    return cell.run_cell(BENCH, workload, seed, 1.0, traced, "cpu",
                         time.perf_counter(), pair=pair, traffic=traffic,
                         limits=limits(workload), **kw)


@pytest.mark.parametrize("method", ["ksqs", "csqs"])
def test_loop_serves_and_checks(method):
    out = run(CELLS[0], method)
    assert out["correct"], out["check"]
    m = out["metrics"]
    assert m["tokens_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert m["latency_per_token_ms"]["value"] > 0
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert list(out)[-1] == "check"
    for c in out["check"].values():
        assert c["value"] == 0.0            # float32 on the plain paths


def test_traced_run_reports_per_layer_metrics():
    out = run(CELLS[1], "ksqs", traced=True)
    m = out["metrics"]
    for name in ("draft_ms", "verify_ms", "wire_host_ms",
                 "uplink_bits_per_token", "token_gap_p95_ms.chat"):
        assert m[name]["value"] > 0, name
    assert "mfu" not in m                   # no card, no device trace


def _no_cache_writes(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "write_rows", lambda t, slot, vals: t)


def _half_batch(monkeypatch):
    from repro_torch.models import model as model_mod
    real = model_mod.extend_step

    def half(model, tokens, cache, pos, collect_traj=False):
        logits, cache, traj = real(model, tokens, cache, pos, collect_traj)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:logits.shape[0] - h]
        return logits, cache, traj
    monkeypatch.setattr(model_mod, "extend_step", half)


def _altered_token(monkeypatch):
    from repro_torch.core import verify as verify_mod
    real = verify_mod.verify

    def altered(*a, **kw):
        r = real(*a, **kw)
        return r._replace(new_token=(r.new_token + 1) % a[3].shape[-1])
    monkeypatch.setattr(verify_mod, "verify", altered)


def _altered_draft(monkeypatch):
    from repro_torch.core import engine
    real = engine.prng.categorical

    def altered(key, logits):
        return (real(key, logits) + 1) % logits.shape[-1]
    monkeypatch.setattr(engine.prng, "categorical", altered)


@pytest.mark.parametrize("fault", [_no_cache_writes, _half_batch,
                                   _altered_token, _altered_draft])
@pytest.mark.parametrize("method", ["ksqs", "csqs"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, method):
    fault(monkeypatch)
    out = run(CELLS[0], method)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_system_passes(workload):
    """bf16 weights and activations (the served precision) pass every
    limit; the reference with float8 weights fails one."""
    method = json.loads((HERE.parent / "traffic" / (
        next(w for w in BENCH["workloads"]
             if w["name"] == workload)["traffic"] + ".json")).read_text()
    )["method"]["name"]
    out = run(workload, method, dtype="bfloat16", control=True,
              seed=2 ** 31 + 5)
    lim = limits(workload)
    assert out["correct"], out["check"]
    assert any(out["control"][k] > v for k, v in lim.items()), out["control"]
