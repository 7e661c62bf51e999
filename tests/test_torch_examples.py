"""The port's examples run on the CPU and exit 0:
``examples/torch_quickstart.py`` (the smoke pair, the four methods),
``examples/torch_train_draft_slm.py`` (a few steps of the smoke GPT-Neo
pair through ``repro_torch.launch.train``), and the two that train the
smoke pair (``examples/torch_pair.py``) and serve it:
``examples/torch_temperature_crossover.py`` (Fig. 2) and
``examples/torch_edge_cloud_serve.py``.  ``torch_pair.run_engine`` on a
briefly trained reference pair, bridged with ``bridge.from_jax``, equals
``benchmarks.common.run_engine``'s summary."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_torch_quickstart_runs_on_cpu():
    r = _run(["examples/torch_quickstart.py", "--device", "cpu"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    for name in ("uncompressed", "dense-QS", "K-SQS", "C-SQS"):
        assert name in r.stdout
    assert "bits/batch" in r.stdout


def test_torch_train_draft_slm_runs_on_cpu(tmp_path):
    r = _run(["examples/torch_train_draft_slm.py", "--device", "cpu",
              "--steps", "4", "--batch", "4", "--seq", "16",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    for role in ("target", "draft"):
        assert (tmp_path / f"gptneo-1.3b-{role}.npz").exists()


@pytest.fixture(scope="module")
def pair_cache(tmp_path_factory):
    """One checkpoint cache for the two examples that train the pair: the
    first trains it, the second loads it."""
    return str(tmp_path_factory.mktemp("pair_cache"))


TINY = ["--device", "cpu", "--steps", "8", "--rounds", "2"]


def test_torch_temperature_crossover_runs_on_cpu(pair_cache):
    r = _run(["examples/torch_temperature_crossover.py", *TINY,
              "--cache", pair_cache])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    table = [ln for ln in r.stdout.splitlines()
             if ln.rstrip().endswith(("| K-SQS", "| C-SQS"))]
    assert len(table) == 5, r.stdout
    rows = [ln for ln in r.stdout.splitlines()
            if ln.strip().startswith("method=")]
    assert len(rows) == 10, r.stdout
    assert all(os.path.exists(os.path.join(pair_cache, f"torch-gptneo-1.3b-"
                                           f"{role}-8.npz"))
               for role in ("target", "draft"))


def test_torch_edge_cloud_serve_runs_on_cpu(pair_cache):
    r = _run(["examples/torch_edge_cloud_serve.py", *TINY, "--method",
              "ksqs", "--no-kernels", "--cache", pair_cache])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "latency breakdown" in r.stdout
    assert "resampling_rate" in r.stdout


@pytest.fixture(scope="module")
def reference_pair():
    """The reference's smoke GPT-Neo pair, trained briefly with the
    reference's trainer on ``benchmarks.common``'s corpus."""
    pytest.importorskip("jax")
    sys.path.insert(0, ROOT)
    from benchmarks import common
    from repro import configs as jconfigs
    from repro.data.pipeline import DataConfig, SyntheticLM
    tc = jconfigs.smoke_variant(jconfigs.get_config("gptneo-1.3b"))
    dc = jconfigs.draft_variant(tc, 2)
    data = SyntheticLM(_corpus(DataConfig, tc.vocab))
    tp, _ = common._train(tc, 30, 1, data)
    dp, _ = common._train(dc, 30, 2, data)
    return common, (dc, dp, tc, tp)


def _corpus(data_config, vocab):
    return data_config(vocab=vocab, seq_len=48, batch=16, p_bigram=0.85,
                       jitter=2, seed=5)


@pytest.mark.parametrize("method", ["ksqs", "csqs"])
@pytest.mark.parametrize("temp", [0.2, 1.0])
def test_run_engine_equals_reference(reference_pair, method, temp):
    import jax
    import numpy as np
    from repro.core import MethodConfig as RefMethodConfig
    from repro.data.pipeline import DataConfig as RefDataConfig
    from repro.data.pipeline import SyntheticLM as RefSyntheticLM
    from repro_torch import bridge, configs
    from repro_torch.core.engine import MethodConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_pair
    common, (dc, dp, tc, tp) = reference_pair
    tdc = configs.draft_variant(
        configs.smoke_variant(configs.get_config("gptneo-1.3b")), 2)
    ttc = configs.smoke_variant(configs.get_config("gptneo-1.3b"))
    dm = bridge.from_jax(jax.tree.map(np.asarray, dp), tdc, device="cpu")
    tm = bridge.from_jax(jax.tree.map(np.asarray, tp), ttc, device="cpu")
    kw = dict(K=16, ell=100) if method == "ksqs" else \
        dict(ell=100, alpha=5e-4, eta=1e-3)
    _, want = common.run_engine(
        dc, dp, tc, tp, RefSyntheticLM(_corpus(RefDataConfig, tc.vocab)),
        method=RefMethodConfig(method, **kw), temperature=temp, rounds=3)
    _, got = torch_pair.run_engine(
        tdc, dm, ttc, tm, SyntheticLM(_corpus(DataConfig, ttc.vocab)),
        method=MethodConfig(method, **kw), temperature=temp, rounds=3)
    for key in ("resampling_rate", "accept_rate", "mean_K",
                "tokens_per_batch"):
        assert got[key] == want[key], (key, got[key], want[key])
    np.testing.assert_allclose(got["bits_per_batch"], want["bits_per_batch"],
                               rtol=1e-5)
