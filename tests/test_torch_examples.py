"""The port's two examples that need no benchmark run on the CPU and exit
0: ``examples/torch_quickstart.py`` (the smoke pair, the four methods)
and ``examples/torch_train_draft_slm.py`` (a few steps of the smoke
GPT-Neo pair through ``repro_torch.launch.train``)."""
import os
import subprocess
import sys

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
