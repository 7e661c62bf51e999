"""The port, its examples and chip_smoke.py stand alone: with the
``jax``, ``repro`` and ``benchmarks`` imports blocked, every module of
repro_torch and every ``examples/torch_*.py`` imports, and chip_smoke.py
compiles."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import glob, importlib, importlib.abc, importlib.util, os, pkgutil
import py_compile, sys

BLOCKED = ("jax", "jaxlib", "repro", "benchmarks")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
examples = sorted(glob.glob(os.path.join(sys.argv[2], "torch_*.py")))
for path in examples:
    name = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
py_compile.compile(sys.argv[1], doraise=True)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names), len(examples))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE,
                          os.path.join(ROOT, "chip_smoke.py"),
                          os.path.join(ROOT, "examples")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules, n_examples = map(int, res.stdout.split())
    assert n_modules >= 42                    # every module was visited
    assert n_examples >= 5                    # and every torch example
