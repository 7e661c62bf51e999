"""Nothing the benchmark runs loads JAX or the JAX package; names are
compared by their whole top-level part."""
import ast
import pathlib
import subprocess
import sys

from harness import isolation

HERE = pathlib.Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    assert isolation.loaded_forbidden(["repro_torch", "repro_torch.core",
                                       "reproducible", "jaxtyping"]) == []
    assert isolation.loaded_forbidden(["repro.core.engine", "jax",
                                       "jaxlib.xla_client", "flax.linen",
                                       "numpy"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]


def test_the_harness_and_the_system_load_none_of_it():
    code = ("import sys; sys.path[:0] = [%r, %r];"
            "import run; from harness import cell, fleet, trace;"
            "import reference.check, reference.decoder;"
            "import repro_torch.core.engine, repro_torch.kernels.ops;"
            "from harness import isolation;"
            "print(isolation.loaded_forbidden())"
            % (str(HERE), str(HERE.parent / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_system():
    allowed = {"__future__", "dataclasses", "math", "typing", "numpy",
               "torch", "reference"}
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)


def test_a_checkout_without_the_system_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    own files the command fails and prints no result line."""
    import shutil
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "sqsbench/run.py", "--workload",
         "gptneo-pair.csqs-chat64", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""
