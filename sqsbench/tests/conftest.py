"""The benchmark's CPU tests: its harness and reference import from the
benchmark's folder, the system from ``src``."""
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parents[1] / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
