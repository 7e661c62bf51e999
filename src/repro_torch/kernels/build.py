"""Build and load the port's CUDA kernel libraries.

Each library is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at first use and loaded with ctypes.  A
library is named by a hash of its source and its flags, so an edited
source or changed flags rebuild.  Nothing is built when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc(source: pathlib.Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Hopper kernels are built from "
                       f"{source} on a machine with the CUDA toolkit")


class KernelLibrary:
    """One CUDA source, its nvcc flags and its ctypes binding.
    ``bind(lib)`` declares argtypes/restype of the library's entry
    points; it runs once, when the library is first loaded."""

    def __init__(self, source: str, flags: List[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.flags = flags
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> pathlib.Path:
        """Compile the library if this source/flag combination has no
        build yet; returns the shared library's path.  ``verbose`` adds
        ``-Xptxas -v`` and prints its report (registers, spills)."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()
                                ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{self.source.stem}_{digest}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(self.source), *self.flags,
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({res.returncode}):\n{res.stderr}")
        if verbose and res.stderr:
            print(res.stderr.strip())
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib


def raise_on(err: int, name: str):
    """Raise if a launch returned a nonzero ``cudaGetLastError()``."""
    if err:
        import torch
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
