"""Binding and wrappers of the Hopper SQS kernels (``csrc/sqs_fused.cu``),
built by ``kernels.build`` at first use.

Each wrapper takes the plain twin in ``kernels.ref`` for a tensor on the
CPU, and for a CUDA tensor launches its kernel on the current stream or
raises.  ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import BASE_FLAGS, KernelLibrary, raise_on

LANE = 128
BISECT_ITERS = 40
# --fmad=false: the kernels' integer decisions on floats (q >= beta, the
# lattice rounding, the +-1 select) need the twin's rounding points
NVCC_FLAGS = BASE_FLAGS + ["--fmad=false"]

LAUNCHES = {"sqs_fused": 0, "topk_threshold": 0}


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sqs_fused_launch.argtypes = [p, p, p, p, p, p, i, i, f, i, i, p]
    lib.sqs_fused_launch.restype = i
    lib.topk_threshold_launch.argtypes = [p, p, p, i, i, f, i, i, p]
    lib.topk_threshold_launch.restype = i


LIBRARY = KernelLibrary("sqs_fused.cu", NVCC_FLAGS, _bind)


def pad_vocab(V: int) -> int:
    return -(-V // LANE) * LANE


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build(verbose: bool = False):
    """Compile the library (if needed); returns its path."""
    return LIBRARY.build(verbose)


def _check_rows(logits_padded):
    if logits_padded.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits_padded.dtype}")
    if logits_padded.dim() != 2 or logits_padded.shape[1] % LANE:
        raise ValueError("logits must be (B, Vp) with Vp a multiple of "
                         f"{LANE}, got {tuple(logits_padded.shape)}")
    if not logits_padded.is_contiguous():
        raise ValueError("logits must be contiguous")


def sqs_fused(logits_padded, beta, *, inv_temp: float, ell: int,
              exact_k: int = 0):
    """Fused softmax -> support -> lattice counts with sum b == ell.
    logits_padded: (B, Vp) f32 (-inf padded); beta: (B, 2) f32 [lo, hi].
    Returns (b (B,Vp) i32, mask (B,Vp) i32, stats (B,4) f32 =
    [dropped, K, sum_b_raw, max_logit])."""
    if logits_padded.device.type == "cpu":
        return ref.sqs_fused_ref(logits_padded, beta, inv_temp=inv_temp,
                                 ell=ell, exact_k=exact_k)
    if logits_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {logits_padded.device}")
    _check_rows(logits_padded)
    B, Vp = logits_padded.shape
    if beta.shape != (B, 2) or beta.dtype != torch.float32 \
            or beta.device != logits_padded.device \
            or not beta.is_contiguous():
        raise ValueError("beta must be a contiguous (B, 2) float32 tensor "
                         "on the logits' device")
    dev = logits_padded.device
    b = torch.empty((B, Vp), dtype=torch.int32, device=dev)
    mask = torch.empty((B, Vp), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 4), dtype=torch.float32, device=dev)
    scratch = torch.empty((B, Vp), dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.sqs_fused_launch(
            logits_padded.data_ptr(), beta.data_ptr(), b.data_ptr(),
            mask.data_ptr(), stats.data_ptr(), scratch.data_ptr(), B, Vp,
            float(inv_temp), int(ell), int(exact_k),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "sqs_fused")
    LAUNCHES["sqs_fused"] += 1
    return b, mask, stats


def topk_threshold(logits_padded, K: int, *, inv_temp: float,
                   iters: int = BISECT_ITERS):
    """Softmax of the padded logits fused with the K-SQS bisection:
    (B, 2) = [lo, hi], count(q >= lo) >= K, count(q >= hi) < K."""
    if logits_padded.device.type == "cpu":
        return ref.topk_threshold_ref(
            ref.softmax_padded(logits_padded, inv_temp), K, iters)
    if logits_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {logits_padded.device}")
    _check_rows(logits_padded)
    B, Vp = logits_padded.shape
    dev = logits_padded.device
    tau = torch.empty((B, 2), dtype=torch.float32, device=dev)
    scratch = torch.empty((B, Vp), dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.topk_threshold_launch(
            logits_padded.data_ptr(), tau.data_ptr(), scratch.data_ptr(), B,
            Vp, float(inv_temp), int(K), int(iters),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "topk_threshold")
    LAUNCHES["topk_threshold"] += 1
    return tau
