"""Binding and wrappers of the Hopper SQS kernels (``csrc/sqs_fused.cu``),
built by ``kernels.build`` at first use.

They replace the reference's Pallas kernels ``sqs_fused_call``
(``_sqs_kernel`` + ``_select_n``) and ``topk_threshold_call``
(``_topk_kernel``, with the temperature softmax of
``repro.kernels.ops.sqs_topk`` fused in).  The bytes bound them: 4 B read
and 8 B written per vocab entry (``sqs_fused``), 4 B read
(``topk_threshold``), 2.2 and 0.7 microseconds at the main path's 4 rows
of 151936, so a call costs its launch, a few passes over each block's
slice and the dependent steps between them.

Each row goes to one thread-block cluster of C blocks (``plan_cluster``,
a function of Vp alone, so both kernels split a row alike and compute
bit-identical q).  Block r holds slice r of the row in shared memory, read
from device memory once; blocks swap partials through distributed shared
memory and fold them in rank order, so the float sums have one fixed
order.  The two bisections (the top-K bracket and the +-1 select) keep
the sequential loop's midpoints and decisions bit for bit: a sweep bins
every value against the next ``LEVELS`` levels of the midpoint tree and
replays them from the bin counts, and once the values left in [lo, hi)
fit ``CAP`` they are compacted into block 0, which finishes alone.

Each wrapper takes the plain twin in ``kernels.ref`` for a tensor on the
CPU, and for a CUDA tensor launches its kernel on the current stream or
raises.  ``LAUNCHES`` counts kernel launches per wrapper.  An optional
``info`` (B, 4) int32 tensor receives, per row, [cluster barriers,
cluster sweeps, compaction buffer size or -1, steps finished in block 0].
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import BASE_FLAGS, KernelLibrary, raise_on

LANE = 128
BISECT_ITERS = 40
# Mirrors of the .cu's constants: threads per block, the largest slice a
# block holds, the largest cluster, bisection levels per sweep, bins per
# sweep, the compaction buffer, the largest buffer one warp finishes, the
# shared memory a block may use (its static part is under SMEM_STATIC),
# and the launcher's own error codes.
NT = 1024
SLICE_MAX = 20480
CLUSTER_MAX = 16
LEVELS = 8
NBIN = (1 << LEVELS) + 2
CAP = 8192
WARP_MAX = 256
MAX_SMEM = 232448
SMEM_STATIC = 8192
_ERRORS = {1000: "the card cannot place one cluster of this shape",
           1001: "cluster size or slice outside the kernel's limits"}
# --fmad=false: the kernels' integer decisions on floats (q >= beta, the
# lattice rounding, the +-1 select) need the twin's rounding points
NVCC_FLAGS = BASE_FLAGS + ["--fmad=false"]

LAUNCHES = {"sqs_fused": 0, "topk_threshold": 0}


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sqs_fused_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, i,
                                     p]
    lib.sqs_fused_launch.restype = i
    lib.topk_threshold_launch.argtypes = [p, p, p, i, i, i, i, f, i, i, p]
    lib.topk_threshold_launch.restype = i


LIBRARY = KernelLibrary("sqs_fused.cu", NVCC_FLAGS, _bind)


def pad_vocab(V: int) -> int:
    return -(-V // LANE) * LANE


@functools.lru_cache(maxsize=None)
def plan_cluster(Vp: int):
    """(C, L): blocks per row's cluster and entries per block's slice.
    C is the smallest power of two that leaves each block at most
    SLICE_MAX entries; L is Vp / C rounded up to a multiple of LANE, so
    block r holds [r * L, min((r + 1) * L, Vp)) and the last slice may be
    shorter.  A function of Vp alone: both kernels split a row alike.

    At Vp 151936 that is 8 blocks a row, a cluster size every Hopper card
    places; 16 rows fill 128 of the card's 132 SMs.  ``sqs_sweep.py``
    times twice as many blocks a row: faster at the main path's 4 rows,
    far slower at 32, where clusters of 16 queue for the SMs."""
    if Vp <= 0 or Vp % LANE:
        raise ValueError(f"Vp must be a positive multiple of {LANE}, got {Vp}")
    C = 1
    while C * SLICE_MAX < Vp:
        C *= 2
    if C > CLUSTER_MAX:
        raise ValueError(f"Vp {Vp} needs more than {CLUSTER_MAX} blocks of "
                         f"{SLICE_MAX} entries")
    L = -(-Vp // (C * LANE)) * LANE
    _smem_check(C, L)
    return C, L


def smem_bytes(C: int, L: int) -> int:
    """Dynamic shared memory of one block (mirrors ``dyn_smem`` in the
    .cu): the slice in f32, the compaction buffer, the double-buffered
    bin counts of every rank, and one flag byte per slice entry."""
    return 4 * L + 4 * CAP + 2 * C * NBIN * 4 + L


def _smem_check(C: int, L: int):
    need = smem_bytes(C, L) + SMEM_STATIC
    if need > MAX_SMEM:
        raise ValueError(f"a slice of {L} entries in a cluster of {C} needs "
                         f"{need} B of shared memory > {MAX_SMEM}")


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


def _check_info(info, B, dev):
    if info is not None and (info.shape != (B, 4)
                             or info.dtype != torch.int32
                             or info.device != dev
                             or not info.is_contiguous()):
        raise ValueError("info must be a contiguous (B, 4) int32 tensor on "
                         "the logits' device")


def _call(dev, fn, *args):
    """fn(*args, stream) on the current stream of ``dev``, made the current
    device only where it is not.  The raw stream handle costs a tenth of a
    microsecond where ``torch.cuda.current_stream()`` costs several, which
    is most of a kernel's time at the main path's few rows."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    if idx == cur:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def _raise_on(err: int, name: str, C: int, L: int):
    if err in _ERRORS:
        raise RuntimeError(f"{name} launch failed: {_ERRORS[err]} (cluster "
                           f"of {C} blocks, slices of {L} entries, "
                           f"{smem_bytes(C, L)} B of shared memory)")
    raise_on(err, name)


def sqs_fused(logits_padded, beta, *, inv_temp: float, ell: int,
              exact_k: int = 0, info=None):
    """Fused softmax -> support -> lattice counts with sum b == ell.
    logits_padded: (B, Vp) f32 (-inf padded); beta: (B, 2) f32 [lo, hi].
    Returns (b (B,Vp) i32, mask (B,Vp) i32, stats (B,4) f32 =
    [dropped, K, sum_b_raw, max_logit])."""
    dev = logits_padded.device
    if dev.type == "cpu":
        return ref.sqs_fused_ref(logits_padded, beta, inv_temp=inv_temp,
                                 ell=ell, exact_k=exact_k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_rows(logits_padded)
    B, Vp = logits_padded.shape
    if beta.shape != (B, 2) or beta.dtype != torch.float32 \
            or beta.device != dev or not beta.is_contiguous():
        raise ValueError("beta must be a contiguous (B, 2) float32 tensor "
                         "on the logits' device")
    _check_info(info, B, dev)
    C, L = plan_cluster(Vp)
    # one allocation for b, mask and stats, cut into views after the
    # launch: at a few rows the host work before a launch is a large part
    # of a call's time
    out = torch.empty(2 * B * Vp + 4 * B, dtype=torch.int32, device=dev)
    base = out.data_ptr()
    lib = LIBRARY.load()
    err = _call(dev, lib.sqs_fused_launch,
                logits_padded.data_ptr(), beta.data_ptr(), base,
                base + 4 * B * Vp, base + 8 * B * Vp,
                None if info is None else info.data_ptr(), B, Vp, C, L,
                float(inv_temp), int(ell), int(exact_k))
    _raise_on(err, "sqs_fused", C, L)
    LAUNCHES["sqs_fused"] += 1
    b, mask = out[:2 * B * Vp].view(2, B, Vp)
    return b, mask, out[2 * B * Vp:].view(torch.float32).view(B, 4)


def topk_threshold(logits_padded, K: int, *, inv_temp: float,
                   iters: int = BISECT_ITERS, info=None):
    """Softmax of the padded logits fused with the K-SQS bisection:
    (B, 2) = [lo, hi], count(q >= lo) >= K, count(q >= hi) < K."""
    dev = logits_padded.device
    if dev.type == "cpu":
        return ref.topk_threshold_ref(
            ref.softmax_padded(logits_padded, inv_temp), K, iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_rows(logits_padded)
    B, Vp = logits_padded.shape
    _check_info(info, B, dev)
    C, L = plan_cluster(Vp)
    tau = logits_padded.new_empty(2 * B)    # shaped after the launch
    lib = LIBRARY.load()
    err = _call(dev, lib.topk_threshold_launch,
                logits_padded.data_ptr(), tau.data_ptr(),
                None if info is None else info.data_ptr(), B, Vp, C, L,
                float(inv_temp), int(K), int(iters))
    _raise_on(err, "topk_threshold", C, L)
    LAUNCHES["topk_threshold"] += 1
    return tau.view(B, 2)
