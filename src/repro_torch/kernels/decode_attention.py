"""Binding and wrappers of the Hopper flash-decode GQA kernels
(``csrc/decode_attention.cu``), built by ``kernels.build`` at first use,
and the int8 KV quantizer of ``repro.kernels.decode_attention``.

    q     : (B, nq, hd)                         f32 or bf16
    k, v  : (B, S, nkv, hd) contiguous cache, or
            (P, page_size, nkv, hd) page pool    f32, bf16 or int8
    scales: (B, S, nkv) / (P, page_size, nkv)   f32, with int8 K/V only
    pos   : (B,) int32, >= 0 -- positions > pos are masked
    out   : (B, nq, hd) f32;  query head h reads KV head h // (nq // nkv)

``flash_gqa_decode`` replaces the reference's ``flash_gqa_decode_call``
and ``paged_flash_gqa_decode`` its ``paged_flash_gqa_decode_call``
(``repro/kernels/decode_attention.py``).  One query token reads its
row's K and V up to ``pos`` once, at qpk flops per byte in bf16, so the
bytes of K and V over device memory bound both (``chip_smoke.py`` prints
the bound beside the time).

Design (the source note of the ``.cu`` has the details).  The positions
of a row are split over blocks: ``plan_chunks`` picks, from the shapes
alone, a chunk of positions per block so that the grid (nkv, chunks, B)
holds about two waves of blocks on the card's 132 SMs
(``TARGET_BLOCKS``).  Each block walks its chunk in tiles copied
asynchronously (``cp.async``) into a ring in shared memory in the
cache's own type, keeps the online softmax of its
query heads in registers (f32 on the CUDA cores: a bf16 tensor-core
product would round p to bf16 and break the 2e-5 tolerance), and either
writes the row's output (one live chunk) or its running max, sum and
accumulator to f32 scratch, which a combine kernel, launched by the same
C call, merges in chunk order.  Chunks past ``pos`` exit at once and
positions past ``pos`` are never read.

Numerics: softmax in base 2 (log2 e folded into q), sums within a tile,
then tile by tile, then over the block's warps in index order, then over
chunks in chunk order; within the reference tests' tolerances of the
twin.  Dense and paged calls over the same capacity get the same plan
and differ only in the address of a row, so on gathered pages the two
outputs are equal bit for bit.

Each wrapper takes the plain twin in ``kernels.ref`` for a tensor on the
CPU, and for a CUDA tensor launches its kernels on the current stream or
raises.  The page table is trusted: every entry must be a valid pool row
(``models.attention.sanitize_page_table`` maps FREE entries to the trash
page); checking it would cost a device-to-host copy per call, so tests
and ``chip_smoke.py`` check it instead.  ``LAUNCHES`` counts wrapper
calls that launched (split and combine kernels together).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import BASE_FLAGS, KernelLibrary, raise_on

# Mirrors of the .cu's constants: threads per block, positions per tile,
# ring stages, dims per lane, the head dims it is built for, and the
# shared memory a block may use.
NT, TILE, STAGES, EPL = 128, 32, 4, 8
HEAD_DIMS = (64, 128)
MAX_SMEM = 232448
# The plan: chunks are powers of two in [MIN_CHUNK, MAX_CHUNK] positions,
# the largest that still gives the grid TARGET_BLOCKS blocks, about two
# waves of the card's 132 SMs.  Fewer, longer blocks amortise each
# block's pipeline fill and merge; too few leave SMs idle.
TARGET_BLOCKS = 256
MIN_CHUNK, MAX_CHUNK = 64, 1024
LOG2E = 1.4426950408889634

LAUNCHES = {"flash_gqa_decode": 0, "paged_flash_gqa_decode": 0}
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gqa_decode_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                      i, i, i, i, f, p]
    lib.gqa_decode_launch.restype = i
    lib.paged_gqa_decode_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                            i, i, i, i, i, i, i, i, f, p]
    lib.paged_gqa_decode_launch.restype = i


LIBRARY = KernelLibrary("decode_attention.cu", BASE_FLAGS, _bind)


def build(verbose: bool = False):
    """Compile the library (if needed); returns its path."""
    return LIBRARY.build(verbose)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plan_chunks(capacity: int, B: int, nkv: int, page_size: int = 1):
    """Positions per block and the number of chunks of a row of
    ``capacity`` positions: the largest power of two in [MIN_CHUNK,
    MAX_CHUNK] whose grid B * nkv * chunks holds TARGET_BLOCKS blocks (or
    MIN_CHUNK where the capacity is too small for that), rounded up to a
    multiple of ``page_size``.  Chunk c covers [c * chunk, min((c + 1) *
    chunk, capacity)).  A dense cache plans with ``page_size`` 1, so any
    page size dividing MIN_CHUNK gives dense and paged the same plan."""
    chunk = MAX_CHUNK
    while chunk > MIN_CHUNK and \
            B * nkv * -(-capacity // chunk) < TARGET_BLOCKS:
        chunk //= 2
    chunk = math.lcm(chunk, page_size)
    return chunk, -(-capacity // chunk)


def head_groups(qpk: int):
    """(query heads per block, head groups per KV head): qpk padded to a
    power of two up to 8, wider qpk split into groups of 8."""
    qpk_t = min(8, 1 << (qpk - 1).bit_length())
    return qpk_t, -(-qpk // qpk_t)


def smem_bytes(qpk: int, hd: int, kv_bytes: int, chunk: int = 0,
               page_size: int = 0) -> int:
    """Shared memory of one block (mirrors ``smem_bytes`` in the .cu): the
    ring of K/V tiles (and int8 scales), reused for the block's softmax
    states at the chunk's end, then the chunk's page-table entries
    (``page_size`` 0: dense)."""
    qpk_t, _ = head_groups(qpk)
    ring = STAGES * (2 * TILE * hd * kv_bytes
                     + (2 * TILE * 4 if kv_bytes == 1 else 0))
    nsub = (NT // 32) * (32 // (hd // EPL))
    merge = 4 * (nsub * qpk_t * (hd + 2) + 2 * qpk_t)
    pt = 4 * -(-chunk // page_size) if page_size else 0
    return max(ring, merge) + pt


def quantize_kv(x):
    """x: (..., hd) -> (int8 values, f32 scales (...)): per position x
    head absmax / 127, rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _check(q, k, v, pos, k_scale, v_scale, B_rows: int):
    """Device, dtype, shape and contiguity of a launch's operands."""
    dev = q.device
    if q.dim() != 3 or q.dtype not in _Q_DTYPES:
        raise ValueError(f"q must be (B, nq, hd) f32/bf16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, nq, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.dtype != v.dtype \
            or k.dtype not in _KV_DTYPES:
        raise ValueError(f"k/v must be equal 4-d f32/bf16/int8 tensors, got "
                         f"{tuple(k.shape)} {k.dtype} / {tuple(v.shape)} "
                         f"{v.dtype}")
    nkv = k.shape[2]
    if k.shape[3] != hd or nkv == 0 or nq % nkv:
        raise ValueError(f"head layout: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if k.shape[0] != B_rows:
        raise ValueError(f"k/v leading dimension {k.shape[0]} != {B_rows}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != \
            (v_scale is None):
        raise ValueError("scales are required with int8 K/V and only then")
    if pos.shape != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be (B,) int32, got {tuple(pos.shape)} "
                         f"{pos.dtype}")
    ts = [q, k, v, pos] + ([k_scale, v_scale] if quant else [])
    for t in ts:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if quant:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != k.shape[:3]:
                raise ValueError(f"scales must be f32 {tuple(k.shape[:3])}, "
                                 f"got {tuple(t.shape)} {t.dtype}")
    return B, nq, hd, nkv


def _smem_check(qpk: int, hd: int, kv_bytes: int, chunk: int = 0,
                page_size: int = 0):
    need = smem_bytes(qpk, hd, kv_bytes, chunk, page_size)
    if need > MAX_SMEM:
        raise ValueError(f"hd {hd} x {qpk} query heads with a chunk of "
                         f"{chunk} positions in pages of {page_size} needs "
                         f"{need} B of shared memory > {MAX_SMEM}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(name, q, k, v, k_scale, v_scale, pos, nkv, page_table=None):
    """Plan, allocate output and scratch, and make the one C call that
    launches the split kernel and (for rows of several chunks) the
    combine kernel."""
    B, nq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for "
                         f"{HEAD_DIMS}")
    paged = page_table is not None
    ps = k.shape[1] if paged else 1
    capacity = page_table.shape[1] * ps if paged else k.shape[1]
    qpk_t, n_hg = head_groups(nq // nkv)
    chunk, n_chunks = plan_chunks(capacity, B, nkv, ps)
    _smem_check(nq // nkv, hd, k.element_size(), chunk, ps if paged else 0)
    out = torch.empty((B, nq, hd), dtype=torch.float32, device=q.device)
    scratch = None
    if n_chunks > 1:
        scratch = torch.empty(B * nkv * n_hg * n_chunks * qpk_t * (hd + 2),
                              dtype=torch.float32, device=q.device)
    lib = LIBRARY.load()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
            _ptr(v_scale))
    with torch.cuda.device(q.device):
        tail = (nq, nkv, hd, qpk_t, chunk, _Q_DTYPES[q.dtype],
                _KV_DTYPES[k.dtype], LOG2E / float(hd) ** 0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
        if paged:
            err = lib.paged_gqa_decode_launch(
                *head, page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                _ptr(scratch), B, ps, page_table.shape[1], *tail)
        else:
            err = lib.gqa_decode_launch(
                *head, pos.data_ptr(), out.data_ptr(), _ptr(scratch), B,
                capacity, *tail)
    raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def flash_gqa_decode(q, k, v, pos, k_scale=None, v_scale=None):
    """Flash decode over a contiguous cache k/v (B, S, nkv, hd).
    Returns (B, nq, hd) f32."""
    if q.device.type == "cpu":
        return ref.gqa_decode_ref(q, k, v, pos, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _, _, _, nkv = _check(q, k, v, pos, k_scale, v_scale, q.shape[0])
    return _launch("flash_gqa_decode", q, k, v, k_scale, v_scale, pos, nkv)


def paged_flash_gqa_decode(q, k, v, page_table, pos, k_scale=None,
                           v_scale=None):
    """Flash decode over page pools k/v (P, page_size, nkv, hd) through
    ``page_table`` (B, max_pages) int32, every entry a valid pool row.
    Returns (B, nq, hd) f32."""
    if q.device.type == "cpu":
        return ref.paged_gqa_decode_ref(q, k, v, page_table, pos, k_scale,
                                        v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, _, _, nkv = _check(q, k, v, pos, k_scale, v_scale, k.shape[0])
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.dtype != torch.int32 \
            or page_table.device != q.device \
            or not page_table.is_contiguous():
        raise ValueError(f"page_table must be a contiguous (B, max_pages) "
                         f"int32 tensor on {q.device}, got "
                         f"{tuple(page_table.shape)} {page_table.dtype}")
    return _launch("paged_flash_gqa_decode", q, k, v, k_scale, v_scale, pos,
                   nkv, page_table)
