"""Binding and wrappers of the Hopper flash-decode GQA kernels
(``csrc/decode_attention.cu``), built by ``kernels.build`` at first use,
and the int8 KV quantizer of ``repro.kernels.decode_attention``.

    q     : (B, nq, hd)                         f32 or bf16
    k, v  : (B, S, nkv, hd) contiguous cache, or
            (P, page_size, nkv, hd) page pool    f32, bf16 or int8
    scales: (B, S, nkv) / (P, page_size, nkv)   f32, with int8 K/V only
    pos   : (B,) int32 -- positions > pos are masked
    out   : (B, nq, hd) f32;  query head h reads KV head h // (nq // nkv)

Each wrapper takes the plain twin in ``kernels.ref`` for a tensor on the
CPU, and for a CUDA tensor launches its kernel on the current stream or
raises.  The page table is trusted: every entry must be a valid pool row
(``models.attention.sanitize_page_table`` maps FREE entries to the trash
page); checking it would cost a device-to-host copy per call, so tests
and ``chip_smoke.py`` check it instead.  ``LAUNCHES`` counts kernel
launches per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import BASE_FLAGS, KernelLibrary, raise_on

DENSE_TILE = 32                     # positions per tile of the dense kernel
MAX_SMEM = 232448                   # bytes of shared memory a block may use

LAUNCHES = {"flash_gqa_decode": 0, "paged_flash_gqa_decode": 0}
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _bind(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gqa_decode_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      i, i, f, p]
    lib.gqa_decode_launch.restype = i
    lib.paged_gqa_decode_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                            i, i, i, i, i, f, p]
    lib.paged_gqa_decode_launch.restype = i


LIBRARY = KernelLibrary("decode_attention.cu", BASE_FLAGS, _bind)


def build(verbose: bool = False):
    """Compile the library (if needed); returns its path."""
    return LIBRARY.build(verbose)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(qpk: int, hd: int, tile: int) -> int:
    """Shared memory of one block (mirrors ``smem_floats`` in the .cu)."""
    return 4 * (qpk * hd * 2 + 2 * tile * (hd + 1) + qpk * tile + 3 * qpk)


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


def _smem_check(qpk: int, hd: int, tile: int):
    if smem_bytes(qpk, hd, tile) > MAX_SMEM:
        raise ValueError(f"tile of {tile} positions x hd {hd} x {qpk} query "
                         f"heads needs {smem_bytes(qpk, hd, tile)} B of "
                         f"shared memory > {MAX_SMEM}")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def flash_gqa_decode(q, k, v, pos, k_scale=None, v_scale=None):
    """Flash decode over a contiguous cache k/v (B, S, nkv, hd).
    Returns (B, nq, hd) f32."""
    if q.device.type == "cpu":
        return ref.gqa_decode_ref(q, k, v, pos, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, nq, hd, nkv = _check(q, k, v, pos, k_scale, v_scale, q.shape[0])
    S = k.shape[1]
    _smem_check(nq // nkv, hd, DENSE_TILE)
    out = torch.empty((B, nq, hd), dtype=torch.float32, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.gqa_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
            _ptr(v_scale), pos.data_ptr(), out.data_ptr(), B, S, nq, nkv, hd,
            DENSE_TILE, _Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype],
            1.0 / float(hd) ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "flash_gqa_decode")
    LAUNCHES["flash_gqa_decode"] += 1
    return out


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
    B, nq, hd, nkv = _check(q, k, v, pos, k_scale, v_scale, k.shape[0])
    ps = k.shape[1]
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.dtype != torch.int32 \
            or page_table.device != q.device \
            or not page_table.is_contiguous():
        raise ValueError(f"page_table must be a contiguous (B, max_pages) "
                         f"int32 tensor on {q.device}, got "
                         f"{tuple(page_table.shape)} {page_table.dtype}")
    maxp = page_table.shape[1]
    _smem_check(nq // nkv, hd, ps)
    out = torch.empty((B, nq, hd), dtype=torch.float32, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.paged_gqa_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
            _ptr(v_scale), page_table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, ps, maxp, nq, nkv, hd, _Q_DTYPES[q.dtype],
            _KV_DTYPES[k.dtype], 1.0 / float(hd) ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, "paged_flash_gqa_decode")
    LAUNCHES["paged_flash_gqa_decode"] += 1
    return out
