"""Core protocol math of the port: SQS/SLQ, conformal control, bits,
verification, the wire codecs, the channel and its shared links, the
paged-KV allocator and the engine.

Re-exports the names ``repro.core`` exports, each from its port module.
They load on first use (PEP 562 ``__getattr__``): importing
``repro_torch.core`` or one of its modules loads nothing else, so the
models, which import ``core.slq`` and ``core.sqs``, never import the
engine through this package, and no kernel is built at import."""
from __future__ import annotations

import importlib

_MODULES = ("bits", "channel", "conformal", "theory", "transport", "wire")
_NAMES = {
    "slq": ("lattice_quantize", "slq_distortion_bound", "tv_distance"),
    "sqs": ("SQSResult", "softmax_temp", "sparsify_topk",
            "sparsify_threshold", "dense_qs", "no_compression"),
    "verify": ("acceptance_prob", "VerifyResult"),
    "engine": ("CloudVerifyEngine", "EdgeCloudEngine", "EdgeDraftEngine",
               "EdgeEngineBase", "MethodConfig", "EngineConfig",
               "PendingRound", "SpecDraft", "cloud_row_key",
               "rollback_cache", "row_key", "summarize"),
    "channel": ("ChannelConfig", "SharedUplink"),
    "pages": ("PageAllocator", "PageStats", "pages_for"),
    "transport": ("TransportError",),
    "wire": ("DraftPayload", "VerdictPayload", "WireDecodeError",
             "WireFormat", "packed_bits"),
}
# name -> (module, attribute); ``sd_verify`` is ``verify.verify``
_WHERE = {name: (mod, name) for mod, names in _NAMES.items()
          for name in names}
_WHERE["sd_verify"] = ("verify", "verify")

__all__ = sorted(_MODULES + tuple(_WHERE))


def __getattr__(name: str):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    mod, attr = _WHERE[name]
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
    globals()[name] = value
    return value
