"""PyTorch/CUDA port of the edge-cloud SQS speculative-decoding system.

The JAX package ``repro`` is the reference; this package imports nothing
of it (nor of JAX) and mirrors its module names.  Every entry point takes
an explicit ``device`` ("cuda" by default); on a CUDA device the SQS edge
kernels and the flash-decode attention kernels run as hand-written Hopper
kernels (``repro_torch.kernels``)."""
import torch


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; a missing card is an error, never a silent fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but not available; pass "
                           "device='cpu' to run on the CPU")
    return device
