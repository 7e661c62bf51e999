"""Modality frontend stubs (mirrors ``repro.models.frontend``).

The models cover the transformer backbone only: the audio frontend
(mel-spectrogram and convolutional feature extractor) and the vision
encoder (ViT and projector) are stubs.  The audio stub draws frame
embeddings of the right shape; the vision stub gives the M-RoPE (t, h, w)
position ids of a patch grid, which reach the model through
``positions=`` beside ordinary token ids.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def audio_frame_embeds(generator: torch.Generator, batch: int,
                       n_frames: int, d_model: int, dtype=torch.float32):
    """Stand-in for the audio feature extractor's output: (batch,
    n_frames, d_model) normal x 0.02, drawn from ``generator`` on its
    device."""
    x = torch.randn((batch, n_frames, d_model), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


def vision_patch_positions(batch: int, n_patches: int, grid_h: int,
                           grid_w: int, device="cuda"):
    """M-RoPE position ids of a (grid_h x grid_w) patch grid: (3, batch,
    n_patches) int64 (t, h, w), t 0, patch i at row (i // grid_w) %
    grid_h, column i % grid_w."""
    idx = torch.arange(n_patches, device=resolve_device(device))
    pos = torch.stack([torch.zeros_like(idx), (idx // grid_w) % grid_h,
                       idx % grid_w])                       # (3, n_patches)
    return pos[:, None, :].expand(3, batch, n_patches)


def mrope_text_positions(batch: int, seq: int, start: int = 0,
                         device="cuda"):
    """Text positions start, start + 1, ... with t == h == w: (3, batch,
    seq) int64."""
    p = start + torch.arange(seq, device=resolve_device(device))
    return p[None, None].expand(3, batch, seq)
