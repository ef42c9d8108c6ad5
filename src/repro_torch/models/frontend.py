"""Modality frontend stubs: the backbones of the VLM and audio entries take
precomputed patch or frame embeddings, and these helpers draw stand-ins.

The port of the JAX package's ``repro/models/frontend.py``.  Draws come
from an explicit ``torch.Generator`` (in float32 on the generator's
device, then cast to the model's dtype and moved); they differ from
``jax.random``'s, so the differential tests feed both packages the same
numpy embeddings instead.
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from .layers import param_dtype


def _normal(cfg: ModelConfig, gen: torch.Generator, shape,
            device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.to(device=resolve_device(device), dtype=param_dtype(cfg))


def vit_patch_embeds(cfg: ModelConfig, gen: torch.Generator, batch: int,
                     device=None) -> torch.Tensor:
    """InternViT stub: (batch, frontend_len, d_model) patch embeddings on
    ``device`` (``None``: the card)."""
    if cfg.frontend != "vit":
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r}, not 'vit'")
    return _normal(cfg, gen, (batch, cfg.frontend_len, cfg.d_model), device)


def audio_frame_embeds(cfg: ModelConfig, gen: torch.Generator, batch: int,
                       num_frames: int, device=None) -> torch.Tensor:
    """Speech-frontend stub: (batch, num_frames, d_model) frame embeddings
    (the w2v-BERT conv feature extractor's output in seamless-m4t) on
    ``device`` (``None``: the card)."""
    if cfg.frontend != "audio":
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r}, not "
                         "'audio'")
    return _normal(cfg, gen, (batch, num_frames, cfg.d_model), device)


__all__ = ["audio_frame_embeds", "vit_patch_embeds"]
