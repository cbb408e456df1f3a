"""Model registry: config -> model object (the port's ``build_model``)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from .lm import DecoderLM


def build_model(cfg: ArchConfig, device=None, seed: int | None = 0) -> DecoderLM:
    """The decoder for ``cfg`` on ``device`` (the card by default), weights
    drawn from ``seed``.  The encoder-decoder family is not ported yet:
    ``DecoderLM`` raises for it, as for every block kind it lacks."""
    return DecoderLM(cfg, device=device, seed=seed)
