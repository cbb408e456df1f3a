"""Model registry: config -> model object (the port's ``build_model``)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from .encdec import EncDecLM
from .lm import DecoderLM

MODEL_FAMILIES = ("dense", "moe", "vlm", "ssm", "audio", "hybrid")


def build_model(cfg: ArchConfig, device=None, seed: int | None = 0,
                param_dtype: str | None = None) -> DecoderLM | EncDecLM:
    """The model for ``cfg`` on ``device`` (the card by default), weights
    drawn from ``seed``: ``EncDecLM`` for an encoder-decoder config
    (``n_enc_layers > 0``), else ``DecoderLM``.  ``param_dtype`` holds the
    weights in that dtype (training: ``cfg.param_dtype``, the master
    weights) instead of the compute dtype."""
    model = EncDecLM if cfg.is_encdec else DecoderLM
    return model(cfg, device=device, seed=seed, param_dtype=param_dtype)
