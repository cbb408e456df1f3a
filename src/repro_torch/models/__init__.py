"""The LM stack of the port: the serving path of all ten architectures on
PyTorch.

``layers.py`` holds the layers (norms, RoPE and M-RoPE, GQA attention with
the hand-written flash kernel on the card, FFNs, the MoE block with the
hand-written expert-FFN kernel on the card, the causal conv, the Mamba-2
SSD mixer, the RG-LRU mixer with the hand-written scan kernel on the card),
``lm.py`` the decoder-only LM (``attn`` / ``local`` / ``moe`` / ``ssd`` /
``rglru`` block kinds; token or precomputed-embedding inputs),
``encdec.py`` the encoder-decoder LM, ``convert.py`` carries the reference
package's weights across, and ``registry.py`` builds a model from a config.
"""

from .registry import MODEL_FAMILIES, build_model  # noqa: F401
