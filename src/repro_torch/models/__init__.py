"""The LM stack of the port: the dense decoder's serving path on PyTorch.

``layers.py`` holds the dense layer subset (norms, RoPE, GQA attention with
the hand-written flash kernel on the card, FFNs), ``lm.py`` the decoder-only
LM (``attn`` / ``local`` block kinds), ``convert.py`` carries the reference
package's weights across, and ``registry.py`` builds a model from a config.
"""

from .registry import build_model  # noqa: F401
