"""Architecture configs of the port — copies of ``repro.configs``.

``get_config(name)`` returns the full-size config, ``get_smoke_config(name)``
the reduced same-family config the CPU tests use.  Only the architectures
whose blocks the port has resolve: the dense attention-only ones
(``qwen3-8b``, ``gemma3-27b``, ``qwen1.5-110b``, ``internlm2-20b``), the
MoE ones (``qwen3-moe-235b-a22b``, ``llama4-maverick-400b-a17b``), the SSM
``mamba2-1.3b`` and the hybrid ``recurrentgemma-9b``; the others raise
``NotImplementedError`` naming their ROADMAP item.
"""

from .base import (  # noqa: F401
    ARCH_NAMES,
    SHAPES,
    ArchConfig,
    ShapeSpec,
    get_config,
    get_smoke_config,
)
