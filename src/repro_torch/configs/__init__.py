"""Architecture configs of the port — copies of ``repro.configs``.

``get_config(name)`` returns the full-size config, ``get_smoke_config(name)``
the reduced same-family config the CPU tests use, for each of the ten
``ARCH_NAMES`` (``cell_status`` and ``iter_cells`` name the dry run's
cells): the dense attention-only ones (``qwen3-8b``,
``gemma3-27b``, ``qwen1.5-110b``, ``internlm2-20b``), the MoE ones
(``qwen3-moe-235b-a22b``, ``llama4-maverick-400b-a17b``), the VLM backbone
``qwen2-vl-72b``, the SSM ``mamba2-1.3b``, the encoder-decoder
``seamless-m4t-medium`` and the hybrid ``recurrentgemma-9b``.
"""

from .base import (  # noqa: F401
    ARCH_NAMES,
    SHAPES,
    ArchConfig,
    ShapeSpec,
    cell_status,
    get_config,
    get_smoke_config,
    iter_cells,
)
