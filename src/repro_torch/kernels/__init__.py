"""Hand-written Hopper kernels of the RME and their plain PyTorch versions.

``rme_project``    — packed projection (the paper's BSL / PCK / MLP revisions)
``rme_project_multi`` — several packed views from one row-store pass
``rme_select``     — selection with per-block compaction, and ``densify``
``rme_filter``     — fused selection + projection
``rme_aggregate``  — fused selection + aggregation, and group-by
``rme_scan_multi`` — the heterogeneous one-pass scan and its requests
``rme_join``       — the device hash-join build and probe
``flash_attention`` — the GQA flash-attention forward of the LM stack
``w8_matmul``      — the int8-weight decode matmul of int8 serving
``ops``            — the engine's import surface
``_cuda``          — builds, loads and launches ``csrc/*.cu``
"""

# The kernel modules import the core's schema and the core's engine imports
# the kernel modules.  Loading the core first, whichever module a caller
# imports first, runs that cycle in the one order that resolves it.
import repro_torch.core  # noqa: F401
