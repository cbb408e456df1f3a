"""Hand-written Hopper kernels of the RME and their plain PyTorch versions.

``rme_project``    — packed projection (the paper's MLP revision)
``rme_filter``     — fused selection + projection
``rme_aggregate``  — fused selection + aggregation, and group-by
``rme_scan_multi`` — the heterogeneous one-pass scan and its requests
``rme_join``       — the device hash-join build and probe
``ops``            — the engine's import surface
``_cuda``          — builds, loads and launches ``csrc/*.cu``
"""

# The kernel modules import the core's schema and the core's engine imports
# the kernel modules.  Loading the core first, whichever module a caller
# imports first, runs that cycle in the one order that resolves it.
import repro_torch.core  # noqa: F401
