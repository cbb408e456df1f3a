"""rmbench: the end-to-end benchmark of the PyTorch/CUDA port (``repro_torch``).

One run is one process: ``python3 -m rmbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Everything a
cell needs is found by name from ``BENCHMARK.json``: its configuration
(``configs/<config>.json``), its traffic mix (``mixes/<traffic>.json``), the
driver its configuration names (``drivers/<driver>.py``) and one reader per
per-layer metric (``metrics/<metric>.py``).  ``work/`` holds the frozen
arithmetic (peaks, sector bounds, model operations), ``reference/`` the
plain references that decide ``correct``.  Nothing here imports JAX or the
JAX package; ``reference/`` imports nothing of the port either.
"""
