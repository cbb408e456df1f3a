"""train.elementwise_ms: device milliseconds a profiled step of the
operations that are neither GEMMs (cuBLAS, CUTLASS) nor the port's own
kernels (``rm_*``): the elementwise passes, reductions and copies of
``models/layers.py``, ``models/lm.py`` and the update."""

GEMM = ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")


def elementwise(name: str) -> bool:
    low = name.lower()
    return "rm_" not in low and not any(t in low for t in GEMM)


def read(run):
    trace = run.get("trace")
    if trace is None or not trace.ops:
        return None
    return trace.seconds(elementwise) * 1e3 / run["profile_steps"]
