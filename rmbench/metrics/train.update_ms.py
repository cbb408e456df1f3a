"""train.update_ms: the AdamW update (``train/step.py`` ``adamw_update``),
milliseconds a step by CUDA events around the call, mean over the traced
window's steps."""


def read(run):
    return run.get("update_ms")
