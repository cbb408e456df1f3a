"""train_mfu: the whole step's share of the card's bf16 peak: the model
operations of the traced window's steps (``work.flops``) over its seconds,
at 989 TFLOP/s."""

from rmbench.work import flops, peaks


def read(run):
    w = run.get("window")
    if run.get("device") != "cuda" or not w or not w["seconds"]:
        return None
    m, mix = run["config"], run["mix"]
    step = flops.train_step_flops(
        m["num_hidden_layers"], m["hidden_size"], m["num_attention_heads"],
        m["num_key_value_heads"], m["head_dim"], m["intermediate_size"], m["vocab_size"],
        True, mix["batch"] * mix["seq"], mix["seq"])
    return 100.0 * step * w["steps"] / w["seconds"] / peaks.BF16_FLOPS
