"""train.flash_roofline: the flash kernels' share of their bound in the
profiled steps: each forward call (``rm_flash_attention*``) and each
backward call (``rm_flash_bwd_prep_kernel`` opens one) counted at the
least work of causal GQA attention at the microbatch's shape
(``work.flash``, bf16 tensor cores), over the device time of every
``rm_flash`` kernel."""

from rmbench.work import flash

FORWARD = "rm_flash_attention"
BACKWARD = "rm_flash_bwd_prep_kernel"


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    device_s = trace.seconds(lambda name: "rm_flash" in name)
    if device_s <= 0:
        return None
    m, mix = run["config"], run["mix"]
    shape = (mix["batch"] // mix["microbatches"], mix["seq"], m["num_attention_heads"],
             m["num_key_value_heads"], m["head_dim"], 2)
    bound = (trace.count(lambda name: FORWARD in name) * flash.bound_s(flash.forward_work(*shape))
             + trace.count(lambda name: BACKWARD in name)
             * flash.bound_s(flash.backward_work(*shape)))
    return 100.0 * bound / device_s
