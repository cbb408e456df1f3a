"""rm.solo_roofline: the single-request kernels' share of their bound in the
profiled stretch (a tick of one read runs ``rm_project_kernel``,
``rm_filter_kernel``, ``rm_aggregate_kernel`` or ``rm_groupby_kernel``, and
the partial reductions that follow them), each request's least time from
``work.sectors``."""

from rmbench.work import sectors

KERNELS = ("rm_project_kernel", "rm_filter_kernel", "rm_aggregate_kernel",
           "rm_groupby_kernel")
FOLLOWER = "rm_reduce_partials_kernel"


def read(run):
    trace = run.get("trace")
    passes = [p for p in run.get("passes", ()) if p[0] == "solo"]
    if trace is None or not passes:
        return None
    device_s = trace.seconds_with_followers(lambda name: any(k in name for k in KERNELS),
                                            FOLLOWER)
    if device_s <= 0:
        return None
    bound = sum(sectors.pass_bound_s(reqs, rows, row_bytes)[0]
                for _, reqs, rows, row_bytes in passes)
    return 100.0 * bound / device_s
