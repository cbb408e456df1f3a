"""rm.scan_roofline: the fused scan's share of its bound in the profiled
stretch: the least time of every fused pass recorded there (the sectors of
its requests' enabled words read once, every output written once, at the
card's memory rate: ``work.sectors``) over the device time of
``rm_scan_multi_kernel`` and the partial reductions that follow it."""

from rmbench.work import sectors

KERNEL = "rm_scan_multi_kernel"
FOLLOWER = "rm_reduce_partials_kernel"


def read(run):
    trace = run.get("trace")
    passes = [p for p in run.get("passes", ()) if p[0] == "fused"]
    if trace is None or not passes:
        return None
    device_s = trace.seconds_with_followers(lambda name: KERNEL in name, FOLLOWER)
    if device_s <= 0:
        return None
    bound = sum(sectors.pass_bound_s(reqs, rows, row_bytes)[0]
                for _, reqs, rows, row_bytes in passes)
    return 100.0 * bound / device_s
