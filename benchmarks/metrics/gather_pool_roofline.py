"""The gather-pool kernels' share of their roofline over the window (%):
the sum of the copied bounds (``yardstick.roofline``) of every gather-pool
forward and backward call the window made, at each call's shape, over the
device time of the kernels of ``ops/csrc/gather_pool*.cu`` in the traced
window. Read on the hub rung with the kernels on: per train step a forward
and a backward over the whole table (layer 0's residual) and over the
step's rows (the last layer's), per embedding pass a forward over the whole
table per layer. A batch forward's table read is counted at its least (the
residual's width in rows), the plan kernels of the per-refresh layouts
count in the time and not in the bound: the share is never overstated.
Nothing to read where the launches counted do not match those calls."""

from benchmarks.yardstick import roofline

KERNELS = ("gather_pool_kernel", "gather_pool_resident_kernel", "gather_pool_bwd_kernel",
           "segment_sum_kernel", "combine_kernel", "segment_plan_kernel")


def read(run):
    tr, sh = run.device_trace, run.records.get("shapes")
    if tr is None or sh is None or sh["gather_impl"] != "pallas" or len(sh["hub_residuals"]) != 2:
        return None
    steps, embeds = run.records["steps"], run.records["embed_passes"]
    if run.records["launches"]["gather_pool"] != 2 * steps + 2 * embeds:
        return None
    n, d, b = sh["n"], sh["d"], sh["batch_rows"]
    r0, r1 = sh["hub_residuals"]

    def fwd(rows, pooled, k):
        return roofline.gather_pool_bound(rows, d, pooled, k, 2)["ms"]

    def bwd(pooled, k):
        return roofline.gather_pool_bwd_bound(n, d, pooled, k, 2)["ms"]

    bound_ms = (steps * (fwd(n, n, r0) + fwd(r1, b, r1) + bwd(n, r0) + bwd(b, r1))
                + embeds * (fwd(n, n, r0) + fwd(n, n, r1)))
    dev_s = sum(s for name, s in tr["by_name"].items()
                if any(name.startswith(k) or f" {k}" in name or f"{k}<" in name for k in KERNELS))
    return 100.0 * bound_ms / 1e3 / dev_s if dev_s > 0 else None
