"""The embedding bags' share of their roofline over the window (%): the
least time of every gather-pool forward and compact segment backward the
window's DLRM steps and validation passes made (``yardstick.dlrm``: bytes
over 3.35 TB/s, the tables' rows counted at the distinct rows each call
reached, from the program's counters and the driver's count of the
held-out bags' rows), over the device time of the kernels of
``ops/csrc/gather_pool.cu`` and ``gather_pool_bwd_segment.cu`` in the
traced window: the forward's two routes, both segment passes and every
plan kernel (``segment_plan_*``) of the compact layouts, matched on the
kernel's name without its namespace, template arguments and parameters.
The plan kernels count in the time and not in the bound, so the share is
never overstated. Nothing to read in a cell that trains no DLRM."""

import re

from benchmarks.yardstick import dlrm

KERNELS = ("gather_pool_kernel", "gather_pool_resident_kernel", "segment_sum_kernel",
           "combine_kernel")
PLAN_PREFIX = "segment_plan_"


def counted(name: str) -> bool:
    """Whether a device op of the trace is one of the bags' kernels."""
    base = re.split(r"[<(]", name.removeprefix("void ").replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0]
    return base in KERNELS or base.startswith(PLAN_PREFIX)


def read(run):
    tr, h = run.device_trace, run.records.get("dlrm")
    if tr is None or not h or not h["epochs"]:
        return None
    dm, b, val = h["dims"], h["batch"], h["val"]
    bags, d = list(dm["bags"]), dm["d"]
    nbytes = 0
    for e in h["epochs"]:
        nbytes += dlrm.bag_fwd_bytes(e["steps"], b, bags, d, e["unique_rows"])
        nbytes += dlrm.bag_bwd_bytes(e["steps"], b, bags, d, e["unique_rows"])
        nbytes += dlrm.bag_fwd_bytes(val["chunks"], val["chunk"], bags, d, val["unique_rows"])
    dev_s = sum(s for name, s in tr["by_name"].items() if counted(name))
    return 100.0 * dlrm.bound_seconds(nbytes) / dev_s if dev_s > 0 else None
