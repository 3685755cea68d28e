"""Share of the traced serving window in which no operation ran on the
device (%): one minus the union of kernel, copy and set intervals over the
window."""


def read(run):
    t = run.device_trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None
