"""DLRM-DCNv2 training's share of the card's bf16 peak (%): the dense
part's model FLOPs of the window's training samples
(``yardstick.dlrm.train_flops``: the bottom, cross and top matmuls, 3x the
forward; validation's forward left out) over the window's wall time, over
989 TFLOP/s (H100 SXM, dense bf16). Nothing to read in a cell that trains
no DLRM."""

from benchmarks.yardstick import dlrm


def read(run):
    h = run.records.get("dlrm")
    if not h or not run.window_s:
        return None
    dm = h["dims"]
    width = (1 + len(dm["bags"])) * dm["d"]
    samples = sum(e["samples"] for e in h["epochs"])
    flops = dlrm.train_flops(samples, dm["dense"], list(dm["bottom"]), width, dm["rank"],
                             dm["cross_layers"], list(dm["top"]))
    return 100.0 * flops / run.window_s / dlrm.BF16_TENSOR_FLOPS_PER_S
