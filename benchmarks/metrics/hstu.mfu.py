"""HSTU training's share of the card's bf16 peak (%): the model FLOPs of the
window's epochs (``yardstick.hstu.train_flops`` of each epoch's real
positions, attention pairs and supervised positions: padding left out) over
the window's wall time, over 989 TFLOP/s (H100 SXM, dense bf16). Nothing to
read in a cell that trains no HSTU."""

from benchmarks.yardstick import hstu


def read(run):
    h = run.records.get("hstu")
    if not h or not run.window_s:
        return None
    dm = h["dims"]
    flops = sum(hstu.train_flops(dm["d"], dm["blocks"], dm["heads"], dm["dqk"], dm["dv"],
                                 h["negatives"], e["real_slots"], e["attn_pairs"],
                                 e["positions"]) for e in h["epochs"])
    return 100.0 * flops / run.window_s / hstu.BF16_TENSOR_FLOPS_PER_S
