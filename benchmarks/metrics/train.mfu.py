"""The training's share of the card's bf16 peak (%): the model FLOPs of a
train example (``yardstick.roofline.train_step_flops`` over the batch: the
PinSage math of K-neighbour pooling and the linear layers, forward and
backward, the same for every pooling form) times the window's trained
examples per second, over 989 TFLOP/s (H100 SXM, dense bf16, 700 W)."""

from benchmarks.yardstick import roofline


def read(run):
    cfg, rate = run.records.get("cfg"), run.e2e.get("train_ex_per_s")
    if cfg is None or not rate:
        return None
    sh = run.records["shapes"]
    flops = roofline.train_step_flops(
        sh["n"], cfg.features.feature_dim, cfg.model.hidden_dim, cfg.model.embed_dim,
        cfg.walk.num_neighbors, cfg.train.batch_size,
        min(cfg.train.num_negative_samples, sh["n"]), run.records["num_hard"],
        cfg.model.num_layers)
    return 100.0 * flops / cfg.train.batch_size * rate / roofline.BF16_TENSOR_FLOPS_PER_S
