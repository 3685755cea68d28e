"""The plain reference of the DLRM-DCNv2 cell: float32 PyTorch with TF32 off,
nothing of the port, for the comparison that decides ``correct``.

It follows the published description (DLRM, arXiv:1906.00091; DCN-V2's
low-rank cross network, arXiv:2008.13535; MLPerf Training's
``recommendation_v2/torchrec_dlrm`` reference, TorchRec's ``DLRM_DCN``):
an ``nn.EmbeddingBag(mode="sum")`` per feature, the bottom MLP (ReLU after
every layer), ``x0 = concat(bottom, bags)``, the low-rank cross layers
``x_{l+1} = x0 * (U_l (V_l^T x_l) + b_l) + x_l``, the top MLP (ReLU between
its layers), binary cross-entropy, autograd, ``torch.optim.Adagrad`` on the
dense parameters and FBGEMM's exact row-wise Adagrad on the rows a batch
touched, read from the bags' sparse gradients. Its CPU twin is
``tests/dlrm_reference.py``. Departures, each the port's too: the weights
are held in the port's layout (linear weights [in, out]; the cross layers'
V and U as [in, rank] and [rank, in]); Adagrad's eps is 1e-8 on the dense
parameters as on the tables; each table holds the rows of this device's
share, its ids drawn from them.

Beside that reference it adds what the check needs: the seeded weights
(``init_tables``, ``init_dense``: TorchRec's initialisation, each table from
a generator of its own so that one table can be made at a time), the fp8
control (``pinsage.Precision``: every matmul operand rounded to float8
e4m3), the faults of calibration (half the batch out of the loss, the cross
layers without ``x0 *``, one table's update skipped) and the logits of a
split in blocks of samples.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .pinsage import Precision, tf32_off

__all__ = ["Precision", "tf32_off", "Dims", "Fault", "init_tables", "init_dense", "Model",
           "train_steps", "logits", "auc"]

EPS = 1e-8


class Dims(NamedTuple):
    dense: int
    bags: tuple
    rows: tuple          # rows held per table
    published: tuple     # published rows per table (the init's bound)
    d: int
    bottom: tuple
    top: tuple
    cross_layers: int
    rank: int


class Fault(NamedTuple):
    """A fault of calibration: ``half`` leaves the odd samples out of the
    loss, ``no_x0`` drops ``x0 *`` from every cross layer, ``skip`` names a
    table whose update is skipped (-1: none)."""

    half: bool = False
    no_x0: bool = False
    skip: int = -1


def _sub(seed: int, i: int) -> int:
    return (int(seed) * 64 + i) % (2 ** 63)


def init_tables(seed: int, dm: Dims, device):
    """Table f, [rows_f, d] uniform in +-sqrt(1 / published rows_f) (TorchRec's
    default), from a generator seeded by ``seed`` and f; one at a time."""
    for f, (rows, published) in enumerate(zip(dm.rows, dm.published)):
        g = torch.Generator(device=device).manual_seed(_sub(seed, f))
        t = torch.rand((rows, dm.d), generator=g, device=device)
        yield t.mul_(2.0).sub_(1.0).mul_(math.sqrt(1.0 / published))


def init_dense(seed: int, dm: Dims, device) -> dict:
    """The dense parameters in the port's tree: linear layers as
    ``nn.Linear`` (weight and bias uniform in +-1 / sqrt(fan in)), each
    cross layer's V and U Xavier-normal and its bias 0 (``LowRankCrossNet``)."""
    g = torch.Generator(device=device).manual_seed(_sub(seed, 63))
    width = (1 + len(dm.bags)) * dm.d

    def uniform(shape, bound):
        return bound * (2 * torch.rand(shape, generator=g, device=device) - 1)

    def linear(a, b):
        return {"w": uniform((a, b), 1.0 / math.sqrt(a)), "b": uniform((b,), 1.0 / math.sqrt(a))}

    def xavier(a, b):
        return math.sqrt(2.0 / (a + b)) * torch.randn((a, b), generator=g, device=device)

    w = (dm.dense, *dm.bottom)
    bottom = [linear(a, b) for a, b in zip(w[:-1], w[1:])]
    cross = [{"v": xavier(width, dm.rank), "u": xavier(dm.rank, width),
              "b": torch.zeros(width, device=device)} for _ in range(dm.cross_layers)]
    w = (width, *dm.top)
    return {"bottom": bottom, "cross": cross, "top": [linear(a, b) for a, b in zip(w[:-1], w[1:])]}


def dense_leaves(dense: dict) -> dict[str, torch.Tensor]:
    """``{path: leaf}`` of the dense tree, in the port's key paths."""
    out = {}
    for part in ("bottom", "cross", "top"):
        for i, layer in enumerate(dense[part]):
            for k in sorted(layer):
                out[f"{part}/{i}/{k}"] = layer[k]
    return out


class Model:
    """The model over ``tables`` (one ``nn.EmbeddingBag`` each, the tensor
    itself as its weight) and a dense tree, in precision ``prec``."""

    def __init__(self, tables: list, dense: dict, prec: Precision, fault: Fault = Fault()):
        self.bags = [torch.nn.EmbeddingBag(t.shape[0], t.shape[1], mode="sum", sparse=True,
                                           _weight=t) for t in tables]
        self.dense = {k: v.detach().clone().requires_grad_() for k, v in
                      dense_leaves(dense).items()}
        self.prec, self.fault = prec, fault
        self.layers = {p: len([k for k in self.dense if k.startswith(f"{p}/")]) // (
            3 if p == "cross" else 2) for p in ("bottom", "cross", "top")}

    def _linear(self, part: str, i: int, x: torch.Tensor) -> torch.Tensor:
        q = self.prec.q
        return q(x) @ q(self.dense[f"{part}/{i}/w"]) + self.dense[f"{part}/{i}/b"]

    def forward(self, dense: torch.Tensor, ids: list) -> torch.Tensor:
        q = self.prec.q
        z = dense
        for i in range(self.layers["bottom"]):
            z = F.relu(self._linear("bottom", i, z))
        x0 = torch.cat([z] + [bag(i.long()) for bag, i in zip(self.bags, ids)], dim=1)
        x = x0
        for i in range(self.layers["cross"]):
            c = {k: self.dense[f"cross/{i}/{k}"] for k in ("v", "u", "b")}
            low = q(q(x) @ q(c["v"])) @ q(c["u"]) + c["b"]
            x = (low if self.fault.no_x0 else x0 * low) + x
        n = self.layers["top"]
        for i in range(n):
            x = self._linear("top", i, x)
            if i < n - 1:
                x = F.relu(x)
        return x[:, 0]


def train_steps(tables: list, dense: dict, batches: list, lr: float, prec: Precision,
                fault: Fault = Fault()) -> dict:
    """Adagrad (dense) and row-wise Adagrad (tables, updated in place) from
    ``tables`` and ``dense`` over ``batches`` of (dense, ids, labels): the
    losses, the first gradients' norms by leaf (the tables' over their
    touched rows, ``tables/<f>``) and the dense leaves after the last step."""
    model = Model(tables, dense, prec, fault)
    opt = torch.optim.Adagrad(list(model.dense.values()), lr=lr, eps=EPS)
    acc = [torch.zeros(t.shape[0], device=t.device) for t in tables]
    losses, norms = [], None
    for x, ids, labels in batches:
        for p in model.dense.values():
            p.grad = None
        for bag in model.bags:
            bag.weight.grad = None
        out = model.forward(x, ids)
        w = torch.ones_like(labels)
        if fault.half:
            w[1::2] = 0.0
        loss = (F.binary_cross_entropy_with_logits(out, labels, reduction="none") * w).sum() \
            / w.sum()
        loss.backward()
        losses.append(float(loss.detach()))
        grads = [bag.weight.grad.coalesce() for bag in model.bags]
        if norms is None:
            norms = {k: float(torch.linalg.vector_norm(p.grad)) for k, p in model.dense.items()}
            norms.update({f"tables/{f}": float(torch.linalg.vector_norm(g.values()))
                          for f, g in enumerate(grads)})
        opt.step()
        with torch.no_grad():
            for f, (bag, a, g) in enumerate(zip(model.bags, acc, grads)):
                if f == fault.skip:
                    continue
                r, v = g.indices()[0], g.values()
                a[r] += (v * v).mean(1)
                bag.weight[r] -= (lr / (a[r].sqrt() + EPS))[:, None] * v
    return {"losses": losses, "norms": norms,
            "dense": {k: v.detach() for k, v in model.dense.items()}}


@torch.no_grad()
def logits(tables: list, dense: dict, split: tuple, prec: Precision, fault: Fault = Fault(),
           block: int = 65536) -> torch.Tensor:
    """[n] logits of ``split`` (dense [n, F], ids per feature [n, K_f], on
    the host or the device) in blocks of ``block`` samples."""
    model = Model(tables, dense, prec, fault)
    dev = tables[0].device
    x, ids = split[0], split[1]
    out = []
    for s in range(0, x.shape[0], block):
        out.append(model.forward(torch.as_tensor(x[s:s + block], device=dev),
                                 [torch.as_tensor(i[s:s + block], device=dev) for i in ids]))
    return torch.cat(out)


def auc(scores: torch.Tensor, labels: torch.Tensor) -> float:
    """ROC AUC in float64 by the Mann-Whitney count, ties by mean rank."""
    s = scores.double().cpu()
    y = labels.double().cpu()
    order = torch.argsort(s)
    s, y = s[order], y[order]
    values, counts = torch.unique_consecutive(s, return_counts=True)
    ends = torch.cumsum(counts, 0).double()
    mean_rank = ends - (counts.double() - 1) / 2
    ranks = torch.repeat_interleave(mean_rank, counts)
    p = float(y.sum())
    n = y.shape[0] - p
    return (float((ranks * y).sum()) - p * (p + 1) / 2) / (p * n)
