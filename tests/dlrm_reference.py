"""A plain reference of DLRM-DCNv2's training step: float32 PyTorch, nothing
of the port (no gather kernel, no compact route, no graph), written from
the published description (DLRM, arXiv:1906.00091; DCN-V2's low-rank cross
network, arXiv:2008.13535; MLPerf Training's ``recommendation_v2/
torchrec_dlrm`` reference, TorchRec's ``DLRM_DCN``): an
``nn.EmbeddingBag(mode="sum")`` per feature, the bottom MLP, the cross
layers, the top MLP, binary cross-entropy and autograd, then
``torch.optim.Adagrad`` on the dense parameters and FBGEMM's exact
row-wise Adagrad on the rows the batch touched (from the bags' sparse
gradients).

Departures from the published description, each the port's too:

- the weights come in the port's tree (``models/dlrm.init_params``), each
  table with spare rows past its rows held, which this reference leaves out;
- the cross layers' V and U are stored transposed ([in, rank], [rank, in]),
  as row-major products take them; the linear layers' weights as [in, out];
- Adagrad's eps is 1e-8 on the dense parameters as on the tables.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-8


class DLRM(nn.Module):
    """The model on the port's tree of weights (copied), table f's first
    ``rows[f]`` rows."""

    def __init__(self, params: dict, rows):
        super().__init__()
        self.bags = nn.ModuleList(
            nn.EmbeddingBag(r, t.shape[1], mode="sum", sparse=True,
                            _weight=t[:r].detach().clone()) for t, r in zip(params["tables"], rows))
        self.bottom = nn.ModuleList(_linear(p) for p in params["bottom"])
        self.cross = nn.ParameterList()
        for c in params["cross"]:
            self.cross.extend([nn.Parameter(c["v"].detach().clone()),
                               nn.Parameter(c["u"].detach().clone()),
                               nn.Parameter(c["b"].detach().clone())])
        self.top = nn.ModuleList(_linear(p) for p in params["top"])

    def forward(self, dense: torch.Tensor, ids: list[torch.Tensor]) -> torch.Tensor:
        z = dense
        for layer in self.bottom:
            z = F.relu(layer(z))
        x0 = torch.cat([z] + [bag(i.long()) for bag, i in zip(self.bags, ids)], dim=1)
        x = x0
        for i in range(0, len(self.cross), 3):
            v, u, b = self.cross[i], self.cross[i + 1], self.cross[i + 2]
            x = x0 * ((x @ v) @ u + b) + x
        for j, layer in enumerate(self.top):
            x = layer(x)
            if j < len(self.top) - 1:
                x = F.relu(x)
        return x[:, 0]

    def dense_parameters(self) -> list[nn.Parameter]:
        return [p for name, p in self.named_parameters() if not name.startswith("bags.")]

    def tree(self, grads: bool = False) -> dict:
        """The weights (or with ``grads`` the dense parameters' gradients) in
        the port's tree, each table its rows held alone."""
        def get(p):
            return (p.grad if grads else p).detach().clone()

        def lin(m):
            return {"w": get(m.weight).T.contiguous(), "b": get(m.bias)}

        out = {"bottom": [lin(m) for m in self.bottom],
               "cross": [{"v": get(self.cross[i]), "u": get(self.cross[i + 1]),
                          "b": get(self.cross[i + 2])} for i in range(0, len(self.cross), 3)],
               "top": [lin(m) for m in self.top]}
        if not grads:
            out["tables"] = [b.weight.detach().clone() for b in self.bags]
        return out


def _linear(p: dict) -> nn.Linear:
    m = nn.Linear(*p["w"].shape)
    with torch.no_grad():
        m.weight.copy_(p["w"].T)
        m.bias.copy_(p["b"])
    return m


def loss_and_grads(model: DLRM, dense, ids, labels):
    """(loss, the dense parameters' gradients in the port's tree, per table
    (touched rows [R] ascending, their summed gradients [R, d]))."""
    model.zero_grad(set_to_none=True)
    loss = F.binary_cross_entropy_with_logits(model(dense, ids), labels)
    loss.backward()
    grads = model.tree(grads=True)
    rows = []
    for bag in model.bags:
        g = bag.weight.grad.coalesce()
        rows.append((g.indices()[0], g.values()))
    return float(loss.detach()), grads, rows


def train_steps(params: dict, rows, batches: list, lr: float) -> dict:
    """Adagrad (dense) and row-wise Adagrad (tables) from ``params`` (tables
    of ``rows`` rows held) over ``batches`` of (dense, ids, labels): the
    losses, the first step's gradients and the params after the last step,
    in the port's tree."""
    model = DLRM(params, rows)
    opt = torch.optim.Adagrad(model.dense_parameters(), lr=lr, eps=EPS)
    acc = [torch.zeros(b.weight.shape[0]) for b in model.bags]
    losses, first = [], None
    for dense, ids, labels in batches:
        loss, grads, rows = loss_and_grads(model, dense, ids, labels)
        losses.append(loss)
        first = first or {"dense": grads, "rows": rows}
        opt.step()
        with torch.no_grad():
            for bag, a, (r, g) in zip(model.bags, acc, rows):
                a[r] += (g * g).mean(1)
                bag.weight[r] -= (lr / (a[r].sqrt() + EPS))[:, None] * g
    return {"losses": losses, "first": first, "params": model.tree(), "row_acc": acc}
