"""The reference's training step: the loss's gradient by autograd, the
global-norm clip and AdamW with decoupled weight decay, as a cell's
traffic file states them (``optimizer``: ``lr``, ``b1``, ``b2``,
``eps``, ``weight_decay``, ``grad_clip`` and ``groups``, a list of
``[regex, {"lr_mult": ..., "weight_decay": ...}]`` of which the first
match of a leaf's path wins).  The learning rate is constant.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

from bench.reference.model import Model, Params


def _group(opt: dict, path: str) -> Tuple[float, float]:
    for rx, over in opt.get("groups", ()):
        if re.search(rx, path):
            return (over.get("lr_mult", 1.0),
                    over.get("weight_decay", opt["weight_decay"]))
    return 1.0, opt["weight_decay"]


class AdamW:
    def __init__(self, opt: dict, params: Params):
        self.opt = opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def clipped(self, grads: Params) -> Params:
        clip = self.opt["grad_clip"]
        if clip <= 0:
            return grads
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp_max(clip / (norm + 1e-9), 1.0)
        return {k: g * scale for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        o = self.opt
        self.t += 1
        bc1, bc2 = 1.0 - o["b1"] ** self.t, 1.0 - o["b2"] ** self.t
        for k, g in grads.items():
            mult, wd = _group(o, k)
            m, v, p = self.m[k], self.v[k], params[k]
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"]) + wd * p
            p.add_(-o["lr"] * mult * u)


def step(model: Model, params: Params, adam: AdamW, batch: dict
         ) -> Tuple[torch.Tensor, Params]:
    """One step on ``batch``: ``params`` updated in place; returns the
    loss and the clipped gradient the optimizer got."""
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    loss = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    for v in params.values():
        v.requires_grad_(False)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(params.items(), grads)}
    grads = adam.clipped(grads)
    adam.step(params, grads)
    return loss.detach(), grads


def train(model: Model, params: Params, batches: List[dict],
          opt: dict) -> Dict[str, object]:
    """Steps over ``batches`` from ``params`` (updated in place) ->
    ``{"losses": [float], "grads": the first step's clipped gradient}``.
    """
    adam = AdamW(opt, params)
    losses, first = [], None
    for batch in batches:
        loss, grads = step(model, params, adam, batch)
        if first is None:
            first = grads
        losses.append(float(loss))
        del grads, loss
    return {"losses": losses, "grads": first}
