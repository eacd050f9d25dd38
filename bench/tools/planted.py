"""What is put in the program's place to show that a training cell's
check fails: the control and the planted faults.  The timed runner
knows nothing of them; each is a class with the interface of
:class:`bench.kinds.train.Program`, swapped in with :func:`in_place`.

* :class:`Control`: the reference, computed in fp8 (e4m3 operands, e5m2
  gradients) in the program's place;
* :class:`Frozen`: the program, its step returning the state unchanged;
* :class:`HalfBatch`: the program, each step given half of the batch's
  rows, the mean taken over them.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

from bench import weights
from bench.kinds import train
from bench.reference import model as ref_model
from bench.reference import optim as ref_optim


class Control:
    """The fp8 reference as the system under test."""

    def __init__(self, model: dict, mix: dict, seed: int, device):
        self.shapes = train.shapes_of(train.program_config(model))
        ref_model.no_tf32()
        self.net = ref_model.Model(model, device, ref_model.Arith("fp8"))
        self.params = weights.make(self.shapes, seed, model, device)
        self.adam = ref_optim.AdamW(mix["optimizer"], self.params)
        self.first = None

    def step(self, batch: dict) -> torch.Tensor:
        loss, grads = ref_optim.step(self.net, self.params, self.adam, batch)
        if self.first is None:
            self.first = train.on_host(grads)
        return loss

    def first_steps(self, batches: List[dict], model: dict, seed: int,
                    b1: float) -> dict:
        losses = [float(self.step(b)) for b in batches[:train.CHECK_STEPS]]
        return {"losses": losses, "grad1_t": self.first,
                "params3_t": train.on_host(self.params),
                "change3": train.change_norms(self.params, self.shapes,
                                              seed, model)}


class Frozen(train.Program):
    """A step that returns the state unchanged."""

    def __init__(self, *args):
        super().__init__(*args)
        real = self.step_fn

        def stuck(state, batch):
            keep = {k: v.clone() for k, v in
                    weights.flatten(state["params"]).items()}
            state, metrics = real(state, batch)
            for k, v in weights.flatten(state["params"]).items():
                v.copy_(keep[k])
            return state, metrics

        self.step_fn = stuck


def halved(batch: dict) -> dict:
    """The first half of a batch's rows."""
    return {k: t[: t.shape[0] // 2] for k, t in batch.items()}


class HalfBatch(train.Program):
    """Half of the batch left out, the mean taken over the rest."""

    def __init__(self, *args):
        super().__init__(*args)
        real = self.step_fn
        self.step_fn = lambda state, batch: real(state, halved(batch))


PLANTED = {"control": Control, "frozen": Frozen, "half_batch": HalfBatch}


@contextlib.contextmanager
def in_place(name: str):
    """Run the training cells with ``PLANTED[name]`` as the program."""
    real = train.Program
    train.Program = PLANTED[name]
    try:
        yield
    finally:
        train.Program = real
