"""The plain reference against the program's CPU path (its kernels'
plain versions) at smoke size, fp32, for both configurations: logits,
loss and gradients."""

import pytest
import torch

from bench import weights
from bench.kinds import train as train_kind
from bench.reference import model as ref_model
from bench.traffic import train as gen
from bench.tests.smoke import smoke_model

CPU = torch.device("cpu")


def _program(cfg_dict):
    from repro_torch.models import get_model

    cfg = train_kind.program_config(cfg_dict)
    return cfg, get_model(cfg)


@pytest.mark.parametrize("name", ["seamless_m4t_large_v2",
                                  "deepseek_moe_16b-stage7"])
def test_loss_and_grads_match_the_program(name):
    d = smoke_model(name, dtype="float32")
    cfg, model = _program(d)
    shapes = train_kind.shapes_of(cfg)
    mix = {"rows": 2, "seq": 12, "frames": 6 if d["family"] == "encdec"
           else 0, "zipf_a": 1.2, "markov": 0.5}
    batch = gen.batch(mix, d, 3, 0, CPU)
    flat = weights.make(shapes, 3, d, CPU)
    for v in flat.values():
        v.requires_grad_(True)
    loss_p = model.loss_fn(weights.nest(flat), batch, cfg)
    grads_p = torch.autograd.grad(loss_p, list(flat.values()))
    ref = ref_model.Model(d, CPU)
    flat_r = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat.items()}
    loss_r = ref.loss(flat_r, batch)
    grads_r = torch.autograd.grad(loss_r, list(flat_r.values()))
    assert float(loss_p.detach()) == pytest.approx(float(loss_r.detach()), rel=1e-5)
    for k, gp, gr in zip(flat, grads_p, grads_r):
        scale = max(float(gr.norm()), 1e-6)
        assert float((gp - gr).norm()) / scale < 1e-4, k


def test_logits_match_the_program():
    d = smoke_model("seamless_m4t_large_v2", dtype="float32")
    cfg, model = _program(d)
    shapes = train_kind.shapes_of(cfg)
    flat = weights.make(shapes, 4, d, CPU)
    tokens = torch.randint(0, d["vocab_size"], (2, 9),
                           generator=torch.Generator().manual_seed(0))
    frames = torch.randn((2, 5, d["d_model"]),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.apply(weights.nest(flat), tokens, cfg, frames)
        ref = ref_model.Model(d, CPU)
        want = ref.logits(flat, ref.encdec_hidden(flat, tokens, frames))
    assert float((got - want).abs().max()) < 1e-4


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import os

    here = os.path.join(os.path.dirname(ref_model.__file__))
    for f in os.listdir(here):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(here, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in (
                        "repro_torch", "repro", "jax", "jaxlib", "flax"), (f, n)
