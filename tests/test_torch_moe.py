"""Port parity, the Mixture-of-Experts layer: ``repro_torch.models.mlp``'s
``_route``, ``_moe_scatter``, ``_moe_einsum``, ``moe`` and
``moe_aux_loss``, the MoE transformer's loss gradients and the
speculative engine over MoE layers, on weights bridged from the live JAX
reference's ``init`` (``deepseek_moe_16b`` SMOKE: 8 routed experts top-2 +
1 shared, d_model 128, expert d_ff 64, fp32).

Where the reference reaches a Pallas kernel (``method="pallas"``) it runs
as its own tests run it: ``repro.kernels.ops`` in interpret mode on the
CPU, under its ``jax.vmap`` over the experts; the port's grouped kernels
run their plain versions here.  Expert SELL cascades operate at N = 128
(SMOKE) and, with ``d_ff=1280``, at N = 1280 > ``MAX_FUSED_N`` (the
grouped two-call ``scaled_matmul`` route of every full-width MoE config).

Capacity: ``capacity_factor`` 0.5 drops (token, slot)s, ``float(E)``
keeps every one.  Tolerances fp32 atol 2e-4, rtol 1e-3
(tests/test_kernel_grads.py:248); routing decisions (indices, positions,
keeps) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import get_model as jget
from repro.models import mlp as jmlp
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.spec import draft as jdraft
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.models import mlp as tmlp
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.spec import draft as tdraft

from _torch_clock import StepClock
from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
ARCH = "deepseek_moe_16b"
CAPACITY = {"drops": 0.5, "no-drops": 8.0}


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _cfgs(kind="dense", method="auto", **over):
    jcfg = jreg.get_smoke_config(ARCH)
    tcfg = treg.get_smoke_config(ARCH)
    if kind != "dense":
        jcfg = jreg.with_sell(jcfg, kind, method=method)
        tcfg = treg.with_sell(tcfg, kind, method=method)
    return (dataclasses.replace(jcfg, **over),
            dataclasses.replace(tcfg, **over))


def _moe_pair(kind="dense", method="auto", **over):
    """Both configs and layer 0's MoE parameters (reference, port)."""
    jcfg, tcfg = _cfgs(kind, method, **over)
    jp = jget(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(_flat(jp), device="cpu")
    jl = jax.tree.map(lambda v: v[0], jp["layers"]["moe"])
    tl = {k: v for k, v in _layer0(tp["layers"]["moe"]).items()}
    return jcfg, tcfg, jl, tl


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _x(cfg, b=3, s=7, seed=0):
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(
        np.float32)


@pytest.mark.parametrize("cap", sorted(CAPACITY))
def test_route_matches_reference(cap):
    jcfg, tcfg, jl, tl = _moe_pair(capacity_factor=CAPACITY[cap])
    xt = _x(jcfg).reshape(-1, jcfg.d_model)
    jv, ji, jpos, jkeep, jcap, joh = jmlp._route(jnp.asarray(xt), jl, jcfg)
    tv, ti, tpos, tkeep, tcap, toh = tmlp._route(torch.from_numpy(xt), tl,
                                                 tcfg)
    assert tcap == jcap == tmlp.capacity(tcfg, xt.shape[0])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)
    # the drop is exercised where it should be
    assert bool(tkeep.all()) == (cap == "no-drops")


@pytest.mark.parametrize("cap", sorted(CAPACITY))
@pytest.mark.parametrize("impl", ["scatter", "einsum"])
def test_dispatch_matches_reference(impl, cap):
    jcfg, tcfg, jl, tl = _moe_pair(capacity_factor=CAPACITY[cap])
    xt = _x(jcfg, seed=1).reshape(-1, jcfg.d_model)
    jr = jmlp._route(jnp.asarray(xt), jl, jcfg)
    tr = tmlp._route(torch.from_numpy(xt), tl, tcfg)
    if impl == "scatter":
        want = jmlp._moe_scatter(jl, jnp.asarray(xt), jcfg, *jr[:5])
        got = tmlp._moe_scatter(tl, torch.from_numpy(xt), tcfg, *tr[:5])
    else:
        want = jmlp._moe_einsum(jl, jnp.asarray(xt), jcfg, *jr)
        got = tmlp._moe_einsum(tl, torch.from_numpy(xt), tcfg, *tr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the two dispatches compute the same function
    other = (tmlp._moe_einsum(tl, torch.from_numpy(xt), tcfg, *tr)
             if impl == "scatter" else
             tmlp._moe_scatter(tl, torch.from_numpy(xt), tcfg, *tr[:5]))
    np.testing.assert_allclose(got.numpy(), other.numpy(), **F32)


# (kind, method, d_ff override): dense experts; SELL experts on every
# method at N = 128; pallas and matmul also at N = 1280 (two-call route)
EXPERTS = [("dense", "auto", None), ("acdc", "auto", None),
           ("acdc", "fft", None), ("acdc", "matmul", None),
           ("acdc", "pallas", None), ("acdc", "pallas", 1280),
           ("acdc", "matmul", 1280)]


@pytest.mark.parametrize("cap", sorted(CAPACITY))
@pytest.mark.parametrize("kind,method,d_ff", EXPERTS)
def test_moe_and_aux_loss_match_reference(kind, method, d_ff, cap):
    over = dict(capacity_factor=CAPACITY[cap])
    if d_ff:
        over["d_ff"] = d_ff
    jcfg, tcfg, jl, tl = _moe_pair(kind, method, **over)
    x = _x(jcfg, seed=2)
    np.testing.assert_allclose(
        tmlp.moe(tl, torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jmlp.moe(jl, jnp.asarray(x), jcfg)), **F32)
    np.testing.assert_allclose(
        float(tmlp.moe_aux_loss(tl, torch.from_numpy(x), tcfg)),
        float(jmlp.moe_aux_loss(jl, jnp.asarray(x), jcfg)), **F32)


@pytest.mark.parametrize("impl", ["scatter", "einsum"])
def test_moe_impls_equal(impl):
    _, tcfg, _, tl = _moe_pair("acdc", "matmul", capacity_factor=0.5)
    x = torch.from_numpy(_x(tcfg, seed=3))
    other = "einsum" if impl == "scatter" else "scatter"
    got = tmlp.moe(tl, x, dataclasses.replace(tcfg, moe_impl=impl))
    want = tmlp.moe(tl, x, dataclasses.replace(tcfg, moe_impl=other))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


@pytest.mark.parametrize("method,d_ff", [("matmul", None), ("pallas", None),
                                         ("pallas", 1280)])
def test_loss_grads_match_reference(method, d_ff):
    """``loss_fn`` (cross-entropy + 0.01 aux) and its gradient against
    ``jax.vjp`` for every parameter: experts' diagonals (grouped, per
    expert), router, shared expert, attention, norms, embedding."""
    over = dict(d_ff=d_ff) if d_ff else {}
    jcfg, tcfg = _cfgs("acdc", method, **over)
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    flat = _flat(jp)
    tp = bridge.to_torch(flat, device="cpu")
    leaves = {}

    def mark(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                mark(v, f"{prefix}{k}/")
            else:
                v.requires_grad_(True)
                leaves[f"{prefix}{k}"] = v

    mark(tp)
    rs = np.random.RandomState(4)
    toks = rs.randint(0, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss, vjp = jax.vjp(
        lambda p: jm.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jcfg), jp)
    jgrad = _flat(vjp(jnp.ones_like(jloss))[0])
    tloss = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, tcfg)
    tgrad = torch.autograd.grad(tloss, list(leaves.values()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **F32)
    assert set(leaves) == set(jgrad)
    for (path, _), g in zip(leaves.items(), tgrad):
        np.testing.assert_allclose(g.numpy(), jgrad[path], err_msg=path,
                                   **F32)
    assert jgrad["layers/moe/experts/wg/sell/a"].shape[1] == jcfg.n_experts


def test_truncate_cascades_on_expert_stacks():
    jcfg, tcfg = _cfgs("acdc", "pallas")
    jp = jget(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(_flat(jp), device="cpu")
    want = _flat(jdraft.truncate_cascades(jp, 1))
    got = bridge.to_numpy(tdraft.truncate_cascades(tp, 1))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # (L, E, K, N) expert stacks keep L and E, cut K
    assert got["layers/moe/experts/wu/sell/d"].shape == (
        jcfg.n_layers, jcfg.n_experts, 1, 128)


def _prompts(vocab):
    rs = np.random.RandomState(7)
    return [rs.randint(0, vocab, size=rs.randint(4, 12)).tolist()
            for _ in range(5)]


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_engine_streams_match_reference(paged, monkeypatch):
    """The speculative engine (k = 3, the default depth-1 draft of the K = 2
    cascades, experts truncated too) over MoE layers: the reference's
    greedy streams, finish reasons and acceptance counts.

    Paged, the reference runs its paged-attention kernel (interpret mode,
    ``FORCE_FUSED``) as the port runs its own: the MoE's capacity couples
    the batch's rows, so a parked row's output (the kernel attends it to
    its new tokens; the reference's CPU gather route to every stale key)
    reaches the live rows' routing."""
    from repro.kernels import paged_attn as jpaged_attn

    monkeypatch.setattr(jpaged_attn, "FORCE_FUSED", True)
    jcfg, tcfg = _cfgs("acdc", "pallas")
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(_flat(jp), device="cpu")
    kw = dict(n_slots=2, max_len=24, max_prompt_len=12, spec_k=3)
    if paged:
        kw.update(paged=True, block_size=4)
    out = []
    for eng_cls, req_cls, model, cfg, params in (
            (JEngine, JRequest, jm, jcfg, jp),
            (TEngine, TRequest, tm, tcfg, tp)):
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(_prompts(cfg.vocab_size))]
        eng = eng_cls(model, cfg, params, clock=StepClock(), **kw)
        eng.run(reqs, max_ticks=400)
        out.append(([list(map(int, r.generated)) for r in reqs],
                    [r.finish_reason for r in reqs],
                    (int(eng.stats["drafted"]), int(eng.stats["accepted"]))))
    assert out[1] == out[0]
    assert sum(map(len, out[1][0])) == 40
