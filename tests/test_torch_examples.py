"""The five PyTorch examples (``examples/*_torch.py``) against the JAX
examples beside them, on the CPU, on numpy-seeded inputs and weights
carried across by ``repro_torch.bridge``:

* quickstart: the parameter counts of sections [1] - [3] equal the
  reference's; the outputs of [1] (one layer), [2] (the 12-deep stack),
  [4] (the fused kernel: the reference's Pallas kernel in interpret mode,
  the port's plain version) and [5] (the smoke model's logits) agree;
* linear recovery: ``make_problem`` is bitwise the reference's; the
  per-step losses of K = 1 and K = 4 agree over 20 steps;
* convnet: the logits agree, and so do the parameters after 3 SGD steps,
  for ``acdc`` (a stack of ``CONV_K`` = 4, the example's 12 cut for
  time: every layer is the same mechanism) and ``dense``, on batches of
  the reference's ``synth_images``;
* train_lm: the parameter count equals the reference example's
  ``eval_shape`` count; 2 tiny steps train on the CPU and checkpoint (the
  reference launcher's ``main`` is red: ``test_launcher_main_smoke``);
* serve_lm: a smoke run finishes every request.

Tolerances fp32 atol 2e-4, rtol 1e-3 (tests/test_kernel_grads.py:248);
the convnet's parameters after 3 steps (lr multipliers up to x24 on
gradients that differ by the last bits) atol 2e-4, rtol 1e-3 too.
"""

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import acdc as JA
from repro.core import sell as jsell
from repro.kernels import ops as jops
from repro.models import get_model as jget
from repro.optim import OptimizerConfig as JOptConfig
from repro.optim import make_optimizer as jmake_opt
from repro.optim import step_decay_schedule as jstep_decay
from repro.optim.optimizers import tree_add, tree_paths
from repro_torch import bridge

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)
#: the convnet's ACDC depth here (the example's is 12)
CONV_K = 4
ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    """``examples/<name>.py`` as a module."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _n(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qs():
    return _load("quickstart_torch")


def test_quickstart_parameter_counts(qs):
    rng = jax.random.PRNGKey(0)
    jp1 = JA.init_acdc_params(rng, JA.ACDCConfig(n=512, k=1))
    j1 = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jp1))
    j12 = JA.ACDCConfig(n=512, k=12, relu=True, permute=True).param_count()
    j3 = jsell.SellConfig(kind="acdc", n_in=768, n_out=3072, k=2,
                          lane_multiple=128).param_count()
    got = qs.main(["--device", "cpu"])
    assert got["params"] == (j1, j12, j3)
    assert torch.isfinite(got["logits"]).all()
    assert got["fused"][4] <= F32["atol"]


@pytest.mark.parametrize("section", ["layer", "cascade"])
def test_quickstart_acdc_sections_match(qs, section):
    rng = jax.random.PRNGKey(0)
    jcfg = (JA.ACDCConfig(n=512, k=1) if section == "layer" else
            JA.ACDCConfig(n=512, k=12, relu=True, permute=True))
    jp = JA.init_acdc_params(rng, jcfg)
    x = np.random.RandomState(3).randn(8, 512).astype(np.float32)
    want = JA.acdc_cascade(jp, jnp.asarray(x), jcfg)
    got = getattr(qs, section)(bridge.to_torch(_flat(jp), device="cpu"),
                               _t(x))
    np.testing.assert_allclose(_n(got), np.asarray(want), **F32)


def test_quickstart_projection_matches(qs):
    scfg = jsell.SellConfig(kind="acdc", n_in=768, n_out=3072, k=2,
                            lane_multiple=128)
    jp = jsell.init_sell_params(jax.random.PRNGKey(0), scfg)
    x = np.random.RandomState(4).randn(4, 768).astype(np.float32)
    want = jsell.structured_linear(jp, jnp.asarray(x), scfg)
    got = qs.projection(bridge.to_torch(_flat(jp), device="cpu"), _t(x))
    np.testing.assert_allclose(_n(got), np.asarray(want), **F32)


def test_quickstart_fused_kernel_matches(qs):
    r = np.random.RandomState(5)
    n = qs.KERNEL_N
    a = (1 + 0.1 * r.randn(n)).astype(np.float32)
    d = (1 + 0.1 * r.randn(n)).astype(np.float32)
    x = r.randn(qs.KERNEL_M, n).astype(np.float32)
    want = jops.acdc_fused_op(jnp.asarray(x), jnp.asarray(a),
                              jnp.asarray(d), None)
    yk, yr, err = qs.fused(_t(x), _t(a), _t(d))
    np.testing.assert_allclose(_n(yk), np.asarray(want), **F32)
    np.testing.assert_allclose(_n(yr), np.asarray(want), **F32)
    assert err <= F32["atol"]


def test_quickstart_model_logits_match(qs):
    jcfg = dataclasses.replace(jreg.get_smoke_config("qwen3_1_7b"),
                               sell_kind="acdc", sell_k=2)
    jp = jax.jit(lambda r: jget(jcfg).init(r, jcfg))(jax.random.PRNGKey(0))
    toks = np.random.RandomState(6).randint(0, jcfg.vocab_size, (2, 16))
    want = jax.jit(lambda p, t: jget(jcfg).apply(p, t, jcfg))(
        jp, jnp.asarray(toks, jnp.int32))
    got = qs.model_logits(bridge.to_torch(_flat(jp), device="cpu"),
                          torch.from_numpy(toks.astype(np.int64)))
    np.testing.assert_allclose(_n(got), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# linear recovery
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fig3():
    from benchmarks import bench_fig3_recovery
    return bench_fig3_recovery


def test_linear_recovery_problem_is_the_references(fig3):
    lr = _load("linear_recovery_torch")
    want = fig3.make_problem()
    got = lr.make_problem(device="cpu")
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), _n(g))


@pytest.mark.parametrize("k", [1, 4])
def test_linear_recovery_losses_match(fig3, k):
    lr = _load("linear_recovery_torch")
    x, y, _ = fig3.make_problem()
    jcfg = JA.ACDCConfig(n=fig3.N, k=k, bias=True, init_mean=1.0,
                         init_std=1e-1)
    final, losses = fig3.train(jcfg, x, y, steps=20)
    params = bridge.to_torch(
        _flat(JA.init_acdc_params(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    tx, ty, _ = lr.make_problem(device="cpu")
    t_final, t_losses = lr.train(
        lr.A.ACDCConfig(n=lr.N, k=k, bias=True, **lr.GOOD), tx, ty,
        steps=20, params=params)
    np.testing.assert_allclose(_n(t_losses), np.asarray(losses), **F32)
    assert math.isclose(t_final, final, rel_tol=F32["rtol"],
                        abs_tol=F32["atol"])
    assert t_losses[-1] < t_losses[0]


# ---------------------------------------------------------------------------
# convnet
# ---------------------------------------------------------------------------

def _jax_convnet_step(jconv, fc, steps, cfg):
    """The reference example's jitted SGD step (its ``main``), on given
    batches."""
    groups = ((r"sell/a$", {"lr_mult": 24.0, "weight_decay": 0.0}),
              (r"sell/d$", {"lr_mult": 12.0, "weight_decay": 0.0}),
              (r"sell/bias$", {"weight_decay": 0.0}))
    opt = jmake_opt(JOptConfig(kind="sgd", lr=1.0, momentum=0.65,
                               weight_decay=5e-4, grad_clip=1.0,
                               groups=groups),
                    jstep_decay(1e-3, 0.1, max(steps // 2, 1)))

    def loss_fn(p, x, y):
        logits = jconv.forward(p, x, fc, cfg)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    @jax.jit
    def step(p, opt_state, i, x, y):
        g = jax.grad(loss_fn)(p, x, y)
        u, opt_state = opt.update(g, opt_state, p, i)
        return tree_add(p, u), opt_state

    return opt, step


@pytest.mark.parametrize("fc", ["acdc", "dense"])
def test_convnet_logits_and_three_steps_match(fc):
    jconv = _load("convnet_acdc")
    tconv = _load("convnet_acdc_torch")
    steps = 300

    def init(rng):          # under jit: eager JAX compiles every op
        p, _ = jconv.init_model(rng, fc, CONV_K)
        p.pop("_cfg", None)
        return p

    jp = jax.jit(init)(jax.random.PRNGKey(0))
    n_feat = 8 * (jconv.IMG // 2) ** 2
    synth = jax.jit(jconv.synth_images, static_argnums=1)
    jcfg = JA.ACDCConfig(n=n_feat, k=CONV_K, relu=True, permute=True,
                         bias=True, init_std=0.061)
    tp = bridge.to_torch(_flat(jp), device="cpu")
    tcfg = tconv.acdc_config(CONV_K)
    x, y = synth(jax.random.PRNGKey(7), 64)
    want = jconv.forward(jp, x, fc, jcfg)
    got = tconv.forward(tp, _t(x), fc, tcfg)
    np.testing.assert_allclose(_n(got), np.asarray(want), **F32)

    opt, step = _jax_convnet_step(jconv, fc, steps, jcfg)
    jstate = opt.init(jp)
    topt = tconv.make_opt(steps)
    tstate = topt.init(tp)
    for i in range(3):
        x, y = synth(jax.random.fold_in(jax.random.PRNGKey(0), i), 64)
        jp, jstate = step(jp, jstate, jnp.asarray(i), x, y)
        tp, tstate, loss, _ = tconv.train_step(
            tp, tstate, topt, _t(x), _t(y), i, fc, tcfg)
        assert torch.isfinite(loss)
    want = _flat(jp)
    got = bridge.to_numpy(tp)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], **F32,
                                   err_msg=path)


def test_convnet_images_and_run_on_the_cpu():
    """The port's own data: the reference's shapes and classes; a short
    run trains."""
    tconv = _load("convnet_acdc_torch")
    x, y = tconv.synth_images(torch.Generator().manual_seed(0), 8,
                              device="cpu")
    assert x.shape == (8, 16, 16, 1) and y.shape == (8,)
    assert int(y.min()) >= 0 and int(y.max()) < tconv.N_CLASSES
    out = tconv.main(["--steps", "4", "--batch", "16", "--k", "2",
                      "--device", "cpu"])
    assert all(math.isfinite(v) for v in out["losses"])
    assert 0.0 <= out["eval_acc"] <= 1.0


# ---------------------------------------------------------------------------
# train_lm, serve_lm
# ---------------------------------------------------------------------------

def test_train_lm_parameter_count_and_two_steps(tmp_path):
    lm = _load("train_lm_torch")
    jcfg = dataclasses.replace(
        jreg.get_config("qwen3_1_7b"),
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=32000, dtype="float32")
    probe = jax.eval_shape(lambda r: jget(jcfg).init(r, jcfg),
                           jax.random.PRNGKey(0))
    want = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(probe))
    assert lm.param_count(lm.config()) == want
    state, history = lm.main(["--steps", "2", "--seq-len", "16",
                              "--global-batch", "2", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path)])
    assert len(history) == 2
    assert all(math.isfinite(h["loss"]) for h in history)
    assert any(tmp_path.iterdir())


def test_serve_lm_finishes_every_request():
    sl = _load("serve_lm_torch")
    eng, reqs = sl.main(sl.DEFAULT_ARGV + ["--device", "cpu"])
    assert reqs and all(r.done for r in reqs)
    assert all(r.finish_reason == "length" and len(r.generated) == 24
               for r in reqs)
