"""Port parity, the SELL methods and kinds end to end: the port's engine
and train step against the live reference on bridged weights.

* the smoke decoder served greedily by ``repro_torch.serving.Engine``
  and ``repro.serving.Engine``: ``--sell acdc`` at ``method`` ``matmul``
  and ``fft`` (dense), ``fft`` paged (4-token pages), and ``--sell
  low_rank``, ``fastfood``, ``circulant`` (dense): TOKEN-IDENTICAL
  streams and finish reasons;
* three ``make_train_step`` steps under ``fft`` against the reference's:
  loss, grad_norm and update_norm each step, every parameter and moment
  at the end (fp32 atol 2e-4, rtol 1e-3, tests/test_kernel_grads.py:248);
* a cascade-free kind has nothing to truncate: the speculative engine
  refuses it without ``draft_skip_layers``, as the reference does, and
  with them drafts and serves the reference's streams;
* both launchers default to the reference's ``--sell-method auto``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import steps as jsteps
from repro.launch.train import SELL_GROUPS as J_SELL_GROUPS
from repro.models import get_model as jget
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.dist import steps as tsteps
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model as tget
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import Request as TRequest

from _torch_clock import StepClock
from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)


def _flat(tree):
    return dict(zip(jax.tree.leaves(tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _cfgs(kind, method):
    return (jreg.with_sell(jreg.get_smoke_config("qwen3_1_7b"), kind,
                           method=method),
            treg.with_sell(treg.get_smoke_config("qwen3_1_7b"), kind,
                           method=method))


def _prompts(vocab):
    rs = np.random.RandomState(7)
    return [rs.randint(0, vocab, size=rs.randint(4, 12)).tolist()
            for _ in range(5)]


def _serve_both(kind, method, **kw):
    jcfg, tcfg = _cfgs(kind, method)
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(_flat(jp), device="cpu")
    kw = dict(n_slots=2, max_len=24, max_prompt_len=12, **kw)
    out = []
    for eng_cls, req_cls, model, cfg, params in (
            (JEngine, JRequest, jm, jcfg, jp),
            (TEngine, TRequest, tm, tcfg, tp)):
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(_prompts(cfg.vocab_size))]
        eng_cls(model, cfg, params, clock=StepClock(), **kw).run(reqs, max_ticks=400)
        out.append(([list(map(int, r.generated)) for r in reqs],
                    [r.finish_reason for r in reqs]))
    return out


@pytest.mark.parametrize("kind,method,paged", [
    ("acdc", "matmul", False), ("acdc", "fft", False),
    ("acdc", "fft", True), ("low_rank", "auto", False),
    ("fastfood", "auto", False), ("circulant", "auto", False)])
def test_greedy_streams_identical_to_reference(kind, method, paged):
    kw = dict(paged=True, block_size=4) if paged else {}
    (jstreams, jfin), (tstreams, tfin) = _serve_both(kind, method, **kw)
    assert tstreams == jstreams
    assert tfin == jfin
    assert sum(map(len, tstreams)) == 40


def test_train_steps_match_reference_under_fft():
    jcfg, tcfg = _cfgs("acdc", "fft")
    jm, tm = jget(jcfg), tget(tcfg)
    ocfg = dict(kind="adamw", lr=3e-3, groups=J_SELL_GROUPS)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg),
                             jsched.cosine_schedule(3e-3, 1, 6))
    to = topt.make_optimizer(topt.OptimizerConfig(**ocfg),
                             tsched.cosine_schedule(3e-3, 1, 6))
    jstate = jsteps.init_state(jm, jcfg, jo, jax.random.PRNGKey(0))
    tstate = bridge.state_to_torch(_flat(jstate), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jm, jcfg, jo, 1))
    tstep = tsteps.make_train_step(tm, tcfg, to, 1)
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                    global_batch=4))
    for step in range(3):
        batch = {n: np.array(v) for n, v in data.batch_at(step).items()}
        jstate, jmet = jstep(jstate, {n: jnp.asarray(v)
                                      for n, v in batch.items()})
        tstate, tmet = tstep(tstate, {n: torch.from_numpy(v)
                                      for n, v in batch.items()})
        for name in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                       err_msg=f"{name} step {step}", **F32)
    want = _flat(jstate)
    got = bridge.state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **F32)


def test_cascade_free_kind_drafts_only_with_skipped_layers():
    jcfg, tcfg = _cfgs("low_rank", "auto")
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    tp = bridge.to_torch(_flat(jp), device="cpu")
    kw = dict(n_slots=2, max_len=24, max_prompt_len=12, spec_k=2)
    with pytest.raises(ValueError, match="no stacked cascades"):
        JEngine(jm, jcfg, jp, clock=StepClock(), **kw)
    with pytest.raises(ValueError, match="no stacked cascades"):
        TEngine(tm, tcfg, tp, clock=StepClock(), **kw)
    streams = []
    for eng_cls, req_cls, model, cfg, params in (
            (JEngine, JRequest, jm, jcfg, jp),
            (TEngine, TRequest, tm, tcfg, tp)):
        eng = eng_cls(model, cfg, params, clock=StepClock(), draft_skip_layers=1, **kw)
        assert eng.draft.skip_layers == 1 and eng.draft.depth is None
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(_prompts(cfg.vocab_size))]
        eng.run(reqs, max_ticks=400)
        streams.append([list(map(int, r.generated)) for r in reqs])
    assert streams[1] == streams[0]


def test_launchers_default_to_auto():
    for launcher in (tserve, ttrain):
        args = launcher.parse_args([])
        assert args.sell_method == "auto" and args.device == "cuda"
    cfg, _, _ = tserve.build(tserve.parse_args(
        ["--smoke", "--sell", "acdc", "--device", "cpu"]))
    assert cfg.sell_method == "auto"
    full = treg.with_sell(treg.get_config("qwen3_1_7b"), "acdc",
                          method="auto")
    assert tserve.sell_routes(full) == "N=2048 matmul, N=6144 fft"
    assert tserve.sell_routes(treg.get_config("qwen3_1_7b")) == ""
