"""Port parity, training: the port's optimizers, schedules, data,
checkpoints and train step against the live JAX reference on the CPU.

* ``adamw`` (also with ``compact_state``) and ``sgd_momentum`` with and
  without clipping, ``global_norm`` and the schedules on random trees that
  hit every ``SELL_GROUPS`` regex;
* ``SyntheticLM``: label shift, -1 at the end, token range, and the Markov
  hash against the reference's formula on the reference's own tokens;
* checkpoints written by each package restore in the other;
* three steps of ``make_train_step`` (K = 2 and K = 1, ``accum_steps`` 1
  and 2) against ``repro.dist.steps.make_train_step`` on one bridged state
  and the same numpy batches: loss, grad_norm and update_norm each step,
  and every parameter and moment at the end;
* the launcher on the CPU: train, checkpoint, resume.

Tolerances: fp32 with different summation orders, atol 2e-4 / rtol 1e-3
(tests/test_kernel_grads.py:248) for the train step; the optimizer's
elementwise arithmetic is the reference's op for op, held at rtol 1e-5.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.configs import registry as jreg
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import steps as jsteps
from repro.launch.train import SELL_GROUPS as J_SELL_GROUPS
from repro.models import get_model as jget
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager as TCkpt
from repro_torch.configs import registry as treg
from repro_torch.data import DataConfig as TDataConfig
from repro_torch.data import SyntheticLM as TSyntheticLM
from repro_torch.data.pipeline import markov_next
from repro_torch.dist import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model as tget
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

from _torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-4, rtol=1e-3)

#: leaf paths touching every SELL_GROUPS regex and the default group
_PATHS = ("layers/attn/wo/sell/a", "layers/attn/wo/sell/d",
          "layers/mlp/wg/sell/bias", "layers/norm1/scale",
          "final_norm/scale", "embed/table", "layers/attn/wq/w",
          "head/bias")


def _flat(tree):
    return dict(zip(jax.tree.leaves(jopt.tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def _random_tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {p: (scale * rs.randn(3, 5)).astype(np.float32) for p in _PATHS}


def _nest_jax(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def test_sell_groups_match_reference():
    assert ttrain.SELL_GROUPS == J_SELL_GROUPS
    params = _random_tree(0)
    cfg_j = jopt.OptimizerConfig(groups=J_SELL_GROUPS)
    cfg_t = topt.OptimizerConfig(groups=ttrain.SELL_GROUPS)
    jl, jw = jopt._group_maps(cfg_j, _nest_jax(params))
    tl, tw = topt._group_maps(cfg_t, bridge.to_torch(params, device="cpu"))
    jl_flat = dict(zip(jax.tree.leaves(jopt.tree_paths(jl)),
                       jax.tree.leaves(jl)))
    jw_flat = dict(zip(jax.tree.leaves(jopt.tree_paths(jw)),
                       jax.tree.leaves(jw)))
    tpaths, tls = topt.tree_flatten(tl)
    _, tws = topt.tree_flatten(tw)
    assert tpaths == sorted(jl_flat)
    assert dict(zip(tpaths, tls)) == jl_flat
    assert dict(zip(tpaths, tws)) == jw_flat
    # every group is hit at least once
    assert {v for v in tls} == {24.0, 12.0, 1.0}
    assert {v for v in tws} == {0.0, 0.1}


def test_global_norm_matches_reference():
    tree = _random_tree(1)
    want = float(jopt.global_norm(_nest_jax(tree)))
    got = float(topt.global_norm(bridge.to_torch(tree, device="cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kind,compact,clip", [
    ("adamw", False, 1.0), ("adamw", False, 0.0), ("adamw", True, 1.0),
    ("sgd", False, 1.0), ("sgd", False, 0.0)])
def test_optimizer_matches_reference(kind, compact, clip):
    kw = dict(kind=kind, lr=1e-2, groups=J_SELL_GROUPS, grad_clip=clip,
              compact_state=compact)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**kw),
                             jsched.cosine_schedule(1e-2, 1, 5))
    to = topt.make_optimizer(topt.OptimizerConfig(**kw),
                             tsched.cosine_schedule(1e-2, 1, 5))
    params = _random_tree(2)
    jp = _nest_jax(params)
    tp = bridge.to_torch(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _random_tree(10 + step, scale=0.5 + step)
        ju, js = jo.update(_nest_jax(grads), js, jp, jnp.int32(step))
        tu, ts = to.update(bridge.to_torch(grads, device="cpu"), ts, tp,
                           step)
        jp = jopt.tree_add(jp, ju)
        topt.tree_map(lambda p, u: p.add_(u), tp, tu)
        np.testing.assert_allclose(
            float(topt.global_norm(tu)), float(jopt.global_norm(ju)),
            rtol=1e-5)
        for name, jt, tt in (("params", jp, tp), ("updates", ju, tu),
                             ("state", js, ts)):
            jf = _flat(jt)
            tf = bridge.to_numpy(tt)
            assert sorted(jf) == sorted(tf), name
            for path in jf:
                np.testing.assert_allclose(
                    tf[path].astype(np.float32),
                    jf[path].astype(np.float32), rtol=1e-5, atol=1e-7,
                    err_msg=f"{name} {path} step {step}")


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)),
    ("step_decay_schedule", (1e-2, 0.1, 4)),
    ("cosine_schedule", (3e-4, 3, 20)),
    ("cosine_schedule", (1e-3, 0, 7, 0.2))])
def test_schedules_match_reference(name, args):
    jfn = getattr(jsched, name)(*args)
    tfn = getattr(tsched, name)(*args)
    for step in (0, 1, 2, 3, 5, 9, 19, 25):
        np.testing.assert_allclose(float(tfn(step)),
                                   float(jfn(jnp.int32(step))), rtol=1e-6)


def test_synthetic_lm_labels_and_range():
    cfg = TDataConfig(vocab_size=300, seq_len=33, global_batch=3, seed=4)
    data = TSyntheticLM(cfg)
    b = data.batch_at(7)
    tok, lab = b["tokens"], b["labels"]
    assert tok.shape == lab.shape == (3, 33)
    assert tok.dtype == lab.dtype == torch.int32
    assert torch.equal(lab[:, :-1], tok[:, 1:])
    assert bool((lab[:, -1] == -1).all())
    assert int(tok.min()) >= 0 and int(tok.max()) < 300
    assert torch.equal(data.batch_at(7)["tokens"], tok)   # stateless
    assert not torch.equal(data.batch_at(8)["tokens"], tok)
    # half the tokens are the hash of the ORIGINAL previous token, which
    # itself survives with probability 1/2: about a quarter of the pairs
    # follow the hash in the final stream, as in the reference
    hit = (markov_next(tok[:, :-1], 300) == tok[:, 1:]).float().mean()
    assert 0.15 < float(hit) < 0.45
    # a vision frontend: stub patch embeddings drawn after the tokens (the
    # tokens stay those of the same seed and step), no loss on the prefix
    fcfg = dataclasses.replace(cfg, frontend="vision", n_frontend_tokens=5,
                               d_model=8)
    fb = TSyntheticLM(fcfg).batch_at(7)
    assert torch.equal(fb["tokens"], tok)
    assert fb["frontend_embeds"].shape == (3, 5, 8)
    assert fb["frontend_embeds"].dtype == torch.float32
    assert bool((fb["labels"][:, :5] == -1).all())
    assert torch.equal(fb["labels"][:, 5:], lab[:, 5:])


def test_markov_hash_matches_reference_on_its_tokens():
    cfg = JDataConfig(vocab_size=5000, seq_len=64, global_batch=4, seed=1)
    ref = JSyntheticLM(cfg).batch_at(3)
    tok = np.asarray(ref["tokens"])
    tu = jnp.asarray(tok[:, :-1]).astype(jnp.uint32)
    want = ((tu * jnp.uint32(2654435761) + jnp.uint32(12345))
            % jnp.uint32(5000)).astype(jnp.int32)
    got = markov_next(torch.from_numpy(tok[:, :-1].copy()), 5000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.15 < float(np.mean(np.asarray(want) == tok[:, 1:])) < 0.45
    # and on the hash's full input range (uint32 wrap-around)
    big = np.array([[0, 1, 4999, 2 ** 20 + 3, 2 ** 31 - 1]], np.int64)
    want_big = ((jnp.asarray(big).astype(jnp.uint32) * jnp.uint32(2654435761)
                 + jnp.uint32(12345)) % jnp.uint32(5000))
    np.testing.assert_array_equal(
        markov_next(torch.from_numpy(big), 5000).numpy(),
        np.asarray(want_big).astype(np.int32))


def _tiny_state():
    params = _random_tree(3)
    return {"params": params,
            "opt": {"m": _random_tree(4), "v": _random_tree(5)},
            "step": 7}


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    state = _tiny_state()
    tstate = bridge.state_to_torch(
        {**{f"params/{k}": v for k, v in state["params"].items()},
         **{f"opt/m/{k}": v for k, v in state["opt"]["m"].items()},
         **{f"opt/v/{k}": v for k, v in state["opt"]["v"].items()},
         "step": np.int32(7)}, device="cpu")
    tck = TCkpt(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        tck.save_async(s, tstate, extra={"arch": "qwen3_1_7b", "s": s})
    tck.wait()
    assert tck.all_steps() == [2, 3]          # keep-2 garbage collection
    jck = JCkpt(str(tmp_path), keep=2)
    assert jck.latest_step() == 3 and jck.extra(3)["s"] == 3
    like = {"params": _nest_jax(state["params"]),
            "opt": {"m": _nest_jax(state["opt"]["m"]),
                    "v": _nest_jax(state["opt"]["v"])},
            "step": jnp.int32(0)}
    got = _flat(jck.restore(3, like))
    want = bridge.state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path])


def test_async_save_holds_the_state_of_its_call(tmp_path, monkeypatch):
    """``save_async`` copies every leaf when it is called: an in-place
    update after the call (the next step's optimizer) does not reach the
    file, however late its writer thread runs."""
    import threading

    go = threading.Event()
    write = TCkpt._write

    def late_write(self, *args):
        go.wait(30)
        write(self, *args)

    monkeypatch.setattr(TCkpt, "_write", late_write)
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "m": torch.ones(3)}
    want = {k: v.clone() for k, v in state.items()}
    tck = TCkpt(str(tmp_path))
    tck.save_async(1, state)
    for t in state.values():
        t.add_(1.0)
    go.set()
    tck.wait()
    got = tck.restore(1, want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    state = _tiny_state()
    jstate = {"params": _nest_jax(state["params"]),
              "opt": {"m": _nest_jax(state["opt"]["m"]),
                      "v": _nest_jax(state["opt"]["v"])},
              "step": jnp.int32(7)}
    JCkpt(str(tmp_path)).save(7, jstate, extra={"arch": "x"})
    tck = TCkpt(str(tmp_path))
    assert tck.latest_step() == 7 and tck.extra(7) == {"arch": "x"}
    like = bridge.state_to_torch(
        {k: np.zeros_like(v) for k, v in _flat(jstate).items()},
        device="cpu")
    got = tck.restore(7, like)
    assert got["step"] == 7 and isinstance(got["step"], int)
    want = _flat(jstate)
    flat = bridge.state_to_numpy(got)
    for path in want:
        np.testing.assert_array_equal(flat[path], want[path])


def _train_pair(k: int, accum: int):
    jcfg = dataclasses.replace(
        jreg.with_sell(jreg.get_smoke_config("qwen3_1_7b"), "acdc",
                       method="pallas"), sell_k=k)
    tcfg = dataclasses.replace(
        treg.with_sell(treg.get_smoke_config("qwen3_1_7b"), "acdc",
                       method="pallas"), sell_k=k)
    jm, tm = jget(jcfg), tget(tcfg)
    ocfg = dict(kind="adamw", lr=3e-3, groups=J_SELL_GROUPS)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg),
                             jsched.cosine_schedule(3e-3, 1, 6))
    to = topt.make_optimizer(topt.OptimizerConfig(**ocfg),
                             tsched.cosine_schedule(3e-3, 1, 6))
    jstate = jsteps.init_state(jm, jcfg, jo, jax.random.PRNGKey(0))
    tstate = bridge.state_to_torch(_flat(jstate), device="cpu")
    return (jax.jit(jsteps.make_train_step(jm, jcfg, jo, accum)), jstate,
            tsteps.make_train_step(tm, tcfg, to, accum), tstate,
            jcfg.vocab_size)


@pytest.mark.parametrize("k,accum", [(2, 1), (2, 2), (1, 1), (1, 2)])
def test_train_steps_match_reference(k, accum):
    jstep, jstate, tstep, tstate, vocab = _train_pair(k, accum)
    data = JSyntheticLM(JDataConfig(vocab_size=vocab, seq_len=16,
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
    assert tstate["step"] == int(jstate["step"]) == 3
    want = _flat(jstate)
    got = bridge.state_to_numpy(tstate)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **F32)


def test_train_step_counts_reverse_sweeps():
    from repro_torch.kernels import ops as tops

    _, _, tstep, tstate, vocab = _train_pair(2, 1)
    data = TSyntheticLM(TDataConfig(vocab_size=vocab, seq_len=8,
                                    global_batch=2))
    before = dict(tops.CASCADE_BWD_DISPATCHES)
    tstep(tstate, data.batch_at(0))
    # 3 layers x 4 SELL projections (attn_out, mlp wg/wu/wd), one fused
    # cascade backward each
    assert tops.CASCADE_BWD_DISPATCHES["reverse_sweep"] == \
        before["reverse_sweep"] + 12
    assert tops.CASCADE_BWD_DISPATCHES["per_layer_scan"] == \
        before["per_layer_scan"]


def _launch(ckpt_dir, *extra):
    return ttrain.main(["--arch", "qwen3_1_7b", "--smoke", "--sell", "acdc",
                        "--sell-method", "pallas", "--device", "cpu",
                        "--seq-len", "16", "--global-batch", "2",
                        "--log-every", "1", "--ckpt-dir", str(ckpt_dir),
                        *extra])


def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    _, full = _launch(tmp_path / "a", "--steps", "3", "--ckpt-every", "2")
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "|g|" in out and "done." in out
    assert all(np.isfinite(m["loss"]) for m in full)
    assert TCkpt(str(tmp_path / "a")).all_steps() == [2, 3]
    # cut the run after step 2 and resume: the last step repeats exactly
    shutil.rmtree(tmp_path / "a" / "step_0000000003")
    _, resumed = _launch(tmp_path / "a", "--steps", "3", "--resume")
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done." in out
    assert len(resumed) == 1
    for name in ("loss", "grad_norm", "update_norm"):
        np.testing.assert_allclose(resumed[0][name], full[2][name],
                                   rtol=1e-6)


def test_launcher_defaults_to_cuda_and_pallas():
    """The reference's default method, ``auto``, on the card."""
    args = ttrain.parse_args([])
    assert args.device == "cuda" and args.sell_method == "auto"
