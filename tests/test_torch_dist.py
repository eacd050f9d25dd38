"""Port parity, the distributed layer's policies and rules on the CPU:
``repro_torch.dist.elastic``, ``repro_torch.dist.sharding``,
``repro_torch.launch.mesh`` and ``SyntheticLM.shard_at``, against the
live reference where it has the same function.

* ``ElasticPolicy.resolve_mesh`` equal to the reference's for 1 - 40
  devices and model_parallel 1, 2, 4, 16, and the same error at 0;
* ``Heartbeat``: install, SIGTERM to this process, ``should_stop``,
  uninstall restores the previous handler;
* ``param_specs`` over the train state (params, AdamW moments, step and a
  two-rank ``grad_error``) of every one of the ten ``ARCHS`` at smoke
  width, ``data_specs`` and ``cache_specs`` over each family's dense and
  paged caches (batch 1 and 8), each equal to the reference's over the
  same shapes, keyed by bridge path, on the meshes {data 1, model 1},
  {data 2, model 2}, {data 4, model 2} and {pod 2, data 4, model 2};
* ``placements`` of a spec on a world-of-one gloo ``DeviceMesh`` from
  ``make_host_mesh``; the launcher's refusal of a model axis above 1
  with ``--compress-grads`` (the reference's);
* ``shard_at``: the rows of ``batch_at``, the shards tiling the batch.
"""

import dataclasses
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jreg
from repro.dist import elastic as jelastic
from repro.dist import sharding as jshard
from repro.dist import steps as jsteps
from repro.models import get_model as jget
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.configs import registry as treg
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import elastic as telastic
from repro_torch.dist import sharding as tshard
from repro_torch.dist import steps as tsteps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model as tget
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

from _torch_threads import one_torch_thread  # noqa: F401

MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 2},
          {"data": 4, "model": 2}, {"pod": 2, "data": 4, "model": 2})


@pytest.mark.parametrize("mp", [1, 2, 4, 16])
def test_resolve_mesh_matches_reference(mp):
    want = jelastic.ElasticPolicy(model_parallel=mp)
    got = telastic.ElasticPolicy(model_parallel=mp)
    for n in range(1, 41):
        assert got.resolve_mesh(n) == want.resolve_mesh(n), n
    for pol in (want, got):
        with pytest.raises(ValueError, match="no devices"):
            pol.resolve_mesh(0)
    assert [telastic._pow2_floor(n) for n in range(0, 70)] == \
        [jelastic._pow2_floor(n) for n in range(0, 70)]


def test_heartbeat_drains_on_sigterm():
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGTERM)
    hb = telastic.Heartbeat().install()
    try:
        # the handler must be ours before the signal is sent
        assert signal.getsignal(signal.SIGTERM) == hb._handle
        assert not hb.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert hb.should_stop
    finally:
        hb.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


def test_heartbeat_skips_registration_off_the_main_thread():
    before = signal.getsignal(signal.SIGTERM)
    box = []
    t = threading.Thread(target=lambda: box.append(
        telastic.Heartbeat().install()))
    t.start()
    t.join()
    assert signal.getsignal(signal.SIGTERM) == before
    assert not box[0].should_stop
    box[0].uninstall()


def _abstract_mesh(sizes: dict):
    return jax.sharding.AbstractMesh(tuple(sizes.values()),
                                     tuple(sizes.keys()))


def _ref_specs(tree) -> dict:
    """{path: tuple} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jshard._path_str(path): tuple(spec) for path, spec in leaves}


def _port_specs(tree) -> dict:
    return dict(zip(*topt.tree_flatten(tree)))


def _pair(arch):
    jcfg = jreg.with_sell(jreg.get_smoke_config(arch), "acdc",
                          method="pallas")
    tcfg = treg.with_sell(treg.get_smoke_config(arch), "acdc",
                          method="pallas")
    return jcfg, tcfg


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_param_specs_match_reference(arch):
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)
    jcfg, tcfg = _pair(arch)
    ocfg = dict(kind="adamw", lr=1e-3)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg),
                             jsched.constant_schedule(1e-3))
    to = topt.make_optimizer(topt.OptimizerConfig(**ocfg),
                             tsched.constant_schedule(1e-3))
    jstate = jsteps.abstract_state(jget(jcfg), jcfg, jo, compress_dp=2)
    tstate = tsteps.abstract_state(tget(tcfg), tcfg, to, compress_dp=2)
    shapes = {p: tuple(getattr(leaf, "shape", ()))
              for p, leaf in _port_specs(tstate).items()}
    ref_shapes = dict(zip(jax.tree.leaves(jopt.tree_paths(jstate)),
                          (tuple(x.shape) for x in jax.tree.leaves(jstate))))
    assert shapes == ref_shapes
    assert all(t.device.type == "meta"
               for t in topt.tree_flatten(tstate)[1]
               if isinstance(t, torch.Tensor))
    for sizes in MESHES:
        want = _ref_specs(jshard.param_specs(jstate, _abstract_mesh(sizes)))
        got = _port_specs(tshard.param_specs(tstate, sizes))
        assert got == want, sizes
    # some leaf of every state shards once a mesh has room
    assert any(any(s) for s in
               _port_specs(tshard.param_specs(tstate, MESHES[2])).values())


def _batch_shapes(cfg, b: int) -> dict:
    shapes = {"tokens": (b, 32), "labels": (b, 32)}
    if cfg.frontend is not None:
        shapes["frontend_embeds"] = (b, 4, cfg.d_model)
    return shapes


@pytest.mark.parametrize("b", [1, 4, 8])
def test_data_specs_match_reference(b):
    jcfg, tcfg = _pair("llava_next_34b")
    shapes = _batch_shapes(tcfg, b)
    jbatch = {k: jax.ShapeDtypeStruct(v, np.float32)
              for k, v in shapes.items()}
    for sizes in MESHES:
        want = {k: tuple(v) for k, v in jshard.data_specs(
            _abstract_mesh(sizes), jbatch).items()}
        assert tshard.data_specs(sizes, shapes) == want, sizes
        tensors = {k: torch.empty(v, device="meta")
                   for k, v in shapes.items()}
        assert tshard.data_specs(sizes, tensors) == want


#: one arch a family, and the hybrid and encoder-decoder with both caches
CACHE_ARCHS = ("qwen3_1_7b", "deepseek_moe_16b", "mamba2_1_3b",
               "zamba2_1_2b", "seamless_m4t_large_v2")


@pytest.mark.parametrize("arch", CACHE_ARCHS)
@pytest.mark.parametrize("batch", [1, 8])
def test_cache_specs_match_reference(arch, batch):
    jcfg, tcfg = _pair(arch)
    jm, tm = jget(jcfg), tget(tcfg)
    caches = [(jax.eval_shape(lambda: jm.init_cache(jcfg, batch, 64)),
               tm.init_cache(tcfg, batch, 64, device="meta"))]
    if jm.init_cache_paged is not None:
        caches.append((
            jax.eval_shape(lambda: jm.init_cache_paged(jcfg, batch, 24, 8)),
            tm.init_cache_paged(tcfg, batch, 24, 8, device="meta")))
    for jcache, tcache in caches:
        for sizes in MESHES:
            want = _ref_specs(jshard.cache_specs(jcache,
                                                 _abstract_mesh(sizes)))
            got = _port_specs(tshard.cache_specs(tcache, sizes))
            common = sorted(set(want) & set(got))
            # the port's per-slot frame count (encdec) has no reference leaf
            assert set(got) - set(want) <= {"xlen"}, sorted(got)
            assert set(want) <= set(got)
            assert {p: got[p] for p in common} == want, sizes
            if "xlen" in got:   # (B,): the generic rule's layer axis
                assert got["xlen"] == (None,)


def test_spec_for_safeguards_match_reference():
    cases = [((64, 128), ("embed", "ffn")), ((7, 128), ("embed", "ffn")),
             ((64, 128, 256), ("expert", "embed", "ffn")),
             ((12, 64, 128), ("embed", "ffn")),
             ((1, 96, 4, 16), ("batch", "seq", "heads", None)),
             ((6, 8), ("batch", "seq")), ((3,), (None,)), ((), ())]
    for sizes in MESHES:
        for shape, logical in cases:
            want = tuple(jshard.spec_for(_abstract_mesh(sizes), shape,
                                         logical))
            assert tshard.spec_for(sizes, shape, logical) == want
    with pytest.raises(ValueError):
        tshard.spec_for(MESHES[0], (4,), ("embed", "ffn"))


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield
    mesh_mod.shutdown()


def test_host_mesh_and_placements(world_of_one):
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_mod.make_host_mesh(1, "cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.get_local_rank("data") == 0
    assert tshard._axis_sizes(mesh) == {"data": 1, "model": 1}
    spec = tshard.spec_for(mesh, (8, 16), ("embed", "ffn"))
    assert spec == ("data", "model")
    assert tshard.placements(spec, mesh) == [Shard(0), Shard(1)]
    assert tshard.placements((None, "model"), mesh) == [Replicate(),
                                                        Shard(1)]
    assert tshard.placements((("pod", "data"), None), mesh) == \
        [Shard(0), Replicate()]
    # a CUDA launcher never sums over gloo
    with pytest.raises(RuntimeError, match="nccl"):
        mesh_mod.init_process_group("cuda")


def test_host_mesh_alone_is_none():
    assert not dist.is_initialized()
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE")
           if k in os.environ}
    try:
        assert mesh_mod.make_host_mesh(1, "cpu") is None
        args = ttrain.parse_args(["--device", "cpu", "--model-parallel",
                                  "16"])
        dp = ttrain.data_parallel(args)
        assert (dp.group, dp.rank, dp.size, dp.in_mesh) == (None, 0, 1,
                                                            True)
    finally:
        os.environ.update(env)


def test_launcher_refuses_a_model_axis(monkeypatch, capsys):
    monkeypatch.setattr(mesh_mod, "init_process_group", lambda _: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    args = ttrain.parse_args(["--device", "cpu", "--model-parallel", "2",
                              "--compress-grads"])
    with pytest.raises(ValueError, match="model axis must be 1"):
        ttrain.data_parallel(args)
    assert "[elastic] resolved mesh data=2 model=2 from 4 devices" in \
        capsys.readouterr().out


def test_shard_at_tiles_the_batch():
    data = SyntheticLM(DataConfig(vocab_size=300, seq_len=9,
                                  global_batch=8, frontend="vision",
                                  n_frontend_tokens=2, d_model=4))
    full = data.batch_at(5)
    for n in (1, 2, 4, 8):
        parts = [data.shard_at(5, r, n) for r in range(n)]
        for key, t in full.items():
            assert all(p[key].shape[0] == 8 // n for p in parts)
            assert torch.equal(torch.cat([p[key] for p in parts]), t)
    cfg = dataclasses.replace(data.cfg, global_batch=6)
    assert SyntheticLM(cfg).shard_at(0, 1, 4)["tokens"].shape == (1, 9)
