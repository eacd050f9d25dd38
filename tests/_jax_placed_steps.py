"""The reference's train step jitted with its state placed by
``param_shardings`` on forced host devices, for ``test_torch_placement.py``
(a subprocess: the device count must be set before JAX starts).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_placed_steps.py OUT.npz STEPS

Smoke Qwen3-1.7B, ``acdc`` on ``pallas`` (interpret mode), fp32, batch
4 x 32, AdamW with the launcher's SELL groups, jitted as
``repro.launch.train.build`` jits it (``in_shardings`` /
``out_shardings`` from ``param_shardings`` and ``data_specs``) on the
meshes (data=2, model=1) over the first two devices and (2, 2).  Writes
the initial state (``init/<path>``), each step's batch
(``batch<s>/<name>``) and, per mesh ``m<data><model>``, the per-step
metrics (``m22/loss`` ...) and every device's block of the final state at
its mesh coordinate (``m22/<d>_<m>/<path>``).  Then, shapes only, the
block of every leaf of the ten configs' full-width train states (params,
AdamW moments, step; ``acdc`` projections) that each device holds on the
meshes (2, 1), (1, 2) and (2, 2), by ``devices_indices_map``:
``index/<mesh>/<arch>``, a JSON string ``{path: {"d_m": [[start,
stop], ...]}}``.
"""

import json
import sys

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import registry
from repro.data import DataConfig, SyntheticLM
from repro.dist import sharding, steps
from repro.launch.train import SELL_GROUPS
from repro.models import get_model
from repro.optim import optimizers as opt_mod
from repro.optim import schedules

MESHES = {"m21": (2, 1), "m12": (1, 2), "m22": (2, 2)}


def flat(tree) -> dict:
    return dict(zip(jax.tree.leaves(opt_mod.tree_paths(tree)),
                    jax.tree.leaves(tree)))


def make_mesh(shape) -> jax.sharding.Mesh:
    n = shape[0] * shape[1]
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))


def coords(mesh) -> dict:
    """{device: "d_m"} of the mesh."""
    return {dev: f"{d}_{m}" for (d, m), dev in np.ndenumerate(mesh.devices)}


def blocks(tree, mesh) -> dict:
    """{"d_m/path": block} of every device's block of every leaf."""
    where = coords(mesh)
    out = {}
    for path, arr in flat(tree).items():
        for shard in arr.addressable_shards:
            out[f"{where[shard.device]}/{path}"] = np.array(shard.data)
    return out


def train(n_steps: int) -> dict:
    cfg = registry.with_sell(registry.get_smoke_config("qwen3_1_7b"),
                             "acdc", method="pallas")
    model = get_model(cfg)
    opt = opt_mod.make_optimizer(
        opt_mod.OptimizerConfig(kind="adamw", lr=3e-3, groups=SELL_GROUPS),
        schedules.cosine_schedule(3e-3, 1, 6))
    state0 = steps.init_state(model, cfg, opt, jax.random.PRNGKey(0))
    arrays = {f"init/{k}": np.array(v) for k, v in flat(state0).items()}
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4))
    batches = [{k: np.array(v) for k, v in data.batch_at(s).items()}
               for s in range(n_steps)]
    for s, batch in enumerate(batches):
        arrays.update({f"batch{s}/{k}": v for k, v in batch.items()})
    for tag in ("m21", "m22"):
        mesh = make_mesh(MESHES[tag])
        state_sh = sharding.param_shardings(state0, mesh)
        batch_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                                sharding.data_specs(mesh, batches[0]))
        rep = NamedSharding(mesh, P())
        step = jax.jit(steps.make_train_step(model, cfg, opt),
                       in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, {k: rep for k in (
                           "loss", "grad_norm", "update_norm")}))
        state = jax.device_put(state0, state_sh)
        metrics = {"loss": [], "grad_norm": [], "update_norm": []}
        for batch in batches:
            state, met = jax.block_until_ready(step(state, batch))
            for k in metrics:
                metrics[k].append(float(met[k]))
        arrays.update({f"{tag}/{k}": v for k, v in blocks(state,
                                                           mesh).items()})
        arrays.update({f"{tag}/{k}": np.array(v)
                       for k, v in metrics.items()})
    return arrays


def indices() -> dict:
    opt = opt_mod.make_optimizer(opt_mod.OptimizerConfig(kind="adamw"),
                                 schedules.constant_schedule(1e-3))
    out = {}
    for arch in registry.ARCHS:
        cfg = registry.with_sell(registry.get_config(arch), "acdc",
                                 method="pallas")
        like = steps.abstract_state(get_model(cfg), cfg, opt)
        for tag, shape in MESHES.items():
            mesh = make_mesh(shape)
            where = coords(mesh)
            specs = flat(sharding.param_specs(like, mesh))
            index = {}
            for path, leaf in flat(like).items():
                got = NamedSharding(mesh, specs[path]).devices_indices_map(
                    leaf.shape)
                index[path] = {where[dev]: [[s.start or 0,
                                             dim if s.stop is None
                                             else s.stop]
                                            for s, dim in zip(sl, leaf.shape)]
                               for dev, sl in got.items()}
            out[f"index/{tag}/{arch}"] = np.array(json.dumps(index))
    return out


def main(out: str, n_steps: int) -> None:
    np.savez(out, **train(n_steps), **indices())


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
