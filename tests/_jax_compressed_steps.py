"""The reference's compressed data-parallel train step on two forced host
devices, for ``test_torch_dist_train.py`` (a subprocess: the device count
must be set before JAX starts).

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        python tests/_jax_compressed_steps.py OUT.npz STEPS

Smoke Qwen3-1.7B, ``acdc`` on ``pallas`` (interpret mode), fp32, batch
4 x 32, AdamW with the launcher's SELL groups, mesh (data=2, model=1),
``make_train_step(compress_mesh=mesh)``.  Writes the initial state
(``init/<path>``), each step's batch (``batch<s>/<name>``), the final
state (``final/<path>``), the per-step metrics, and the int8 levels and
block scales every rank's quantizer chose (``q<s>r<rank>/<path>``,
``scale<s>r<rank>/<path>``: a spy around ``compressed_psum_tree`` that
quantizes what ``compressed_psum`` quantizes and sends it to the host).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry
from repro.data import DataConfig, SyntheticLM
from repro.dist import compression, steps
from repro.launch.train import SELL_GROUPS
from repro.models import get_model
from repro.optim import optimizers as opt_mod
from repro.optim import schedules


def flat(tree) -> dict:
    return dict(zip(jax.tree.leaves(opt_mod.tree_paths(tree)),
                    (np.array(x) for x in jax.tree.leaves(tree))))


def spy_levels(records: dict, now: dict) -> None:
    """Record each rank's (q, scale) of every leaf into ``records``."""
    psum_tree = compression.compressed_psum_tree

    def record(path, rank, q, scale):
        key = f"{now['step']}r{int(rank)}/{path}"
        records[f"q{key}"] = np.array(q)
        records[f"scale{key}"] = np.array(scale)

    def spy(grads, errors, axis_name):
        paths = jax.tree.leaves(opt_mod.tree_paths(grads))
        flat_g, treedef = jax.tree_util.tree_flatten(grads)
        for path, g, e in zip(paths, flat_g, treedef.flatten_up_to(errors)):
            flat = g.astype(jnp.float32).reshape(-1) + e.reshape(-1)
            flat = jnp.where(jnp.isfinite(flat), flat, 0.0)
            q, scale = compression.quantize_int8(flat)
            jax.debug.callback(functools.partial(record, path),
                               jax.lax.axis_index(axis_name), q, scale)
        return psum_tree(grads, errors, axis_name)

    compression.compressed_psum_tree = spy


def main(out: str, n_steps: int) -> None:
    cfg = registry.with_sell(registry.get_smoke_config("qwen3_1_7b"),
                             "acdc", method="pallas")
    model = get_model(cfg)
    opt = opt_mod.make_optimizer(
        opt_mod.OptimizerConfig(kind="adamw", lr=3e-3, groups=SELL_GROUPS),
        schedules.cosine_schedule(3e-3, 1, 6))
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    state = steps.init_state(model, cfg, opt, jax.random.PRNGKey(0),
                             compress_dp=2)
    arrays = {f"init/{k}": v for k, v in flat(state).items()}
    step = jax.jit(steps.make_train_step(model, cfg, opt,
                                         compress_mesh=mesh))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4))
    metrics = {"loss": [], "grad_norm": [], "update_norm": []}
    now = {"step": 0}
    spy_levels(arrays, now)
    for s in range(n_steps):
        now["step"] = s
        batch = {k: np.array(v) for k, v in data.batch_at(s).items()}
        arrays.update({f"batch{s}/{k}": v for k, v in batch.items()})
        state, met = jax.block_until_ready(step(state, batch))
        jax.effects_barrier()
        for k in metrics:
            metrics[k].append(float(met[k]))
    arrays.update({f"final/{k}": v for k, v in flat(state).items()})
    arrays.update({k: np.array(v) for k, v in metrics.items()})
    np.savez(out, **arrays)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
