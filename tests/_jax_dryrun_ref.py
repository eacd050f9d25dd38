"""The reference's placed train step at (pod 2, data 2, model 1) and its
serving steps, for ``test_torch_dryrun.py`` (a subprocess: the device
count must be set before JAX starts).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_dryrun_ref.py IN.npz OUT.npz

``IN.npz`` holds the inputs the test drew: ``train/params/<path>`` (smoke
Qwen3-1.7B), ``train/batch<s>/<name>`` a step, and for each served config
``serve/<arch>/params/<path>``, ``serve/<arch>/tokens`` (B, S),
``serve/<arch>/lengths`` (B,) and ``serve/<arch>/first`` (B,), the first
decode inputs.  Writes:

* ``train/loss`` (a step) and every device's block of the final params
  and moments at its mesh coordinate (``train/<p>_<d>_<m>/<path>``), from
  ``make_train_step`` jitted with ``param_shardings`` / ``data_specs`` on
  the mesh ("pod", "data", "model") = (2, 2, 1) over four forced host
  devices (AdamW, lr 3e-3, cosine over 6 steps);
* ``serve/<arch>/logits`` (B, S, V) and the cache (``cache/<leaf>``) of
  ``make_prefill_step(full_logits=True)`` on a (B, 16) cache, then
  ``DECODE_STEPS`` greedy ``make_serve_step`` steps from ``first`` at
  ``lengths``: ``serve/<arch>/next`` (steps, B) and the final cache
  (``final/<leaf>``).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import registry
from repro.dist import sharding, steps
from repro.models import get_model
from repro.optim import optimizers as opt_mod
from repro.optim import schedules

DECODE_STEPS = 3
CACHE_LEN = 16


def nest(flat: dict) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def flat(tree) -> dict:
    return dict(zip(jax.tree.leaves(opt_mod.tree_paths(tree)),
                    jax.tree.leaves(tree)))


def under(src, prefix: str) -> dict:
    return {k[len(prefix):]: src[k] for k in src.files
            if k.startswith(prefix)}


def train(src) -> dict:
    cfg = registry.get_smoke_config("qwen3_1_7b")
    model = get_model(cfg)
    opt = opt_mod.make_optimizer(
        opt_mod.OptimizerConfig(kind="adamw", lr=3e-3),
        schedules.cosine_schedule(3e-3, 1, 6))
    params = nest(under(src, "train/params/"))
    state0 = {"params": params, "opt": opt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    n_steps = len({k.split("/")[1] for k in src.files
                   if k.startswith("train/batch")})
    batches = [under(src, f"train/batch{s}/") for s in range(n_steps)]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1),
                             ("pod", "data", "model"))
    state_sh = sharding.param_shardings(state0, mesh)
    batch_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                            sharding.data_specs(mesh, batches[0]))
    rep = NamedSharding(mesh, P())
    step = jax.jit(steps.make_train_step(model, cfg, opt),
                   in_shardings=(state_sh, batch_sh),
                   out_shardings=(state_sh, {k: rep for k in (
                       "loss", "grad_norm", "update_norm")}))
    state = jax.device_put(state0, state_sh)
    losses = []
    for batch in batches:
        state, met = jax.block_until_ready(step(state, batch))
        losses.append(float(met["loss"]))
    where = {dev: f"{p}_{d}_{m}"
             for (p, d, m), dev in np.ndenumerate(mesh.devices)}
    out = {"train/loss": np.array(losses)}
    for path, arr in flat({"params": state["params"],
                           "opt": state["opt"]}).items():
        for shard in arr.addressable_shards:
            out[f"train/{where[shard.device]}/{path}"] = np.array(shard.data)
    return out


def serve(src, arch: str) -> dict:
    cfg = registry.get_smoke_config(arch)
    model = get_model(cfg)
    pre = f"serve/{arch}/"
    params = nest(under(src, pre + "params/"))
    tokens = jnp.asarray(src[pre + "tokens"])
    lengths = jnp.asarray(src[pre + "lengths"])
    cache = model.init_cache(cfg, tokens.shape[0], CACHE_LEN)
    prefill = jax.jit(steps.make_prefill_step(model, cfg, full_logits=True))
    logits, cache = prefill(params, cache, tokens, lengths)
    out = {pre + "logits": np.array(logits)}
    out.update({f"{pre}cache/{k}": np.array(v) for k, v in cache.items()})
    step = jax.jit(steps.make_serve_step(model, cfg))
    tok, pos = jnp.asarray(src[pre + "first"]), lengths
    nxt = []
    for _ in range(DECODE_STEPS):
        tok, cache = step(params, cache, tok, pos, jax.random.PRNGKey(0))
        nxt.append(np.array(tok))
        pos = pos + 1
    out[pre + "next"] = np.stack(nxt)
    out.update({f"{pre}final/{k}": np.array(v) for k, v in cache.items()})
    return out


def main(src_path: str, out_path: str) -> None:
    src = np.load(src_path)
    out = train(src)
    for arch in sorted({k.split("/")[1] for k in src.files
                        if k.startswith("serve/")}):
        out.update(serve(src, arch))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
