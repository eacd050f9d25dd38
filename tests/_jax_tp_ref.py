"""The reference's train and prefill steps jitted with ``param_shardings``
/ ``data_specs`` on forced host devices, for
``test_torch_tensor_parallel.py`` (a subprocess: the device count must be
set before JAX starts).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_tp_ref.py IN.npz OUT.npz [CASE,CASE,...]

``IN.npz`` holds, for each case ``<case>/`` the test drew (the cases
named, or every one): ``arch``,
``sell`` ("dense" or "acdc": ``pallas``, interpret mode here),
``capacity_factor`` and ``meshes`` (e.g. ``"2x2,1x4"``) as 0-d arrays,
optionally ``overrides`` (a JSON object of config fields, e.g.
``{"d_inner": 192}``),
``params/<path>``, the train batches ``batch<s>/<name>`` (with
``frontend_embeds`` (B, F, D) for the encoder-decoder) and, where a
prefill is asked, ``prefill/tokens`` (B, S), ``prefill/lengths`` (B,),
``prefill/cache_len`` and ``prefill/frontend_embeds``.  For every mesh
``("data", "model") = (d, m)`` of the case, over the first d * m devices:
the state from the params with fresh AdamW moments, placed by
``param_shardings``, trained one step a batch by
``make_train_step`` jitted with ``in_shardings`` / ``out_shardings`` from
``param_shardings`` and ``data_specs``.  Writes ``<case>/<mesh>/<metric>``
(one value a step) and every device's block of the final params at its
mesh coordinate (``<case>/<mesh>/<d>_<m>/<path>``); for a prefill at
(2, 2), ``make_prefill_step(full_logits=True)`` on a fresh cache placed
by ``cache_specs``: ``<case>/prefill/logits`` (B, S, V) and the new cache
``<case>/prefill/cache/<leaf>``.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import registry
from repro.dist import sharding, steps
from repro.launch.train import SELL_GROUPS
from repro.models import get_model
from repro.optim import optimizers as opt_mod
from repro.optim import schedules

METRICS = ("loss", "grad_norm", "update_norm")


def nest(flat: dict) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def under(src, prefix: str) -> dict:
    return {k[len(prefix):]: src[k] for k in src.files
            if k.startswith(prefix)}


def flat(tree) -> dict:
    return dict(zip(jax.tree.leaves(opt_mod.tree_paths(tree)),
                    jax.tree.leaves(tree)))


def config(src, pre: str):
    cfg = registry.get_smoke_config(str(src[pre + "arch"]))
    if str(src[pre + "sell"]) == "acdc":
        cfg = registry.with_sell(cfg, "acdc", method="pallas")
    overrides = (json.loads(str(src[pre + "overrides"]))
                 if pre + "overrides" in src.files else {})
    return dataclasses.replace(
        cfg, capacity_factor=float(src[pre + "capacity_factor"]),
        **overrides)


def make_mesh(shape) -> jax.sharding.Mesh:
    n = shape[0] * shape[1]
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))


def blocks(tree, mesh) -> dict:
    """{"d_m/path": block} of every device's block of every leaf."""
    where = {dev: f"{d}_{m}" for (d, m), dev in np.ndenumerate(mesh.devices)}
    out = {}
    for path, arr in flat(tree).items():
        for shard in arr.addressable_shards:
            out[f"{where[shard.device]}/{path}"] = np.array(shard.data)
    return out


def train(src, case: str) -> dict:
    pre = f"{case}/"
    cfg = config(src, pre)
    model = get_model(cfg)
    opt = opt_mod.make_optimizer(
        opt_mod.OptimizerConfig(kind="adamw", lr=3e-3, groups=SELL_GROUPS),
        schedules.cosine_schedule(3e-3, 1, 6))
    params = nest(under(src, pre + "params/"))
    state0 = {"params": params, "opt": opt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    n_steps = len({k.split("/")[1] for k in src.files
                   if k.startswith(pre + "batch")})
    batches = [{k: np.asarray(v) for k, v in
                under(src, f"{pre}batch{s}/").items()}
               for s in range(n_steps)]
    out = {}
    for tag in str(src[pre + "meshes"]).split(","):
        mesh = make_mesh(tuple(int(d) for d in tag.split("x")))
        state_sh = sharding.param_shardings(state0, mesh)
        batch_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                                sharding.data_specs(mesh, batches[0]))
        rep = NamedSharding(mesh, P())
        step = jax.jit(steps.make_train_step(model, cfg, opt),
                       in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, {k: rep for k in METRICS}))
        state = jax.device_put(state0, state_sh)
        metrics = {k: [] for k in METRICS}
        for batch in batches:
            state, met = jax.block_until_ready(step(state, batch))
            for k in METRICS:
                metrics[k].append(float(met[k]))
        out.update({f"{pre}{tag}/{k}": v
                    for k, v in blocks(state["params"], mesh).items()})
        out.update({f"{pre}{tag}/{k}": np.array(v)
                    for k, v in metrics.items()})
    return out


def prefill(src, case: str) -> dict:
    pre = f"{case}/"
    cfg = config(src, pre)
    model = get_model(cfg)
    mesh = make_mesh((2, 2))
    named = lambda tree: jax.tree.map(  # noqa: E731
        lambda s: NamedSharding(mesh, s), tree)
    rep = NamedSharding(mesh, P())
    params = nest(under(src, pre + "params/"))
    params_sh = sharding.param_shardings(params, mesh)
    params = jax.device_put(params, params_sh)
    tokens = jnp.asarray(src[pre + "prefill/tokens"])
    lengths = jnp.asarray(src[pre + "prefill/lengths"])
    b = tokens.shape[0]
    cache = model.init_cache(cfg, b, int(src[pre + "prefill/cache_len"]))
    cache_sh = named(sharding.cache_specs(cache, mesh))
    cache = jax.device_put(cache, cache_sh)
    args = [params, cache, tokens, lengths]
    in_sh = [params_sh, cache_sh, named(sharding.data_specs(mesh, tokens)),
             rep]
    if pre + "prefill/frontend_embeds" in src.files:
        fe = jnp.asarray(src[pre + "prefill/frontend_embeds"])
        args.append(fe)
        in_sh.append(named(sharding.data_specs(mesh, fe)))
    vspec = sharding.spec_for(mesh, (b, tokens.shape[1], cfg.vocab_size),
                              ("batch", None, "vocab"))
    step = jax.jit(steps.make_prefill_step(model, cfg, full_logits=True),
                   in_shardings=tuple(in_sh),
                   out_shardings=(NamedSharding(mesh, vspec), cache_sh))
    logits, cache = step(*args)
    out = {pre + "prefill/logits": np.array(logits)}
    out.update({f"{pre}prefill/cache/{k}": np.array(v)
                for k, v in cache.items()})
    return out


def main(src_path: str, out_path: str, cases: str = "") -> None:
    src = np.load(src_path)
    out = {}
    every = {k.split("/")[0] for k in src.files} - {"structure"}
    for case in (cases.split(",") if cases else sorted(every)):
        out.update(train(src, case))
        if f"{case}/prefill/tokens" in src.files:
            out.update(prefill(src, case))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
