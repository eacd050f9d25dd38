"""The reference's serving steps placed by ``cache_specs``, for
``test_torch_headsplit.py`` and ``test_torch_tensor_parallel_decode.py``
(a subprocess: the device count must be set before JAX starts).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_headsplit_ref.py IN.npz OUT.npz [CASE,CASE,...]

``IN.npz`` holds, for each case ``<case>/`` the test drew (the cases
named, or every one): ``arch`` and ``cache_len`` / ``steps`` (0-d),
optionally ``mesh`` (e.g. ``"1x4"``; (2, 2) without one), ``sell``
(``"acdc"``: ``pallas``, interpret mode here), ``overrides`` (a JSON
object of config fields) and ``decode_logits`` (a flag),
``params/<path>``, ``tokens`` (B, S), ``lengths`` (B,), ``first`` (B,)
and, for the encoder-decoder, ``frames`` (B, F, D).  As the reference's
dry run places its serving cells (``launch/dryrun.py``), on the mesh
("data", "model") over the first devices of four forced host devices:
params by ``param_shardings``, the cache by ``cache_specs``, the prompts
by ``data_specs``, the decode's tokens and positions replicated.  Writes
for each case ``logits`` (B, S, V) of ``make_prefill_step(full_logits=
True)`` on a fresh (B, cache_len) cache, ``next`` (steps, B) of that many
greedy ``make_serve_step`` steps from ``first`` at ``lengths`` (with
``decode_logits``: ``model.decode_step`` jitted the same way and its
greedy sample, the sampler's argmax, each step's logits in
``decode_logits`` (steps, B, V)), the final cache (``final/<leaf>``)
and, for the encoder-decoder, ``again`` (B, S, V): a second prefill of
the same prompts without frames, which reads the final cache's cross
K/V.
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
from repro.models import get_model
from repro.serving import sampler


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


def config(src, pre: str):
    cfg = registry.get_smoke_config(str(src[pre + "arch"]))
    if pre + "sell" in src.files and str(src[pre + "sell"]) == "acdc":
        cfg = registry.with_sell(cfg, "acdc", method="pallas")
    if pre + "overrides" in src.files:
        cfg = dataclasses.replace(
            cfg, **json.loads(str(src[pre + "overrides"])))
    return cfg


def make_mesh(src, pre: str) -> jax.sharding.Mesh:
    shape = tuple(int(d) for d in (str(src[pre + "mesh"])
                                   if pre + "mesh" in src.files
                                   else "2x2").split("x"))
    return jax.sharding.Mesh(
        np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
        ("data", "model"))


def serve(src, case: str, mesh) -> dict:
    pre = f"{case}/"
    cfg = config(src, pre)
    model = get_model(cfg)
    named = lambda tree: jax.tree.map(  # noqa: E731
        lambda s: NamedSharding(mesh, s), tree)
    rep = NamedSharding(mesh, P())
    params = nest(under(src, pre + "params/"))
    params_sh = sharding.param_shardings(params, mesh)
    params = jax.device_put(params, params_sh)
    tokens = jnp.asarray(src[pre + "tokens"])
    lengths = jnp.asarray(src[pre + "lengths"])
    b = tokens.shape[0]
    cache = model.init_cache(cfg, b, int(src[pre + "cache_len"]))
    cache_sh = named(sharding.cache_specs(cache, mesh))
    cache = jax.device_put(cache, cache_sh)
    tok_sh = named(sharding.data_specs(mesh, tokens))
    args, in_sh = [params, cache, tokens, lengths], [params_sh, cache_sh,
                                                     tok_sh, rep]
    if pre + "frames" in src.files:
        frames = jnp.asarray(src[pre + "frames"])
        args.append(frames)
        in_sh.append(named(sharding.data_specs(mesh, frames)))
    vspec = sharding.spec_for(mesh, (b, tokens.shape[1], cfg.vocab_size),
                              ("batch", None, "vocab"))
    prefill = jax.jit(steps.make_prefill_step(model, cfg, full_logits=True),
                      in_shardings=tuple(in_sh),
                      out_shardings=(NamedSharding(mesh, vspec), cache_sh))
    logits, cache = prefill(*args)
    out = {pre + "logits": np.array(logits)}
    with_logits = pre + "decode_logits" in src.files
    if with_logits:
        def body(p, c, t, q):
            logits, c = model.decode_step(p, c, t, q, cfg)
            return (sampler.sample(jax.random.PRNGKey(0), logits,
                                   method="greedy"), logits, c)
        outs = (rep, rep, cache_sh)
    else:
        serve_fn = steps.make_serve_step(model, cfg)

        def body(p, c, t, q):
            return serve_fn(p, c, t, q, jax.random.PRNGKey(0))
        outs = (rep, cache_sh)
    step = jax.jit(body, in_shardings=(params_sh, cache_sh, rep, rep),
                   out_shardings=outs)
    tok, pos = jnp.asarray(src[pre + "first"]), lengths
    nxt, step_logits = [], []
    for _ in range(int(src[pre + "steps"])):
        if with_logits:
            tok, logits, cache = step(params, cache, tok, pos)
            step_logits.append(np.array(logits))
        else:
            tok, cache = step(params, cache, tok, pos)
        nxt.append(np.array(tok))
        pos = pos + 1
    out[pre + "next"] = np.stack(nxt)
    if with_logits:
        out[pre + "decode_logits"] = np.stack(step_logits)
    out.update({f"{pre}final/{k}": np.array(v) for k, v in cache.items()})
    if cfg.family == "encdec":
        again = jax.jit(steps.make_prefill_step(model, cfg,
                                                full_logits=True),
                        in_shardings=(params_sh, cache_sh, tok_sh, rep),
                        out_shardings=(NamedSharding(mesh, vspec),
                                       cache_sh))
        out[pre + "again"] = np.array(again(params, cache, tokens,
                                            lengths)[0])
    return out


def main(src_path: str, out_path: str, cases: str = "") -> None:
    src = np.load(src_path)
    names = (cases.split(",") if cases else
             sorted({k.split("/")[0] for k in src.files if "/" in k}))
    out = {}
    for case in names:
        mesh = make_mesh(src, f"{case}/")
        with mesh:
            out.update(serve(src, case, mesh))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
