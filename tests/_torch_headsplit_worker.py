"""One of four gloo ranks of the port's head-parallel, sequence-parallel
and tensor-parallel decode, for ``test_torch_headsplit.py`` and
``test_torch_tensor_parallel_decode.py``.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_headsplit_worker.py IN.npz OUT_DIR

``IN.npz`` is what the test drew (``_jax_headsplit_ref.py`` reads the
same file).  On the case's mesh ("data", "model") (``mesh``, e.g.
``"1x4"``; (2, 2) without one) every rank runs, for each case: params
placed by ``param_specs``, a fresh cache placed by ``cache_specs``,
``make_prefill_step(full_logits=True, mesh=)`` on this rank's rows (and
frames), then greedy ``make_serve_step(mesh=)`` steps from ``first``
(tensor-parallel: every rank computes its "model" blocks); it keeps the
logits rows, the next tokens, its final cache blocks with the slices of
the full leaves they are, and for the encoder-decoder a second prefill
without frames (``again``), which reads its block of the cache's cross
K/V.  A case with ``decode_logits`` also keeps each decode step's logits
of its rows, whole over the vocabulary, as ``steps.make_placed_decode``
gives them to the serve step's sampler (taken on a copy of the cache
before the step).  A case's config is the arch's SMOKE one, with
``acdc`` on ``pallas`` where ``sell`` says so and its ``overrides``
(JSON) applied.  Then, unless ``IN.npz``'s ``sampled`` is false,
``sampled``: smoke Gemma3-27B's decode at (2, 2) with ``temp``
sampling, each rank drawing from a generator of its own seed, its
streams and the largest difference of its final blocks from the port's
unplaced steps fed the same tokens.

Writes ``OUT_DIR/rank<r>.npz`` and ``OUT_DIR/rank<r>.json``.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.dist import sharding, steps
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import get_model

#: the sampled case: smoke Gemma3-27B, 4 rows of 8 prompt tokens, a
#: (4, 16) cache, 3 decode steps
SAMPLED = ("gemma3_27b", 4, 8, 16, 3)


def under(src, prefix: str) -> dict:
    return {k[len(prefix):]: src[k] for k in src.files
            if k.startswith(prefix)}


def block_slices(cache: sharding.PlacedCache) -> dict:
    pl = cache.placement
    coord = {a: pl.mesh.get_local_rank(a) for a in pl.mesh.mesh_dim_names}
    return {k: [[s.start, s.stop] for s in sharding.shard_slices(
        pl.shapes[k], pl.specs[k], pl.sizes, coord)] for k in cache}


def rows_of(mesh, b: int) -> slice:
    return sharding.shard_slices(
        (b,), sharding.rows_spec(mesh, b), sharding._axis_sizes(mesh),
        {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names})[0]


def config(src, pre: str):
    cfg = registry.get_smoke_config(str(src[pre + "arch"]))
    if pre + "sell" in src.files and str(src[pre + "sell"]) == "acdc":
        cfg = registry.with_sell(cfg, "acdc", method="pallas")
    if pre + "overrides" in src.files:
        cfg = dataclasses.replace(
            cfg, **json.loads(str(src[pre + "overrides"])))
    return cfg


def serve(src, case: str, mesh, arrays: dict, facts: dict) -> None:
    pre = f"{case}/"
    cfg = config(src, pre)
    model = get_model(cfg)
    params = sharding.place_params(
        bridge.to_torch(under(src, pre + "params/"), "cpu"), mesh)
    tokens = torch.from_numpy(src[pre + "tokens"])
    lengths = torch.from_numpy(src[pre + "lengths"])
    b = tokens.shape[0]
    rows = rows_of(mesh, b)
    frames = (torch.from_numpy(src[pre + "frames"])[rows]
              if pre + "frames" in src.files else None)
    cache = sharding.place_cache(
        model.init_cache(cfg, b, int(src[pre + "cache_len"]), device="cpu"),
        mesh)
    prefill = steps.make_prefill_step(model, cfg, full_logits=True,
                                      mesh=mesh)
    logits, cache = prefill(params, cache, tokens[rows], lengths, frames)
    # a decoder's are this rank's block of the vocabulary: gathered
    logits = steps.gather_vocab(logits, steps.tensor_split(cfg, mesh))
    arrays[pre + "logits"] = logits.numpy().copy()
    step = steps.make_serve_step(model, cfg, mesh=mesh)
    decode = steps.make_placed_decode(model, cfg, mesh)
    tok, pos = torch.from_numpy(src[pre + "first"]), lengths.clone()
    nxt, step_logits = [], []
    for _ in range(int(src[pre + "steps"])):
        if pre + "decode_logits" in src.files:
            copy = sharding.PlacedCache(
                {k: v.clone() for k, v in cache.items()}, cache.placement)
            step_logits.append(decode(params, copy, tok, pos)[0].numpy())
        tok, cache = step(params, cache, tok, pos)
        nxt.append(tok.tolist())
        pos = pos + 1
    if step_logits:
        arrays[pre + "decode_logits"] = np.stack(step_logits)
    arrays.update({f"{pre}final/{k}": v.numpy().copy()
                   for k, v in cache.items()})
    if cfg.family == "encdec":
        again, _ = prefill(params, cache, tokens[rows], lengths)
        arrays[pre + "again"] = steps.gather_vocab(
            again, steps.tensor_split(cfg, mesh)).numpy().copy()
    facts[case] = dict(rows=[rows.start, rows.stop], next=nxt,
                       final_slices=block_slices(cache),
                       specs={k: list(s) for k, s in
                              cache.placement.specs.items()},
                       coord=[mesh.get_local_rank(a)
                              for a in ("data", "model")])


def sampled(mesh, facts: dict) -> None:
    """``temp`` decode with a generator a rank: its streams and its final
    blocks against the unplaced steps fed the same tokens."""
    arch, b, s, cache_len, n = SAMPLED
    cfg = registry.get_smoke_config(arch)
    model = get_model(cfg)
    full = model.init(torch.Generator().manual_seed(7), cfg, "cpu")
    params = sharding.place_params(
        model.init(torch.Generator().manual_seed(7), cfg, "cpu"), mesh)
    gen = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           dtype=torch.int32)
    lengths = torch.tensor([8, 6, 8, 4], dtype=torch.int32)
    first = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                          dtype=torch.int32)
    rows = rows_of(mesh, b)
    cache = sharding.place_cache(
        model.init_cache(cfg, b, cache_len, device="cpu"), mesh)
    _, cache = steps.make_prefill_step(model, cfg, full_logits=True,
                                       mesh=mesh)(params, cache,
                                                  tokens[rows], lengths)
    step = steps.make_serve_step(model, cfg, sample="temp",
                                 temperature=1.5, mesh=mesh)
    mine = torch.Generator().manual_seed(100 + int(os.environ["RANK"]))
    tok, pos, stream = first, lengths.clone(), []
    for _ in range(n):
        tok, cache = step(params, cache, tok, pos, mine)
        stream.append(tok.tolist())
        pos = pos + 1
    # the unplaced steps fed the tokens this rank decoded with
    one = model.init_cache(cfg, b, cache_len, device="cpu")
    with torch.no_grad():
        _, one = model.prefill(full, one, tokens, cfg, lengths)
        tok, pos = first, lengths.clone()
        for i in range(n):
            _, one = model.decode_step(full, one, tok, pos, cfg)
            tok, pos = torch.tensor(stream[i], dtype=torch.int32), pos + 1
    slices = block_slices(cache)
    diff = max(float((cache[k] - one[k][tuple(slice(a, z) for a, z in
                                               slices[k])]).abs().max())
               for k in cache)
    facts["sampled"] = dict(next=stream, block_vs_unplaced=diff,
                            coord=[mesh.get_local_rank(a)
                                   for a in ("data", "model")])


def main(src: str, out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    rank = int(os.environ["RANK"])
    mesh_mod.init_process_group("cpu")
    src = np.load(src)
    arrays, facts = {}, {}
    meshes: dict = {}

    def mesh_of(tag: str):
        if tag not in meshes:
            meshes[tag] = dryrun.mesh_of(
                tuple(int(d) for d in tag.split("x")), "cpu")
        return meshes[tag]

    try:
        for case in sorted({k.split("/")[0] for k in src.files
                            if "/" in k}):
            tag = (str(src[f"{case}/mesh"]) if f"{case}/mesh" in src.files
                   else "2x2")
            serve(src, case, mesh_of(tag), arrays, facts)
        if "sampled" not in src.files or bool(src["sampled"]):
            sampled(mesh_of("2x2"), facts)
        np.savez(out / f"rank{rank}.npz", **arrays)
        (out / f"rank{rank}.json").write_text(json.dumps(facts))
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    assert "RANK" in os.environ, "start one process a rank (torchrun's env)"
    main(sys.argv[1], sys.argv[2])
