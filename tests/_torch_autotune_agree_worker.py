"""One rank of a gloo group asking the autotuner for plans under a faked
card, for ``test_torch_autotune_agree.py``.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/_torch_autotune_agree_worker.py OUT_PREFIX CASE

Each rank starts with its own memo and its own persistent file, seeded
so that the ranks would answer apart: key ``seeded`` is in every memo
with a plan of the rank's own; key ``filed`` is in rank 1's file only
(rank 0 sweeps it through a stubbed sweep); key ``fresh`` is in neither
(rank 0 sweeps).  ``CASE`` ``agree`` (two ranks) requests the three keys
on both ranks inside ``agreeing()``, then one key on rank 1 alone after
the block; ``apart`` (two ranks) has rank 1 ask for another key than
rank 0 inside the block; ``outside`` (three ranks) has ranks 0 and 1
request the three keys inside ``agreeing(group)`` of a group of those
two, while rank 2, outside the group as an elastic run's rank left out
of its mesh is, requests ``seeded`` and another key alone.  Writes
``OUT_PREFIX<rank>.json``: the plans each rank holds, its sweeps, its
digest, or the error it raised.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.kernels import autotune

CARD = "FAKE H100|sm_90"
KEYS = {"seeded": ("cascade", (64, 1024, 2), True),
        "filed": ("cascade_bwd", (512, 1024, 2), True),
        "fresh": ("fwd", (4, 256, 1), False)}
ALONE = ("cascade", (16, 256, 2), True)


def _request(direction, dims, permute):
    return autotune.autotuned_plan(direction, *dims, device="cpu",
                                   permute=permute)


def _pick(direction, dims, permute, index):
    return autotune.candidates(direction, *dims, permute=permute)[index]


def _plans(names) -> dict:
    return {name: autotune._plan_to_json(_request(*KEYS[name]))
            for name in names}


def main(prefix: str, case: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    os.environ[autotune.CACHE_ENV + "_PATH"] = f"{prefix}file{rank}.json"
    autotune._backend = lambda device: CARD
    swept = []

    def sweep(direction, *dims, permute=False, **kw):
        swept.append(direction)
        cands = autotune.candidates(direction, *dims, permute=permute)
        return autotune.Sweep(
            key=(direction, *dims), candidates=len(cands),
            cost_model=autotune.cost_model(direction, *dims,
                                           permute=permute),
            cost_model_s=2.0, winner=cands[-1], winner_s=1.0, seconds=0.0)

    autotune.sweep = sweep
    d, dims, pm = KEYS["seeded"]
    key = autotune.key_of(d, dims, permute=pm)
    autotune._CACHE[(CARD, key)] = _pick(d, dims, pm, rank)
    if rank == 1:
        d, dims, pm = KEYS["filed"]
        key = autotune.key_of(d, dims, permute=pm)
        autotune._save_persistent(CARD, key, _pick(d, dims, pm, 0))
    # every rank makes the group (new_group is collective over the world)
    pair = dist.new_group([0, 1]) if case == "outside" else None
    out = {"rank": rank}
    try:
        if case == "apart":     # rank 1 asks for another key than rank 0
            with autotune.agreeing():
                _request(*(ALONE if rank == 1 else KEYS["seeded"]))
        elif case == "outside" and rank == 2:
            out["plans"] = _plans(["seeded"])
            out["alone"] = autotune._plan_to_json(_request(*ALONE))
        else:
            with autotune.agreeing(pair):
                out["plans"] = _plans(KEYS)
                # the group's answers stand: asked again, no collective
                assert _plans(KEYS) == out["plans"]
            if rank == 1 and case == "agree":
                out["alone"] = autotune._plan_to_json(_request(*ALONE))
        out["digest"] = autotune.digest()
    except RuntimeError as e:
        out["error"] = str(e)
    out["swept"] = swept
    with open(f"{prefix}{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
