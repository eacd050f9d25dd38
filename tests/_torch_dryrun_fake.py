"""The port's dry run on fake process groups, for ``test_torch_dryrun.py``
(a subprocess: the fake group is process-wide).

    python tests/_torch_dryrun_fake.py OUT.json TAG [TAG ...]

Traces, as rank 0 of a fake group, for each TAG: ``m22`` / ``m222``,
every (arch x shape) cell of the reference's order at SMOKE width on the
small ``SMALL`` shape cells over the mesh (data 2, model 2) / (pod 2,
data 2, model 2); ``m221``, the cells of ``COMPARE`` that
``_torch_dryrun_worker.py`` runs for real on four gloo ranks at (pod 2,
data 2, model 1) (``m22`` covers its (2, 2) ones); ``full``, the
full-width cell Qwen3-1.7B ``train_4k`` on the single-pod production
mesh through ``run_cell``.  Writes ``{"<tag>/<arch>/<shape>": record}``
and ``{"full": record}``.
"""

import json
import sys

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

#: the small stand-ins of the four shape cells at SMOKE width: batches
#: that split over 4 row ranks (1 for the long cell), sequences short
SMALL = {
    "train_4k": registry.ShapeCell("train_4k", 16, 4, "train"),
    "prefill_32k": registry.ShapeCell("prefill_32k", 16, 4, "prefill"),
    "decode_32k": registry.ShapeCell("decode_32k", 16, 4, "decode"),
    "long_500k": registry.ShapeCell("long_500k", 32, 1, "decode"),
}

MESHES = {"m22": ((2, 2), ("data", "model")),
          "m222": ((2, 2, 2), ("pod", "data", "model")),
          "m221": ((2, 2, 1), ("pod", "data", "model"))}

#: cells run on real gloo ranks too: (mesh, arch, shape)
COMPARE = (("m22", "qwen3_1_7b", "train_4k"),
           ("m22", "qwen3_1_7b", "prefill_32k"),
           ("m22", "deepseek_67b", "decode_32k"),
           ("m22", "mamba2_1_3b", "prefill_32k"),
           ("m22", "seamless_m4t_large_v2", "prefill_32k"),
           ("m22", "zamba2_1_2b", "train_4k"),
           ("m22", "gemma3_27b", "decode_32k"),
           ("m22", "gemma3_27b", "long_500k"),
           ("m221", "qwen3_1_7b", "train_4k"),
           ("m221", "deepseek_67b", "decode_32k"),
           ("m221", "seamless_m4t_large_v2", "prefill_32k"))


def make_mesh(tag: str) -> DeviceMesh:
    shape, names = MESHES[tag]
    n = 1
    for d in shape:
        n *= d
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def cells_of(tag: str) -> list:
    if tag == "m221":
        return [(a, s) for t, a, s in COMPARE if t == tag]
    return [(a, s) for a, s in registry.cells(include_skipped=True)
            if registry.skips(a, s) is None]


def main(out: str, tags: list) -> None:
    torch.set_num_threads(1)
    records = {}
    try:
        for tag in tags:
            if tag == "full":
                records["full"] = dryrun.run_cell("qwen3_1_7b", "train_4k",
                                                  False, save=False)
                continue
            n = 1
            for d in MESHES[tag][0]:
                n *= d
            mesh_mod.init_fake_group(n)
            mesh = make_mesh(tag)
            for arch, name in cells_of(tag):
                records[f"{tag}/{arch}/{name}"] = dryrun.trace_cell(
                    arch, SMALL[name], mesh, smoke=True)
    finally:
        mesh_mod.shutdown()
    with open(out, "w") as f:
        json.dump(records, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
