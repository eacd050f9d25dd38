"""Training launcher: config -> model -> AdamW with the paper's SELL
parameter groups -> train state -> train step -> synthetic data ->
checkpoints (async, atomic, keep-3) -> elastic policy (SIGTERM drain +
straggler monitor).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b \\
        --smoke --sell acdc --sell-method pallas --device cpu --steps 2

Data parallelism: started by ``torchrun``, every rank trains on its rows
of the global batch and the gradients are summed over the data ranks
(NCCL on ``cuda``, gloo on ``cpu``); ``--compress-grads`` sums them as
int8 with error feedback (:mod:`repro_torch.dist.compression`)::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --smoke --sell acdc --sell-method pallas --device cpu --compress-grads

Under ``torchrun`` the train state is placed at rest by the sharding
rules (:mod:`repro_torch.dist.sharding`): ZeRO-3 over "data", shards over
"model", a stacked layer gathered where the model uses it.
``--model-parallel M`` resolves the (data, model) mesh from the world
size through ``ElasticPolicy`` (ranks outside it exit); batch rows split
over "data" only::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --smoke --sell acdc \\
        --sell-method pallas --device cpu --model-parallel 2

A model axis above 1 with ``--compress-grads`` is refused, as the
reference refuses it.  Checkpoints hold full leaves (gathered to rank 0
one at a time) and restore onto any mesh.  Without ``torchrun`` the
launcher runs as one process with the whole state.

Prints (rank 0) ``step N loss ... |g| ... ms`` lines (every
``--log-every`` steps and the last), ``resumed from step N`` when
``--resume`` finds a checkpoint, ``[straggler]`` lines for steps a
``StragglerMonitor`` flags, ``[compress]`` and ``[elastic]`` lines, the
``[preempt]`` line when SIGTERM drains the run (the ranks agree on the
step; the state is saved at the next step's number), a ``[placement]``
line a rank (its bytes at rest), and ``done.``.  The
step loss, tokens/s, step time, the gradient wire and raw bytes and every
cascade's diagonal norms go to the process-global obs registry;
``--metrics-jsonl PATH`` appends its snapshot on the ``--log-every``
cadence.  Weights are random (seed 0), batches synthetic
(:class:`repro_torch.data.SyntheticLM`).  Runs on ``--device cuda`` (the
default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import DEFAULT_DEVICE
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import compression, elastic
from repro_torch.dist import sharding as shard_mod
from repro_torch.dist import steps as steps_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import get_model
from repro_torch.obs import REGISTRY, JsonlExporter
from repro_torch.optim import (OptimizerConfig, cosine_schedule,
                               make_optimizer)
from repro_torch.optim.optimizers import tree_flatten, tree_map

# The paper's per-group treatment of the SELL diagonals (section 6.2):
# lr x24 on A, x12 on D, no weight decay on either; norms/bias undecayed.
SELL_GROUPS = (
    (r"sell/a$", {"lr_mult": 24.0, "weight_decay": 0.0}),
    (r"sell/d$", {"lr_mult": 12.0, "weight_decay": 0.0}),
    (r"sell/", {"weight_decay": 0.0}),
    (r"norm|scale$|bias$", {"weight_decay": 0.0}),
)

#: default checkpoint root: build/train_ckpt at the repository root
#: (``build/`` is not committed)
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_ckpt")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_1_7b", choices=registry.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small smoke configuration")
    ap.add_argument("--sell", default="dense",
                    help="SELL kind for the target projections: dense | "
                         "low_rank | circulant | fastfood | acdc (afdf, "
                         "complex-valued, is core-level only)")
    ap.add_argument("--sell-method", default="auto",
                    choices=["auto", "fft", "matmul", "pallas"],
                    help="transform backend of --sell acdc: auto (the "
                         "reference's default: matmul at N <= 4096, fft "
                         "above) | fft (torch.fft) | matmul (the explicit "
                         "matrices) | pallas (the hand-written kernels)")
    ap.add_argument("--sell-transform", default="acdc",
                    help="transform family of --sell acdc cascades "
                         "(acdc | circulant | hadamard)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="append registry snapshots (JSON lines) to PATH "
                         "on the --log-every cadence; off when unset")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient all-reduce "
                         "(repro_torch.dist.compression) over the data "
                         "ranks")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="resolve the mesh via ElasticPolicy from the "
                         "world size (elastic restart drill); 0 = every "
                         "rank a data rank")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


@dataclasses.dataclass
class DataParallel:
    """This process's place among the data ranks (one process alone:
    rank 0 of 1, no group)."""

    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    size: int = 1
    split_rows: bool = False            # batch rows split over "data"
    in_mesh: bool = True
    lead: bool = True                   # global rank 0: prints and saves
    mesh: Optional[object] = None       # the (data, model) DeviceMesh
    placement: Optional[shard_mod.Placement] = None   # set by ``build``


def data_parallel(args: argparse.Namespace) -> DataParallel:
    """Join ``torchrun``'s process group (if any), resolve the mesh and
    this rank's place in it."""
    device_type = torch.device(args.device).type
    joined = mesh_mod.init_process_group(device_type)
    world = dist.get_world_size() if joined else 1
    data, model = world, 1
    if args.model_parallel > 0:
        data, model = elastic.ElasticPolicy(
            model_parallel=args.model_parallel).resolve_mesh(world)
        if not joined or dist.get_rank() == 0:
            print(f"[elastic] resolved mesh data={data} model={model} "
                  f"from {world} devices", flush=True)
    if model > 1 and args.compress_grads:
        # the compressed sum treats params as replicated across the whole
        # mesh: on a model axis it would gather the full tree everywhere
        raise ValueError("--compress-grads supports data-parallel meshes "
                         "only (model axis must be 1)")
    if not joined:
        return DataParallel()
    mesh = mesh_mod.make_host_mesh(model, device_type, data * model)
    if mesh.get_coordinate() is None:
        return DataParallel(in_mesh=False, lead=False)
    rows = (args.global_batch, args.seq_len)
    split = shard_mod.data_specs(mesh, {"tokens": rows})["tokens"][0]
    return DataParallel(group=mesh.get_group("data"),
                        rank=mesh.get_local_rank("data"), size=data,
                        split_rows=split is not None,
                        lead=dist.get_rank() == 0, mesh=mesh)


class RankBatches:
    """This rank's rows of the synthetic batches (all of them when the
    rows do not split over "data"); ``dp`` is the rank's place."""

    def __init__(self, source: SyntheticLM, dp: DataParallel):
        self.source = source
        self.cfg = source.cfg
        self.dp = dp

    def batch_at(self, step: int) -> dict:
        if self.dp.split_rows:
            return self.source.shard_at(step, self.dp.rank, self.dp.size)
        return self.source.batch_at(step)


def build(args: argparse.Namespace, **overrides):
    """(cfg, model, opt, train_step, pipeline) for the launcher flags;
    ``overrides`` replace fields of the config (e.g. ``sell_k=1``).  The
    pipeline gives this rank's rows (:class:`RankBatches`)."""
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = registry.with_sell(cfg, args.sell, method=args.sell_method,
                             transform=args.sell_transform)
    cfg = dataclasses.replace(cfg, **overrides)
    model = get_model(cfg)
    opt = make_optimizer(
        OptimizerConfig(kind="adamw", lr=args.lr, groups=SELL_GROUPS),
        cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps))
    dp = data_parallel(args)
    if dp.mesh is not None:
        dp.placement = shard_mod.Placement(
            steps_mod.abstract_state(model, cfg, opt), dp.mesh)
    train_step = steps_mod.make_train_step(
        model, cfg, opt, args.accum_steps, group=dp.group,
        compress=args.compress_grads, mesh=dp.mesh)
    source = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, frontend=cfg.frontend,
        n_frontend_tokens=(cfg.n_frontend_tokens
                           or (args.seq_len // 4 if cfg.frontend == "audio"
                               else 0)),
        d_model=cfg.d_model))
    return cfg, model, opt, train_step, RankBatches(source, dp)


def _restore(ckpt, step, model, cfg, opt, args, dp: DataParallel) -> dict:
    """Elastic-safe restore: grad_error residuals are an optimization, not
    model state, so a checkpoint that lacks them (compression turned on
    after the save) or carries them for another data-parallel size
    (elastic shrink/grow changed the rank axis) restores everything else
    and re-zeros the residuals; otherwise each rank takes its row.  A
    placed state reads each full leaf on the host and keeps this rank's
    block, whatever mesh the checkpoint was saved at."""
    like = steps_mod.abstract_state(model, cfg, opt,
                                    compress_dp=dp.size
                                    if args.compress_grads else 0)
    err_like = like.pop("grad_error", None)
    state = ckpt.restore(step, like, device=args.device,
                         shard=dp.placement.shard_array
                         if dp.placement is not None else None)
    if err_like is None:
        return state
    try:    # host first: every rank reads every row, keeps its own
        err = ckpt.restore(step, {"grad_error": err_like},
                           device="cpu")["grad_error"]
    except KeyError:
        err = None
    lead = tree_flatten(err)[1][0].shape[0] if err is not None else None
    if lead == dp.size:
        state["grad_error"] = tree_map(
            lambda e: e[dp.rank:dp.rank + 1].to(args.device), err)
    else:
        if dp.lead:
            print(f"[compress] residual rank axis {lead} -> {dp.size}: "
                  f"resetting error feedback", flush=True)
        state["grad_error"] = tree_map(
            lambda e: torch.zeros((1,) + tuple(e.shape[1:]),
                                  dtype=torch.float32, device=args.device),
            err_like)
    return state


def init_or_resume(args, cfg, model, opt, ckpt: CheckpointManager,
                   dp: DataParallel):
    """(state, start step): the latest checkpoint under ``--resume``, else
    a fresh state from seed 0 on ``--device`` (with ``--compress-grads``,
    this rank's zero residual row)."""
    latest = ckpt.latest_step() if args.resume else None
    if latest is None:
        gen = torch.Generator(device=args.device).manual_seed(0)
        return steps_mod.init_state(
            model, cfg, opt, gen, args.device,
            compress_dp=1 if args.compress_grads else 0, mesh=dp.mesh), 0
    state = _restore(ckpt, latest, model, cfg, opt, args, dp)
    if dp.lead:
        print(f"resumed from step {latest} (elastic restore onto "
              f"data={dp.size})", flush=True)
    return state, latest


def batch_on(pipeline, step: int, device) -> dict:
    return {k: t.to(device) for k, t in pipeline.batch_at(step).items()}


def _grad_wire_bytes(params) -> tuple:
    """Static per-all-reduce payload of the int8 blockwise compressor
    (int8 payload padded to BLOCK plus one fp32 scale per block) vs the
    uncompressed fp32 equivalent."""
    wire = raw = 0
    for leaf in tree_flatten(params)[1]:
        n = max(int(leaf.numel()), 1)
        nb = -(-n // compression.BLOCK)
        wire += nb * compression.BLOCK + 4 * nb
        raw += 4 * n
    return wire, raw


def _gathered(state: dict, dp: DataParallel) -> dict:
    """The state in its checkpoint layout: a placed state's params and
    moments gathered to rank 0's host one leaf at a time, every data
    rank's ``grad_error`` row gathered on rank 0 (all ranks must call
    this; other ranks get None leaves)."""
    if dp.placement is not None:
        state = {**state,
                 "params": dp.placement.to_host(state["params"], "params",
                                                dp.lead),
                 "opt": dp.placement.to_host(state["opt"], "opt", dp.lead)}
    if "grad_error" not in state or dp.size == 1:
        return state
    dst = dist.get_global_rank(dp.group, 0)

    def gather(e):
        rows = ([torch.empty_like(e) for _ in range(dp.size)]
                if dp.rank == 0 else None)
        dist.gather(e.contiguous(), rows, dst=dst, group=dp.group)
        return torch.cat(rows) if dp.rank == 0 else None

    return {**state, "grad_error": tree_map(gather, state["grad_error"])}


def _save(ckpt, step: int, state: dict, args, dp: DataParallel,
          blocking: bool) -> None:
    out = _gathered(state, dp)
    if dp.lead:
        save = ckpt.save if blocking else ckpt.save_async
        save(step, out, extra={"arch": args.arch})


def _agreed_stop(hb: elastic.Heartbeat, dp: DataParallel, device) -> bool:
    """The drain flag, agreed by every rank of the mesh (MAX over "data",
    then over "model"): a rank that checkpointed while another entered
    the next collective would leave that one waiting forever."""
    if dp.group is None:
        return hb.should_stop
    flag = torch.tensor([int(hb.should_stop)], dtype=torch.int32,
                        device=device)
    for axis in dp.mesh.mesh_dim_names:
        dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                        group=dp.mesh.get_group(axis))
    return bool(flag.item())


def _train_metrics() -> dict:
    """Training diagnostics in the process-global registry (names as in
    the ``repro_torch/obs/__init__.py`` glossary)."""
    return {
        "loss": REGISTRY.gauge("train_step_loss", "last step loss"),
        "tps": REGISTRY.gauge("train_tokens_per_s",
                              "last step token throughput"),
        "step_s": REGISTRY.histogram("train_step_seconds",
                                     "step wall time (incl. the first "
                                     "step's set-up)"),
        "wire": REGISTRY.gauge("train_grad_compressed_bytes",
                               "int8+scales gradient wire bytes per "
                               "all-reduce"),
        "raw": REGISTRY.gauge("train_grad_raw_bytes",
                              "fp32-equivalent gradient bytes per "
                              "all-reduce"),
        "diag": REGISTRY.gauge("train_cascade_diag_norm",
                               "per-cascade SELL diagonal l2 norm",
                               labels=("param", "cascade")),
    }


def _emit_diag_norms(gauge, params, placement=None) -> None:
    """Per-cascade ||A||_2 / ||D||_2 gauges, labelled by the parameter
    path: the paper's init/depth sensitivity lives in these diagonals.
    Of a placed tree every rank must call it (the norms are mesh-wide)."""
    diag = [(path, leaf) for path, leaf in zip(*tree_flatten(params))
            if path.endswith(("sell/a", "sell/d"))]
    sums = [torch.sum(torch.square(leaf.float())) for _, leaf in diag]
    if placement is not None:
        sums = placement.reduce_sums("params")([p for p, _ in diag], sums)
    for (path, _), sq in zip(diag, sums):
        cascade, _, suffix = path.rpartition("/sell/")
        gauge.labels(param=suffix, cascade=cascade).set(
            float(torch.sqrt(sq)))


def run(args: argparse.Namespace, cfg, model, opt, train_step, pipeline):
    """The training loop over ``build``'s pieces; returns (state, one dict
    per step of its metrics as floats and its wall time ``ms``).  A rank
    outside the resolved mesh returns (None, []) at once."""
    dp = pipeline.dp
    if not dp.in_mesh:
        print(f"[elastic] rank {dist.get_rank()} is outside the resolved "
              f"mesh: exiting", flush=True)
        return None, []
    lead = dp.lead
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    state, start = init_or_resume(args, cfg, model, opt, ckpt, dp)
    cuda = torch.device(args.device).type == "cuda"
    hb = elastic.Heartbeat().install()
    monitor = elastic.StragglerMonitor()
    obs = _train_metrics()
    exporter = (JsonlExporter(args.metrics_jsonl, REGISTRY,
                              every=args.log_every, clock=time.time)
                if args.metrics_jsonl and lead else None)
    if dp.placement is not None:
        at_rest = {k: state[k] for k in ("params", "opt")}
        print(f"[placement] rank {dist.get_rank()} at (data "
              f"{dp.mesh.get_local_rank('data')}, model "
              f"{dp.mesh.get_local_rank('model')}) of mesh "
              f"{tuple(dp.mesh.shape)}: {dp.placement.nbytes(at_rest)} "
              f"bytes of params and moments at rest, of "
              f"{dp.placement.nbytes(at_rest, full=True)}", flush=True)
    if args.compress_grads:
        wire, raw = _grad_wire_bytes(
            steps_mod.abstract_state(model, cfg, opt)["params"])
        obs["wire"].set(wire)
        obs["raw"].set(raw)
        if lead:
            print(f"[compress] grad wire bytes {wire} vs fp32 {raw} "
                  f"({wire / max(raw, 1):.3f}x)", flush=True)
    history = []
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch_on(pipeline, step,
                                                        args.device))
            if cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            history.append({**{k: float(v) for k, v in metrics.items()},
                            "ms": dt * 1e3})
            obs["loss"].set(history[-1]["loss"])
            obs["tps"].set(args.global_batch * args.seq_len / max(dt, 1e-9))
            obs["step_s"].observe(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                _emit_diag_norms(obs["diag"], state["params"],
                                 dp.placement)
                if lead:
                    print(f"step {step:5d} loss {history[-1]['loss']:.4f} "
                          f"|g| {history[-1]['grad_norm']:.3f} "
                          f"{dt * 1e3:.0f}ms", flush=True)
                if exporter is not None:
                    exporter.export(step)
            # the first step pays the set-up (kernel loads, allocator
            # growth): seeding the EWMA with it would mask real stragglers
            if step > start and monitor.observe(step, dt) and lead:
                print(f"[straggler] step {step} exceeded {monitor.factor}x "
                      f"EWMA", flush=True)
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                _save(ckpt, step + 1, state, args, dp, blocking=False)
            if _agreed_stop(hb, dp, args.device):
                if lead:
                    print("[preempt] SIGTERM received: draining + "
                          "checkpointing", flush=True)
                ckpt.wait()
                _save(ckpt, step + 1, state, args, dp, blocking=True)
                break
        else:
            # completed (no drain): the final save must not run on the
            # drain path -- it would label a mid-run state ``--steps`` and
            # a resumed job would think training is done
            ckpt.wait()
            _save(ckpt, args.steps, state, args, dp, blocking=True)
    finally:
        hb.uninstall()
    if exporter is not None:
        exporter.close()
        print(f"[obs] metrics jsonl -> {args.metrics_jsonl} "
              f"({exporter.exports} snapshots)", flush=True)
    if lead:
        print("done.", flush=True)
    return state, history


def main(argv=None):
    """Train; returns ``run``'s (state, history).  Leaves the process
    group it joined, if any."""
    args = parse_args(argv)
    try:
        return run(args, *build(args))
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    main()
