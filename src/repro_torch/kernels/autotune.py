"""First-call on-card launch-plan autotuning for the Hopper kernels.

Port of :mod:`repro.kernels.autotune`.  The reference times its fused
Pallas kernels over the row blocks {64, 128, 256} at the first call of a
key, because the sweet spot shifts with N, K, dtype and TPU generation.
The Hopper kernels are cut by launch plans, not row blocks: a cascade's
cluster size, rows a cluster, column groups and resident or streamed
slices (:func:`.acdc_cascade_fused.plan`, :func:`.acdc_cascade_bwd.plan_bwd`),
and paged attention's splits, tile depth and combine
(:func:`.paged_attn.plan`).  Those plans come from cost models fitted to
measured times; here the first call of a key on the card times the cost
model's own candidates instead and keeps the fastest.

Directions (the reference's five): ``fwd`` / ``bwd`` (one layer: the
cascade kernels at K = 1), ``cascade`` (the whole-cascade forward),
``cascade_bwd`` (the reverse sweep) and ``paged_attn`` (decode and
verify).  ``scaled_matmul`` is not tuned: the reference tunes no block
of it.

Keys.  The ACDC directions key on the reference's ``(direction, N, K,
dtype, bias, permute, family)`` plus an M bucket (M rounded up to a power
of two): a Hopper plan depends on M (its cluster count), where the
reference's row block did not.  The sweep runs at the bucket's M; the
memo holds the winner's choice (column split, rows a cluster, tile
depth, resident slices, stash) and the plan is rebuilt at each call's
own M.  ``paged_attn`` keys on :func:`.paged_attn.plan`'s own arguments,
which are fixed per engine.  The transform family keys the memo and
shapes the sweep's operands (the family's own ``C``, ``C^T`` and
``ct_mid``): a winner timed on one family never answers for another.
Keys written without the family field (the reference's six fields plus
the M bucket) are migrated by tagging them ``acdc``, as the reference
migrates its six-field keys.

Behaviour.  Off the card (CPU tensors) nothing is swept: the answer is
the cost model's plan at the key, memoized, the counterpart of the
reference's fixed fallback constants.  On the card the first call of a
key builds sample operands from a seeded generator (unit diagonals, a
random x and g; for paged attention two ticks on random pools, every row
as long as its table holds and every row at half of it), runs every
schedulable
candidate once (each output held against the cost model's plan's output
on the same sample: a disagreement raises, naming the plan), times it by
CUDA events behind a ``torch.cuda._sleep``, best of ``SWEEP_REPS``, and
memoizes the fastest (ties go to the cost model's plan).  A launch or
build error raises: there is no fallback.  Within one process a key's
answer never changes after its first use.  Sweeps launch through
``launch_cascade`` / ``launch_bwd`` / ``paged_attn.launch`` with an
explicit plan, never through the counting wrappers, so no wrapper's
``launches`` moves.

Winners persist across processes in ``build/autotune_cache.json``
(gitignored), keyed by the card (its name and compute capability): an
entry swept on another card never answers.  The write is a
read-merge-write under a file lock, to a temporary file moved into place,
so concurrent workers neither tear the file nor drop each other's
entries.  ``REPRO_AUTOTUNE_CACHE=0`` disables the file;
``REPRO_AUTOTUNE_CACHE_PATH`` moves it.  Every sweep counts in
``autotune_sweeps_total{direction}`` (and its seconds in
``autotune_sweep_seconds_total``) of the process registry, is appended
to :data:`SWEEPS` and emits ``instant_global("autotune", "sweep", ...)``.

One plan a key across ranks, where the caller asks for it.  Inside
:func:`agreeing` (``group``: a process group, the default group when
None), every rank of the group takes the group's first rank's plan for a
key: at the key's first request in the block on each rank, that rank
resolves it (its memo, the file, or a sweep) and broadcasts the plan
with the key over the group; the others take it into their memos and
sweep nothing.  A rank whose memo or file already holds the key still
enters the broadcast, and a rank whose key differs from the first
rank's raises.  Without it the ranks of a placed step may sweep or load
their plans apart and run the same replicated cascade in different
summation orders.  The broadcast is a collective, and so a deadlock
risk: every rank of the group must enter the block and ask for the same
keys in the same order (SPMD), and a rank of the group that asks for a
key the others never ask for waits in the broadcast until the group's
timeout.  Outside the block (code one rank runs alone, ranks outside
the group, an elastic run's ranks left out of its mesh) nothing changes:
each process's own plans, no collective.  CPU tensors take the cost
model's plan with no collective, inside the block too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import functools
import hashlib
import json
import math
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import families as families_mod
from repro_torch.kernels import acdc_cascade_bwd as cascade_bwd_mod
from repro_torch.kernels import acdc_cascade_fused as cascade_mod
from repro_torch.kernels import build
from repro_torch.kernels import paged_attn as paged_attn_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

DIRECTIONS = ("fwd", "bwd", "cascade", "cascade_bwd", "paged_attn")

#: the cascade kernels' candidates (:func:`.acdc_cascade_fused.candidates`):
#: rows a cluster, 32-column groups a thread, streamed tile depths
CANDIDATE_BMS = cascade_mod.ROW_BLOCKS
CANDIDATE_COL_GROUPS = cascade_mod.COL_GROUPS
CANDIDATE_STREAM_KTS = cascade_mod.STREAM_KTS
#: paged attention's candidates around :func:`.paged_attn.plan`'s answer:
#: its splits and keys a tile halved, kept and doubled, each combined in
#: a cluster or through the workspace
CANDIDATE_PAGED_SCALES = (0.5, 1.0, 2.0)
CANDIDATE_PAGED_COMBINES = (True, False)

#: timing repetitions per candidate (after one warm-up call)
SWEEP_REPS = 3
#: GPU cycles of the ``torch.cuda._sleep`` queued before each timed call
#: (~0.5 ms): the call is enqueued before the start event fires, so the
#: events time the device alone
SWEEP_SLEEP_CYCLES = 1_000_000
#: (atol, rtol) of a candidate's output against the cost model's plan's,
#: by output dtype: fp32's, and for bf16 outputs (paged attention's bf16
#: pools) one bf16 rounding more, as the kernel is held in the plain check
SWEEP_TOL = {torch.float32: (2e-4, 1e-3), torch.bfloat16: (2e-2, 2 ** -7)}

#: set to "0"/"off"/"false"/"no" to disable the on-disk winner cache;
#: ``CACHE_ENV + "_PATH"`` moves it
CACHE_ENV = "REPRO_AUTOTUNE_CACHE"

Plan = Union[cascade_mod.Plan, paged_attn_mod.Plan]


@dataclasses.dataclass(frozen=True)
class Sweep:
    """One sweep: its key, the candidates timed, the cost model's plan
    and the winner with their best times (seconds), and the sweep's own
    wall seconds."""
    key: Tuple
    candidates: int
    cost_model: Plan
    cost_model_s: float
    winner: Plan
    winner_s: float
    seconds: float


#: (backend, key) -> plan at the key's M bucket (paged: the plan)
_CACHE: Dict[Tuple[str, Tuple], Plan] = {}
#: backends whose persistent file has been merged into ``_CACHE``
_PERSIST_LOADED: Set[str] = set()
#: every sweep this process ran, in order
SWEEPS: List[Sweep] = []
#: (group's ranks, backend, key) of the plans a group agreed on
_AGREED: Set[Tuple[Tuple, str, Tuple]] = set()
#: the groups of the :func:`agreeing` blocks open, innermost last
_GROUPS: list = []

#: on-card sweeps completed this process, by direction: memo and file
#: hits and CPU answers do NOT count (a run that shows zero sweeps either
#: read the file or never touched a card)
_SWEEPS = obs_metrics.REGISTRY.counter(
    "autotune_sweeps_total", "on-card launch-plan sweeps completed",
    labels=("direction",))
_SWEEP_SECONDS = obs_metrics.REGISTRY.counter(
    "autotune_sweep_seconds_total", "wall seconds of on-card sweeps",
    labels=("direction",))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def m_bucket(m: int) -> int:
    """The M a key sweeps at: M rounded up to a power of two."""
    return 1 << (max(int(m), 1) - 1).bit_length()


def totals() -> Tuple[int, float]:
    """(sweeps, their wall seconds) so far in this process."""
    return (int(sum(c.value for _, c in _SWEEPS.children())),
            sum(c.value for _, c in _SWEEP_SECONDS.children()))


def describe(p: Plan) -> str:
    """A plan in one short string (trace events, logs)."""
    if isinstance(p, paged_attn_mod.Plan):
        return f"splits={p.splits} kt={p.kt} {p.route}"
    return (f"s={p.s} bm={p.bm} cpt={p.cpt} "
            + ("resident" if p.resident else f"kt={p.kt}")
            + (" stash_smem" if p.stash_smem else "")
            + f" smem={p.smem_bytes}")


# ---------------------------------------------------------------------------
# Candidates and the cost model's answer
# ---------------------------------------------------------------------------

def _riffle(direction: str, k: int, permute: bool) -> bool:
    return direction in ("cascade", "cascade_bwd") and permute and k > 1


def _module(direction: str):
    """The module of a cascade direction's kernel (forward or backward)."""
    return cascade_mod if direction in ("fwd", "cascade") \
        else cascade_bwd_mod


def cost_model(direction: str, *dims: int, permute: bool = False) -> Plan:
    """The plan the cost model picks: ``dims`` are (M, N, K) for the ACDC
    directions, :func:`.paged_attn.plan`'s arguments for ``paged_attn``."""
    if direction == "paged_attn":
        return paged_attn_mod.plan(*dims)
    m, n, k = dims
    riffle = _riffle(direction, k, permute)
    if direction in ("fwd", "cascade"):
        return cascade_mod.plan(m, n, k, riffle)
    if direction in ("bwd", "cascade_bwd"):
        return cascade_bwd_mod.plan_bwd(m, n, k, riffle)
    raise ValueError(f"unknown direction {direction!r}")


def _paged_candidates(b, hkv, mb, bs, group, t, dh, item) -> List[Plan]:
    base = paged_attn_mod.plan(b, hkv, mb, bs, group, t, dh, item)
    out = []
    for fs in CANDIDATE_PAGED_SCALES:
        splits = max(1, min(mb, int(base.splits * fs)))
        pps = _cdiv(mb, splits)
        kt_max = min(128, 16 * _cdiv(pps * bs, 16))
        for fk in CANDIDATE_PAGED_SCALES:
            kt = min(kt_max, max(16, 16 * int(base.kt * fk / 16)))
            for cluster in CANDIDATE_PAGED_COMBINES:
                p = paged_attn_mod.make_plan(b, hkv, mb, bs, group, t, dh,
                                             item, splits, kt, cluster)
                if p not in out and p.smem_bytes <= paged_attn_mod.SMEM_LIMIT:
                    out.append(p)
    return out


def candidates(direction: str, *dims: int, permute: bool = False
               ) -> List[Plan]:
    """Every candidate launch of a key (before the card's schedulability
    filter): the cascade directions' ``acdc_cascade_fused.candidates``
    with their own shared-memory rule (K = 1 for ``fwd`` / ``bwd``), or
    paged attention's grid around its plan.  The cost model's plan is
    always among them."""
    if direction == "paged_attn":
        return _paged_candidates(*dims)
    m, n, k = dims
    smem_of = _module(direction).smem_of(k, _riffle(direction, k, permute))
    return list(cascade_mod.candidates(m, n, cascade_mod.vec_width(n, True),
                                       smem_of))


def _schedulable(direction: str, p: Plan, dims: Tuple[int, ...],
                 permute: bool) -> bool:
    """Whether the card holds at least one of the plan's clusters
    (``cudaOccupancyMaxActiveClusters``); paged attention's candidates
    are cut to the shared-memory limit and clusters of at most 8
    (portable) already."""
    if direction == "paged_attn":
        return True
    m, _, k = dims
    return _module(direction).max_clusters(
        p, m, k, _riffle(direction, k, permute), strict=False) > 0


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

Runner = Callable[[Plan], Callable[[], object]]


def make_runner(direction: str, dims: Tuple[int, ...], device,
                dtype: torch.dtype = torch.float32, bias: bool = False,
                permute: bool = False, family: str = "acdc") -> Runner:
    """``build(plan) -> run()``: one launch of the plan on the sweep's
    sample operands (from a seeded generator), returning its output."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    if direction == "paged_attn":
        b, hkv, mb, bs, group, t, dh, item = dims
        dt = {2: torch.bfloat16, 4: torch.float32}[item]
        nb = b * mb
        q = randn(b, t, hkv * group, dh, dt=dt)
        kn, vn = randn(b, t, hkv, dh, dt=dt), randn(b, t, hkv, dh, dt=dt)
        tables = torch.arange(nb, dtype=torch.int32,
                              device=device).reshape(b, mb)
        # two ticks of a generation, each on pools of its own: every row
        # as long as its table holds, and every row at half of it.  The
        # plan sees host integers only, never the positions, and a plan
        # that wins on full tables can lose on half-full ones (and back)
        full = max(0, mb * bs - t)
        ticks = [(randn(nb + 1, bs, hkv, dh, dt=dt),
                  randn(nb + 1, bs, hkv, dh, dt=dt),
                  torch.full((b,), length, dtype=torch.int32,
                             device=device))
                 for length in (full, min(full, mb * bs // 2))]
        return lambda p: lambda: tuple(
            paged_attn_mod.launch(q, kn, vn, kp, vp, tables, pos, 0, 0.0, p)
            for kp, vp, pos in ticks)

    m, n, k = dims
    fam = families_mod.get_family(family)
    c, ct = fam.matrices(n, torch.float32, device)
    ct_mid = None
    if _riffle(direction, k, permute):
        perm = torch.as_tensor(fam.riffle(n), dtype=torch.long,
                               device=device)
        ct_mid = ct[:, perm].contiguous()
    a = torch.ones((k, n), dtype=torch.float32, device=device)
    d = torch.ones((k, n), dtype=torch.float32, device=device)
    b = (torch.zeros((k, n), dtype=torch.float32, device=device)
         if bias and direction != "bwd" else None)
    x = randn(m, n)
    if direction in ("fwd", "cascade"):
        return lambda p: lambda: cascade_mod.launch_cascade(
            x, a, d, b, c, ct, ct_mid, False, p)
    g = randn(m, n)
    return lambda p: lambda: cascade_bwd_mod.launch_bwd(
        x, g, a, d, b, c, ct, ct_mid, False, p, with_db=bias)


def _device_timer(run: Callable[[], object]) -> float:
    """Best of ``SWEEP_REPS`` device times (seconds) of one call, each
    queued behind a ``torch.cuda._sleep`` and timed by CUDA events."""
    best = math.inf
    for _ in range(SWEEP_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SWEEP_SLEEP_CYCLES)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _outputs(out) -> Tuple[Optional[torch.Tensor], ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _disagreement(got, want) -> Optional[float]:
    """None when every output of ``got`` is within ``SWEEP_TOL`` of
    ``want``'s (atol relative to the output's largest entry: the
    diagonal grads are sums over M), else the largest difference."""
    worst, bad = 0.0, False
    for g, w in zip(_outputs(got), _outputs(want)):
        if g is None or w is None:
            bad |= (g is None) != (w is None)
            continue
        if g.shape != w.shape:
            return math.inf
        atol, rtol = SWEEP_TOL.get(w.dtype, SWEEP_TOL[torch.float32])
        gf, wf = g.float(), w.float()
        diff = (gf - wf).abs()
        scale = max(float(wf.abs().max()), 1.0) if wf.numel() else 1.0
        bad |= not bool((diff <= atol * scale + rtol * wf.abs()).all())
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst if bad else None


def sweep(direction: str, *dims: int, device="cuda",
          dtype: torch.dtype = torch.float32, bias: bool = False,
          permute: bool = False, family: str = "acdc",
          timer: Optional[Callable[[Callable[[], object]], float]] = None,
          runner: Optional[Runner] = None) -> Sweep:
    """Time every schedulable candidate of a key at ``dims`` and return
    the sweep with its winner.  Each candidate's output is first held
    against the cost model's plan's on the same sample; a candidate that
    disagrees raises, naming its plan, and a launch error raises as it
    is.  ``timer`` (seconds of one call of a thunk) and ``runner``
    (``plan -> thunk`` returning the output) are injectable for tests;
    by default the thunks launch the kernels on sample operands and are
    timed on the card."""
    t0 = time.perf_counter()
    base = cost_model(direction, *dims, permute=permute)
    cands = [p for p in candidates(direction, *dims, permute=permute)
             if _schedulable(direction, p, dims, permute)]
    build_run = runner or make_runner(direction, dims, device, dtype, bias,
                                      permute, family)
    timer = timer or _device_timer
    want = build_run(base)()
    timings = []
    for i, p in enumerate(cands):
        run = build_run(p)
        err = _disagreement(run(), want)     # also the warm-up call
        if err is not None:
            raise ValueError(
                f"autotune {direction} {dims}: plan {p} disagrees with the "
                f"cost model's plan {base} (max |diff| {err})")
        timings.append((timer(run), p != base, i))
    if not timings:
        raise ValueError(f"autotune {direction} {dims}: no schedulable "
                         f"candidate")
    best = min(timings)
    base_s = next((s for s, other, _ in timings if not other), math.nan)
    return Sweep(key=(direction, *dims), candidates=len(cands),
                 cost_model=base, cost_model_s=base_s,
                 winner=cands[best[2]], winner_s=best[0],
                 seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Persistent winner cache (build/autotune_cache.json)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)}|sm_{major}{minor}"


def _backend(device: torch.device) -> str:
    """The card's name and compute capability; ``cpu`` for any device
    that is not a card (never swept)."""
    if device.type != "cuda":
        return "cpu"
    return _card_name(torch.cuda._get_device_index(device, optional=True))


def _persist_enabled() -> bool:
    return os.environ.get(CACHE_ENV, "1").lower() not in (
        "0", "off", "false", "no")


def _cache_path() -> str:
    override = os.environ.get(CACHE_ENV + "_PATH")
    if override:
        return override
    return str(build.BUILD_DIR.parent / "autotune_cache.json")


def _key_str(key: Tuple) -> str:
    return "|".join(str(p) for p in key)


def _key_from_str(s: str) -> Tuple:
    parts = s.split("|")
    if parts[0] == "paged_attn":
        if len(parts) != 9:
            raise ValueError(f"bad paged_attn key {s!r}")
        return ("paged_attn", *(int(p) for p in parts[1:]))
    if len(parts) == 7:
        # written before the family field: every such sweep ran the DCT,
        # so migrate rather than discard -- but never to another family
        parts.insert(6, "acdc")
    direction, n, k, dtype, bias, permute, family, m = parts
    if direction not in DIRECTIONS:
        raise ValueError(f"bad direction in key {s!r}")
    return (direction, int(n), int(k), dtype, bias == "True",
            permute == "True", family, int(m))


def _dims_of(key: Tuple) -> Tuple[int, ...]:
    """The dims a key sweeps at (the ACDC directions at their bucket)."""
    if key[0] == "paged_attn":
        return key[1:]
    direction, n, k, _, _, _, _, m = key
    return (m, n, k)


def _plan_to_json(p: Plan) -> dict:
    d = dataclasses.asdict(p)
    if isinstance(p, cascade_mod.Plan):
        del d["n"], d["clusters"]     # from the key
    return d


def _plan_from_json(key: Tuple, d: dict) -> Optional[Plan]:
    """The stored choice as a plan at the key's dims, or None when it is
    not (or no longer) one of the key's candidates."""
    dims = _dims_of(key)
    permute = False
    if key[0] == "paged_attn":
        d = dict(d)
        if d.get("workspace") is not None:
            d["workspace"] = tuple(d["workspace"])
        p = paged_attn_mod.Plan(**d)
    else:
        m, n, _ = dims
        p = cascade_mod.Plan(n=n, clusters=_cdiv(m, d["bm"]), **d)
        permute = key[5]
    return p if p in candidates(key[0], *dims, permute=permute) else None


def _load_persistent(backend: str) -> None:
    """Merge the file's winners for ``backend`` into the memo (once)."""
    if backend in _PERSIST_LOADED:
        return
    _PERSIST_LOADED.add(backend)
    if not _persist_enabled():
        return
    try:
        with open(_cache_path()) as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return
    if not isinstance(blob, dict) or blob.get("backend") != backend \
            or not isinstance(blob.get("entries"), dict):
        return
    for key_s, choice in blob["entries"].items():
        try:
            key = _key_from_str(key_s)
            p = _plan_from_json(key, choice)
        except (ValueError, TypeError, KeyError, AttributeError):
            continue
        if p is not None:
            _CACHE.setdefault((backend, key), p)


def _save_persistent(backend: str, key: Tuple, p: Plan) -> None:
    """Record one winner on disk: read-merge-write under an exclusive
    lock, the new file written beside the old and moved over it."""
    if not _persist_enabled():
        return
    path = _cache_path()
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path + ".lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            entries = {}
            try:
                with open(path) as f:
                    blob = json.load(f)
                if blob.get("backend") == backend:
                    entries = dict(blob["entries"])
            except (OSError, ValueError, AttributeError, KeyError,
                    TypeError):
                pass
            entries[_key_str(key)] = _plan_to_json(p)
            try:
                with open(tmp, "w") as f:
                    json.dump({"backend": backend, "entries": entries}, f,
                              indent=1, sort_keys=True)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    except OSError as e:
        warnings.warn(f"autotune: winner of {_key_str(key)} not saved to "
                      f"{path}: {e}")


# ---------------------------------------------------------------------------
# The memoized answer
# ---------------------------------------------------------------------------

def key_of(direction: str, dims: Tuple[int, ...],
           dtype: torch.dtype = torch.float32, bias: bool = False,
           permute: bool = False, family: str = "acdc") -> Tuple:
    """The memo key of a request (``autotuned_plan``'s arguments)."""
    if direction == "paged_attn":
        if len(dims) != 8:
            raise ValueError(f"paged_attn takes plan()'s 8 dims, got {dims}")
        return ("paged_attn", *(int(v) for v in dims))
    if direction not in DIRECTIONS or len(dims) != 3:
        raise ValueError(f"autotune: bad request {direction!r} {dims}")
    m, n, k = dims
    return (direction, int(n), int(k), str(dtype).removeprefix("torch."),
            bool(bias), bool(permute), family, m_bucket(m))


@functools.lru_cache(maxsize=4096)
def _at_m(p: cascade_mod.Plan, m: int) -> cascade_mod.Plan:
    """A cascade plan rebuilt at the call's own M."""
    clusters = _cdiv(m, p.bm)
    return p if p.clusters == clusters else dataclasses.replace(
        p, clusters=clusters)


def _resolve(direction: str, key: Tuple, backend: str, device, dtype,
             bias: bool, permute: bool, family: str) -> Plan:
    """This process's plan of ``key`` at its dims: the memo, then the
    persistent file, then a sweep (recorded and saved)."""
    p = _CACHE.get((backend, key))
    if p is not None:
        return p
    _load_persistent(backend)
    p = _CACHE.get((backend, key))
    if p is not None:
        return p
    rec = sweep(direction, *_dims_of(key), device=device, dtype=dtype,
                bias=bias, permute=permute, family=family)
    rec = dataclasses.replace(rec, key=key)
    _save_persistent(backend, key, rec.winner)
    SWEEPS.append(rec)
    _SWEEPS.labels(direction=direction).inc()
    _SWEEP_SECONDS.labels(direction=direction).inc(rec.seconds)
    obs_trace.instant_global("autotune", "sweep", direction=direction,
                             key=_key_str(key), winner=describe(rec.winner))
    return rec.winner


def _agreeing() -> Optional[Tuple]:
    """The ranks (global, in group order) that must agree on each key
    here: those of the innermost :func:`agreeing` block's group, where
    it holds more than one rank; else None."""
    if not (_GROUPS and dist.is_available() and dist.is_initialized()) \
            or dist.get_backend() == "fake":
        return None
    ranks = tuple(dist.get_process_group_ranks(_GROUPS[-1])
                  if _GROUPS[-1] is not None
                  else range(dist.get_world_size()))
    return ranks if len(ranks) > 1 else None


def _agree(key: Tuple, plan: Optional[Plan], ranks: Tuple) -> Plan:
    """The group's first rank's ``plan`` of ``key`` on every rank of the
    innermost :func:`agreeing` group (the other ranks pass None)."""
    box = [(key, plan)]
    dist.broadcast_object_list(box, src=ranks[0], group=_GROUPS[-1])
    got, plan = box[0]
    if got != key:
        raise RuntimeError(
            f"autotune: rank {dist.get_rank()} asks for {_key_str(key)} "
            f"where rank {ranks[0]} asks for {_key_str(got)}: the ranks of "
            f"an agreeing() block must request the same keys in the same "
            f"order")
    return plan


@contextlib.contextmanager
def agreeing(group=None):
    """Inside the block every rank of ``group`` (a process group; the
    default group when None) takes the group's first rank's plan for
    each key (see the module doc: every rank of the group must enter the
    block and ask for the same keys in the same order)."""
    _GROUPS.append(group)
    try:
        yield
    finally:
        _GROUPS.pop()


def autotuned_plan(direction: str, *dims: int, device,
                   dtype: torch.dtype = torch.float32, bias: bool = False,
                   permute: bool = False, family: str = "acdc") -> Plan:
    """The memoized launch plan of a kernel call: ``dims`` are (M, N, K)
    for ``fwd`` / ``bwd`` (K = 1), ``cascade`` and ``cascade_bwd``, and
    :func:`.paged_attn.plan`'s (B, Hkv, MB, bs, group, T, Dh, item) for
    ``paged_attn``.  On the card the first call of a key sweeps (see the
    module doc), and inside :func:`agreeing` every rank of its group
    takes the group's first rank's plan; off it the cost model answers.
    ACDC plans come back at the call's own M."""
    key = key_of(direction, dims, dtype, bias, permute, family)
    backend = _backend(torch.device(device))
    p = _CACHE.get((backend, key))
    if backend == "cpu":
        if p is None:
            p = cost_model(direction, *_dims_of(key), permute=permute)
    elif (ranks := _agreeing()) and (ranks, backend, key) not in _AGREED:
        mine = (_resolve(direction, key, backend, device, dtype, bias,
                         permute, family)
                if dist.get_rank() == ranks[0] else None)
        p = _agree(key, mine, ranks)
        _AGREED.add((ranks, backend, key))
    elif p is None:
        p = _resolve(direction, key, backend, device, dtype, bias, permute,
                     family)
    _CACHE[(backend, key)] = p
    return p if direction == "paged_attn" else _at_m(p, dims[0])


def digest() -> str:
    """A short digest of the plans of the keys this process agreed on
    with its groups: equal on two ranks exactly when they hold the same
    plans for the same keys."""
    entries = sorted((_key_str(key), _plan_to_json(_CACHE[(b, key)]))
                     for _, b, key in _AGREED)
    text = json.dumps(entries, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def memo(backend: Optional[str] = None) -> Dict[Tuple, Plan]:
    """The memo's entries (key -> plan at the key's dims), of one backend
    or of every card backend."""
    return {key: p for (b, key), p in _CACHE.items()
            if (b == backend if backend is not None else b != "cpu")}
