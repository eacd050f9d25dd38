"""The port's launch-plan autotuner (``kernels/autotune.py``) on the CPU.

Mirrors the reference's own autotune tests (``tests/test_kernels.py``,
block-size autotuning), with the reference run in the same test where a
behaviour is shared:

* off the card neither package sweeps: the port answers with the cost
  models (``plan`` / ``plan_bwd`` / ``paged_attn.plan``) for all five
  directions, memoized, and both ``autotune_sweeps_total`` stay 0;
* ``sweep`` picks the fastest schedulable candidate under an injected
  timer and runner, over exactly the generator's schedulable candidates;
  a candidate that disagrees with the cost model's plan raises, and a
  runner that raises is not swallowed;
* the persistent file under a faked card backend: a winner reloads in a
  fresh memo without a sweep, another card ignores it,
  ``REPRO_AUTOTUNE_CACHE=0`` disables it and ``_PATH`` moves it, a
  garbage file is ignored, keys without the family field migrate to
  ``acdc``, and the write is atomic;
* a key's M bucket: one sweep answers every M of the bucket, rebuilt at
  the call's own M;
* the routing decisions answer the same whatever the memo holds, and the
  plan ``kernels.ops`` passes each wrapper is the autotuned one;
* a sweep launches through ``launch_cascade`` / ``launch_bwd`` /
  ``paged_attn.launch`` and adds nothing to any wrapper's ``launches``.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro.kernels import acdc_bwd as jbwd
from repro.kernels import acdc_cascade_bwd as jcbwd
from repro.kernels import acdc_cascade_fused as jcascade
from repro.kernels import acdc_fused as jfused
from repro.obs import metrics as jmetrics
from repro_torch.kernels import acdc_bwd as tbwd
from repro_torch.kernels import acdc_cascade_bwd as tcbwd
from repro_torch.kernels import acdc_cascade_fused as tcascade
from repro_torch.kernels import acdc_fused as tfused
from repro_torch.kernels import autotune
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as tpa
from repro_torch.kernels import ref

from _torch_threads import one_torch_thread  # noqa: F401

CARD = "FAKE H100|sm_90"
OTHER = "FAKE A100|sm_80"
PAGED = (4, 8, 6, 16, 2, 5, 128, 2)    # Qwen3's paged verify, 4 slots

#: one request of each direction: (direction, dims, permute)
REQUESTS = [("fwd", (4, 256, 1), False), ("bwd", (256, 128, 1), False),
            ("cascade", (64, 1024, 2), True),
            ("cascade_bwd", (512, 1024, 2), True),
            ("paged_attn", PAGED, False)]


def _cost_model(direction, dims, permute):
    if direction == "paged_attn":
        return tpa.plan(*dims)
    m, n, k = dims
    riffle = permute and k > 1
    if direction in ("fwd", "cascade"):
        return tcascade.plan(m, n, k, riffle)
    return tcbwd.plan_bwd(m, n, k, riffle)


def _sweeps(registry, name="autotune_sweeps_total"):
    fam = registry.get(name)
    return 0 if fam is None else sum(c.value for _, c in fam.children())


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """An empty memo, the file under ``tmp_path`` and no recorded sweeps:
    the state of a new process."""
    path = tmp_path / "autotune_cache.json"
    monkeypatch.setenv(autotune.CACHE_ENV + "_PATH", str(path))
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_PERSIST_LOADED", set())
    monkeypatch.setattr(autotune, "SWEEPS", [])
    return path


def _new_process(monkeypatch):
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_PERSIST_LOADED", set())


def _fake_card(monkeypatch, backend=CARD):
    monkeypatch.setattr(autotune, "_backend", lambda device: backend)


def _fake_sweep(monkeypatch, pick):
    """``autotune.sweep`` returning ``pick(candidates)`` without a card;
    the calls are recorded."""
    calls = []

    def sweep(direction, *dims, permute=False, **kw):
        cands = autotune.candidates(direction, *dims, permute=permute)
        calls.append((direction, dims))
        base = autotune.cost_model(direction, *dims, permute=permute)
        return autotune.Sweep(key=(direction, *dims), candidates=len(cands),
                              cost_model=base, cost_model_s=2.0,
                              winner=pick(cands), winner_s=1.0, seconds=0.0)

    monkeypatch.setattr(autotune, "sweep", sweep)
    return calls


def _request(direction, dims, permute, device="cpu"):
    return autotune.autotuned_plan(direction, *dims, device=device,
                                   permute=permute)


@pytest.mark.parametrize("direction,dims,permute", REQUESTS)
def test_off_card_both_packages_skip_the_sweep(fresh, direction, dims,
                                               permute):
    """Off the card: the reference answers with its fixed constants, the
    port with its cost models; both memoize; neither counts a sweep."""
    j_before = _sweeps(jmetrics.REGISTRY)
    t_before = autotune.totals()
    jdir = {"fwd": ("fwd", jfused.DEFAULT_BM), "bwd": ("bwd", jbwd.DEFAULT_BM),
            "cascade": ("cascade", jcascade.pick_bm(1024, 2, permute=True,
                                                    bias=False)),
            "cascade_bwd": ("cascade_bwd", jcbwd.pick_bm(
                1024, 2, permute=True, bias=False))}
    if direction in jdir:
        name, want = jdir[direction]
        n, k = dims[1], dims[2]
        assert jautotune.autotuned_bm(name, n, k, permute=permute) == want
    else:
        assert jautotune.autotuned_bm("paged_attn", 128, 5) \
            == jautotune._fallback("paged_attn", 128, 5, bias=False,
                                   permute=False)
    got = _request(direction, dims, permute)
    assert got == _cost_model(direction, dims, permute)
    memo = autotune.memo("cpu")
    assert len(memo) == 1 and list(memo.values())[0] == \
        _cost_model(direction, dims, permute)
    # memoized: the same object again, nothing swept
    assert _request(direction, dims, permute) is got
    assert autotune.SWEEPS == []
    assert autotune.totals() == t_before
    assert _sweeps(jmetrics.REGISTRY) == j_before


@pytest.mark.parametrize("direction,dims,permute", REQUESTS)
def test_sweep_picks_fastest_schedulable_candidate(monkeypatch, direction,
                                                   dims, permute):
    """The injected timer's fastest candidate wins, over exactly the
    generator's candidates the card can schedule (one is refused here);
    a tie goes to the cost model's plan."""
    cands = autotune.candidates(direction, *dims, permute=permute)
    base = autotune.cost_model(direction, *dims, permute=permute)
    assert base in cands and len(cands) >= 2
    refused = next(p for p in cands if p != base)
    monkeypatch.setattr(autotune, "_schedulable",
                        lambda d, p, dims, permute: p != refused)
    built = []
    out = torch.arange(12.0).reshape(3, 4)

    def runner(p):
        built.append(p)
        return lambda: out.clone()

    fast = next(p for p in reversed(cands) if p not in (base, refused))
    times = {p: 3.0 + i for i, p in enumerate(cands)}
    times[fast] = 1.0
    rec = autotune.sweep(direction, *dims, permute=permute,
                         runner=runner, timer=lambda run: times[built[-1]])
    assert rec.winner == fast and rec.winner_s == 1.0
    assert rec.cost_model == base and rec.cost_model_s == times[base]
    assert rec.candidates == len(cands) - 1
    # the cost model's plan first (the reference output), then every
    # schedulable candidate once, in the generator's order
    assert built == [base] + [p for p in cands if p != refused]
    tie = {p: 1.0 for p in cands}
    rec = autotune.sweep(direction, *dims, permute=permute, runner=runner,
                         timer=lambda run: tie[built[-1]])
    assert rec.winner == base


def test_candidates_are_the_generators():
    """The cascade directions time ``acdc_cascade_fused.candidates`` with
    their own shared-memory rule; the cost model's plan is one of them."""
    m, n = 512, 1024
    for direction, k, smem in (("cascade", 2, tcascade.smem_of(2, True)),
                               ("fwd", 1, tcascade.smem_of(1, False)),
                               ("cascade_bwd", 2, tcbwd.smem_of(2, True)),
                               ("bwd", 1, tcbwd.smem_of(1, False))):
        got = autotune.candidates(direction, m, n, k, permute=True)
        assert got == list(tcascade.candidates(m, n, 4, smem))
    paged = autotune.candidates("paged_attn", *PAGED)
    assert tpa.plan(*PAGED) in paged
    assert len(set(paged)) == len(paged)
    assert all(p.smem_bytes <= tpa.SMEM_LIMIT for p in paged)


def test_disagreeing_candidate_raises_naming_its_plan(monkeypatch):
    monkeypatch.setattr(autotune, "_schedulable", lambda *a: True)
    dims = (64, 256, 2)
    base = autotune.cost_model("cascade", *dims, permute=True)
    bad = next(p for p in autotune.candidates("cascade", *dims,
                                              permute=True) if p != base)
    want = torch.ones(4, 4)

    def runner(p):
        return lambda: want + (1e-2 if p == bad else 1e-6)

    with pytest.raises(ValueError, match="disagrees") as err:
        autotune.sweep("cascade", *dims, permute=True, runner=runner,
                       timer=lambda run: 1.0)
    assert str(bad) in str(err.value)
    # within the fp32 tolerance: no refusal
    autotune.sweep("cascade", *dims, permute=True,
                   runner=lambda p: lambda: want + 1e-6,
                   timer=lambda run: 1.0)
    # bf16 outputs are held to one bf16 rounding more
    wb = torch.full((4, 4), 3.0, dtype=torch.bfloat16)
    autotune.sweep("cascade", *dims, permute=True,
                   runner=lambda p: lambda: wb if p == base
                   else wb * (1 + 2 ** -8), timer=lambda run: 1.0)


def test_runner_error_is_not_swallowed(monkeypatch, fresh):
    """A launch error in a sweep raises out of ``autotuned_plan``: no
    fallback to the cost model's plan, nothing memoized, counted or
    saved."""
    monkeypatch.setattr(autotune, "_schedulable", lambda *a: True)
    _fake_card(monkeypatch)
    dims = (64, 256, 2)
    base = autotune.cost_model("cascade", *dims, permute=True)

    def runner(p):
        def run():
            if p != base:
                raise RuntimeError("acdc_cascade: CUDA launch failed")
            return torch.zeros(2)
        return run

    real = autotune.sweep
    monkeypatch.setattr(autotune, "sweep", lambda *a, **kw: real(
        *a, **kw, runner=runner, timer=lambda run: 1.0))
    before = autotune.totals()
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        autotune.autotuned_plan("cascade", *dims, device="cpu",
                                permute=True)
    assert autotune.memo(CARD) == {} and autotune.totals() == before
    assert not fresh.exists()


def test_persistent_cache_roundtrip(monkeypatch, fresh):
    """A winner spills to the file and reloads in a fresh memo without a
    sweep; another card ignores the file."""
    _fake_card(monkeypatch)
    direction, dims, permute = REQUESTS[3]
    base = _cost_model(direction, dims, permute)
    calls = _fake_sweep(monkeypatch, lambda cands: next(
        p for p in reversed(cands) if p != base))
    before = autotune.totals()[0]
    won = _request(direction, dims, permute)
    assert won != base and calls == [(direction, dims)]
    assert autotune.totals()[0] == before + 1
    assert [r.winner for r in autotune.SWEEPS] == [won]
    blob = json.loads(fresh.read_text())
    assert blob["backend"] == CARD and len(blob["entries"]) == 1
    # every direction round-trips
    for d, dm, pm in REQUESTS:
        _request(d, dm, pm)
    assert len(json.loads(fresh.read_text())["entries"]) == 5
    answers = {d: _request(d, dm, pm) for d, dm, pm in REQUESTS}

    # a fresh process: the file answers, nothing is swept
    _new_process(monkeypatch)
    calls.clear()
    for d, dm, pm in REQUESTS:
        assert _request(d, dm, pm) == answers[d]
    assert calls == []

    # another card ignores the file: it sweeps anew, and the file is now
    # that card's alone
    _new_process(monkeypatch)
    _fake_card(monkeypatch, OTHER)
    _request(direction, dims, permute)
    assert calls == [(direction, dims)]
    assert json.loads(fresh.read_text())["backend"] == OTHER
    # the CPU never reads the file: the cost model answers
    _new_process(monkeypatch)
    monkeypatch.setattr(autotune, "_backend", lambda device: "cpu")
    assert _request(direction, dims, permute) == base


def test_reference_persistent_cache_roundtrip(monkeypatch, tmp_path):
    """The reference's own round trip under the same environment
    variables (its file under ``tmp_path``), beside the port's above."""
    path = tmp_path / "ref_autotune_cache.json"
    monkeypatch.setenv(jautotune.CACHE_ENV + "_PATH", str(path))
    monkeypatch.setattr(jautotune, "_backend", lambda: "tpu")
    monkeypatch.setattr(jautotune, "sweep", lambda *a, **kw: 64)
    monkeypatch.setattr(jautotune, "_CACHE", {})
    monkeypatch.setattr(jautotune, "_PERSIST_LOADED", False)
    assert jautotune.autotuned_bm("cascade_bwd", 256, 4, bias=True) == 64
    monkeypatch.setattr(jautotune, "sweep", lambda *a, **kw: 128)
    monkeypatch.setattr(jautotune, "_CACHE", {})
    monkeypatch.setattr(jautotune, "_PERSIST_LOADED", False)
    assert jautotune.autotuned_bm("cascade_bwd", 256, 4, bias=True) == 64
    assert json.loads(path.read_text())["backend"] == "tpu"


def test_cache_env_disables_and_path_moves_the_file(monkeypatch, fresh,
                                                    tmp_path):
    _fake_card(monkeypatch)
    calls = _fake_sweep(monkeypatch, lambda cands: cands[-1])
    direction, dims, permute = REQUESTS[2]
    monkeypatch.setenv(autotune.CACHE_ENV, "0")
    _request(direction, dims, permute)
    assert not fresh.exists()
    _new_process(monkeypatch)
    _request(direction, dims, permute)
    assert len(calls) == 2      # nothing read back either
    monkeypatch.setenv(autotune.CACHE_ENV, "1")
    moved = tmp_path / "elsewhere" / "plans.json"
    monkeypatch.setenv(autotune.CACHE_ENV + "_PATH", str(moved))
    _new_process(monkeypatch)
    _request(direction, dims, permute)
    assert moved.exists() and not fresh.exists()
    assert autotune._cache_path() == str(moved)
    monkeypatch.delenv(autotune.CACHE_ENV + "_PATH")
    assert autotune._cache_path().endswith(
        os.path.join("build", "autotune_cache.json"))


@pytest.mark.parametrize("garbage", [
    "{not json", "[]", json.dumps({"backend": CARD, "entries": []}),
    json.dumps({"backend": CARD, "entries": {
        "cascade|64|2|float32|False|True|acdc|64": {"s": 3}}}),
    json.dumps({"backend": CARD, "entries": {"nonsense": {}}})])
def test_garbage_file_is_ignored(monkeypatch, fresh, garbage):
    """A file that does not parse, or entries that are not plans of
    their key, answer nothing: the key is swept; the reference ignores
    an unparsable file the same way."""
    fresh.write_text(garbage)
    _fake_card(monkeypatch)
    calls = _fake_sweep(monkeypatch, lambda cands: cands[0])
    _request("cascade", (64, 64, 2), True)
    assert calls == [("cascade", (64, 64, 2))]
    monkeypatch.setenv(jautotune.CACHE_ENV + "_PATH", str(fresh))
    monkeypatch.setattr(jautotune, "_backend", lambda: "tpu")
    monkeypatch.setattr(jautotune, "_CACHE", {})
    monkeypatch.setattr(jautotune, "_PERSIST_LOADED", False)
    jautotune._load_persistent()
    assert jautotune._CACHE == {}


def test_keys_without_family_migrate_to_acdc(monkeypatch, fresh):
    """A key written without the family field is the DCT's (``acdc``), as
    in the reference; it never answers for another family."""
    assert jautotune._key_from_str("cascade|1024|2|float32|True|True") == (
        "cascade", 1024, 2, "float32", True, True, "acdc")
    assert autotune._key_from_str("cascade|1024|2|float32|False|True|64") \
        == ("cascade", 1024, 2, "float32", False, True, "acdc", 64)
    key = ("cascade", 256, 2, "float32", False, True, "acdc", 64)
    cands = autotune.candidates("cascade", 64, 256, 2, permute=True)
    winner = cands[-1]
    fresh.write_text(json.dumps({"backend": CARD, "entries": {
        "cascade|256|2|float32|False|True|64":
            autotune._plan_to_json(winner)}}))
    _fake_card(monkeypatch)
    calls = _fake_sweep(monkeypatch, lambda c: c[0])
    assert _request("cascade", (64, 256, 2), True) == winner
    assert autotune.memo(CARD) == {key: winner} and calls == []
    got = autotune.autotuned_plan("cascade", 64, 256, 2, device="cpu",
                                  permute=True, family="circulant")
    assert calls == [("cascade", (64, 256, 2))] and got == cands[0]


def test_write_is_atomic(monkeypatch, fresh):
    """A write that fails half way leaves the old file whole and no
    temporary file behind."""
    _fake_card(monkeypatch)
    _fake_sweep(monkeypatch, lambda cands: cands[0])
    _request(*REQUESTS[0])
    old = fresh.read_text()

    def torn(obj, f, **kw):
        f.write('{"backend": "')
        raise RuntimeError("disk gone")

    monkeypatch.setattr(autotune.json, "dump", torn)
    with pytest.raises(RuntimeError, match="disk gone"):
        _request(*REQUESTS[1])
    assert fresh.read_text() == old
    assert sorted(os.listdir(fresh.parent)) == sorted(
        [fresh.name, fresh.name + ".lock"])


def test_concurrent_writers_keep_each_others_entries(monkeypatch, fresh):
    """Two processes' winners merge: each write reads the file under the
    lock, so a second writer keeps the first one's entry."""
    _fake_card(monkeypatch)
    _fake_sweep(monkeypatch, lambda cands: cands[0])
    _request(*REQUESTS[0])
    _new_process(monkeypatch)          # another worker, an empty memo
    monkeypatch.setattr(autotune, "_load_persistent", lambda backend: None)
    _request(*REQUESTS[2])
    assert len(json.loads(fresh.read_text())["entries"]) == 2


@pytest.mark.parametrize("m", [1, 4, 37, 64, 65, 512])
def test_m_bucket_rebuilds_the_plan_at_the_calls_m(monkeypatch, fresh, m):
    """Every M of a power-of-two bucket shares one sweep, run at the
    bucket's M; each call gets the winner with its own cluster count."""
    bucket = autotune.m_bucket(m)
    assert bucket >= m and bucket & (bucket - 1) == 0 and bucket < 2 * m \
        or m == 1
    cpu = autotune.autotuned_plan("cascade", m, 1024, 2, device="cpu",
                                  permute=True)
    at_bucket = tcascade.plan(bucket, 1024, 2, True)
    assert cpu.clusters == -(-m // cpu.bm)
    assert cpu == tcascade.Plan(**{**at_bucket.__dict__,
                                   "clusters": -(-m // at_bucket.bm)})
    _fake_card(monkeypatch)
    calls = _fake_sweep(monkeypatch, lambda cands: cands[-1])
    for mm in sorted({m, bucket, bucket // 2 + 1}):
        p = autotune.autotuned_plan("cascade", mm, 1024, 2, device="cpu",
                                    permute=True)
        assert p.clusters == -(-mm // p.bm)
    assert calls == [("cascade", (bucket, 1024, 2))]


def test_routing_is_the_references_whatever_the_memo_holds(monkeypatch,
                                                           fresh):
    """The routes (``MAX_FUSED_N``, both cascade gates, the paged route)
    do not look at the memo; the plan each wrapper gets from
    ``kernels.ops`` is the memo's."""
    shapes = [(n, k, p, b) for n in (128, 640, 1024, 2048)
              for k in (1, 2, 4, 24) for p in (False, True)
              for b in (False, True)]

    def routes():
        return ([(ops.cascade_route(n, k, permute=p, bias=b),
                  ops.cascade_fits(n, k, permute=p, bias=b),
                  ops.cascade_bwd_fits(n, k, permute=p, bias=b))
                 for n, k, p, b in shapes],
                ops.paged_attn_route(8, 128, 2, 5, torch.device("cpu")))

    before = routes()
    _fake_card(monkeypatch)
    _fake_sweep(monkeypatch, lambda cands: cands[-1])
    for d, dm, pm in REQUESTS:
        _request(d, dm, pm)
    assert routes() == before

    seen = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            seen[name] = kw.get("p")
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(tcascade, "acdc_cascade")
    spy(tcbwd, "acdc_cascade_bwd")
    spy(tfused, "acdc_fused")
    spy(tbwd, "acdc_bwd")
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.randn(3, 5, 256), dtype=torch.float32,
                     requires_grad=True)
    a = torch.tensor(1 + 0.06 * rs.randn(2, 256), dtype=torch.float32)
    d = torch.tensor(1 + 0.06 * rs.randn(2, 256), dtype=torch.float32)
    ops.acdc_cascade_op(x, a, d, permute=True).sum().backward()
    ops.acdc_fused_op(x, a[0], d[0]).sum().backward()
    want = {"acdc_cascade": ("cascade", 2, True),
            "acdc_cascade_bwd": ("cascade_bwd", 2, True),
            "acdc_fused": ("fwd", 1, False), "acdc_bwd": ("bwd", 1, False)}
    for name, (direction, k, permute) in want.items():
        assert seen[name] == autotune.autotuned_plan(
            direction, 15, 256, k, device="cpu", permute=permute), name
        # a CPU call: the cost model's plan at the bucket (16 rows)
        assert seen[name].clusters == -(-15 // seen[name].bm)


def test_sweep_launches_no_counting_wrapper(monkeypatch, fresh):
    """The sweep's runner launches ``launch_cascade`` / ``launch_bwd`` /
    ``paged_attn.launch`` with an explicit plan (faked here by the plain
    versions on the CPU, so the sample operands are checked too), never
    the wrappers: no ``launches`` count moves."""
    used = []

    def cascade(x, a, d, b, c, ct, ct_mid, relu, p):
        used.append(("launch_cascade", p))
        return ref.acdc_cascade_ref(x, a, d, b, c, ct, ct_mid, relu)

    def bwd(x, g, a, d, b, c, ct, ct_mid, relu, p, *, with_db=None):
        used.append(("launch_bwd", p))
        dx, da, dd, db = ref.acdc_cascade_bwd_ref(x, g, a, d, b, c, ct,
                                                  ct_mid, relu)
        return dx, da, dd, (db if with_db else None)

    def paged(q, kn, vn, kp, vp, tables, pos, window, softcap, p):
        used.append(("paged_attn.launch", p))
        return ref.paged_attention_ref(q, kn, vn, kp, vp, tables, pos,
                                       window, softcap)

    monkeypatch.setattr(tcascade, "launch_cascade", cascade)
    monkeypatch.setattr(tcbwd, "launch_bwd", bwd)
    monkeypatch.setattr(tpa, "launch", paged)
    monkeypatch.setattr(autotune, "_schedulable", lambda *a: True)
    monkeypatch.setattr(autotune, "_device_timer", lambda run: 1.0)
    _fake_card(monkeypatch)
    mods = (tcascade, tcbwd, tfused, tbwd, tpa)
    counts = [m.launches for m in mods]
    small = [("fwd", (4, 128, 1), False), ("bwd", (8, 128, 1), False),
             ("cascade", (4, 128, 2), True),
             ("cascade_bwd", (8, 128, 2), True),
             ("paged_attn", (2, 2, 3, 4, 2, 2, 16, 4), False)]
    for direction, dims, permute in small:
        _request(direction, dims, permute)
    assert [m.launches for m in mods] == counts
    names = {name for name, _ in used}
    assert names == {"launch_cascade", "launch_bwd", "paged_attn.launch"}
    assert len(autotune.SWEEPS) == len(small)
    # one run a candidate and the cost model's reference run; a paged run
    # launches two ticks (full and half-full tables)
    assert sum((r.candidates + 1) * (2 if r.key[0] == "paged_attn" else 1)
               for r in autotune.SWEEPS) == len(used)
