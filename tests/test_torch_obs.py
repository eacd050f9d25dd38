"""Port parity, observability: ``repro_torch.obs`` against the live
``repro.obs``, and the port's engine against ``repro.serving.Engine``
with observability on.

* the metric primitives: the same operations on a port and a reference
  ``Registry`` give equal ``snapshot()`` JSON (``sort_keys``) and equal
  ``to_prometheus()`` text, covering labelled counters, histograms
  (percentiles, under/overflow, reset), derived gauges,
  ``merge_snapshots``, ``CounterDict``, ``StatsView`` and the JSON-lines
  exporter;
* the span tracer gives equal Chrome trace JSON;
* ``Prof`` and ``ProfileWindow`` on ``torch.profiler``: disabled is one
  shared ``nullcontext``, the window starts and stops at its ticks and
  writes its files, its digest leaves a session's primer out and counts
  the kernel launches whose device record the trace lost;
* the engine: obs off binds no tracer, exporter or tick hook, streams
  with obs on equal obs off, and a seeded chaos run over a ``FakeClock``
  (paged, a tight pool, corrupt ticks, denied pages, slow ticks, a
  deadline, two priorities), non-speculative and speculative, agrees
  EXACTLY with the reference: finish reasons, greedy streams, ``stats``,
  the registry snapshot, the Chrome trace and the allocator audit; so do
  the engineered ``timeout``,
  ``rejected`` and ``preempted_limit`` terminals.

The setup is test_torch_engine.py's: qwen3 smoke, ``with_sell(cfg,
"acdc", method="pallas")``, bridged weights, Pallas in interpret mode.
Every comparison is exact: host-side integers and ``FakeClock`` floats.
"""

import json

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import get_model as jget
from repro.obs import Observability as JObs
from repro.obs import metrics as jmetrics
from repro.obs import prof as jprof
from repro.obs import trace as jtrace
from repro.optim.optimizers import tree_paths
from repro.serving import Engine as JEngine
from repro.serving import FaultPlan as JFault
from repro.serving import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import get_model as tget
from repro_torch.obs import Observability as TObs
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import prof as tprof
from repro_torch.obs import trace as ttrace
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import FaultPlan as TFault
from repro_torch.serving import Request as TRequest

from _torch_threads import one_torch_thread  # noqa: F401


class FakeClock:
    """Deterministic virtual clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _js(obj) -> str:
    return json.dumps(obj, sort_keys=True)


# ---------------------------------------------------------------------------
# Metric primitives: one script, both modules.
# ---------------------------------------------------------------------------

def _counters(m, tmp_path):
    reg = m.Registry()
    c = reg.counter("c_total", "a counter", labels=("route",))
    c.labels(route="a").inc()
    c.labels(route="a").inc(2)
    c.labels(route="b").inc(0.5)
    g = reg.gauge("g", "a gauge")
    g.set(7)
    g.inc(-2)
    assert reg.counter("c_total", labels=("route",)) is c
    errs = []
    for bad in (lambda: reg.gauge("c_total"), lambda: reg.counter("c_total"),
                lambda: c.labels(wrong="a")):
        with pytest.raises(ValueError) as e:
            bad()
        errs.append(str(e.value))
    return reg, errs


def _histogram(m, tmp_path):
    reg = m.Registry()
    h = reg.histogram("lat_seconds", "latency")
    for v in np.random.RandomState(0).lognormal(-3.0, 1.0, 500):
        h.observe(float(v))
    small = reg.histogram("h", lo=1e-3, hi=1e0, labels=("k",))
    small.labels(k="x").observe(1e-9)       # underflow
    small.labels(k="x").observe(1e9)        # overflow
    small.labels(k="y").observe(0.01)
    out = [h.percentile(q) for q in (0.0, 1.0, 25.0, 50.0, 99.0, 100.0)]
    out += [h.bin_width(0.05), small.labels(k="x").bin_width(1e9),
            small.labels(k="x").percentile(100.0), h.count, h.sum]
    spare = reg.histogram("spare")
    spare.observe(2.0)
    spare.reset()
    out.append(spare.percentile(50.0))
    return reg, out


def _derived(m, tmp_path):
    reg = m.Registry()
    acc = reg.counter("accepted_total")
    drf = reg.counter("drafted_total")
    reg.derived_gauge("rate", lambda: acc.value / drf.value
                      if drf.value else 0.0)
    seen = [reg.snapshot()["gauges"]["rate"][""]]
    drf.inc(4)
    acc.inc(1)
    seen.append(reg.snapshot()["gauges"]["rate"][""])
    drf.inc(4)
    with pytest.raises(ValueError):
        reg.derived_gauge("accepted_total", lambda: 0.0)
    return reg, seen


def _merge(m, tmp_path):
    def build(scale):
        reg = m.Registry()
        reg.counter("c", labels=("k",)).labels(k="x").inc(2 * scale)
        reg.counter("only_" + str(scale)).inc(scale)
        reg.gauge("g").set(3 * scale)
        h = reg.histogram("h")
        for v in (0.01, 0.1 * scale, 0.1):
            h.observe(v)
        return reg

    reg = build(1)
    merged = m.merge_snapshots(reg.snapshot(), build(2).snapshot())
    other = m.Registry()
    other.histogram("h", lo=1e-2).observe(0.1)
    with pytest.raises(ValueError):
        m.merge_snapshots(reg.snapshot(), other.snapshot())
    return reg, merged


def _counterdict(m, tmp_path):
    reg = m.Registry()
    d = m.CounterDict(reg.counter("disp_total", labels=("route",)),
                      ("fused", "gather"))
    d["fused"] += 1
    d["fused"] += 1
    d["gather"] += 1
    with pytest.raises(KeyError):
        d["bogus"]
    return reg, [dict(d), list(d), d.items(), d.values(), "fused" in d,
                 "bogus" in d, len(d), repr(d), d == {"fused": 2,
                                                      "gather": 1}]


def _statsview(m, tmp_path):
    reg = m.Registry()
    view = m.StatsView()
    c = reg.counter("x_total")
    view.bind("x", lambda: int(c.value), c.set)
    view.bind("rate", lambda: 0.5)
    view["x"] += 3
    with pytest.raises(TypeError):
        view["rate"] = 1.0
    with pytest.raises(KeyError):
        view["missing"] = 1
    return reg, [dict(view), view.get("missing"), list(view), len(view),
                 repr(view)]


def _jsonl(m, tmp_path):
    reg = m.Registry()
    extra = m.Registry()
    extra.counter("kernel_total").inc(5)
    c = reg.counter("n")
    path = tmp_path / f"{m.__name__}.jsonl"
    exp = m.JsonlExporter(str(path), reg, every=10, clock=lambda: 42.0,
                          extra_snapshots=(extra.snapshot,))
    for tick in range(25):
        c.inc()
        exp.maybe_export(tick)
    exp.close(25)
    exp.close()                           # idempotent
    return reg, [path.read_text(), exp.exports]


@pytest.mark.parametrize("script", [_counters, _histogram, _derived, _merge,
                                    _counterdict, _statsview, _jsonl],
                         ids=lambda f: f.__name__.strip("_"))
def test_metrics_match_reference(script, tmp_path):
    jreg_, jout = script(jmetrics, tmp_path)
    treg_, tout = script(tmetrics, tmp_path)
    assert _js(treg_.snapshot()) == _js(jreg_.snapshot())
    assert treg_.to_prometheus() == jreg_.to_prometheus()
    if script is _jsonl:                   # file contents, not paths
        assert tout == jout
    else:
        assert _js(tout) == _js(jout)


# ---------------------------------------------------------------------------
# Tracer and profiler hooks.
# ---------------------------------------------------------------------------

def _trace_script(m):
    clk = FakeClock()
    tr = m.SpanTracer(clock=clk)
    tr.req_phase(7, "queued")
    clk.t = 1.0
    tr.req_phase(7, "prefill", slot=0, ctx_len=4)
    tr.instant("engine", "ladder", src="full", dst="shed")
    clk.t = 3.0
    tr.req_phase(7, "decode")
    tr.req_phase(8, "queued")
    clk.t = 5.0
    tr.req_instant(7, "preempt", slot=0)
    tr.req_terminal(7, "length", tokens=4)
    m.instant_global("allocator", "audit")       # no global tracer
    m.set_global_tracer(tr)
    try:
        m.instant_global("allocator", "audit", free=3)
    finally:
        m.set_global_tracer(None)
    return tr


def test_tracer_matches_reference(tmp_path):
    jt, tt = _trace_script(jtrace), _trace_script(ttrace)
    assert [s.name for s in tt.spans_for(7)] == ["queued", "prefill",
                                                 "decode"]
    assert len(tt.terminals_for(7)) == 1
    assert _js(tt.chrome_trace()) == _js(jt.chrome_trace())
    tt.write(str(tmp_path / "t.json"))
    jt.write(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


def test_prof_disabled_is_shared_nullcontext():
    p = tprof.Prof(enabled=False)
    assert p.annotate("decode") is p.annotate("prefill")
    with p.annotate("decode"):
        pass
    on = tprof.Prof(enabled=True)
    with on.annotate("decode"):
        pass
    for spec in ("3:9", "0:0"):
        assert tprof.parse_tick_window(spec) == \
            jprof.parse_tick_window(spec)
    for bad in ("9", "5:3", "-1:2", "a:b"):
        with pytest.raises(ValueError):
            tprof.parse_tick_window(bad)


def test_profile_window_ticks_and_files(tmp_path):
    """The window starts before tick A, stops before tick B + 1, counts
    its ticks and writes trace, table and digest; stop is idempotent."""
    w = tprof.ProfileWindow("2:4", str(tmp_path / "prof"), device="cpu")
    active = []
    for tick in range(8):
        w.on_tick(tick)
        active.append(w.active)
    assert active == [False, False, True, True, True, False, False, False]
    assert w.done and w.summary["steps"] == 3
    assert w.summary["kernels"] == 0          # no CUDA activity on a CPU
    w.stop()
    for name in ("trace.json", "key_averages.txt", "summary.json"):
        assert (tmp_path / "prof" / name).stat().st_size > 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    digest = tprof.summarize(trace, 3, 0.5)
    assert digest["host_s_per_step"] == 0.5 / 3
    # device intervals are unioned, not summed
    fake = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "cp", "ts": 30.0,
         "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 99.0}]}
    digest = tprof.summarize(fake, 2, 1e-4)
    assert digest["device_busy_s"] == pytest.approx(20e-6)
    assert digest["device_busy_share"] == pytest.approx(0.2)
    assert digest["kernels"] == 2 and digest["kernels_per_step"] == 1
    assert [row[0] for row in digest["top"]] == ["k1", "k2", "cp"]
    assert digest["launches_lost"] == digest["window_launches_lost"] == 0


def _launch(corr, ts, name="cudaLaunchKernel"):
    return [{"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
             "dur": 1.0, "args": {"correlation": corr}}]


def _kernel(corr, ts, name):
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": ts + 0.5,
             "dur": 2.0, "args": {"correlation": corr}}]


@pytest.mark.parametrize("lost", [0, 2, 3, 5])
def test_summarize_counts_primer_and_lost_launches(lost):
    """A primed window's digest leaves the primer's kernels out of every
    figure, and counts the launches whose device record the trace lost
    (a session loses its first ones): those beyond the primer's are the
    window's own."""
    primer, window = 3, 4
    spin = f"void at::cuda::{tprof.PRIMER_KERNEL}(long)"
    names = [spin] * primer + [f"k{i}" for i in range(window)]
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
               "dur": 99.0}]
    for corr, name in enumerate(names):
        ts = 10.0 * corr
        events += _launch(corr, ts, "cuLaunchKernelEx" if corr == 5 else
                          "cudaLaunchKernel")
        if corr >= lost:
            events += _kernel(corr, ts, name)
    digest = tprof.summarize({"traceEvents": events}, 2, 1e-3,
                             primer=primer)
    kept = window - max(lost - primer, 0)
    assert digest["kernels"] == kept
    assert digest["device_busy_s"] == pytest.approx(kept * 2e-6)
    assert spin not in [row[0] for row in digest["top"]]
    assert digest["primer_kernels"] == max(primer - lost, 0)
    assert digest["launches_lost"] == lost
    assert digest["window_launches_lost"] == max(lost - primer, 0)


# ---------------------------------------------------------------------------
# Engine integration against the reference.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jreg.with_sell(jreg.get_smoke_config("qwen3_1_7b"), "acdc",
                          method="pallas")
    tcfg = treg.with_sell(treg.get_smoke_config("qwen3_1_7b"), "acdc",
                          method="pallas")
    jm, tm = jget(jcfg), tget(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jcfg)
    flat = dict(zip(jax.tree.leaves(tree_paths(jp)),
                    (np.asarray(x) for x in jax.tree.leaves(jp))))
    return ((JEngine, JRequest, JFault, JObs, jtrace, jm, jcfg, jp),
            (TEngine, TRequest, TFault, TObs, ttrace, tm, tcfg,
             bridge.to_torch(flat, device="cpu")))


def _reqs(req_cls, vocab, n=4, seed=5, max_new=8, **kw):
    rs = np.random.RandomState(seed)
    return [req_cls(rid=i,
                    prompt=rs.randint(0, vocab,
                                      size=int(rs.randint(4, 12))).tolist(),
                    max_new_tokens=max_new, **kw)
            for i in range(n)]


def test_engine_off_is_structurally_noop(models):
    snaps = []
    for eng_cls, _, _, _, _, model, cfg, params in models:
        eng = eng_cls(model, cfg, params, n_slots=2, max_len=32,
                      max_prompt_len=16)
        assert eng._tracer is None
        assert eng._obs_tick is None
        assert not eng._prof.enabled
        assert not eng.obs.enabled
        eng.stats["tokens_out"] += 2
        snaps.append(eng.obs.registry.snapshot())
    assert snaps[1]["counters"]["serve_tokens_out_total"][""] == 2
    assert _js(snaps[1]) == _js(snaps[0])


def test_engine_streams_identical_with_obs_on(models):
    (_, jreq, _, _, _, jm, jcfg, jp), (eng_cls, req_cls, _, obs_cls,
                                       trace_mod, model, cfg, params) = models
    want = _reqs(jreq, jcfg.vocab_size)
    JEngine(jm, jcfg, jp, n_slots=2, max_len=32,
            max_prompt_len=16).run(want, max_ticks=400)
    runs = []
    for obs in (None, obs_cls(tracer=trace_mod.SpanTracer(),
                              prof=tprof.Prof(enabled=True))):
        reqs = _reqs(req_cls, cfg.vocab_size)
        eng_cls(model, cfg, params, n_slots=2, max_len=32,
                max_prompt_len=16, obs=obs).run(reqs, max_ticks=400)
        runs.append([r.generated for r in reqs])
    assert runs[0] == runs[1] == [list(map(int, r.generated)) for r in want]


def _chaos_run(side, spec_k=0):
    """The reference's seeded chaos run (tests/test_obs.py) with a
    deadline and two priorities, speculative with ``spec_k`` > 0;
    returns (requests, tracer, snapshot, stats, audit, injected)."""
    eng_cls, req_cls, fault_cls, obs_cls, trace_mod, model, cfg, params = \
        side
    clock = FakeClock()
    fault = fault_cls(seed=3, p_alloc_fail=0.08, p_spurious_stall=0.04,
                      nan_ticks=(5, 11), p_slow=0.05, slow_ticks=(6, 7, 8),
                      slow_extra_s=123.0)
    obs = obs_cls(tracer=trace_mod.SpanTracer())
    eng = eng_cls(model, cfg, params, n_slots=3, max_len=48,
                  max_prompt_len=24, paged=True, block_size=8, n_blocks=10,
                  clock=clock, fault=fault, obs=obs, spec_k=spec_k)
    reqs = _reqs(req_cls, cfg.vocab_size, n=6, seed=9, max_new=10)
    reqs[3].deadline_s = 0.2             # expires while queued
    reqs[4].max_preemptions = 0          # first preemption is terminal
    for i, r in enumerate(reqs):
        r.priority = i % 2
        eng.submit(r)
    for _ in range(300):
        if not eng.has_work:
            break
        eng.tick()
        clock.t += 0.05
    assert all(r.done for r in reqs)
    obs.close()
    return (reqs, obs.tracer, obs.registry.snapshot(), dict(eng.stats),
            eng.allocator.audit(), fault.injected)


def _assert_chaos_equal(models, spec_k):
    jreqs, jtr, jsnap, jstats, jaudit, jinj = _chaos_run(models[0], spec_k)
    treqs, ttr, tsnap, tstats, taudit, tinj = _chaos_run(models[1], spec_k)
    assert [r.finish_reason for r in treqs] == \
        [r.finish_reason for r in jreqs]
    assert [r.generated for r in treqs] == \
        [list(map(int, r.generated)) for r in jreqs]
    assert tstats == jstats
    assert tinj == jinj and tinj["nan"] >= 1
    assert tstats["corrupt_ticks"] >= 1 and tstats["requeued"] >= 1
    assert tstats["timeout"] >= 1 and tstats["degrade_down"] >= 1
    assert _js(tsnap) == _js(jsnap)
    assert _js(ttr.chrome_trace()) == _js(jtr.chrome_trace())
    assert taudit == jaudit
    for r in treqs:
        assert len(ttr.terminals_for(r.rid)) == 1
    names = {i.name for i in ttr.instants}
    assert {"fault:corrupt_logits", "fault:slow_tick"} <= names
    if spec_k:
        assert tstats["drafted"] > 0
        walked = [i.args["dst"] for i in ttr.instants if i.name == "ladder"]
        assert walked[0] == "spec_half", walked


def test_chaos_run_matches_reference_exactly(models):
    _assert_chaos_equal(models, 0)


def test_spec_chaos_run_matches_reference_exactly(models):
    """Speculative (``spec_k=3``, the default truncated draft): the ladder
    steps to ``spec_half`` first, and every verify window maps k + 1
    positions through the faulty allocator."""
    _assert_chaos_equal(models, 3)


def _terminals(side):
    """The reference's three engineered terminals (tests/test_obs.py):
    ``timeout``, ``rejected`` and ``preempted_limit``."""
    eng_cls, req_cls, _, obs_cls, trace_mod, model, cfg, params = side
    out = []
    clock = FakeClock()
    obs = obs_cls(tracer=trace_mod.SpanTracer())
    eng = eng_cls(model, cfg, params, n_slots=1, max_len=32,
                  max_prompt_len=16, clock=clock, obs=obs)
    hog = req_cls(rid=0, prompt=[1, 2, 3], max_new_tokens=12)
    slo = req_cls(rid=1, prompt=[4, 5, 6], max_new_tokens=4,
                  deadline_s=0.5)
    eng.submit(hog)
    eng.tick()
    eng.submit(slo)
    clock.t = 2.0
    eng.tick()
    assert slo.finish_reason == "timeout"
    assert obs.tracer.spans_for(1)[-1].t1 == 2.0
    out.append(obs.tracer.chrome_trace())

    obs = obs_cls(tracer=trace_mod.SpanTracer())
    eng = eng_cls(model, cfg, params, n_slots=1, max_len=32,
                  max_prompt_len=16, queue_bound=1, obs=obs,
                  clock=FakeClock())
    eng._set_level(len(eng._levels) - 1)           # force "shed"
    victims = _reqs(req_cls, cfg.vocab_size, n=3, seed=11, max_new=2)
    for r in victims:
        eng.submit(r)
    assert any(r.finish_reason == "rejected" for r in victims)
    out += [obs.tracer.chrome_trace(), [r.finish_reason for r in victims]]

    obs = obs_cls(tracer=trace_mod.SpanTracer())
    eng = eng_cls(model, cfg, params, n_slots=1, max_len=64,
                  max_prompt_len=8, paged=True, block_size=4, n_blocks=3,
                  obs=obs, clock=FakeClock())
    doomed = req_cls(rid=0, prompt=[1] * 6, max_new_tokens=30,
                     max_preemptions=0)
    eng.run([doomed], max_ticks=100)
    assert doomed.finish_reason == "preempted_limit"
    out += [obs.tracer.chrome_trace(), obs.registry.snapshot(),
            list(map(int, doomed.generated))]
    return out


def test_engineered_terminals_match_reference(models):
    assert _js(_terminals(models[1])) == _js(_terminals(models[0]))


def test_engine_profile_window_on_cpu(models, tmp_path):
    """A ``ProfileWindow`` over engine ticks 1..2 (device adopted from the
    engine): two ticks captured, the ``decode`` range in the table."""
    _, (eng_cls, req_cls, _, obs_cls, _, model, cfg, params) = models
    window = tprof.ProfileWindow("1:2", str(tmp_path / "p"))
    obs = obs_cls(window=window, prof=tprof.Prof(enabled=True))
    eng = eng_cls(model, cfg, params, n_slots=2, max_len=32,
                  max_prompt_len=16, obs=obs)
    assert window.device == eng.device
    eng.run(_reqs(req_cls, cfg.vocab_size, n=2, max_new=6), max_ticks=100)
    obs.close()
    assert window.summary["steps"] == 2
    assert "decode" in (tmp_path / "p" / "key_averages.txt").read_text()


# ---------------------------------------------------------------------------
# Launchers.
# ---------------------------------------------------------------------------

def test_serve_launcher_overload_and_obs_flags(tmp_path):
    """The serve launcher's reference flags at smoke width on the CPU:
    deadlines and priorities reach the requests, the JSON-lines file's
    last snapshot equals ``stats`` (with the process-global kernel
    counters merged in), the trace has one terminal a request and the
    profile window writes its files; ``--static`` serves too."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import STATS_METRICS

    argv = ["--smoke", "--sell", "acdc", "--device", "cpu", "--paged",
            "--block-size", "4", "--requests", "5", "--prompt-len", "12",
            "--gen", "6", "--deadline-s", "600", "--priorities", "2",
            "--wall-clock-limit-s", "300",
            "--metrics-jsonl", str(tmp_path / "m.jsonl"),
            "--metrics-every", "3", "--trace-out", str(tmp_path / "t.json"),
            "--profile-ticks", "2:3",
            "--profile-logdir", str(tmp_path / "prof")]
    eng, reqs = serve.main(argv)
    assert all(r.finish_reason == "length" for r in reqs)
    assert any(r.deadline_s == 600 for r in reqs)
    assert any(r.deadline_s is None for r in reqs)
    assert {r.priority for r in reqs} <= {0, 1}
    last = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    snap = last["metrics"]
    for key, (name, kind) in STATS_METRICS.items():
        sec = "gauges" if kind in ("gauge", "derived") else "counters"
        assert snap[sec][name][""] == eng.stats[key], key
    assert "kernel_paged_attn_dispatches_total" in snap["counters"]
    trace = json.loads((tmp_path / "t.json").read_text())
    terminals = [e for e in trace["traceEvents"]
                 if e["ph"] == "i" and e["name"].startswith("terminal:")]
    assert len(terminals) == len(reqs)
    assert eng.obs.window.summary["steps"] == 2
    assert (tmp_path / "prof" / "summary.json").exists()
    toks, _, _ = serve.main(["--smoke", "--sell", "acdc", "--device", "cpu",
                             "--static", "--prompt-len", "8", "--gen", "4"])
    assert tuple(toks.shape) == (4, 4)
    with pytest.raises(SystemExit):
        serve.parse_args(["--static", "--trace-out", "x.json"])


def test_train_launcher_metrics_jsonl(tmp_path):
    """``--metrics-jsonl`` on the train launcher: one snapshot a logged
    step plus the final one, holding the step loss, tokens/s, the step
    time histogram and every cascade's diagonal norms."""
    from repro_torch.launch import train

    path = tmp_path / "train.jsonl"
    _, hist = train.main(["--smoke", "--sell", "acdc", "--device", "cpu",
                          "--steps", "2", "--seq-len", "32",
                          "--global-batch", "2", "--log-every", "1",
                          "--ckpt-dir", str(tmp_path / "ck"),
                          "--metrics-jsonl", str(path)])
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert [r["tick"] for r in lines] == [0, 1, None]
    snap = lines[-1]["metrics"]
    assert snap["gauges"]["train_step_loss"][""] == hist[-1]["loss"]
    assert snap["gauges"]["train_tokens_per_s"][""] > 0
    assert sum(snap["histograms"]["train_step_seconds"][""]["counts"]) >= 2
    norms = snap["gauges"]["train_cascade_diag_norm"]
    assert any(k.startswith("param=a,cascade=") for k in norms)
    assert all(v > 0 for v in norms.values())
