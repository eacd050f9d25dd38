"""Typed, labeled metric registry: Counter / Gauge / Histogram (a copy of
:mod:`repro.obs.metrics`: same names, same snapshot format, so a port
snapshot and a reference snapshot compare as JSON).

Why a registry instead of the grab-bag the engine grew (a flat
``Engine.stats`` dict, module-level dispatch-counter globals in
``kernels/ops.py``, timings that existed only inside ``benchmarks/``):
every consumer the ROADMAP names next — a multi-replica front door
reading per-replica health/load, a trace-driven load harness reporting
TTFT *and* time-per-output-token percentiles, training diagnostics for
the paper's init/depth sensitivity — needs the same three primitives
with one snapshot/merge/export story.  This module is that story, and it
is dependency-light on purpose (stdlib + numpy only): the
serving host loop, the kernels' trace-time dispatch counters and the
training launcher can all register into it without import cycles.

Primitives
----------
* :class:`Counter` — monotonic float/int accumulator (``inc``).  For
  back-compat with code that wrote raw dict entries it also accepts
  ``set`` (the ``Engine.stats`` view assigns through it); semantics are
  still "only ever grows" for everything the engine does.
* :class:`Gauge` — last-written value (``set``/``inc``).
* :class:`Histogram` — FIXED log-spaced bins, precomputed at
  construction: the hot path does one ``searchsorted`` into a static
  edge array and one integer bump — it never allocates, never rebins.
  Percentiles come from the bins (linear interpolation inside the
  containing bin), so a percentile is exact to within one bin width —
  the contract the serving bench asserts against its raw-list
  percentiles.

Labels: a metric family created with ``labels=("route",)`` is a factory;
``family.labels(route="fused")`` returns (and memoizes) the child
holding the actual value.  A family created without label names IS its
single child.

Registry-level verbs
--------------------
* ``snapshot()`` — plain deterministic dict (sorted keys, JSON-ready).
* ``merge_snapshots(a, b)`` — counters and histogram bins add, gauges
  take the right-hand value: the multi-replica aggregation rule.
* ``to_prometheus()`` — Prometheus text exposition (histograms as
  cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).
* ``derived_gauge(name, fn)`` — computed at snapshot/read time, never
  stored: this is how ``acceptance_rate`` stays correct when a
  degradation to ``spec_off`` stops the drafted counter moving (the
  stale-last-value bug the flat dict had).

``REGISTRY`` is the process-global default: trace-time kernel dispatch
counters and autotune sweep events land there; engines own private
registries (one per replica) and exporters merge the two.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "CounterDict",
    "StatsView", "JsonlExporter", "REGISTRY", "merge_snapshots",
]


def _label_key(names: Tuple[str, ...], kv: Mapping[str, str]) -> Tuple:
    if set(kv) != set(names):
        raise ValueError(f"labels {sorted(kv)} != declared {sorted(names)}")
    return tuple(str(kv[n]) for n in names)


class _Family:
    """Shared labels machinery: a family with label names is a factory of
    children; without label names it is its own single child."""

    kind = "abstract"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._children: Dict[Tuple, "_Family"] = {}
        if not self.label_names:
            self._children[()] = self

    def labels(self, **kv) -> "_Family":
        key = _label_key(self.label_names, kv)
        child = self._children.get(key)
        if child is None:
            child = self._make_child()
            self._children[key] = child
        return child

    def _make_child(self):
        raise NotImplementedError

    def children(self):
        """(label_values_tuple, child) pairs, sorted for determinism."""
        return sorted(self._children.items())


class Counter(_Family):
    """Monotonic accumulator.  ``inc`` on the hot path; ``set`` exists
    only for the back-compat dict views (and stays monotonic in every
    engine code path, which only ever reads-modify-writes upward)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = ()):
        super().__init__(name, help, labels)
        self._value = 0.0

    def _make_child(self):
        return Counter(self.name)

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Family):
    """Last-written value (degradation level, pool occupancy, loss)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = ()):
        super().__init__(name, help, labels)
        self._value = 0.0

    def _make_child(self):
        return Gauge(self.name)

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    @property
    def value(self) -> float:
        return self._value


#: default histogram range: 10 microseconds .. 1000 seconds, 8 bins per
#: decade — wide enough for TTFT, TPOT and tick latencies at once, and
#: the relative bin width (r - 1 ~ 33%) bounds percentile error.
DEFAULT_LO = 1e-5
DEFAULT_HI = 1e3
DEFAULT_BINS_PER_DECADE = 8


class Histogram(_Family):
    """Fixed log-spaced-bin histogram.

    Edges are computed ONCE at construction (``lo * r**i`` up to ``hi``,
    ``r = 10**(1/bins_per_decade)``); ``observe`` is a searchsorted into
    that static array plus an integer bump — no allocation, no rebin, so
    it is safe on the serving tick path.  Values below ``lo`` land in the
    underflow bin, at or above ``hi`` in the overflow bin.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = (), lo: float = DEFAULT_LO,
                 hi: float = DEFAULT_HI,
                 bins_per_decade: int = DEFAULT_BINS_PER_DECADE):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.lo, self.hi = float(lo), float(hi)
        self.bins_per_decade = int(bins_per_decade)
        n = int(math.ceil(math.log10(hi / lo) * bins_per_decade))
        # interior edges lo .. hi inclusive; counts has underflow (index
        # 0) and overflow (index -1) buckets around the n interior bins
        self.edges = np.asarray(
            [lo * 10.0 ** (i / bins_per_decade) for i in range(n)] + [hi],
            np.float64)
        super().__init__(name, help, labels)
        self.counts = np.zeros(len(self.edges) + 1, np.int64)
        self._sum = 0.0

    def _make_child(self):
        return Histogram(self.name, lo=self.lo, hi=self.hi,
                         bins_per_decade=self.bins_per_decade)

    def observe(self, v: float) -> None:
        self.counts[int(np.searchsorted(self.edges, v, side="right"))] += 1
        self._sum += v

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """q-th percentile (0..100) from the bins, or None when empty.

        Linear interpolation inside the containing bin; the underflow
        bin reports ``lo`` and the overflow bin ``hi`` (the histogram
        cannot resolve beyond its range).  Error bound: one bin width at
        the reported value.
        """
        total = self.count
        if total == 0:
            return None
        rank = q / 100.0 * total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, max(rank, 1e-12), side="left"))
        if i == 0:
            return self.lo
        if i >= len(self.edges):
            return self.hi
        lo_edge = float(self.edges[i - 1])
        hi_edge = float(self.edges[i]) if i < len(self.edges) else self.hi
        prev = float(cum[i - 1])
        inside = float(self.counts[i])
        frac = (rank - prev) / inside if inside > 0 else 0.0
        return lo_edge + (hi_edge - lo_edge) * min(max(frac, 0.0), 1.0)

    def reset(self) -> None:
        """Zero the bins.  Not a Prometheus verb — this exists so benches
        can exclude their compile-warmup observations from the reported
        percentiles (the same reason they delta the stats counters)."""
        self.counts[:] = 0
        self._sum = 0.0

    def bin_width(self, v: float) -> float:
        """Width of the bin containing ``v`` — the percentile error
        bound the serving bench asserts against."""
        i = int(np.searchsorted(self.edges, v, side="right"))
        if i == 0:
            return float(self.edges[0])
        if i >= len(self.edges):
            return float("inf")
        return float(self.edges[i] - self.edges[i - 1])


class Registry:
    """Named metric families + derived gauges, with snapshot/merge/export.

    Registration is get-or-create and type-checked: asking for the same
    name with a different kind (or different label names) is an error,
    so two subsystems can safely share one registry.
    """

    def __init__(self):
        self._metrics: Dict[str, _Family] = {}
        self._derived: Dict[str, Callable[[], float]] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name: str, help: str, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.label_names}")
                return m
            m = cls(name, help, tuple(labels), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Tuple[str, ...] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Tuple[str, ...] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Tuple[str, ...] = (), lo: float = DEFAULT_LO,
                  hi: float = DEFAULT_HI,
                  bins_per_decade: int = DEFAULT_BINS_PER_DECADE
                  ) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels, lo=lo,
                                 hi=hi, bins_per_decade=bins_per_decade)

    def derived_gauge(self, name: str, fn: Callable[[], float],
                      help: str = "") -> Callable[[], float]:
        """A gauge COMPUTED at read/snapshot time — never stored, so it
        can never go stale (the ``acceptance_rate`` fix)."""
        if name in self._metrics:
            raise ValueError(f"metric {name!r} already registered")
        self._derived[name] = fn
        return fn

    def get(self, name: str) -> Optional[_Family]:
        return self._metrics.get(name)

    # -- snapshot / merge / exposition -----------------------------------

    def snapshot(self) -> dict:
        """Deterministic plain-dict state (sorted names, JSON-ready).

        Shape::

            {"counters":   {name: {label_str: value}},
             "gauges":     {name: {label_str: value}},
             "histograms": {name: {label_str: {"edges": [...],
                                               "counts": [...],
                                               "sum": float}}}}

        ``label_str`` is ``"a=x,b=y"`` (sorted by label name) or ``""``
        for unlabeled metrics.  Derived gauges are evaluated here.
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            fam = self._metrics[name]
            sec = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms"}[fam.kind]
            entry = {}
            for vals, child in fam.children():
                label_str = ",".join(
                    f"{n}={v}" for n, v in zip(fam.label_names, vals))
                if fam.kind == "histogram":
                    entry[label_str] = {
                        "edges": [float(e) for e in child.edges],
                        "counts": [int(c) for c in child.counts],
                        "sum": float(child.sum),
                    }
                else:
                    entry[label_str] = float(child.value)
            out[sec][name] = entry
        for name in sorted(self._derived):
            out["gauges"].setdefault(name, {})[""] = float(
                self._derived[name]())
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the current state."""
        lines = []
        snap = self.snapshot()
        helps = {n: m.help for n, m in self._metrics.items()}
        for sec, kind in (("counters", "counter"), ("gauges", "gauge")):
            for name in snap[sec]:
                if helps.get(name):
                    lines.append(f"# HELP {name} {helps[name]}")
                lines.append(f"# TYPE {name} {kind}")
                for label_str, v in snap[sec][name].items():
                    lbl = "{%s}" % _prom_labels(label_str) if label_str \
                        else ""
                    lines.append(f"{name}{lbl} {_prom_num(v)}")
        for name, entry in snap["histograms"].items():
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} histogram")
            for label_str, h in entry.items():
                base = _prom_labels(label_str)
                cum = 0
                for edge, c in zip(h["edges"], h["counts"]):
                    cum += c
                    le = f'le="{_prom_num(edge)}"'
                    lbl = f"{base},{le}" if base else le
                    lines.append(f"{name}_bucket{{{lbl}}} {cum}")
                cum += h["counts"][-1]
                le = 'le="+Inf"'
                lbl = f"{base},{le}" if base else le
                lines.append(f"{name}_bucket{{{lbl}}} {cum}")
                sfx = "{%s}" % base if base else ""
                lines.append(f"{name}_sum{sfx} {_prom_num(h['sum'])}")
                lines.append(f"{name}_count{sfx} {cum}")
        return "\n".join(lines) + "\n"


def _prom_labels(label_str: str) -> str:
    if not label_str:
        return ""
    return ",".join(f'{k}="{v}"'
                    for k, v in (p.split("=", 1)
                                 for p in label_str.split(",")))


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def merge_snapshots(a: dict, b: dict) -> dict:
    """Combine two :meth:`Registry.snapshot` dicts (multi-replica rule):
    counters and histogram bin counts/sums ADD; gauges take ``b``'s value
    (last writer wins — gauges are point-in-time observations).
    Histograms being merged must share their edge grid."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for sec in ("counters", "gauges"):
        for name in sorted(set(a[sec]) | set(b[sec])):
            ea, eb = a[sec].get(name, {}), b[sec].get(name, {})
            entry = {}
            for label in sorted(set(ea) | set(eb)):
                if sec == "counters":
                    entry[label] = ea.get(label, 0.0) + eb.get(label, 0.0)
                else:
                    entry[label] = eb[label] if label in eb else ea[label]
            out[sec][name] = entry
    for name in sorted(set(a["histograms"]) | set(b["histograms"])):
        ea = a["histograms"].get(name, {})
        eb = b["histograms"].get(name, {})
        entry = {}
        for label in sorted(set(ea) | set(eb)):
            if label in ea and label in eb:
                ha, hb = ea[label], eb[label]
                if ha["edges"] != hb["edges"]:
                    raise ValueError(
                        f"histogram {name!r} edge grids differ")
                entry[label] = {
                    "edges": list(ha["edges"]),
                    "counts": [x + y for x, y in zip(ha["counts"],
                                                     hb["counts"])],
                    "sum": ha["sum"] + hb["sum"],
                }
            else:
                src = ea.get(label) or eb[label]
                entry[label] = {"edges": list(src["edges"]),
                                "counts": list(src["counts"]),
                                "sum": src["sum"]}
        out["histograms"][name] = entry
    return out


class CounterDict:
    """Dict-shim over a labeled :class:`Counter` family.

    The kernel dispatch counters (``ops.CASCADE_BWD_DISPATCHES``,
    ``ops.PAGED_ATTN_DISPATCHES``) are read as module-level dicts; tests and benches read them with ``dict(...)`` copies, key
    iteration and ``[key]`` lookups, and ops.py bumps them with
    ``[key] += 1``.  This shim keeps that exact surface while the values
    live in registry counters — one implementation, two spellings.
    """

    def __init__(self, family: Counter, keys: Iterable[str]):
        if len(family.label_names) != 1:
            raise ValueError("CounterDict needs a single-label family")
        self._family = family
        self._label = family.label_names[0]
        self._keys = tuple(keys)
        for k in self._keys:          # register children eagerly so
            self._child(k)            # iteration order is stable

    def _child(self, key: str) -> Counter:
        if key not in self._keys:
            raise KeyError(key)
        return self._family.labels(**{self._label: key})

    def __getitem__(self, key: str) -> int:
        return int(self._child(key).value)

    def __setitem__(self, key: str, value) -> None:
        self._child(key).set(value)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __contains__(self, key):
        return key in self._keys

    def keys(self):
        return self._keys

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def values(self):
        return [self[k] for k in self._keys]

    def __repr__(self):
        return repr(dict(self.items()))

    def __eq__(self, other):
        return dict(self.items()) == other


class StatsView:
    """Back-compat dict facade over registry metrics.

    ``Engine.stats`` predates the registry as a flat mutable dict; every
    engine code path reads/writes it as ``stats[key] += 1`` and callers
    copy it with ``dict(eng.stats)``.  This view keeps that exact
    surface: each key is *bound* to a getter (metric read, or a derived
    computation) and optionally a setter (metric write).  Keys bound
    without a setter — derived gauges like ``acceptance_rate`` — are
    read-only; assigning to them raises, because a stored value is
    exactly the staleness bug the derived form fixes.
    """

    def __init__(self):
        self._getters: Dict[str, Callable[[], float]] = {}
        self._setters: Dict[str, Callable[[float], None]] = {}

    def bind(self, key: str, getter: Callable[[], float],
             setter: Optional[Callable[[float], None]] = None) -> None:
        self._getters[key] = getter
        if setter is not None:
            self._setters[key] = setter

    def __getitem__(self, key: str):
        return self._getters[key]()

    def __setitem__(self, key: str, value) -> None:
        setter = self._setters.get(key)
        if setter is None:
            if key not in self._getters:
                raise KeyError(key)
            raise TypeError(
                f"stats[{key!r}] is derived at read time and cannot be "
                f"assigned")
        setter(value)

    def __contains__(self, key) -> bool:
        return key in self._getters

    def __iter__(self):
        return iter(self._getters)

    def __len__(self) -> int:
        return len(self._getters)

    def keys(self):
        return self._getters.keys()

    def values(self):
        return [self[k] for k in self._getters]

    def items(self):
        return [(k, self[k]) for k in self._getters]

    def get(self, key, default=None):
        return self[key] if key in self._getters else default

    def __eq__(self, other):
        return dict(self.items()) == other

    def __repr__(self):
        return f"StatsView({dict(self.items())!r})"


class JsonlExporter:
    """Periodic JSON-lines snapshot export.

    One line per export: ``{"t": <clock>, "tick": <n>, "metrics":
    <snapshot>}``.  ``every`` is in ticks (the engine calls
    :meth:`maybe_export` once per tick); ``extra_snapshots`` is a list of
    callables merged in (the serve launcher passes the process-global
    ``REGISTRY.snapshot`` so kernel dispatch counters ride along with the
    engine's registry).  The file handle is line-buffered append; call
    :meth:`close` (or rely on the final export) when done.
    """

    def __init__(self, path: str, registry: Registry, every: int = 50,
                 clock: Optional[Callable[[], float]] = None,
                 extra_snapshots: Tuple[Callable[[], dict], ...] = ()):
        self.path = path
        self.registry = registry
        self.every = max(int(every), 1)
        self.clock = clock
        self.extra_snapshots = tuple(extra_snapshots)
        self.exports = 0
        self._fh = open(path, "a", buffering=1)

    def _snapshot(self) -> dict:
        snap = self.registry.snapshot()
        for fn in self.extra_snapshots:
            snap = merge_snapshots(snap, fn())
        return snap

    def export(self, tick: Optional[int] = None) -> None:
        rec = {"tick": tick, "metrics": self._snapshot()}
        if self.clock is not None:
            rec["t"] = self.clock()
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self.exports += 1

    def maybe_export(self, tick: int) -> None:
        if tick % self.every == 0:
            self.export(tick)

    def close(self, tick: Optional[int] = None) -> None:
        if self._fh.closed:
            return
        self.export(tick)
        self._fh.close()


#: process-global default registry: trace-time kernel dispatch counters,
#: autotune sweep events and straggler flags land here; per-engine
#: registries are separate and merged at export time.
REGISTRY = Registry()
