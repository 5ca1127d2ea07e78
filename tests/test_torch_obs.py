"""The port's tracing and metrics layer (``repro_torch.obs``) against the
JAX package's ``repro.obs``: the same spans give the same Chrome events,
the metrics and interval algebra give the same numbers on seeded inputs,
the controller's ``_RunStats`` aggregates the same feeds to the same
dict, and the port's export is a valid Chrome trace for both packages'
validators and summaries.  After ``tests/test_obs.py``'s in-process
cases."""
import random
import threading
import time

import numpy as np
import pytest

from repro.core.controller import _RunStats as JRunStats
from repro.core.controller import _interval_overlap as j_interval_overlap
from repro.core.controller import _merge_intervals as j_merge_intervals
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.obs.__main__ import events_from_chrome as j_events_from_chrome
from repro.obs.__main__ import summarize as j_summarize
from repro_torch.core.controller import _RunStats, _merge_intervals
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.obs.__main__ import events_from_chrome, summarize, \
    summary_lines


@pytest.fixture
def traced():
    """A fresh global port tracer for the test, uninstalled afterwards so
    the rest of the suite keeps the zero-cost disabled path."""
    prior = ttrace.disable()
    t = ttrace.enable("controller")
    try:
        yield t
    finally:
        ttrace.disable()
        if prior is not None:
            ttrace.enable(prior.proc)


def _script(tr):
    """One sequence of nested spans, instants, a counter, a complete
    event and a flow, on two threads."""
    with tr.span("outer", "controller", batch=0):
        tr.instant("tick", "engine", rows=3)
        with tr.span("inner", "genpool", worker="generator0"):
            tr.counter("depth", 2.0, "controller")
    tr.complete("batch", "controller", 0.5, 0.75, batch=1)
    fid = tr.flow_start()
    tr.flow_end(fid)

    def worker():
        with tr.span("publish:generator0", "fabric", version=1):
            pass
    t = threading.Thread(target=worker, name="weight-fabric")
    t.start()
    t.join()


def _shape(doc):
    """A Chrome document without its timestamps and flow ids."""
    out = []
    for ev in doc["traceEvents"]:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur", "id")}
        out.append(ev)
    return out


# ----------------------------------------------------------- tracer core --

def test_same_spans_give_the_same_chrome_events():
    tt = ttrace.Tracer("controller")
    jt = jtrace.Tracer("controller")
    _script(tt)
    _script(jt)
    tdoc, jdoc = ttrace.to_chrome(tt.events()), jtrace.to_chrome(jt.events())
    assert _shape(tdoc) == _shape(jdoc)
    names = [(e["name"], e["ph"]) for e in tdoc["traceEvents"]]
    assert ("inner", "X") in names and ("outer", "X") in names
    # nesting: inner's window sits inside outer's, exit order inner first
    ev = {e[3]: e for e in tt.events() if e[2] == "X"}
    assert [e[3] for e in tt.events() if e[2] == "X"][:2] == \
        ["inner", "outer"]
    inner, outer = ev["inner"], ev["outer"]
    assert outer[5] <= inner[5] and \
        inner[5] + inner[6] <= outer[5] + outer[6] + 1e-9
    assert inner[1] == outer[1] == threading.current_thread().name
    assert ev["publish:generator0"][1] == "weight-fabric"


def test_disabled_tracer_is_shared_noop():
    prior = ttrace.disable()
    try:
        assert not ttrace.enabled()
        assert ttrace.span("x", "cat", a=1) is ttrace.NOOP_SPAN
        assert ttrace.span("y") is ttrace.span("z")
        ttrace.instant("nothing")
        ttrace.complete("nothing", "c", 0.0, 1.0)
        assert ttrace.flow_start() is None
        ttrace.flow_end(None)
        with ttrace.span("x") as sp:
            assert sp.set(a=1) is sp
        assert ttrace.tracer() is None
    finally:
        if prior is not None:
            ttrace.enable(prior.proc)


def test_span_error_annotation_and_ring_buffer(traced):
    with pytest.raises(ValueError):
        with traced.span("boom", "t"):
            raise ValueError("x")
    assert traced.events()[-1][7]["error"] == "ValueError"
    small = ttrace.Tracer("tiny", capacity=4)
    for i in range(7):
        small.instant(f"e{i}")
    assert len(small.events()) == 4 and small.dropped == 3
    assert [e[3] for e in small.events()] == ["e3", "e4", "e5", "e6"]
    drained = small.drain()
    assert len(drained) == 4 and small.events() == []
    other = ttrace.Tracer("parent")
    other.absorb(drained, offset=1.5)
    assert [e[5] for e in other.events()] == [e[5] + 1.5 for e in drained]


def test_port_export_is_valid_for_both_packages(traced, tmp_path):
    _script(traced)
    path = tmp_path / "t.json"
    doc = ttrace.export(str(path), metadata={"run": "test"})
    assert ttrace.validate_chrome(doc) == []
    assert jtrace.validate_chrome(doc) == []
    assert doc["metadata"]["trace_epoch_monotonic"] == ttrace.epoch()
    back = events_from_chrome(doc)
    assert back == j_events_from_chrome(doc)
    for orig, rt in zip(traced.events(), back):
        assert orig[:5] == rt[:5]
        assert rt[5] == pytest.approx(orig[5], abs=2e-6)
    assert summarize(back) == j_summarize(back)
    assert summarize(back)["phases"]["controller/outer"]["count"] == 1
    assert any("phase controller/batch" in ln for ln in summary_lines(back))
    bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1,
                            "ts": 0.0, "dur": -1.0}]}
    assert ttrace.validate_chrome(bad) == jtrace.validate_chrome(bad) != []


# -------------------------------------------------------------- metrics --

def test_histogram_quantiles_equal_jax():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(-4.0, 2.0, 500)
    th, jh = tmetrics.Histogram("lat"), jmetrics.Histogram("lat")
    for v in vals:
        th.observe(float(v))
        jh.observe(float(v))
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert th.counts == jh.counts and th.sum == jh.sum
    assert th.mean == jh.mean
    small = tmetrics.Histogram("lat", buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.002, 0.003, 0.05, 2.5):
        small.observe(v)
    assert small.quantile(0.5) == 0.01 and small.quantile(0.99) == 1.0
    assert tmetrics.Histogram("empty").quantile(0.5) == 0.0


def test_registry_instruments_and_snapshot():
    reg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("c").inc()
        r.counter("c").inc(2.0)
        r.gauge("g").set(7.0)
        r.histogram("h").observe(0.5)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()["c"] == {"type": "counter", "value": 3.0}
    with pytest.raises(AssertionError):
        reg.gauge("c")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_union_and_overlap_equal_jax(seed):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 50, 200)
    raw = [(float(s), float(s + d)) for s, d in
           zip(starts, rng.uniform(0, 5, 200))]
    tu, ju = tmetrics.IntervalUnion(), jmetrics.IntervalUnion()
    for s, e in raw:
        tu.add(s, e)
        ju.add(s, e)
    assert tu.intervals() == ju.intervals() == j_merge_intervals(raw)
    assert _merge_intervals(raw) == j_merge_intervals(raw)
    assert tu.total == ju.total and tu.version == ju.version
    other = [(i * 3.0, i * 3.0 + 2.0) for i in range(40)]
    to, jo = tmetrics.IntervalUnion(other), jmetrics.IntervalUnion(other)
    assert tmetrics.interval_overlap(tu, to) == \
        jmetrics.interval_overlap(ju, jo) == \
        j_interval_overlap(ju.intervals(), other)


# ---------------------------------------------------- controller stats --

class _Feeds:
    """The four interval and wait feeds a threaded run appends to."""

    def __init__(self):
        self.history = []
        self._fabric = type("F", (), {"intervals": []})()
        self.pool = type("P", (), {"intervals": []})()
        self.train_iv = []
        self.publish_wait = []


def test_runstats_equal_jax():
    """The same feeds, polled at the same points, give the same stats in
    both packages, key for key."""
    rng = random.Random(42)
    feeds = _Feeds()
    feeds._fabric.intervals = [(0.0, 1.0)]          # before the run
    feeds.history = [{"gen_idle_s": 99.0, "train_idle_s": 99.0}]
    wall0 = time.monotonic()
    srcs = [cls(feeds, feeds.pool, feeds.train_iv, feeds.publish_wait,
                first=1, wall0=wall0, pub0=1)
            for cls in (_RunStats, JRunStats)]
    t = 10.0
    for step in range(30):
        for _ in range(2):                           # two workers
            a = t + rng.uniform(0, 0.5)
            feeds.pool.intervals.append((a, a + rng.uniform(0.1, 1.0)))
        feeds.train_iv.append((t + 1.0, t + 1.0 + rng.uniform(0.1, 0.4)))
        feeds._fabric.intervals.append((t + 1.5, t + 1.6))
        feeds.publish_wait.append(rng.uniform(0, 0.01))
        feeds.history.append({"gen_idle_s": rng.uniform(0, 0.2),
                              "train_idle_s": rng.uniform(0, 0.1)})
        t += 2.0
        if step % 7 == 0:
            live = [s.compute() for s in srcs]
            assert [k for k in live[0]] == [k for k in live[1]]
            assert {k: v for k, v in live[0].items() if k != "wall_s"} == \
                {k: v for k, v in live[1].items() if k != "wall_s"}
    for s in srcs:
        s.finish(wall=123.0)
    got, want = srcs[0].compute(), srcs[1].compute()
    assert got == want and list(got) == list(want)
    assert got["wall_s"] == 123.0 and got["overlap_s"] > 0
    assert srcs[0].compute() == got                  # cached
