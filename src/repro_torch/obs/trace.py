"""Span tracer with cross-process propagation (a copy of the JAX
package's ``obs/trace.py``; the event format is the same, so one Chrome
trace viewer reads both).

Every claim about the pipeline -- publish overlap, trainer idle time,
generator/trainer overlap -- is a statement about *when things happened
on one timeline*.  This module is that timeline:

  * ``Tracer`` -- a per-process event sink: thread-local span stacks, a
    bounded ring buffer (``REPRO_TRACE_BUFFER`` events, oldest dropped),
    and monotonic timestamps relative to one **trace epoch**
    (``epoch()``: ``time.monotonic()`` captured at import).  The
    supervisor's event log and the controller's history rows timestamp
    against the same epoch via ``now()``, so "the kill at t=1.82s" means
    the same instant everywhere.
  * **zero-cost when off** -- with ``REPRO_TRACE`` unset and no explicit
    ``enable()``, the module-level ``span``/``instant``/``counter``
    helpers test one global and return a shared no-op; nothing
    allocates, nothing locks (tracing is host-side Python only; no
    kernel or model module imports it).
  * **cross-process hooks** -- ``drain``/``absorb`` and the flow
    events (``flow_start``/``flow_end``) are how a process-backed actor
    ships its buffered events back onto the parent's epoch: a child's
    events ride its call replies as ``("__trace__", events)`` frames,
    shifted by the clock offset its transport measured at spawn
    (``core/actors.py``).  In-process actors' events land in this
    tracer directly.
  * ``to_chrome``/``export`` -- Chrome trace-event / Perfetto JSON: one
    pid row per actor process, one tid row per thread, complete ("X")
    spans, instant ("i") events and flow ("s"/"f") arrows, with the
    trace epoch and run metadata in the top-level ``metadata`` dict.

Event tuples are ``(proc, tid, ph, name, cat, ts, dur, args)`` with
``ts``/``dur`` in epoch-relative seconds -- compact enough to ride the
wire, lossless enough to export.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

ENV_FLAG = "REPRO_TRACE"
ENV_BUFFER = "REPRO_TRACE_BUFFER"
DEFAULT_BUFFER = 1 << 18

#: the process-wide trace epoch: every timestamp this module (and the
#: supervisor/controller bookkeeping built on it) records is
#: ``time.monotonic() - _EPOCH``
_EPOCH = time.monotonic()

_FLOW_IDS = itertools.count(1)

Event = Tuple[str, str, str, str, str, float, float, Optional[dict]]


def epoch() -> float:
    """The raw ``time.monotonic()`` value timestamps are relative to
    (exported in run metadata so offline tools can align other logs)."""
    return _EPOCH


def now() -> float:
    """Seconds since the trace epoch -- the one clock base shared by
    trace events, supervisor events and controller history rows."""
    return time.monotonic() - _EPOCH


class _NoopSpan:
    """Shared do-nothing span: what ``span()`` returns while tracing is
    disabled.  One instance, no per-call allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    def set(self, **kwargs):
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    """A live span: records one complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def set(self, **kwargs) -> "_Span":
        """Attach/overwrite args while the span is open (e.g. byte
        counts known only after serialization)."""
        if self.args is None:
            self.args = kwargs
        else:
            self.args.update(kwargs)
        return self

    def __enter__(self):
        self._t0 = now()
        self._tracer._stack().append(self.name)
        return self

    def __exit__(self, et, ev, tb):
        stack = self._tracer._stack()
        if stack:
            stack.pop()
        if et is not None:
            self.set(error=et.__name__)
        self._tracer._add(self._tracer.proc,
                          threading.current_thread().name, "X", self.name,
                          self.cat, self._t0, now() - self._t0, self.args)
        return False


class Tracer:
    """Per-process bounded event sink (module docstring).

    Appends ride the GIL-atomic ``deque.append`` -- no lock on the hot
    path; ``maxlen`` drops the oldest event when full (``dropped``
    counts them, approximately: the counter itself is unlocked)."""

    def __init__(self, proc: str, capacity: int = 0):
        self.proc = proc
        cap = capacity or int(os.environ.get(ENV_BUFFER, DEFAULT_BUFFER))
        self._buf: collections.deque = collections.deque(maxlen=cap)
        self._local = threading.local()
        self.dropped = 0

    # ------------------------------------------------------------ recording --

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_span(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1] if stack else None

    def _add(self, proc, tid, ph, name, cat, ts, dur, args):
        buf = self._buf
        if len(buf) == buf.maxlen:
            self.dropped += 1
        buf.append((proc, tid, ph, name, cat, ts, dur, args))

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "", **args):
        self._add(self.proc, threading.current_thread().name, "i", name,
                  cat, now(), 0.0, args or None)

    def counter(self, name: str, value: float, cat: str = ""):
        self._add(self.proc, threading.current_thread().name, "C", name,
                  cat, now(), 0.0, {"value": value})

    def complete(self, name: str, cat: str, t0: float, t1: float, **args):
        """Record an already-timed span (interval bookkeeping that is
        also the source of ``controller.stats``)."""
        self._add(self.proc, threading.current_thread().name, "X", name,
                  cat, t0, t1 - t0, args or None)

    # ---------------------------------------------------------- propagation --

    def flow_start(self, name: str = "rpc") -> str:
        """Open a cross-process flow arrow; the returned id is the span
        context that rides the RPC frame."""
        fid = f"{os.getpid()}.{next(_FLOW_IDS)}"
        self._add(self.proc, threading.current_thread().name, "s", name,
                  "flow", now(), 0.0, {"id": fid})
        return fid

    def flow_end(self, fid: str, name: str = "rpc"):
        """Bind the receiving side of a flow arrow (child-side, inside
        the serve span)."""
        self._add(self.proc, threading.current_thread().name, "f", name,
                  "flow", now(), 0.0, {"id": fid})

    def drain(self) -> List[Event]:
        """Pop every buffered event (child side: the batch a
        ``__trace__`` frame carries back to the parent)."""
        out: List[Event] = []
        buf = self._buf
        while True:
            try:
                out.append(buf.popleft())
            except IndexError:
                return out

    def absorb(self, events, offset: float = 0.0):
        """Merge drained child events onto this tracer's timeline;
        ``offset`` is the clock-sync correction (child ts + offset ==
        parent-epoch ts)."""
        for ev in events:
            proc, tid, ph, name, cat, ts, dur, args = ev
            self._add(proc, tid, ph, name, cat, ts + offset, dur, args)

    def events(self) -> List[Event]:
        """Snapshot without clearing (the parent-side export source)."""
        return list(self._buf)

    def clear(self):
        self._buf.clear()
        self.dropped = 0


# ------------------------------------------------------------ global state --

_tracer: Optional[Tracer] = None


def enable(proc: Optional[str] = None, *, capacity: int = 0) -> Tracer:
    """Install (or rename) the process-global tracer.  Idempotent: a
    second call keeps the buffer and only updates the process label."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(proc or f"proc-{os.getpid()}", capacity)
    elif proc:
        _tracer.proc = proc
    return _tracer


def disable() -> Optional[Tracer]:
    """Uninstall the global tracer (its events stay readable on the
    returned object); ``span()`` et al. go back to the no-op."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def tracer() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


def span(name: str, cat: str = "", **args):
    """A context-manager span on the global tracer; the shared no-op
    when tracing is disabled (one global load, zero allocation)."""
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "", **args):
    t = _tracer
    if t is not None:
        t.instant(name, cat, **args)


def counter(name: str, value: float, cat: str = ""):
    t = _tracer
    if t is not None:
        t.counter(name, value, cat)


def complete(name: str, cat: str, t0: float, t1: float, **args):
    t = _tracer
    if t is not None:
        t.complete(name, cat, t0, t1, **args)


def flow_start(name: str = "rpc") -> Optional[str]:
    t = _tracer
    return t.flow_start(name) if t is not None else None


def flow_end(fid: Optional[str], name: str = "rpc"):
    t = _tracer
    if t is not None and fid is not None:
        t.flow_end(fid, name)


def absorb(events, offset: float = 0.0):
    t = _tracer
    if t is not None and events:
        t.absorb(events, offset)


if os.environ.get(ENV_FLAG):
    enable()


# ----------------------------------------------------------------- export --

def to_chrome(events, *, metadata: Optional[dict] = None) -> dict:
    """Chrome trace-event JSON (the dict; caller serializes): one pid
    per distinct process label, one tid per thread within it, with
    ``process_name``/``thread_name`` metadata rows so Perfetto labels
    them.  Timestamps convert to microseconds."""
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[str, str], int] = {}
    out: List[dict] = []
    for proc, tid, ph, name, cat, ts, dur, args in events:
        pid = pids.get(proc)
        if pid is None:
            pid = pids[proc] = len(pids) + 1
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": proc}})
        tkey = (proc, tid)
        t = tids.get(tkey)
        if t is None:
            t = tids[tkey] = sum(1 for k in tids if k[0] == proc) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": t, "args": {"name": tid}})
        ev: Dict[str, Any] = {"name": name, "ph": ph, "pid": pid, "tid": t,
                              "ts": ts * 1e6}
        if cat:
            ev["cat"] = cat
        if ph == "X":
            ev["dur"] = max(0.0, dur) * 1e6
        elif ph == "i":
            ev["s"] = "t"
        elif ph in ("s", "f"):
            ev["id"] = (args or {}).get("id", "0")
            if ph == "f":
                ev["bp"] = "e"
            args = None
        if args:
            ev["args"] = args
        out.append(ev)
    doc: Dict[str, Any] = {"traceEvents": out, "displayTimeUnit": "ms"}
    meta = dict(metadata or {})
    meta.setdefault("trace_epoch_monotonic", _EPOCH)
    doc["metadata"] = meta
    return doc


def export(path: str, *, metadata: Optional[dict] = None,
           events=None) -> dict:
    """Write the global tracer's events (or ``events``) as Chrome-trace
    JSON to ``path``; returns the document."""
    if events is None:
        t = _tracer
        events = t.events() if t is not None else []
    doc = to_chrome(events, metadata=metadata)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome(doc) -> List[str]:
    """Schema check against the Chrome trace-event format (the subset
    ``to_chrome`` emits); returns human-readable problems, [] if valid.
    ``chip_smoke.py`` gates its exported trace on this."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["'traceEvents' must be a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in "BEXiICsStfM":
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"{where}: missing integer {key}")
        if ph == "M":
            if not isinstance(ev.get("args", {}).get("name"), str):
                problems.append(f"{where}: metadata without args.name")
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"{where}: missing ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: 'X' event needs dur >= 0")
        if ph in ("s", "t", "f") and "id" not in ev:
            problems.append(f"{where}: flow event without id")
    return problems
