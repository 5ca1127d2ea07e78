"""Metrics registry + incremental interval algebra (a copy of the JAX
package's ``obs/metrics.py``).

Two halves:

  * ``Counter`` / ``Gauge`` / ``Histogram`` behind a ``MetricsRegistry``
    -- lock-cheap process-local instruments.  Updates are single
    bytecode-level mutations under the GIL (``+=`` on a float, a list
    index increment), so the hot path takes no lock; ``snapshot()`` is
    the only reader and tolerates torn reads across *different*
    instruments (each individual value is consistent).  Histograms use
    fixed buckets chosen at construction -- observation is one bisect +
    one increment, and quantiles come from the cumulative counts
    (upper-bound estimates, exact enough for p50/p99 latency summaries).
  * ``IntervalUnion`` -- the incremental replacement for
    ``controller._merge_intervals``: intervals insert into a maintained
    sorted-disjoint list (bisect + splice of any overlapped run), with
    ``total`` updated in place and a ``version`` counter that keys the
    ``overlap()`` cache.  ``controller.stats`` polls used to re-merge
    the full history every access (quadratic for eval loops polling
    once per step); against a union the poll is O(1) when nothing
    changed and O(log n + k) per new interval.

``interval_overlap(a, b)`` on two unions matches
``controller._interval_overlap`` on the equivalent sorted lists
bit-for-bit -- the stats-migration tests assert exactly that.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# ------------------------------------------------------------- instruments --


class Counter:
    """Monotonically-increasing count (GIL-atomic ``+=`` hot path)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        self.value += amount


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float):
        self.value = value

    def add(self, amount: float):
        self.value += amount


#: default latency buckets (seconds): 1ms .. ~2min, x2 per bucket
DEFAULT_BUCKETS = tuple(0.001 * (2.0 ** i) for i in range(18))


class Histogram:
    """Fixed-bucket histogram: observe = bisect + one list increment.

    Buckets are upper bounds; observations above the last bound land in
    the overflow bucket.  Quantiles interpolate nothing -- they report
    the upper bound of the bucket the quantile falls in, which is the
    conservative estimate a latency summary wants."""

    __slots__ = ("name", "bounds", "counts", "count", "sum")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float):
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the ``q``-quantile (0 <= q <= 1)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Name -> instrument map.  Creation takes a lock (rare); updates on
    the returned instruments do not (hot path)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, *args)
        assert isinstance(m, cls), \
            f"metric '{name}' is a {type(m).__name__}, not a {cls.__name__}"
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets)

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict view of every instrument (JSON-ready)."""
        out: Dict[str, dict] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value}
            elif isinstance(m, Histogram):
                out[name] = {"type": "histogram", "count": m.count,
                             "sum": m.sum, "mean": m.mean,
                             "p50": m.quantile(0.5), "p99": m.quantile(0.99)}
        return out


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry (instrument names are shared across
    subsystems on purpose -- one namespace per process)."""
    return _registry


# --------------------------------------------------------- interval algebra --


class IntervalUnion:
    """Sorted-disjoint union of ``(start, end)`` intervals, maintained
    incrementally: ``add`` splices the new interval over any run of
    intervals it overlaps (O(log n + k) with k the overlapped run),
    keeping ``total`` exact without a re-merge.  ``version`` bumps on
    every change so overlap results can be cached against a pair of
    versions (``controller.stats`` does)."""

    __slots__ = ("_starts", "_ivs", "total", "version")

    def __init__(self, intervals: Optional[Sequence[Tuple[float, float]]]
                 = None):
        self._starts: List[float] = []       # parallel to _ivs, for bisect
        self._ivs: List[Tuple[float, float]] = []
        self.total = 0.0
        self.version = 0
        if intervals:
            self.extend(intervals)

    def add(self, start: float, end: float):
        if end < start:
            start, end = end, start
        ivs, starts = self._ivs, self._starts
        # leftmost existing interval that could touch [start, end]: the
        # one before the insertion point may still reach past ``start``
        i = bisect.bisect_left(starts, start)
        if i > 0 and ivs[i - 1][1] >= start:
            i -= 1
        j = i
        while j < len(ivs) and ivs[j][0] <= end:
            s, e = ivs[j]
            self.total -= e - s
            start = min(start, s)
            end = max(end, e)
            j += 1
        ivs[i:j] = [(start, end)]
        starts[i:j] = [start]
        self.total += end - start
        self.version += 1

    def extend(self, intervals):
        for s, e in intervals:
            self.add(s, e)

    def intervals(self) -> List[Tuple[float, float]]:
        return list(self._ivs)

    def __len__(self) -> int:
        return len(self._ivs)


def interval_overlap(a, b) -> float:
    """Total pairwise intersection of two ``IntervalUnion``s (or sorted
    disjoint lists) -- same semantics as the controller's merge-based
    ``_interval_overlap``."""
    if isinstance(a, IntervalUnion):
        a = a._ivs
    if isinstance(b, IntervalUnion):
        b = b._ivs
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot
