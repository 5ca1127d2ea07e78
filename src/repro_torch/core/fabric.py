"""Weight-sync fabric: overlapped DDMA-style weight publication (paper
Sec. 5.2, Table 4; the port of the JAX package's ``core/fabric.py``).

LlamaRL's DDMA moves trainer shards straight into generator shards on a
*side channel*, so weight synchronization costs the training loop almost
nothing: generation keeps running while the new version lands, and each
generator flips to it at its next legal boundary.  ``WeightFabric`` is
that data plane for the async controller:

  * the consumer thread calls ``publish(version, payloads)`` and returns
    at once -- the *publisher thread* then runs, per subscriber channel,
    the transfer toward the subscriber's device (``Transport.prepare``,
    deduped per distinct (port, comm type, target device)) and the
    channel send, overlapped with ongoing generation;
  * a subscriber behind a process transport (``proc``, ``shm``,
    ``socket``) owns versioned **slots**: ``stage_weights`` parks the snapshot actor-side without
    applying it, and the channel carries only a ``StagedWeights`` marker
    whose delivery at the worker's next staleness-legal drain is the
    ``commit_weights`` slot flip.  Slot depth is bounded
    (``max_staged``): the publisher blocks -- not the consumer -- when a
    subscriber falls behind, and the ``on_commit`` release wakes it;
  * in-process subscribers skip staging: their payload is the trainer's
    param tensors shared by reference (the trainer builds new tensors
    every step, so a version never changes after publication), so the
    fixed-staleness schedule stays bit for bit the sequential
    reference's.

Version *delivery order* is exactly publication order -- one publisher
thread, FIFO queue, per-version sends into the versioned channels -- so
overlap changes wall-clock, never the bounded-staleness schedule.

``intervals`` records publisher busy spans; the controller intersects
them with generator busy spans to report ``publish_overlap_s``.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.actors import ActorDied
from repro_torch.core.channels import StagedWeights
from repro_torch.core.offpolicy import Closed
from repro_torch.obs import trace as obs_trace

_log = logging.getLogger(__name__)

#: exception classes that indicate ONE subscriber's transport failed --
#: isolated per-channel so the shared publish loop keeps serving the
#: healthy peers -- as opposed to a systemic publisher error
_SUBSCRIBER_FAILURES = (ActorDied, TimeoutError, BrokenPipeError,
                        ConnectionError, OSError, EOFError)


class Detached(RuntimeError):
    """Recorded as a subscriber's failure when it was detached on
    purpose (supervised respawn in progress, or a pool shrink)."""


def payload_key(ch) -> Tuple[str, int]:
    """How publishers name a source port: (port name, outbound actor)."""
    return (ch.name, id(ch.outbound))


class WeightFabric:
    """Background weight publication over a set of weight channels.

    ``channels`` are the live per-generator weight channels the async
    controller already fans out to; ``overlap=False`` degrades to the
    old blocking fan-out on the caller's thread (the benchmark
    baseline)."""

    def __init__(self, channels, *, overlap: bool = True,
                 max_staged: int = 2, timeout: float = 600.0):
        self.channels = list(channels)
        self.overlap = overlap
        self.max_staged = max(1, int(max_staged))
        self.timeout = timeout
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._staged_out: Dict[int, int] = {}   # id(ch) -> uncommitted slots
        self._dead: Dict[int, BaseException] = {}  # id(ch) -> why detached
        self._latest: Optional[Tuple[int, Dict]] = None   # replay source
        self._busy_version: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._quiescing = False
        self._closed = False
        self._busy = False
        self._error: Optional[BaseException] = None
        #: publisher busy spans (t0, t1) and per-version wall seconds
        self.intervals: List[Tuple[float, float]] = []
        self.published: List[Tuple[int, float]] = []
        #: per-subscriber publish breakdown (see ``subscriber_stats``)
        self.sub_stats: Dict[str, Dict[str, float]] = {}
        #: hook: cb(ch, exc) fired (outside the fabric lock) when a
        #: subscriber's transport fails mid-publish and is detached
        self.on_subscriber_down = None
        #: optional FaultPlan fired per (subscriber, version) publication
        self.chaos = None

    # -------------------------------------------------------------- publish --

    def publish(self, version: int, payloads: Dict[Tuple[str, int], Any]):
        """Queue version ``version`` for delivery to every subscriber.

        ``payloads`` maps ``payload_key(ch)`` to the (already
        snapshotted) source-port value -- the caller snapshots
        synchronously so a later trainer step can never leak into this
        version.  Returns immediately when overlapping; raises any
        publisher-thread failure from a previous publish."""
        self.raise_if_failed()
        if not self.overlap:
            self._publish_now(version, payloads)
            return
        with self._cond:
            if self._closed:
                raise Closed("WeightFabric closed")
            self._queue.append((version, payloads))
            self._cond.notify_all()
            if self._thread is None:
                self._quiescing = False
                # daemon is the last-resort backstop only: every normal
                # path joins deterministically (run() flushes+quiesces,
                # shutdown() closes), but an abandoned fabric -- a test
                # failure mid-publish -- must not wedge interpreter exit
                self._thread = threading.Thread(
                    target=self._run, name="weight-fabric", daemon=True)
                self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed \
                        and not self._quiescing:
                    # timed wait inside the predicate loop: a lost/raced
                    # notify must not park the publisher forever
                    self._cond.wait(1.0)
                if not self._queue:          # closed or quiesced while idle
                    self._thread = None
                    self._cond.notify_all()
                    return
                version, payloads = self._queue.popleft()
                self._busy = True
            try:
                self._publish_now(version, payloads)
            except Closed:                   # controller shutdown, not error
                with self._cond:
                    self._closed = True
            except BaseException as e:       # surfaces on next publish/flush
                with self._cond:
                    self._error = e
            finally:
                with self._cond:
                    self._busy = False
                    if self._error is not None or self._closed:
                        self._queue.clear()
                        self._thread = None
                        self._cond.notify_all()
                        return
                    self._cond.notify_all()

    def _publish_now(self, version: int, payloads):
        t0 = time.monotonic()
        with self._cond:
            self._busy_version = version
        transferred: Dict[tuple, Any] = {}
        down: List[tuple] = []
        try:
            for ch in self.channels:
                with self._cond:
                    if id(ch) in self._dead:
                        continue             # detached: supervisor replays
                try:
                    self._publish_one(ch, version, payloads, transferred)
                except Closed:               # controller shutdown, systemic
                    raise
                except _SUBSCRIBER_FAILURES as e:
                    # ONE subscriber's transport failed: record it, free
                    # its slots, keep publishing to the healthy peers
                    self._mark_dead(ch, e)
                    down.append((ch, e))
        finally:
            t1 = time.monotonic()
            # the controller reads these while the publisher thread is
            # live (overlap accounting), so the appends take the lock
            with self._cond:
                self._busy_version = None
                self.intervals.append((t0, t1))
                self.published.append((version, t1 - t0))
                if self._latest is None or version >= self._latest[0]:
                    self._latest = (version, payloads)
                self._cond.notify_all()
            # the same busy interval, rebased onto the trace epoch
            obs_trace.complete("publish", "fabric",
                               t0 - obs_trace.epoch(),
                               t1 - obs_trace.epoch(), version=version)
        cb = self.on_subscriber_down
        if cb is not None:
            for ch, e in down:               # outside the fabric lock
                try:
                    cb(ch, e)
                except Exception as err:     # pragma: no cover - diagnostics
                    _log.debug("on_subscriber_down for '%s': %r",
                               ch.inbound.name, err)

    def _publish_one(self, ch, version, payloads, transferred):
        name = ch.inbound.name
        if self.chaos is not None:
            self.chaos.fire("publish", name, version)
        pkey = payload_key(ch)
        # one transfer per distinct (payload, comm type, target device),
        # fanned out to every same-target channel
        tkey = (pkey, ch.comm_type, ch.inbound.device)
        sp = obs_trace.span(f"publish:{name}", "fabric", version=version)
        with sp:
            t0 = time.monotonic()
            if tkey not in transferred:
                transferred[tkey] = ch._transfer(payloads[pkey])
            prepared = transferred[tkey]
            wait_s = 0.0
            if ch.inbound.staged_weights and ch.inbound.transport.remote:
                # data plane: ship the bytes now, overlapped with
                # generation; the channel later delivers only the commit
                # marker
                wait_s = self._wait_slot(ch)
                ch.inbound.cast("stage_weights", prepared, version)
                staged_at = obs_trace.now()
                with self._cond:
                    self._staged_out[id(ch)] = \
                        self._staged_out.get(id(ch), 0) + 1
                ch.send_transferred(
                    StagedWeights(version,
                                  on_commit=lambda c=ch, ts=staged_at:
                                  self._released(c, ts)),
                    version=version, timeout=self.timeout)
            else:
                ch.send_transferred(prepared, version=version,
                                    timeout=self.timeout)
            stage_s = time.monotonic() - t0 - wait_s
            sp.set(stage_s=stage_s, wait_s=wait_s)
        with self._cond:
            rec = self._sub_stat(name)
            rec["published"] += 1
            rec["stage_s"] += stage_s
            rec["wait_s"] += wait_s

    # ---------------------------------------------------------------- slots --

    def _wait_slot(self, ch) -> float:
        """Block the *publisher* until the subscriber has a free slot;
        returns the seconds spent waiting (per-subscriber backpressure,
        the quantity the pooled publish aggregates used to hide)."""
        t0 = time.monotonic()
        deadline = t0 + self.timeout
        with self._cond:
            while self._staged_out.get(id(ch), 0) >= self.max_staged:
                if self._closed:
                    raise Closed("WeightFabric closed")
                if id(ch) in self._dead:
                    raise ActorDied(
                        f"subscriber '{ch.inbound.name}' detached while "
                        f"the publisher waited for a slot")
                if not self._cond.wait(0.2):
                    if not ch.inbound.healthy():
                        # a corpse never commits: don't park the shared
                        # publisher on its held slots
                        raise ActorDied(
                            f"subscriber '{ch.inbound.name}' died holding "
                            f"{self.max_staged} staged weight slots")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"subscriber '{ch.inbound.name}' held "
                            f"{self.max_staged} staged weight slots for "
                            f"{self.timeout}s without committing")
        return time.monotonic() - t0

    def _released(self, ch, staged_at: Optional[float] = None):
        now = obs_trace.now()
        with self._cond:
            self._staged_out[id(ch)] = \
                max(0, self._staged_out.get(id(ch), 0) - 1)
            if staged_at is not None:
                self._sub_stat(ch.inbound.name)["commit_s"] += \
                    now - staged_at
            self._cond.notify_all()
        if staged_at is not None:
            # stage->commit as a span: the slot-flip latency is visible
            # per subscriber in the exported timeline
            obs_trace.complete(f"commit:{ch.inbound.name}", "fabric",
                               staged_at, now)

    def _sub_stat(self, name: str) -> Dict[str, float]:
        """Per-subscriber accumulator; callers hold ``self._cond``."""
        rec = self.sub_stats.get(name)
        if rec is None:
            rec = self.sub_stats[name] = {
                "published": 0, "stage_s": 0.0, "commit_s": 0.0,
                "wait_s": 0.0}
        return rec

    def subscriber_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-subscriber publish breakdown: versions ``published`` and
        cumulative ``stage_s`` (transfer + channel send), ``commit_s``
        (stage-to-commit slot-flip latency) and ``wait_s`` (publisher
        blocked on the subscriber's full slots) -- the per-channel view
        the pooled ``publish_s``/``publish_wait_s`` aggregates hide."""
        with self._cond:
            return {name: dict(rec)
                    for name, rec in self.sub_stats.items()}

    def staged_out(self, ch) -> int:
        with self._cond:
            return self._staged_out.get(id(ch), 0)

    # ---------------------------------------------------- subscriber set --

    def _mark_dead(self, ch, exc):
        with self._cond:
            self._dead.setdefault(id(ch), exc)
            self._staged_out.pop(id(ch), None)   # a corpse's slots are free
            self._cond.notify_all()

    def owns(self, ch) -> bool:
        return any(c is ch for c in self.channels)

    def detach(self, ch, error: Optional[BaseException] = None):
        """Stop publishing to ``ch`` (worker lost, pool shrink, or a
        respawn in progress); its held slots stop gating the publisher.
        Idempotent."""
        self._mark_dead(ch, error if error is not None
                        else Detached(f"'{ch.inbound.name}' detached"))

    def subscriber_error(self, ch) -> Optional[BaseException]:
        """Why ``ch`` is detached (None while it is being published to)."""
        with self._cond:
            return self._dead.get(id(ch))

    def dead_subscribers(self) -> List:
        with self._cond:
            return [ch for ch in self.channels if id(ch) in self._dead]

    def latest(self) -> Optional[Tuple[int, Dict]]:
        """The newest fully published (version, payloads) -- the replay
        source for re-admitted subscribers."""
        with self._cond:
            return self._latest

    def seed(self, version: int, payloads: Dict):
        """Record a baseline replay source (the controller's version-0
        init delivery happens outside the fabric)."""
        with self._cond:
            if self._latest is None or version >= self._latest[0]:
                self._latest = (version, payloads)

    def add_subscriber(self, ch):
        """Adopt a new channel mid-run (pool grow / hot spare): it joins
        detached, gets the latest version replayed, then enters the
        publish loop via ``reattach``."""
        with self._cond:
            if not self.owns(ch):
                self.channels.append(ch)
            self._dead.setdefault(id(ch), Detached("awaiting replay"))
        return self.reattach(ch)

    def reattach(self, ch, *, replay: bool = True) -> Optional[int]:
        """Re-admit a (respawned) subscriber.

        Replays the latest published version straight into the actor's
        staged/committed slots -- not through the channel queue, so the
        newcomer's ``weight_version`` is current before its worker
        re-checks admission -- then clears the detach record between
        publisher iterations, closing the race where a version published
        during the replay would be skipped.  Returns the replayed
        version (None when nothing was ever published/seeded)."""
        deadline = time.monotonic() + self.timeout
        delivered: Optional[int] = None
        while True:
            with self._cond:
                while self._busy_version is not None:
                    # wait out an in-flight publish so attach can't race
                    # the skip-dead check inside _publish_now
                    if not self._cond.wait(0.1) and \
                            time.monotonic() > deadline:
                        raise TimeoutError(
                            f"publisher busy; cannot reattach "
                            f"'{ch.inbound.name}'")
                latest = self._latest
                if not replay or latest is None or \
                        (delivered is not None and latest[0] <= delivered):
                    self._dead.pop(id(ch), None)
                    self._staged_out.pop(id(ch), None)
                    self._cond.notify_all()
                    return delivered
            version, payloads = latest
            self._replay_into(ch, version, payloads)
            delivered = version

    def _replay_into(self, ch, version, payloads):
        prepared = ch._transfer(payloads[payload_key(ch)])
        if ch.inbound.staged_weights and ch.inbound.transport.remote:
            # land it in the newcomer's slots the same way a live
            # publish would, but commit immediately: there is no
            # schedule to respect -- this version is already legal
            ch.inbound.cast("stage_weights", prepared, version)
            ch.inbound.cast("commit_weights", version)
        else:
            ch.inbound.cast("set_weights", prepared, version=version)

    # ------------------------------------------------------------ lifecycle --

    def pending(self) -> int:
        with self._cond:
            return len(self._queue) + (1 if self._busy else 0)

    def raise_if_failed(self):
        with self._cond:
            if self._error is not None:
                e, self._error = self._error, None
                raise e

    def flush(self, timeout: Optional[float] = None):
        """Wait until every queued publication has been delivered into
        its channels; re-raise a publisher failure."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.timeout)
        with self._cond:
            while (self._queue or self._busy) and self._error is None \
                    and not self._closed:
                if not self._cond.wait(0.2) and \
                        time.monotonic() > deadline:
                    raise TimeoutError(
                        f"weight fabric still publishing after "
                        f"{timeout if timeout is not None else self.timeout}"
                        f"s ({len(self._queue)} queued)")
        self.raise_if_failed()

    def quiesce(self, timeout: float = 10.0):
        """Stop the (idle) publisher thread between runs: the fabric
        stays usable -- the next ``publish`` restarts it -- but no
        thread outlives the controller's ``run()``."""
        with self._cond:
            self._quiescing = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)
        with self._cond:
            self._quiescing = False

    def close(self):
        """Unblock and stop the publisher (controller shutdown path).
        Queued publications are dropped; idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10.0)
