"""Supervision: survive dead actors -- respawn, replay, re-admit,
degrade (the port of the JAX package's ``core/supervise.py``).

LlamaRL targets clusters where worker death is a *when*, not an *if*;
the streaming frameworks it sits beside (AsyncFlow, Laminar) treat
rollout-worker failure isolation as a prerequisite for long-horizon
asynchronous post-training.  This module turns the repo's fail-fast
``ActorDied`` path into a recoverable event:

  * ``Supervisor`` watches every registered ``ActorHandle`` through the
    transports' existing liveness hooks (``on_death`` fires the moment a
    poll declares the peer gone) and owns the recovery protocol.  The
    thread that *uses* a handle drives recovery -- it is the one holding
    the failed RPC -- by calling ``recover(handle, error)``:

      1. **restart policy** -- capped exponential backoff and a
         max-restarts budget (``RestartPolicy``);
      2. **respawn** -- the handle rebuilds its transport from the
         ``SpawnSpec`` recorded at ``spawn_actor`` time (same factory,
         seed, transport, device spec, address), swapping it in place so
         every pool/channel/controller structure keyed on handle
         identity follows automatically;
      3. **replay** -- the ``WeightFabric``'s latest committed version
         is delivered straight into the newcomer's staged/committed
         slots (``fabric.reattach``), or the recorded version-0 seed
         params for non-fabric consumers (the frozen reference policy);
      4. **re-admission** -- the caller re-pins its in-flight
         ``RolloutJob``s (``repin_job``) under the replayed version; the
         bounded-staleness contract is asserted, not assumed.

  * When the budget is exhausted the actor is declared **lost** and the
    run *degrades*: the fabric detaches the dead subscriber, the pool's
    ``WorkAssignment`` remaps the dead worker's batch indices across the
    survivors, and the adaptive staleness controller re-tunes for the
    smaller pool.  Zero survivors falls back to fail-fast.

  * ``FaultPlan`` / ``REPRO_CHAOS`` is the deterministic fault-injection
    harness that makes all of this testable: kill actor X at batch N (or
    mid-chunk), drop a socket mid-publish, hang a child.  Faults fire at
    scripted schedule points (batch admission, chunk advance, fabric
    publish), not on wall-clock timers, so chaos tests are reproducible.

Spec grammar for ``REPRO_CHAOS`` (``;``-separated, each fires once)::

    kill:generator1@batch=2           SIGKILL before admitting batch 2
    kill:generator1@batch=3,chunk=1   SIGKILL mid-decode (before chunk 1)
    hang:generator0@batch=2:30        wedge the child 30s at batch 2
    drop:generator0@publish=3         cut the connection as version 3
                                      publishes
    kill:ref@consume=3                kill at the consumer's batch 3
"""
from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.actors import ActorDied, ActorHandle
from repro_torch.core.fabric import payload_key
from repro_torch.obs import trace as obs_trace

_log = logging.getLogger(__name__)

#: ``recover`` outcomes
RESPAWNED = "respawned"
LOST = "lost"


@dataclass(frozen=True)
class RestartPolicy:
    """Restart budget and capped exponential backoff, one for every
    supervised actor."""

    max_restarts: int = 3
    backoff_s: float = 0.05        # first-restart delay
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0     # cap
    hang_ping_s: float = 2.0       # responsiveness probe after a timeout

    def backoff(self, attempt: int) -> float:
        """Delay before restart number ``attempt`` (0-based)."""
        return min(self.backoff_max_s,
                   self.backoff_s * (self.backoff_factor ** attempt))


def _nbytes(tree) -> int:
    """The bytes of the tensors (or arrays) of a nested dict or list."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0))


# ------------------------------------------------------------------ chaos --

@dataclass
class Fault:
    """One scripted fault.  ``point`` is a schedule point ("batch",
    "publish", "consume"); ``index`` the batch/version at that point;
    ``chunk`` narrows a "batch" fault to a mid-decode chunk boundary
    (None = the admission boundary)."""

    action: str                    # "kill" | "hang" | "drop"
    actor: str
    point: str
    index: int
    chunk: Optional[int] = None
    arg: float = 30.0              # hang duration
    fired: bool = False


class FaultPlan:
    """Deterministic fault injection over named actors.

    Injection sites call ``fire(point, actor, index, chunk)`` at every
    schedule point; a fault matching all four coordinates executes once.
    Handles are ``bind``-ed by name (and re-bound after respawn, since
    the victim may be scripted to die twice)."""

    def __init__(self, faults=()):
        self.faults: List[Fault] = list(faults)
        self._handles: Dict[str, ActorHandle] = {}
        self._lock = threading.Lock()
        self.fired_log: List[Tuple[str, str, str, int, Optional[int]]] = []

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from the ``REPRO_CHAOS`` grammar (module doc)."""
        faults = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            action, _, rest = part.partition(":")
            actor, _, where = rest.partition("@")
            where, _, arg = where.partition(":")
            fields = dict(kv.split("=", 1) for kv in where.split(","))
            point = next(p for p in ("batch", "publish", "consume")
                         if p in fields)
            faults.append(Fault(
                action=action.strip(), actor=actor.strip(), point=point,
                index=int(fields[point]),
                chunk=int(fields["chunk"]) if "chunk" in fields else None,
                arg=float(arg) if arg else 30.0))
        return cls(faults)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        spec = os.environ.get("REPRO_CHAOS", "").strip()
        return cls.parse(spec) if spec else None

    def bind(self, handle: ActorHandle):
        with self._lock:
            self._handles[handle.name] = handle

    def fire(self, point: str, actor: str, index: int,
             chunk: Optional[int] = None) -> bool:
        """Execute the (single) matching un-fired fault, if any."""
        with self._lock:
            fault = next(
                (f for f in self.faults
                 if not f.fired and f.point == point and f.actor == actor
                 and f.index == index and f.chunk == chunk), None)
            if fault is None:
                return False
            fault.fired = True
            handle = self._handles.get(actor)
            self.fired_log.append(
                (fault.action, actor, point, index, chunk))
        if handle is None:
            raise RuntimeError(
                f"chaos fault names unbound actor {actor!r}")
        self._execute(fault, handle)
        return True

    def fire_any(self, point: str, index: int) -> bool:
        """Execute every un-fired fault at (point, index) regardless of
        which actor it names (consumer-side points, where one thread
        drives many actors)."""
        with self._lock:
            matches = [f for f in self.faults
                       if not f.fired and f.point == point
                       and f.index == index]
            for f in matches:
                f.fired = True
                self.fired_log.append(
                    (f.action, f.actor, point, index, f.chunk))
            pairs = [(f, self._handles.get(f.actor)) for f in matches]
        for fault, handle in pairs:
            if handle is None:
                raise RuntimeError(
                    f"chaos fault names unbound actor {fault.actor!r}")
            self._execute(fault, handle)
        return bool(pairs)

    def _execute(self, fault: Fault, handle: ActorHandle):
        t = handle.transport
        if fault.action == "kill":
            proc = getattr(t, "_proc", None)
            if proc is None:
                raise RuntimeError(
                    f"chaos kill needs a process-backed actor; "
                    f"'{handle.name}' rides {type(t).__name__}")
            proc.kill()                      # SIGKILL: no goodbye
            proc.join(10.0)
        elif fault.action == "drop":
            conn = getattr(t, "_conn", None) or getattr(t, "_sock", None)
            if conn is None:
                raise RuntimeError(
                    f"chaos drop needs a connection-backed actor; "
                    f"'{handle.name}' rides {type(t).__name__}")
            conn.close()                     # next send/recv fails fast
        elif fault.action == "hang":
            handle.cast("chaos_hang", fault.arg)
        else:
            raise ValueError(f"unknown chaos action {fault.action!r}")

    def unfired(self) -> List[Fault]:
        with self._lock:
            return [f for f in self.faults if not f.fired]


# ------------------------------------------------------------- supervisor --

@dataclass
class _Member:
    """Supervision record for one registered handle."""
    handle: ActorHandle
    channels: List[Any] = field(default_factory=list)
    seed_weights: Optional[Tuple[int, Any]] = None
    restarts: int = 0
    lost: bool = False


class Supervisor:
    """Restart supervision over ``ActorHandle``s (module docstring).

    Thread-safety: registration and bookkeeping are lock-guarded; the
    blocking recovery work (backoff sleep, respawn, replay) runs outside
    the lock on the single thread that drives the failed handle, so two
    workers recovering two different actors never serialize on each
    other's child spawns."""

    def __init__(self, policies=None, *, default: Optional[RestartPolicy]
                 = None, chaos: Optional[FaultPlan] = None,
                 monitor_poll_s: float = 0.2):
        # ``policies``: {role: RestartPolicy}, roles not named fall back
        # to ``default``; a bare RestartPolicy is the default for every role
        if isinstance(policies, RestartPolicy):
            default, policies = policies, None
        self.policies: Dict[str, RestartPolicy] = dict(policies or {})
        self.default = default if default is not None else RestartPolicy()
        self.chaos = chaos
        self.monitor_poll_s = monitor_poll_s
        self._lock = threading.Lock()
        self._members: Dict[str, _Member] = {}
        self._fabric = None
        self._bounds = None
        self._events: List[dict] = []
        self._readmit: Dict[str, Any] = {}   # name -> post-replay hook
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # ------------------------------------------------------- registration --

    def register(self, handle: ActorHandle, *, channels=(),
                 seed_weights: Optional[Tuple[int, Any]] = None):
        """Start supervising ``handle``.  ``channels`` are the weight
        channels feeding it (drained + replayed around a respawn);
        ``seed_weights=(version, params)`` is the replay source for
        consumers the fabric does not publish to (the frozen reference
        policy needs its version-0 params back, not the trainer's
        current ones)."""
        with self._lock:
            self._members[handle.name] = _Member(
                handle, list(channels), seed_weights)
        self._hook_death(handle)
        if self.chaos is not None:
            self.chaos.bind(handle)

    def _hook_death(self, handle: ActorHandle):
        t = handle.transport
        if getattr(t, "remote", False):
            t.on_death = lambda err, name=handle.name: \
                self._note("death-detected", name, error=str(err))

    def set_readmit(self, name: str, fn):
        """Register a post-replay re-admission hook for ``name``: called
        on the recovering thread after a respawn's weight replay, it
        rebuilds whatever actor-side state died with the process (the
        continuous-batching engine re-enqueues its in-flight batches
        here).  Returns the re-admitted batch indices (logged)."""
        with self._lock:
            self._readmit[name] = fn

    def attach_fabric(self, fabric, bounds=None):
        """Wire the weight fabric (replay source + subscriber detach)
        and optionally the staleness controller (re-tuned on degrade)."""
        self._fabric = fabric
        self._bounds = bounds
        fabric.on_subscriber_down = lambda ch, e: self._note(
            "publish-failed", ch.inbound.name, error=str(e))

    def covers(self, handle: ActorHandle) -> bool:
        with self._lock:
            m = self._members.get(handle.name)
            return m is not None and not m.lost

    def is_lost(self, name: str) -> bool:
        with self._lock:
            m = self._members.get(name)
            return m is not None and m.lost

    def restarts(self, name: str) -> int:
        with self._lock:
            m = self._members.get(name)
            return m.restarts if m is not None else 0

    def policy_for(self, role: str) -> RestartPolicy:
        return self.policies.get(role, self.default)

    # ------------------------------------------------------------- events --

    def _note(self, kind: str, name: str, **extra):
        # timestamps share the process trace epoch (repro_torch.obs.trace),
        # the same clock base controller history rows and trace events
        # use -- "the kill at t=1.82s" means one instant everywhere
        with self._lock:
            self._events.append(dict(
                t=obs_trace.now(), event=kind, actor=name, **extra))
        # lifecycle events fold into the trace stream as instants, so a
        # chaos kill shows up in the exported timeline, not just here
        obs_trace.instant(kind, "supervisor", actor=name,
                          **{k: v for k, v in extra.items()
                             if isinstance(v, (int, float, str, bool))})

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = [dict(e) for e in self._events]
        return evs if kind is None else [e for e in evs
                                         if e["event"] == kind]

    # ----------------------------------------------------------- recovery --

    def recover(self, handle: ActorHandle, error: BaseException) -> str:
        """Recover ``handle`` after a failed RPC; called by the one
        thread that drives it.

        Returns ``RESPAWNED`` (transport swapped, weights replayed --
        re-admit your jobs and retry) or ``LOST`` (budget exhausted --
        degrade).  Re-raises ``error`` when it was a deadline timeout on
        a *responsive* actor: that is backpressure, not death, and
        restarting cannot fix it."""
        with self._lock:
            member = self._members.get(handle.name)
        if member is None:
            raise error
        policy = self.policy_for(handle.role)
        if isinstance(error, TimeoutError) and not isinstance(error,
                                                              ActorDied):
            if self._responsive(handle, policy.hang_ping_s):
                raise error
            # unresponsive-but-alive: a hung child is a failed child
            self._note("hang-detected", handle.name, error=str(error))
            self._force_kill(handle)
        with self._lock:
            if member.lost:
                return LOST
            attempt = member.restarts
        self._note("recovering", handle.name, error=str(error),
                   attempt=attempt)
        if attempt >= policy.max_restarts:
            return self._mark_lost(member, error)
        # stop the publisher writing to the corpse, release its slots
        fab_chs, aux_chs = self._split_channels(member)
        for ch in fab_chs:
            self._fabric.detach(ch, error)
        for ch in fab_chs + aux_chs:
            ch.drain()
        time.sleep(policy.backoff(attempt))  # capped exponential backoff
        t0 = obs_trace.now()
        handle.respawn()
        t_spawn = obs_trace.now()
        with self._lock:
            member.restarts = attempt + 1
        self._hook_death(handle)
        if self.chaos is not None:
            self.chaos.bind(handle)          # transport swapped: re-bind
        # a fresh child pays its whole import/backend cost inside this
        # init, so bound it by the spawn budget, not the RPC timeout
        spec = getattr(handle, "spawn_spec", None)
        handle.call("init", timeout=spec.spawn_timeout
                    if spec is not None else None)
        t_init = obs_trace.now()
        replayed, replay_bytes = None, 0
        for ch in fab_chs:
            replayed = self._fabric.reattach(ch, replay=True)
            if replayed is not None:
                # every version of a channel's payload has one size
                replay_bytes += _nbytes(
                    self._fabric.latest()[1][payload_key(ch)])
        if member.seed_weights is not None:
            version, params = member.seed_weights
            for ch in aux_chs:
                ch.deliver(params, version=version)
                replay_bytes += _nbytes(params)
            replayed = version
        # the replay is in the child's slots once a round trip returns
        # (casts and calls through one handle run in order)
        handle.call("ping")
        t_replay = obs_trace.now()
        with self._lock:
            readmit = self._readmit.get(handle.name)
        if readmit is not None:
            # actor-side state (engine slots, ledger, parked pool rows)
            # died with the process: rebuild it under the replayed
            # weights, INSIDE the recovery window
            batches = readmit()
            self._note("readmitted", handle.name,
                       batches=repr(list(batches or [])))
        recovery_s = obs_trace.now() - t0
        self._note("respawned", handle.name, attempt=attempt + 1,
                   version=replayed, recovery_s=recovery_s,
                   spawn_s=t_spawn - t0, init_s=t_init - t_spawn,
                   replay_s=t_replay - t_init, replay_gb=replay_bytes / 1e9)
        # the respawn+replay window as a trace span: the gap a chaos
        # kill tears in the timeline closes with this "recover" slice
        obs_trace.complete("recover", "supervisor", t0, t0 + recovery_s,
                           actor=handle.name, attempt=attempt + 1,
                           recovery_s=recovery_s)
        return RESPAWNED

    def _split_channels(self, member: _Member):
        fab = [ch for ch in member.channels
               if self._fabric is not None and self._fabric.owns(ch)]
        aux = [ch for ch in member.channels if ch not in fab]
        return fab, aux

    def _mark_lost(self, member: _Member, error: BaseException) -> str:
        fab_chs, aux_chs = self._split_channels(member)
        for ch in fab_chs:
            self._fabric.detach(ch, error)
        for ch in fab_chs + aux_chs:
            ch.drain()
        with self._lock:
            member.lost = True
        self._note("lost", member.handle.name, error=str(error))
        try:
            member.handle.close()            # reap + unlink what is left
        except Exception as e:               # pragma: no cover - diagnostics
            _log.debug("closing lost actor '%s': %r",
                       member.handle.name, e)
        return LOST

    def on_pool_resize(self, n_workers: int):
        """Degrade/grow notification: let the staleness controller drop
        its stale starvation window and re-tune for the new pool."""
        self._note("pool-resized", "", n_workers=n_workers)
        cb = getattr(self._bounds, "on_pool_resize", None)
        if cb is not None:
            cb(n_workers)

    def _responsive(self, handle: ActorHandle, ping_s: float) -> bool:
        try:
            handle.call("ping", timeout=ping_s)
            return True
        except (ActorDied, TimeoutError):
            return False

    def _force_kill(self, handle: ActorHandle):
        """Put a hung child out of its misery so respawn starts clean."""
        t = handle.transport
        proc = getattr(t, "_proc", None)
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(10.0)
        elif proc is None:
            conn = getattr(t, "_conn", None) or getattr(t, "_sock", None)
            if conn is not None:             # remote host: cut the wire
                try:
                    conn.close()
                except OSError as e:         # pragma: no cover
                    _log.debug("cutting hung actor '%s': %r",
                               handle.name, e)

    # ------------------------------------------------------------ monitor --

    def start_monitor(self):
        """Optional background monitor: polls registered handles so a
        death is *recorded* (time-to-detection) even while every worker
        thread is busy elsewhere.  Recovery itself stays on the worker
        threads."""
        if self._monitor is not None:
            return
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="supervisor-monitor",
            daemon=True)
        self._monitor.start()

    def stop_monitor(self):
        self._stop.set()
        t, self._monitor = self._monitor, None
        if t is not None:
            t.join(timeout=10.0)

    def _monitor_loop(self):
        seen: set = set()
        while not self._stop.wait(self.monitor_poll_s):
            with self._lock:
                members = list(self._members.values())
            for m in members:
                if m.lost:
                    continue
                t = m.handle.transport
                healthy = not getattr(t, "remote", False) or t.healthy()
                if not healthy and m.handle.name not in seen:
                    seen.add(m.handle.name)
                    self._note("unhealthy", m.handle.name)
                elif healthy:
                    seen.discard(m.handle.name)   # respawned
