"""Actor handles, in-process part (the port of the JAX package's
``core/actors.py``).

The controller, the channels and the generator pool hold
``ActorHandle``s, never raw executors: ``call`` is a synchronous endpoint
(a method, or a plain attribute read), ``cast`` a fire-and-forget send.
The only transport here is ``InprocTransport``: the executor lives in
this process and its endpoints are direct calls on the caller's thread.
``spawn_actor`` builds an executor behind a handle and records how
(``handle.spawn_spec``).  The process, shared-memory and socket
transports come with ROADMAP A8: naming one, as an argument or through
``REPRO_TRANSPORT``, raises ``NotImplementedError`` instead of running
the actor in process.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import ddma

#: the transports the reference offers that this port does not yet
REMOTE_TRANSPORTS = ("proc", "shm", "socket")


class ActorDied(RuntimeError):
    """The process or host backing an actor exited.  In-process actors
    never raise it; the pool and controller catch it for the process
    transports (ROADMAP A8) and supervision (A9)."""


class RemoteActorError(RuntimeError):
    """Carries a remote traceback (process transports, ROADMAP A8)."""


def _describe_executor(ex, fallback_name: str) -> Dict[str, Any]:
    """The actor's identity and capability flags, read off the executor."""
    return {"name": getattr(ex, "name", fallback_name),
            "role": getattr(ex, "role", "generic"),
            "chunk_hooks": hasattr(ex, "begin_batch"),
            "pinned_hooks": hasattr(ex, "begin_batch_pinned"),
            "engine_hooks": hasattr(ex, "engine_round"),
            "staged_weights": hasattr(ex, "stage_weights")
            and hasattr(ex, "set_weights")}


def _invoke(ex, method: str, args, kwargs):
    """A callable attribute is invoked, a plain attribute is read."""
    attr = getattr(ex, method)
    if callable(attr):
        return attr(*args, **(kwargs or {}))
    if args or kwargs:
        raise TypeError(f"'{method}' is an attribute, not an endpoint")
    return attr


class InprocTransport:
    """The executor lives in this process; endpoints are direct calls."""

    #: True when endpoints cross a process boundary (never, here)
    remote = False

    def __init__(self, executor):
        self.executor = executor

    def describe(self) -> Dict[str, Any]:
        return _describe_executor(self.executor,
                                  type(self.executor).__name__)

    @property
    def device(self):
        return getattr(self.executor, "device", None)

    def call(self, method, args=(), kwargs=None):
        return _invoke(self.executor, method, args, kwargs)

    def cast(self, method, args=(), kwargs=None):
        self.call(method, args, kwargs)

    def prepare(self, data, comm_type):
        """Stage a channel payload toward this actor: the DDMA (or the
        parameter-server) transfer to the executor's device for weight
        payloads, the identity otherwise and for executors without a
        device."""
        from repro_torch.core.channels import CommType   # import cycle
        device = self.device
        if not comm_type.is_weights or device is None:
            return data
        sync = (ddma.ddma_weight_sync
                if comm_type == CommType.DDMA_WEIGHTS_UPDATE
                else ddma.ps_weight_sync)
        return sync(data, device)

    def healthy(self) -> bool:
        return True


class ActorHandle:
    """What the controller holds: typed endpoints over a transport.
    Identity is the handle object: ``as_handle`` returns one canonical
    handle per executor, so membership checks keep working."""

    def __init__(self, transport: InprocTransport):
        self.transport = transport
        d = transport.describe()
        self.name: str = d["name"]
        self.role: str = d["role"]
        self.chunk_hooks: bool = d["chunk_hooks"]
        self.engine_hooks: bool = d["engine_hooks"]
        self.staged_weights: bool = d["staged_weights"]
        self._pinned_hooks: bool = d["pinned_hooks"]

    @property
    def device(self):
        """The executor's device (the port's stand-in for the
        reference's submesh: the fabric transfers once per target)."""
        return self.transport.device

    def call(self, method: str, *args, **kwargs):
        """Synchronous endpoint: invoke a method (or read an attribute) on
        the actor and return the result."""
        return self.transport.call(method, args, kwargs)

    def cast(self, method: str, *args, **kwargs):
        """Fire-and-forget send (in process: a call whose result is
        dropped)."""
        self.transport.cast(method, args, kwargs)

    def healthy(self) -> bool:
        return self.transport.healthy()

    # -- chunk-stepping collaborator surface (RolloutScheduler) -------------
    # The scheduler calls advance_chunk(job, state), which mutates the job
    # in place.  The handle routes through advance_chunk_rt, which returns
    # the job, and mirrors its fields back onto the caller's job: in
    # process that is the identity, over a process boundary (ROADMAP A8)
    # it is what carries the key split and chunk count home.

    def begin_batch(self, batch_index=None):
        if self.transport.remote and self._pinned_hooks:
            return self.call("begin_batch_pinned", batch_index)
        return self.call("begin_batch", batch_index)

    def advance_chunk(self, job, state):
        job2, state = self.call("advance_chunk_rt", job, state)
        if job2 is not job:
            job.__dict__.update(job2.__dict__)
        return state

    def emit_batch(self, job, state):
        return self.call("emit_batch", job, state)

    def __repr__(self):
        return f"<ActorHandle {self.name!r} role={self.role} in process>"


def as_handle(x) -> ActorHandle:
    """Canonical handle for ``x``: handles pass through; a raw executor
    gets one cached in-process handle."""
    if isinstance(x, ActorHandle):
        return x
    h = getattr(x, "_actor_handle", None)
    if h is None:
        h = ActorHandle(InprocTransport(x))
        x._actor_handle = h
    return h


def _check_transport(transport: str) -> str:
    if transport in REMOTE_TRANSPORTS:
        raise NotImplementedError(
            f"transport {transport!r} comes with the port of the process "
            "transports (ROADMAP A8); only 'inproc' runs in this port")
    if transport != "inproc":
        raise ValueError(
            f"unknown transport {transport!r}: expected 'inproc', 'proc', "
            "'shm' or 'socket'")
    return transport


@dataclass(frozen=True)
class SpawnSpec:
    """How an actor was built: the factory, its arguments and the
    transport, recorded on the handle by ``spawn_actor`` so the actor can
    be rebuilt identically (supervision, ROADMAP A9)."""

    factory: Any
    args: Tuple = ()
    kwargs: Any = None
    transport: str = "inproc"

    def spawn(self) -> ActorHandle:
        """A fresh handle over a newly constructed executor."""
        _check_transport(self.transport)
        h = ActorHandle(InprocTransport(
            self.factory(*self.args, **dict(self.kwargs or {}))))
        h.spawn_spec = self
        return h


def spawn_actor(factory, *args, transport: Optional[str] = None,
                **kwargs) -> ActorHandle:
    """Construct an executor behind an ``ActorHandle``.

    ``transport`` is ``"inproc"``; ``None`` reads ``REPRO_TRANSPORT``
    (default ``inproc``).  ``"proc"``, ``"shm"`` and ``"socket"`` raise
    ``NotImplementedError`` (ROADMAP A8).  The spec is recorded as
    ``handle.spawn_spec``."""
    transport = _check_transport(
        transport or os.environ.get("REPRO_TRANSPORT", "inproc"))
    spec = SpawnSpec(factory, tuple(args), dict(kwargs), transport)
    # the identity-caching as_handle path: wiring sites that name the
    # same raw executor share one canonical handle
    h = as_handle(factory(*args, **kwargs))
    h.spawn_spec = spec
    return h


def close_all_actors():
    """Close every live process-backed actor.  Every actor here is in
    process, so there is nothing to close; kept so scripts written for
    the reference run unchanged."""
