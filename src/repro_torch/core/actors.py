"""Actor handles, in-process part (the port of the JAX package's
``core/actors.py``).

The controller and the channels hold ``ActorHandle``s, never raw
executors: ``call`` is a synchronous endpoint (a method, or a plain
attribute read), ``cast`` a fire-and-forget send.  The only transport
here is ``InprocTransport``: the executor lives in this process and its
endpoints are direct calls on the caller's thread.  The process, shared-
memory and socket transports come with ROADMAP A8.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core import ddma


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

    def __init__(self, executor):
        self.executor = executor

    def describe(self) -> Dict[str, Any]:
        ex = self.executor
        return {"name": getattr(ex, "name", type(ex).__name__),
                "role": getattr(ex, "role", "generic")}

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
        device = getattr(self.executor, "device", None)
        if not comm_type.is_weights or device is None:
            return data
        sync = (ddma.ddma_weight_sync
                if comm_type == CommType.DDMA_WEIGHTS_UPDATE
                else ddma.ps_weight_sync)
        return sync(data, device)


class ActorHandle:
    """What the controller holds: typed endpoints over a transport.
    Identity is the handle object: ``as_handle`` returns one canonical
    handle per executor, so membership checks keep working."""

    def __init__(self, transport: InprocTransport):
        self.transport = transport
        d = transport.describe()
        self.name: str = d["name"]
        self.role: str = d["role"]

    def call(self, method: str, *args, **kwargs):
        """Synchronous endpoint: invoke a method (or read an attribute) on
        the actor and return the result."""
        return self.transport.call(method, args, kwargs)

    def cast(self, method: str, *args, **kwargs):
        """Fire-and-forget send (in process: a call whose result is
        dropped)."""
        self.transport.cast(method, args, kwargs)

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
