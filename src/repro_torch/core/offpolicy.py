"""Off-policy bookkeeping: staleness buffer + partial-rollout cache (an
adapted copy of the JAX package's ``core/offpolicy.py``).

``StalenessBuffer`` realizes the 1..n-step delay between the policy that
generated a batch and the policy that trains on it.  It is thread-safe;
with ``delay=0`` it is a plain bounded FIFO, with ``delay=s`` and one
push + pop per tick it releases exactly the entry pushed ``s`` ticks
earlier (the bounded-staleness weight schedule).  ``close()`` wakes every
blocked producer and consumer with ``Closed``.

``PartialRolloutCache`` stores incomplete ``RolloutState``s across
iterations (paper Sec. 4.2) so long generations never block a training
tick.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.rl.rollout import RolloutState


class Closed(Exception):
    """Raised by blocking buffer/channel calls once ``close()`` was called:
    the shutdown signal, not an error."""


class StalenessBuffer:
    """Thread-safe FIFO of (version, batch) pairs.

    ``pop`` releases the head entry once it is at least ``delay`` versions
    behind the latest push (or the queue holds more than ``delay``
    entries).  ``max_size=0`` means unbounded; a bounded buffer makes
    ``push`` block.  Entries are released in push order.
    """

    def __init__(self, delay: int = 1, max_size: int = 0):
        self.delay = max(0, delay)
        self.max_size = max(0, max_size)
        self._q: Deque[Tuple[int, Any]] = collections.deque()
        self.latest_version = -1
        self._closed = False
        self._cond = threading.Condition()

    def _has_room(self) -> bool:
        return self._closed or not self.max_size \
            or len(self._q) < self.max_size

    def _ready(self) -> bool:
        if not self._q:
            return self._closed
        version, _ = self._q[0]
        return self.latest_version - version >= self.delay or \
            len(self._q) > self.delay or self._closed

    def push(self, version: int, batch: Any,
             timeout: Optional[float] = None):
        """Append (version, batch); blocks while full (bounded buffers)."""
        with self._cond:
            if not self._cond.wait_for(self._has_room, timeout):
                raise TimeoutError(
                    f"StalenessBuffer full for {timeout}s "
                    f"(max_size={self.max_size})")
            if self._closed:
                raise Closed("StalenessBuffer closed")
            self.latest_version = max(self.latest_version, version)
            self._q.append((version, batch))
            self._cond.notify_all()
            return True

    def pop(self) -> Optional[Tuple[int, Any]]:
        """Non-blocking: the released (version, batch), or None."""
        with self._cond:
            if not self._q or not self._ready():
                return None
            item = self._q.popleft()
            self._cond.notify_all()
            return item

    def pop_wait(self, timeout: Optional[float] = None) -> Tuple[int, Any]:
        """Blocking pop: waits until an entry is released."""
        with self._cond:
            if not self._cond.wait_for(self._ready, timeout):
                raise TimeoutError(
                    f"StalenessBuffer empty for {timeout}s")
            if not self._q:                  # closed and drained
                raise Closed("StalenessBuffer closed")
            item = self._q.popleft()
            self._cond.notify_all()
            return item

    def close(self):
        """Wake all blocked producers/consumers with ``Closed``.  Queued
        entries stay poppable; new pushes are refused.  Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def versions(self) -> List[int]:
        """The versions of the queued entries, in queue order."""
        with self._cond:
            return [v for v, _ in self._q]

    def __len__(self):
        with self._cond:
            return len(self._q)


class PartialRolloutCache:
    """Holds unfinished rollouts keyed by an id; thread-safe."""

    def __init__(self):
        self._store: Dict[int, RolloutState] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    def put(self, state: RolloutState) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._store[rid] = state
            return rid

    def get(self, rid: int) -> RolloutState:
        with self._lock:
            return self._store.pop(rid)

    def pending(self) -> List[int]:
        with self._lock:
            return list(self._store)

    @staticmethod
    def finished_mask(state: RolloutState) -> np.ndarray:
        """True where the sequence is complete (EOS seen or buffer full).
        The port's cache cursor is a Python int."""
        done = state.done.cpu().numpy()
        full = int(state.cache["pos"]) >= state.tokens.shape[1]
        return done | full

    def __len__(self):
        with self._lock:
            return len(self._store)
