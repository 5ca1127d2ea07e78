"""Supervision outcomes (the names of the JAX package's
``core/supervise.py`` that the generator pool reads).

``Supervisor.recover`` answers a dead actor with one of these.  The
supervisor itself, its restart policy and fault injection come with
ROADMAP A9; until then the pool and the controller run unsupervised
(fail-fast), as the reference does with ``supervise=None``.
"""

#: ``recover`` outcomes
RESPAWNED = "respawned"
LOST = "lost"
