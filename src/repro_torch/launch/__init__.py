"""Entry points that place the port's actors (``train``: the RL training
launcher)."""
