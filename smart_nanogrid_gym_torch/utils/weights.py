"""Trained weights as plain numpy archives.

The JAX package checkpoints through orbax, which the port does not depend
on.  A committed artifact is therefore also stored as ``<step>.npz`` beside
its orbax directory, with one entry per flax leaf under a ``/``-joined path
(``params/pi/Dense_0/kernel``).
"""

from __future__ import annotations

import numpy as np

from ..solvers.networks import ActorCritic, actor_critic_from_flax


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def load_actor_critic_npz(path: str) -> ActorCritic:
    """The PPO actor-critic stored at ``path`` (dtype as stored)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return actor_critic_from_flax(unflatten(flat))
