"""Trained weights and learner state as plain numpy.

The JAX package checkpoints through orbax, which the port does not depend
on.  A committed artifact is therefore also stored as ``<step>.npz`` beside
its orbax directory, with one entry per flax leaf under a ``/``-joined path
(``params/pi/Dense_0/kernel``).

:func:`ppo_state_from_jax` carries a JAX ``PPOLearner``'s parameters and
optimizer state, given as numpy arrays, into the port's learner state:
the 13 leaves of :func:`..solvers.networks.actor_critic_leaves` and an
:class:`..ops.ppo_sweep.AdamState`.  :func:`ppo_state_to_jax` goes back, so
that tests compare trained parameters leaf by leaf.  :func:`ddpg_state_from_jax`
and :func:`ddpg_state_to_jax` do the same for a JAX ``DDPGLearner``: the
actor, the critic, their targets (6 leaves each, :func:`..solvers.networks.
ddpg_leaves`) and both Adam states.  The DDPG checkpoint holds only the
actor's params (:func:`load_ddpg_actor_npz`).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..ops.ppo_sweep import AdamState
from ..solvers.networks import (
    ActorCritic,
    DDPGActor,
    actor_critic_from_flax,
    ddpg_actor_from_flax,
    mlp_leaves_from_flax,
)

_NETS = ("pi", "vf")


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


def leaves_from_flax(tree: Mapping, device: torch.device | str = "cpu") -> list[torch.Tensor]:
    """ActorCritic flax params (``{"params": …}`` or the inner dict, numpy
    leaves) as the 13 learner leaves; a flax ``kernel (in, out)`` becomes a
    ``weight (out, in)``."""
    p = tree["params"] if "params" in tree else tree
    leaves = []
    for name in _NETS:
        for i in range(3):
            dense = p[name][f"Dense_{i}"]
            leaves.append(torch.from_numpy(np.array(dense["kernel"]).T.copy()))
            leaves.append(torch.from_numpy(np.array(dense["bias"])))
    leaves.append(torch.from_numpy(np.array(p["log_std"])))
    return [x.to(device) for x in leaves]


def leaves_to_flax(leaves: Sequence[torch.Tensor]) -> dict:
    """The inverse of :func:`leaves_from_flax`: ``{"params": …}`` with numpy leaves."""
    arrays = [x.detach().cpu().numpy() for x in leaves]
    p: dict = {"log_std": arrays[12]}
    for n, name in enumerate(_NETS):
        p[name] = {f"Dense_{i}": {"kernel": arrays[6 * n + 2 * i].T.copy(),
                                  "bias": arrays[6 * n + 2 * i + 1]} for i in range(3)}
    return {"params": p}


def find_adam_state(opt_state):
    """The first node of an optax chain state with ``count``, ``mu`` and ``nu``
    (``ScaleByAdamState``), searched depth first through tuples, as
    ``solvers/ppo.py:132-155`` of the JAX package finds it; None if absent."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)) and not hasattr(opt_state, "shape"):
        for sub in opt_state:
            found = find_adam_state(sub)
            if found is not None:
                return found
    return None


def ppo_state_from_jax(params_tree: Mapping, opt_state,
                       device: torch.device | str = "cpu") -> tuple[list[torch.Tensor], AdamState]:
    """A JAX ``PPOLearner``'s ``params`` and ``opt_state`` (numpy leaves, for
    example ``jax.tree.map(np.asarray, state)``) as the port's learner leaves
    and Adam state."""
    adam = find_adam_state(opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam state (count, mu, nu)")
    return (leaves_from_flax(params_tree, device),
            AdamState(int(np.asarray(adam.count)), leaves_from_flax(adam.mu, device),
                      leaves_from_flax(adam.nu, device)))


def ppo_state_to_jax(leaves: Sequence[torch.Tensor], adam: AdamState) -> tuple[dict, dict]:
    """The inverse of :func:`ppo_state_from_jax`: ``(params, {"count", "mu",
    "nu"})`` as flax-shaped numpy trees."""
    return leaves_to_flax(leaves), {"count": np.int32(adam.count),
                                    "mu": leaves_to_flax(adam.mu), "nu": leaves_to_flax(adam.nu)}


def load_ddpg_actor_npz(path: str, config) -> DDPGActor:
    """The DDPG actor stored at ``path`` (dtype as stored), squashing into
    ``config``'s action box (flax keeps the box out of the params)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    low, high = config.action_bounds()
    return ddpg_actor_from_flax(unflatten(flat), low, high)


def mlp_leaves_to_flax(leaves: Sequence[torch.Tensor], head: str) -> dict:
    """The inverse of :func:`..solvers.networks.mlp_leaves_from_flax`:
    ``{"params": {head: …}}`` with numpy leaves."""
    arrays = [x.detach().cpu().numpy() for x in leaves]
    return {"params": {head: {f"Dense_{i}": {"kernel": arrays[2 * i].T.copy(), "bias": arrays[2 * i + 1]}
                              for i in range(3)}}}


_DDPG_HEADS = (("actor_params", "mu"), ("critic_params", "q"), ("target_actor_params", "mu"),
               ("target_critic_params", "q"))


def ddpg_state_from_jax(trees: Mapping, device: torch.device | str = "cpu"):
    """A JAX ``DDPGLearner`` state's networks and optimizers (``trees`` holds
    ``actor_params``, ``critic_params``, ``target_actor_params``,
    ``target_critic_params``, ``actor_opt``, ``critic_opt`` with numpy
    leaves, for example ``jax.tree.map(np.asarray, state)._asdict()``) as
    ``(actor, critic, target_actor, target_critic, actor_adam, critic_adam)``:
    four lists of 6 leaves and two :class:`..ops.ppo_sweep.AdamState`."""
    nets = [[x.to(device) for x in mlp_leaves_from_flax(trees[key], head)] for key, head in _DDPG_HEADS]
    adams = []
    for key, head in (("actor_opt", "mu"), ("critic_opt", "q")):
        adam = find_adam_state(trees[key])
        if adam is None:
            raise ValueError(f"{key} holds no Adam state (count, mu, nu)")
        adams.append(AdamState(int(np.asarray(adam.count)),
                               [x.to(device) for x in mlp_leaves_from_flax(adam.mu, head)],
                               [x.to(device) for x in mlp_leaves_from_flax(adam.nu, head)]))
    return (*nets, *adams)


def ddpg_state_to_jax(actor, critic, target_actor, target_critic, actor_adam: AdamState,
                      critic_adam: AdamState) -> dict:
    """The inverse of :func:`ddpg_state_from_jax`: flax-shaped numpy trees,
    each optimizer as ``{"count", "mu", "nu"}``."""
    out = {key: mlp_leaves_to_flax(leaves, head)
           for (key, head), leaves in zip(_DDPG_HEADS, (actor, critic, target_actor, target_critic))}
    for key, head, adam in (("actor_opt", "mu", actor_adam), ("critic_opt", "q", critic_adam)):
        out[key] = {"count": np.int32(adam.count), "mu": mlp_leaves_to_flax(adam.mu, head),
                    "nu": mlp_leaves_to_flax(adam.nu, head)}
    return out
