"""Policy networks (port of ``solvers/networks.py``).

``ActorCritic`` is the SB3-default PPO ``MlpPolicy``: separate 64-64 tanh MLPs
for the action mean (``pi``) and the value (``vf``) plus a state-independent
``log_std``.  Submodule names follow the flax tree (``pi/Dense_0`` …) so that
:func:`actor_critic_from_flax` reads off one to one.  A fresh network takes
the flax initialisation: orthogonal kernels with gain √2 on the hidden
layers, 0.01 on the ``pi`` output and 1.0 on the ``vf`` output, zero biases,
``log_std`` zeros.

The learner (``solvers/ppo.py``) and the sweep kernels work on the 13
parameter leaves in a fixed order (:func:`actor_critic_leaves`): for ``pi``
then ``vf``, ``Dense_i.weight (out, in)`` and ``Dense_i.bias (out,)`` for
i = 0, 1, 2, then ``log_std (A,)``.

``DDPGActor`` and ``DDPGCritic`` are SB3's DDPG ``MlpPolicy`` (400-300 ReLU
torsos, ``networks.py:55-78``): the actor's output is squashed by ``tanh``
into the action box, ``low + (tanh(x) + 1)·0.5·(high − low)``; the critic
reads ``cat([obs, action])`` and returns Q squeezed.  Both take flax's
initialisation (orthogonal, gain √2 on the hidden layers and 1.0 on the
output, zero biases).  The DDPG learner and its kernels work on each
network's 6 leaves (:func:`ddpg_leaves`): ``Dense_i.weight (out, in)`` and
``Dense_i.bias (out,)`` for i = 0, 1, 2.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn


HIDDEN_GAIN = math.sqrt(2.0)


class MLP(nn.Module):
    """``Dense_0 … Dense_{k}``: hidden layers with an activation, then the output.

    Kernels are orthogonal (gain √2 on the hidden layers, ``out_scale`` on the
    output) and biases zero, as flax's ``MLP`` initialises them; the draws
    come from ``generator`` (torch's default generator when it is None)."""

    def __init__(self, in_dim: int, features: Sequence[int], out_dim: int,
                 activation: str = "tanh", out_scale: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [in_dim, *features, out_dim]
        self.num_layers = len(dims) - 1
        for i in range(self.num_layers):
            layer = nn.Linear(dims[i], dims[i + 1])
            gain = out_scale if i == self.num_layers - 1 else HIDDEN_GAIN
            with torch.no_grad():
                nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
                layer.bias.zero_()
            self.add_module(f"Dense_{i}", layer)
        self.activation = torch.tanh if activation == "tanh" else torch.relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_layers - 1:
                x = self.activation(x)
        return x


class ActorCritic(nn.Module):
    """PPO actor-critic with SB3-default torso sizes."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.obs_dim, self.action_dim, self.hidden = obs_dim, action_dim, tuple(hidden)
        self.pi = MLP(obs_dim, hidden, action_dim, "tanh", 0.01, generator)
        self.vf = MLP(obs_dim, hidden, 1, "tanh", 1.0, generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs: torch.Tensor):
        """``(mean, log_std, value)`` as the flax module returns them."""
        return self.pi(obs), self.log_std, self.vf(obs).squeeze(-1)

    def act(self, obs: torch.Tensor, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        """Deterministic action: the mean clipped to the action box."""
        return torch.clamp(self.pi(obs), low, high)


def make_actor_policy_fn(config, net: ActorCritic):
    """Deterministic policy ``obs -> clipped mean`` in ``net``'s dtype and device
    (the JAX ``PPOLearner.policy_fn(params, deterministic=True)``)."""
    ref = net.log_std
    low, high = (torch.as_tensor(b).to(device=ref.device, dtype=ref.dtype)
                 for b in config.action_bounds())

    def policy(obs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return net.act(obs.to(ref.dtype), low, high)

    return policy


def actor_critic_leaves(net: ActorCritic) -> list[torch.Tensor]:
    """The 13 parameter leaves of ``net`` in the learner's order."""
    leaves = []
    for name in ("pi", "vf"):
        mlp = getattr(net, name)
        if mlp.num_layers != 3:
            raise ValueError("the PPO learner and its kernels take torsos of two hidden layers")
        for i in range(3):
            layer = getattr(mlp, f"Dense_{i}")
            leaves += [layer.weight, layer.bias]
    return leaves + [net.log_std]


def actor_critic_from_leaves(leaves: Sequence[torch.Tensor]) -> ActorCritic:
    """An :class:`ActorCritic` holding copies of ``leaves`` (dtype and device
    of the leaves)."""
    if len(leaves) != 13:
        raise ValueError(f"an ActorCritic has 13 leaves, got {len(leaves)}")
    obs_dim, action_dim = leaves[0].shape[1], leaves[4].shape[0]
    net = ActorCritic(obs_dim, action_dim, (leaves[0].shape[0], leaves[2].shape[0]))
    net = net.to(device=leaves[0].device, dtype=leaves[0].dtype)
    with torch.no_grad():
        for dst, src in zip(actor_critic_leaves(net), leaves):
            dst.copy_(src.detach())
    return net


def _leaf(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def actor_critic_from_flax(tree: Mapping) -> ActorCritic:
    """Build an :class:`ActorCritic` from flax params given as numpy.

    ``tree`` is ``{"params": {"pi": {"Dense_i": {"kernel", "bias"}}, "vf": …,
    "log_std": …}}`` (or its inner ``params`` dict).  A flax ``Dense.kernel``
    is ``(in, out)``; ``nn.Linear.weight`` is ``(out, in)``.  The module takes
    the dtype of the given arrays.
    """
    p = tree["params"] if "params" in tree else tree
    pi = p["pi"]
    n_layers = len(pi)
    kernels = [np.asarray(pi[f"Dense_{i}"]["kernel"]) for i in range(n_layers)]
    obs_dim, action_dim = kernels[0].shape[0], kernels[-1].shape[1]
    hidden = [k.shape[1] for k in kernels[:-1]]
    net = ActorCritic(obs_dim, action_dim, hidden)
    net = net.to(_leaf(kernels[0]).dtype)
    with torch.no_grad():
        for name in ("pi", "vf"):
            mlp = getattr(net, name)
            for i in range(mlp.num_layers):
                dense = p[name][f"Dense_{i}"]
                layer = getattr(mlp, f"Dense_{i}")
                layer.weight.copy_(_leaf(dense["kernel"]).T)
                layer.bias.copy_(_leaf(dense["bias"]))
        net.log_std.copy_(_leaf(p["log_std"]))
    return net


# --------------------------------------------------------------------- DDPG ---

DDPG_HIDDEN = (400, 300)


def squash(x: torch.Tensor, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """``low + (tanh(x) + 1)·0.5·(high − low)`` in flax's order (networks.py:66-69)."""
    return low + (torch.tanh(x) + 1.0) * 0.5 * (high - low)


class DDPGActor(nn.Module):
    """DDPG actor: ReLU torso ``mu``, output squashed into the action box."""

    def __init__(self, obs_dim: int, action_dim: int, low: Sequence[float], high: Sequence[float],
                 hidden: Sequence[int] = DDPG_HIDDEN, generator: torch.Generator | None = None):
        super().__init__()
        self.obs_dim, self.action_dim, self.hidden = obs_dim, action_dim, tuple(hidden)
        self.mu = MLP(obs_dim, hidden, action_dim, "relu", 1.0, generator)
        self.register_buffer("low", torch.as_tensor(np.asarray(low, np.float32)))
        self.register_buffer("high", torch.as_tensor(np.asarray(high, np.float32)))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return squash(self.mu(obs), self.low.to(obs.dtype), self.high.to(obs.dtype))


class DDPGCritic(nn.Module):
    """DDPG Q-network ``q`` over ``cat([obs, action])``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = DDPG_HIDDEN,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.obs_dim, self.action_dim, self.hidden = obs_dim, action_dim, tuple(hidden)
        self.q = MLP(obs_dim + action_dim, hidden, 1, "relu", 1.0, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.q(torch.cat([obs, action], dim=-1)).squeeze(-1)


def ddpg_leaves(net: DDPGActor | DDPGCritic) -> list[torch.Tensor]:
    """The 6 parameter leaves of a DDPG network (its ``mu`` or ``q`` torso)."""
    mlp = net.mu if isinstance(net, DDPGActor) else net.q
    if mlp.num_layers != 3:
        raise ValueError("the DDPG learner and its kernels take torsos of two hidden layers")
    leaves = []
    for i in range(3):
        layer = getattr(mlp, f"Dense_{i}")
        leaves += [layer.weight, layer.bias]
    return leaves


def _load_leaves(net, leaves: Sequence[torch.Tensor]):
    net = net.to(device=leaves[0].device, dtype=leaves[0].dtype)
    with torch.no_grad():
        for dst, src in zip(ddpg_leaves(net), leaves):
            dst.copy_(src.detach())
    return net


def ddpg_actor_from_leaves(leaves: Sequence[torch.Tensor], low: Sequence[float],
                           high: Sequence[float]) -> DDPGActor:
    """A :class:`DDPGActor` holding copies of its 6 ``leaves``."""
    if len(leaves) != 6:
        raise ValueError(f"a DDPG network has 6 leaves, got {len(leaves)}")
    net = DDPGActor(leaves[0].shape[1], leaves[4].shape[0], low, high,
                    (leaves[0].shape[0], leaves[2].shape[0]))
    return _load_leaves(net, leaves)


def ddpg_critic_from_leaves(leaves: Sequence[torch.Tensor], obs_dim: int) -> DDPGCritic:
    """A :class:`DDPGCritic` holding copies of its 6 ``leaves``."""
    if len(leaves) != 6:
        raise ValueError(f"a DDPG network has 6 leaves, got {len(leaves)}")
    net = DDPGCritic(obs_dim, leaves[0].shape[1] - obs_dim, (leaves[0].shape[0], leaves[2].shape[0]))
    return _load_leaves(net, leaves)


def mlp_leaves_from_flax(tree: Mapping, head: str) -> list[torch.Tensor]:
    """The 6 leaves of the flax torso ``head`` (``mu`` or ``q``) of ``tree``
    (``{"params": …}`` or its inner dict, numpy leaves); a flax ``kernel (in,
    out)`` becomes a ``weight (out, in)``."""
    p = tree["params"] if "params" in tree else tree
    leaves = []
    for i in range(3):
        dense = p[head][f"Dense_{i}"]
        leaves.append(torch.from_numpy(np.array(dense["kernel"]).T.copy()))
        leaves.append(_leaf(dense["bias"]))
    return leaves


def ddpg_actor_from_flax(tree: Mapping, low: Sequence[float], high: Sequence[float]) -> DDPGActor:
    """A :class:`DDPGActor` from flax ``DDPGActor`` params given as numpy (the
    action box is a module attribute in flax, so it is passed here); the
    module takes the dtype of the arrays."""
    return ddpg_actor_from_leaves(mlp_leaves_from_flax(tree, "mu"), low, high)


def ddpg_critic_from_flax(tree: Mapping, obs_dim: int) -> DDPGCritic:
    """A :class:`DDPGCritic` from flax ``DDPGCritic`` params given as numpy."""
    return ddpg_critic_from_leaves(mlp_leaves_from_flax(tree, "q"), obs_dim)


def make_ddpg_policy_fn(net: DDPGActor):
    """Deterministic policy ``obs -> actions`` in ``net``'s dtype and device
    (the JAX ``DDPGLearner.policy_fn``)."""
    ref = net.low

    def policy(obs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return net(obs.to(device=ref.device, dtype=net.mu.Dense_0.weight.dtype))

    return policy
