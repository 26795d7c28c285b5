"""Policy networks (port of ``solvers/networks.py:25-52``).

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
i = 0, 1, 2, then ``log_std (A,)``.  The DDPG networks are not ported yet.
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
