"""Env-batch sharding over ranks (port of ``parallel/mesh.py``).

The reference has no parallel execution of any kind (SURVEY.md §2.3).  The
JAX package shards the env batch over a 1-D ``envs`` device mesh; the port
uses torch's idiom instead, one process per card on ``torch.distributed``:

- an :class:`EnvMesh` is the process group, this process's rank, the world
  size and the device the rank runs on (NCCL carries collectives of CUDA
  tensors, gloo those of CPU tensors; a gloo group given CUDA tensors stages
  them through the host);
- each rank holds the contiguous ``[lo, hi)`` slice of the global env axis
  (:func:`shard_env_batch`), and the rollout issues **no collective**;
- the learners' gradient mean is the only cross-rank traffic
  (:mod:`..solvers.ppo`, :mod:`..solvers.ddpg`).

At world size 1 every function here is the single-process computation.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch
import torch.distributed as dist

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..core.rollout import fused_day_rollout

ENV_AXIS = "envs"


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """A 1-D env mesh (the ``ENV_AXIS``): ``world_size`` ranks, each holding
    ``1 / world_size`` of the env batch on ``device``.  ``group`` is the
    process group (None in one process without ``torch.distributed``)."""

    group: object
    rank: int
    world_size: int
    device: torch.device

    def shard_bounds(self, global_batch: int) -> tuple[int, int]:
        """This rank's contiguous ``[lo, hi)`` of a global env axis."""
        if global_batch % self.world_size:
            raise ValueError(f"global batch {global_batch} not divisible by world size {self.world_size}")
        local = global_batch // self.world_size
        return self.rank * local, (self.rank + 1) * local

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where this group's backend can carry it: gloo takes host tensors."""
        if x.device.type == "cuda" and dist.get_backend(self.group) == "gloo":
            return x.cpu()
        return x

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks (JAX's ``pmean``): a sum, then a
        division by the world size; ``x`` itself at world size 1."""
        if self.world_size == 1:
            return x
        buf = self._staged(x).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(x.device) / self.world_size

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        if self.world_size == 1:
            return x
        buf = self._staged(x).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        return buf.to(x.device)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in rank order."""
        if self.world_size == 1:
            return x
        buf = self._staged(x).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.world_size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank."""
        if self.world_size == 1:
            return x
        buf = self._staged(x).contiguous().clone()
        dist.broadcast(buf, src=dist.get_global_rank(self.group, src), group=self.group)
        return buf.to(x.device)

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier(group=self.group)


def make_mesh(device: torch.device | str | None = None, group=None) -> EnvMesh:
    """The env mesh of this process: every rank of ``group`` (the default
    group) when ``torch.distributed`` is initialised, else this process alone.
    ``device`` defaults to this rank's card, ``cuda:LOCAL_RANK`` (``cuda:0``
    outside a launcher); a bare ``"cuda"`` becomes the same."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        return EnvMesh(group, dist.get_rank(group), dist.get_world_size(group), device)
    if group is not None:
        raise ValueError("a process group was given but torch.distributed is not initialised")
    return EnvMesh(None, 0, 1, device)


def _map(fn, tree):
    """``fn`` on every tensor leaf of a (nested) NamedTuple, tuple or list."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


def shard_env_batch(tree, mesh: EnvMesh):
    """This rank's ``[lo, hi)`` slice of the leading env axis of every leaf of
    a global batch, on the mesh's device."""
    def leaf(x):
        lo, hi = mesh.shard_bounds(x.shape[0])
        return x[lo:hi].to(mesh.device)

    return _map(leaf, tree)


def replicate(tree, mesh: EnvMesh):
    """Every leaf of ``tree`` as rank 0 holds it (a broadcast; a no-op at
    world size 1), e.g. learner params initialised from a shared seed."""
    return _map(mesh.broadcast, tree)


def sharded_rollout_fn(
    config: NanogridConfig,
    mesh: EnvMesh,
    policy_fn: Callable[[torch.Tensor], torch.Tensor],
    num_steps: int | None = None,
):
    """A closed-loop rollout of this rank's envs through the plain engine.

    Returns ``rollout(params, states, obs, pv_shifts) -> (states', obs', (obs,
    rew, done))``: ``params`` (unbatched, or batched to this rank's envs),
    ``states`` and ``obs`` are this rank's shard (:func:`shard_env_batch`);
    ``pv_shifts (num_days, global_batch)`` are the day-end PV shifts of the
    **global** batch, which each rank slices (JAX's replicated day keys, as
    values), so that the sharded rollout equals the unsharded one bit for
    bit.  Chained days pass the previous trailing observation (the
    continuation invariant).  No collective is issued.
    """
    num_days = max(1, (num_steps or config.steps_per_day) // config.steps_per_day)

    def rollout(params: NanogridParams, states, obs, pv_shifts: torch.Tensor):
        if pv_shifts.shape[0] < num_days:
            raise ValueError(f"pv_shifts holds {pv_shifts.shape[0]} days, the rollout rolls {num_days}")
        lo, hi = mesh.shard_bounds(pv_shifts.shape[1])
        if hi - lo != states.t.shape[0]:
            raise ValueError(f"pv_shifts cover {pv_shifts.shape[1]} envs, not {mesh.world_size} x "
                             f"{states.t.shape[0]}")
        trajs, obs0 = [], obs
        for d in range(num_days):
            states, traj = fused_day_rollout(config, params, states, policy_fn, obs0=obs0,
                                             next_pv_shift=pv_shifts[d, lo:hi].to(states.soc.device))
            obs0 = traj[0][-1]
            trajs.append(traj)
        obs_traj, rewards, dones = (torch.cat(xs, dim=0) for xs in zip(*trajs))
        return states, obs_traj[-1], (obs_traj, rewards, dones)

    return rollout
