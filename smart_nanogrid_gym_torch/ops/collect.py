"""The PPO collection day: kernels K1 and K2 with their plain twin.

Replaces ``smart_nanogrid_gym_tpu/ops/pallas_collect.py`` (the PPO entries):
one fresh generated day per env under the *stochastic* actor-critic, in one
launch, writing the trajectory the update sweep reads:

- :func:`ppo_collect_day` (K1, ``pallas_ppo_collect_day``): generation from
  explicit uniforms ``(T, 5, N, B)``, action noise from explicit standard
  normals ``(T, A, B)``, an explicit PV shift;
- :func:`ppo_collect_day_seeded` (K2, ``pallas_ppo_collect_day_seeded``): the
  uniforms, the normals (Box-Muller) and the fresh day's PV shift drawn in
  the kernel from Philox keyed by ``(seed, env)`` (:func:`.philox.collect_draws`).

Each step runs K5's step body with the stochastic actor in place of the
deterministic one: ``a_raw = mean + exp(log_std)·normal``; the env consumes
the action clipped to the box while the trajectory records ``a_raw``, its
Gaussian log-prob (``pallas_collect.py:104-111``, summed over actions in
index order) and the ``vf`` torso's value.  Outputs follow the JAX layout:
``obs (T, F, B)``, ``act_raw (T, A, B)``, ``logp``/``value``/``rewards (T, B)``,
``batt_final (B,)``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import nn

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..utils.profiling import spanned
from . import _build
from ._build import kernel_device
from .gen_policy_rollout import (
    ActorWeights,
    check_collect_block,
    check_policy_config,
    dense,
    gen_policy_step,
    policy_day_costs,
    policy_kwargs,
)
from .gen_rollout import F32, Traces, fresh_carry, kernel_traces, pv_shift_from_uniform, sum_rows
from .param_guard import W_VEH
from .philox import collect_draws
from .ppo_sweep import LOG_2PI


class CollectWeights(NamedTuple):
    """The actor-critic in the kernels' layout (f32): the ``pi`` torso with
    the action bounds, the ``vf`` torso ``(w1, b1, w2, b2, w3 (1, H2), b3
    (1, 1))`` and ``log_std (A, 1)``."""

    pi: ActorWeights
    vf: tuple
    log_std: torch.Tensor

    def packed(self) -> torch.Tensor:
        """One block in the order ``csrc/day_step.cuh`` reads it."""
        parts = [self.pi.packed()] + [x.reshape(-1) for x in self.vf] + [self.log_std.reshape(-1)]
        return torch.cat(parts).contiguous()


def collect_weights(config: NanogridConfig, net, device: torch.device) -> CollectWeights:
    """``net`` (an :class:`ActorCritic` or its 13 leaves) as f32 on ``device``."""
    from ..solvers.networks import actor_critic_leaves

    leaves = actor_critic_leaves(net) if isinstance(net, nn.Module) else list(net)
    if len(leaves) != 13:
        raise ValueError(f"the collection kernels take an actor-critic of 13 leaves, got {len(leaves)}")
    F, A = leaves[0].shape[1], leaves[4].shape[0]
    if F != config.obs_dim or A != config.num_actions:
        raise ValueError(f"actor-critic is {F}->{A}, config needs {config.obs_dim}->{config.num_actions}")

    def t(x, column=False):
        x = x.detach().to(device=device, dtype=F32)
        return (x[:, None] if column else x).contiguous()

    low, high = config.action_bounds()
    pi = ActorWeights(t(leaves[0]), t(leaves[1], True), t(leaves[2]), t(leaves[3], True),
                      t(leaves[4]), t(leaves[5], True),
                      torch.as_tensor(low, device=device)[:, None],
                      torch.as_tensor(high, device=device)[:, None])
    vf = (t(leaves[6]), t(leaves[7], True), t(leaves[8]), t(leaves[9], True),
          t(leaves[10]), t(leaves[11], True))
    return CollectWeights(pi, vf, t(leaves[12], True))


def collect_policy(w: CollectWeights, normal: torch.Tensor, record: dict, obs: torch.Tensor):
    """The stochastic actor on an ``(F, B)`` block (``_collect_policy``,
    pallas_collect.py:85-116): records obs, raw action, log-prob and value;
    returns the action clipped to the box."""
    h = torch.tanh(dense(w.pi.w1, w.pi.b1, obs))
    h = torch.tanh(dense(w.pi.w2, w.pi.b2, h))
    mean = dense(w.pi.w3, w.pi.b3, h)
    vw1, vb1, vw2, vb2, vw3, vb3 = w.vf
    g = torch.tanh(dense(vw1, vb1, obs))
    g = torch.tanh(dense(vw2, vb2, g))
    value = dense(vw3, vb3, g)[0]
    std = torch.exp(w.log_std)
    a_raw = mean + std * normal
    diff = a_raw - mean
    var = std * std
    logp = sum_rows(-0.5 * (diff * diff / var + 2.0 * w.log_std + LOG_2PI))
    record.update(obs=obs, act=a_raw, logp=logp, value=value)
    return torch.clamp(a_raw, w.pi.low, w.pi.high)


# --------------------------------------------------------------------- K1 ---

def ppo_collect_day_plain(config: NanogridConfig, traces: Traces, weights: CollectWeights,
                          uniforms, normals, pv_shift, batt_soc):
    """Plain twin of K1 on f32 tensors."""
    T = config.steps_per_day
    kw = policy_kwargs(config)
    B = pv_shift.shape[0]
    carry = fresh_carry(kw["N"], B, pv_shift.device, kw["diff_caps"], kw["req_soc"])
    rows_list, recs = [], []
    for t in range(T):
        rec: dict = {}
        policy = functools.partial(collect_policy, weights, normals[t], rec)
        rows, _, carry, batt_soc = gen_policy_step(
            t, uniforms[t].unbind(0), carry, batt_soc, traces, pv_shift, policy, T=T, **kw)
        rows["pen"] = sum_rows(rows["pen"])
        rows_list.append(rows)
        recs.append(rec)
    stacked = {k: torch.stack([r[k] for r in rows_list]) for k in rows_list[0]}
    cost = policy_day_costs(stacked, traces.price[:T, None], traces.solar[:T, None], pv_shift,
                            dt=kw["dt"], pv=kw["pv"], batt=kw["batt"])
    rewards = -(cost + W_VEH * stacked["pen"])
    obs, act, logp, value = (torch.stack([r[k] for r in recs]) for k in ("obs", "act", "logp", "value"))
    return obs, act, logp, value, rewards, batt_soc


def _outputs(config: NanogridConfig, B: int, device):
    T, F, A = config.steps_per_day, config.obs_dim, config.num_actions
    return (torch.empty((T, F, B), dtype=F32, device=device), torch.empty((T, A, B), dtype=F32, device=device),
            torch.empty((T, B), dtype=F32, device=device), torch.empty((T, B), dtype=F32, device=device),
            torch.empty((T, B), dtype=F32, device=device), torch.empty((B,), dtype=F32, device=device))


def _hidden(weights: CollectWeights) -> tuple[int, int]:
    return weights.pi.w1.shape[0], weights.pi.w2.shape[0]


def _library(config, traces, weights, device):
    """The library of K1/K2, whose shared memory holds the actor-critic: the
    learner's 64×64 torsos fit, a 256×256 pair does not."""
    hidden = _hidden(weights)
    lib = _build.load(_build.config_spec(config, hidden), device)
    check_collect_block(config, traces, lib, hidden)
    return lib


def _block(weights: CollectWeights, lib) -> torch.Tensor:
    block = weights.packed()
    if block.numel() != lib.ngk_collect_weights_size():
        raise ValueError(f"actor-critic block has {block.numel()} floats, the kernel library "
                         f"expects {lib.ngk_collect_weights_size()}")
    return block


def ppo_collect_day(config: NanogridConfig, params: NanogridParams, net, uniforms: torch.Tensor,
                    normals: torch.Tensor, pv_shift: torch.Tensor, batt_soc: torch.Tensor):
    """One collection day per env from explicit draws (K1).

    ``uniforms (T, 5, N, B)``, ``normals (T, A, B)``, ``pv_shift (B,)``,
    ``batt_soc (B,)``; ``net`` is an :class:`ActorCritic` or its 13 leaves.
    Returns ``(obs (T, F, B), act_raw (T, A, B), logp (T, B), value (T, B),
    rewards (T, B), batt_final (B,))``.  Any batch size works.
    """
    check_policy_config(config, params, "ppo_collect_day")
    T, N, A = config.steps_per_day, config.num_chargers, config.num_actions
    B = pv_shift.shape[0]
    if tuple(uniforms.shape) != (T, 5, N, B):
        raise ValueError(f"uniforms must be ({T}, 5, {N}, {B}), got {tuple(uniforms.shape)}")
    if tuple(normals.shape) != (T, A, B):
        raise ValueError(f"normals must be ({T}, {A}, {B}), got {tuple(normals.shape)}")
    device = uniforms.device
    traces = kernel_traces(params, device)
    weights = collect_weights(config, net, device)
    if not kernel_device(uniforms):
        return ppo_collect_day_plain(config, traces, weights, uniforms.to(F32), normals.to(F32),
                                     pv_shift.to(F32), batt_soc.to(F32))

    u = _build.check_f32(uniforms, "uniforms")
    nrm = _build.check_f32(normals, "normals")
    pv = _build.check_f32(pv_shift, "pv_shift")
    batt = _build.check_f32(batt_soc.contiguous(), "batt_soc")
    outs = _outputs(config, B, device)
    lib = _library(config, traces, weights, device)
    _build.launch(
        "ppo_collect_day", lib.ngk_ppo_collect_day,
        traces.price, traces.price_norm, traces.price_norm.numel(), traces.rad_norm,
        traces.rad_norm.numel(), traces.solar, u, nrm, batt, pv, _block(weights, lib), *outs,
        B, *_build.day_dims(config), device=device,
    )
    return outs


# --------------------------------------------------------------------- K2 ---

def ppo_collect_day_seeded_plain(config: NanogridConfig, traces: Traces, weights: CollectWeights,
                                 seed: int, batt_soc, batch: int):
    """Plain twin of K2: K1's twin fed the Philox draws of ``seed``."""
    u, normals, u_pv = collect_draws(seed, batch, config.steps_per_day, config.num_chargers,
                                     config.num_actions, batt_soc.device)
    return ppo_collect_day_plain(config, traces, weights, u, normals, pv_shift_from_uniform(u_pv),
                                 batt_soc.to(F32))


@spanned("collect")
def ppo_collect_day_seeded(config: NanogridConfig, params: NanogridParams, net, seed: int,
                           batt_soc: torch.Tensor, batch: int, check_params: bool = True):
    """One collection day per env with every draw made in the kernel (K2).

    The generation uniforms, the action normals and the fresh day's PV shift
    come from Philox keyed by ``(seed, env)``; ``batt_soc (batch,)`` is the
    carried battery.  Returns the tuple of :func:`ppo_collect_day`.
    ``check_params=False`` skips the param guard for callers that ran it
    once already (the learner checks when it builds its step).
    """
    if check_params:
        check_policy_config(config, params, "ppo_collect_day_seeded")
    elif config.lookahead != 3:
        raise ValueError("ppo_collect_day_seeded bakes the reference 3-step observation lookahead")
    if tuple(batt_soc.shape) != (batch,):
        raise ValueError(f"batt_soc must be ({batch},), got {tuple(batt_soc.shape)}")
    device = batt_soc.device
    traces = kernel_traces(params, device)
    weights = collect_weights(config, net, device)
    if not kernel_device(batt_soc):
        return ppo_collect_day_seeded_plain(config, traces, weights, seed, batt_soc, batch)

    batt = _build.check_f32(batt_soc.contiguous(), "batt_soc")
    outs = _outputs(config, batch, device)
    lib = _library(config, traces, weights, device)
    _build.launch(
        "ppo_collect_day_seeded", lib.ngk_ppo_collect_day_seeded,
        traces.price, traces.price_norm, traces.price_norm.numel(), traces.rad_norm,
        traces.rad_norm.numel(), traces.solar, int(seed) & 0xFFFFFFFF, batt, _block(weights, lib),
        *outs, batch, *_build.day_dims(config), device=device,
    )
    return outs
