"""The DDPG collection day: kernel K9 with its plain twin.

Replaces ``pallas_ddpg_collect_day`` and ``pallas_ddpg_collect_day_seeded``
of ``smart_nanogrid_gym_tpu/ops/pallas_collect.py`` (``_ddpg_collect_call``):
one fresh generated day per env under the deterministic DDPG actor plus
Ornstein-Uhlenbeck exploration noise, in one launch, writing the day's
replay transitions:

- :func:`ddpg_collect_day`: generation from explicit uniforms ``(T, 5, N,
  B)`` and an explicit PV shift;
- :func:`ddpg_collect_day_seeded`: the uniforms and the fresh day's PV shift
  drawn in the kernel from Philox keyed by ``(seed, env)``, with K2's kinds
  (:func:`.philox.collect_day_draws`), so that K2 and K9 generate the same
  days at the same seed.

In both the OU sequence ``ou (T, A, B)`` is an explicit input
(pallas_collect.py:461-494).  Each step runs K5's step body with the DDPG
actor: ``a = clip(low + (tanh(mu(obs)) + 1)·0.5·(high − low) + ou[t], low,
high)`` (pallas_collect.py:133-149); the env consumes ``a`` and the replay
stores it.  Outputs: ``obs (T, F, B)``, the clipped action ``(T, A, B)``,
``rewards (T, B)``, ``next_obs (T, F, B)`` (``next_obs[t] = obs[t+1]`` and
the trailing day-end observation at ``T − 1``, :152-175) and ``batt_final
(B,)``.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..utils.profiling import spanned
from . import _build
from ._build import kernel_device
from .gen_policy_rollout import (
    ActorWeights,
    actor_weights,
    check_collect_block,
    check_policy_config,
    ddpg_action,
    gen_policy_step,
    policy_day_costs,
    policy_kwargs,
    ring_block,
)
from .gen_rollout import F32, Traces, div, fresh_carry, kernel_traces, pv_shift_from_uniform, sum_rows
from .param_guard import W_VEH
from .philox import collect_day_draws


def ddpg_weights(config: NanogridConfig, net, device: torch.device) -> ActorWeights:
    """``net`` (a :class:`..solvers.networks.DDPGActor` or its 6 leaves) in
    the kernels' layout, f32 on ``device``."""
    if isinstance(net, nn.Module):
        return actor_weights(config, net, device, actor="ddpg")
    leaves = list(net)
    if len(leaves) != 6:
        raise ValueError(f"a DDPG actor has 6 leaves, got {len(leaves)}")
    F, A = leaves[0].shape[1], leaves[4].shape[0]
    if F != config.obs_dim or A != config.num_actions:
        raise ValueError(f"actor is {F}->{A}, config needs {config.obs_dim}->{config.num_actions}")

    def t(x, column=False):
        x = x.detach().to(device=device, dtype=F32)
        return (x[:, None] if column else x).contiguous()

    low, high = config.action_bounds()
    return ActorWeights(t(leaves[0]), t(leaves[1], True), t(leaves[2]), t(leaves[3], True),
                        t(leaves[4]), t(leaves[5], True),
                        torch.as_tensor(low, device=device)[:, None], torch.as_tensor(high, device=device)[:, None])


def _hidden(weights: ActorWeights) -> tuple[int, int]:
    return weights.w1.shape[0], weights.w2.shape[0]


def final_observation(config: NanogridConfig, traces: Traces, carry: dict, batt_soc, pv_shift):
    """The trailing day-end observation ``(F, B)`` (``_final_observe``,
    pallas_collect.py:152-175): the t > 0 rows at trace offset ``T − 1``
    with the carries after the last step."""
    o = config.steps_per_day - 1
    B = pv_shift.shape[0]
    price_norm, rad_norm = traces.price_norm, traces.rad_norm
    if config.pv_system:
        rows = [rad_norm[o] * pv_shift, price_norm[o].expand(B)]
        rows += [rad_norm[o + i] * pv_shift for i in range(1, 4)]
        rows += [price_norm[o + i].expand(B) for i in range(1, 4)]
    else:
        rows = [price_norm[o + i].expand(B) for i in range(4)]
    parts = [torch.stack(rows), carry["prev_col"], div(carry["prev_depcol"], 24.0)]
    if config.battery_system:
        parts.append(batt_soc[None])
    return torch.cat(parts)


def _explore(w: ActorWeights, ou_t: torch.Tensor, record: dict, obs: torch.Tensor) -> torch.Tensor:
    """The DDPG actor plus the step's OU noise, clipped to the box; records
    the observation and the clipped action."""
    action = torch.clamp(ddpg_action(w, obs) + ou_t, w.low, w.high)
    record.update(obs=obs, act=action)
    return action


def ddpg_collect_day_plain(config: NanogridConfig, traces: Traces, weights: ActorWeights,
                           uniforms, ou_seq, pv_shift, batt_soc):
    """Plain twin of K9 on f32 tensors."""
    T = config.steps_per_day
    kw = policy_kwargs(config)
    B = pv_shift.shape[0]
    carry = fresh_carry(kw["N"], B, pv_shift.device, kw["diff_caps"], kw["req_soc"])
    rows_list, recs = [], []
    for t in range(T):
        rec: dict = {}
        policy = functools.partial(_explore, weights, ou_seq[t], rec)
        rows, _, carry, batt_soc = gen_policy_step(
            t, uniforms[t].unbind(0), carry, batt_soc, traces, pv_shift, policy, T=T, **kw)
        rows["pen"] = sum_rows(rows["pen"])
        rows_list.append(rows)
        recs.append(rec)
    stacked = {k: torch.stack([r[k] for r in rows_list]) for k in rows_list[0]}
    cost = policy_day_costs(stacked, traces.price[:T, None], traces.solar[:T, None], pv_shift,
                            dt=kw["dt"], pv=kw["pv"], batt=kw["batt"])
    rewards = -(cost + W_VEH * stacked["pen"])
    obs = torch.stack([r["obs"] for r in recs])
    act = torch.stack([r["act"] for r in recs])
    last = final_observation(config, traces, carry, batt_soc, pv_shift)
    next_obs = torch.cat([obs[1:], last[None]])
    return obs, act, rewards, next_obs, batt_soc


def _outputs(config: NanogridConfig, B: int, device):
    T, F, A = config.steps_per_day, config.obs_dim, config.num_actions
    return (torch.empty((T, F, B), dtype=F32, device=device), torch.empty((T, A, B), dtype=F32, device=device),
            torch.empty((T, B), dtype=F32, device=device), torch.empty((T, F, B), dtype=F32, device=device),
            torch.empty((B,), dtype=F32, device=device))


def _check_ou(config: NanogridConfig, ou_seq: torch.Tensor, B: int) -> None:
    want = (config.steps_per_day, config.num_actions, B)
    if tuple(ou_seq.shape) != want:
        raise ValueError(f"ou_seq must be {want}, got {tuple(ou_seq.shape)}")


# K9's k-rows of W1 and W2 are padded to whole tiles of its two layers
# (csrc/day_step.cuh::DdpgCollect: R1 = 8 and R2 = 4 rows)
PAD1, PAD2 = 8, 4


def k9_block(weights: ActorWeights, lib) -> torch.Tensor:
    """The actor in K9's layout (:func:`.gen_policy_rollout.ring_block`):
    ``W1`` and ``W2`` k-major with their k-rows padded, so that the kernel
    streams each chunk of k-rows through its shared-memory ring as one bulk
    copy, then ``b1, b2, W3, b3, low, high``."""
    block = ring_block(weights, PAD1, PAD2)
    if block.numel() != lib.ngk_collect_weights_size():
        raise ValueError(f"actor block has {block.numel()} floats, the kernel library "
                         f"expects {lib.ngk_collect_weights_size()}")
    return block


def _library(config, traces, weights, device):
    hidden = _hidden(weights)
    lib = _build.load(_build.config_spec(config, hidden, "ddpg"), device)
    check_collect_block(config, traces, lib, hidden)
    return lib


def ddpg_collect_day(config: NanogridConfig, params: NanogridParams, net, uniforms: torch.Tensor,
                     ou_seq: torch.Tensor, pv_shift: torch.Tensor, batt_soc: torch.Tensor):
    """One DDPG collection day per env from explicit draws (K9).

    ``uniforms (T, 5, N, B)``, ``ou_seq (T, A, B)``, ``pv_shift (B,)``,
    ``batt_soc (B,)``; ``net`` is a :class:`..solvers.networks.DDPGActor` or
    its 6 leaves.  Returns ``(obs (T, F, B), act (T, A, B), rewards (T, B),
    next_obs (T, F, B), batt_final (B,))``.  Any batch size works.
    """
    check_policy_config(config, params, "ddpg_collect_day")
    T, N = config.steps_per_day, config.num_chargers
    B = pv_shift.shape[0]
    if tuple(uniforms.shape) != (T, 5, N, B):
        raise ValueError(f"uniforms must be ({T}, 5, {N}, {B}), got {tuple(uniforms.shape)}")
    _check_ou(config, ou_seq, B)
    device = uniforms.device
    traces = kernel_traces(params, device)
    weights = ddpg_weights(config, net, device)
    if not kernel_device(uniforms):
        return ddpg_collect_day_plain(config, traces, weights, uniforms.to(F32), ou_seq.to(F32),
                                      pv_shift.to(F32), batt_soc.to(F32))

    u = _build.check_f32(uniforms, "uniforms")
    ou = _build.check_f32(ou_seq.contiguous(), "ou_seq")
    pv = _build.check_f32(pv_shift, "pv_shift")
    batt = _build.check_f32(batt_soc.contiguous(), "batt_soc")
    outs = _outputs(config, B, device)
    lib = _library(config, traces, weights, device)
    _build.launch(
        "ddpg_collect_day", lib.ngk_ddpg_collect_day,
        traces.price, traces.price_norm, traces.price_norm.numel(), traces.rad_norm,
        traces.rad_norm.numel(), traces.solar, u, ou, batt, pv, k9_block(weights, lib), *outs,
        B, *_build.day_dims(config), device=device,
    )
    return outs


def ddpg_collect_day_seeded_plain(config: NanogridConfig, traces: Traces, weights: ActorWeights,
                                  seed: int, ou_seq, batt_soc, batch: int):
    """Plain twin of K9 seeded: the explicit twin fed the Philox day of ``seed``."""
    u, u_pv = collect_day_draws(seed, batch, config.steps_per_day, config.num_chargers, batt_soc.device)
    return ddpg_collect_day_plain(config, traces, weights, u, ou_seq.to(F32), pv_shift_from_uniform(u_pv),
                                  batt_soc.to(F32))


@spanned("collect")
def ddpg_collect_day_seeded(config: NanogridConfig, params: NanogridParams, net, seed: int,
                            ou_seq: torch.Tensor, batt_soc: torch.Tensor, batch: int,
                            check_params: bool = True):
    """One DDPG collection day per env with the day drawn in the kernel (K9 seeded).

    The generation uniforms and the fresh day's PV shift come from Philox
    keyed by ``(seed, env)``; ``ou_seq (T, A, batch)`` is the exploration
    noise and ``batt_soc (batch,)`` the carried battery.  Returns the tuple
    of :func:`ddpg_collect_day`.  ``check_params=False`` skips the param
    guard for callers that ran it once already.
    """
    if check_params:
        check_policy_config(config, params, "ddpg_collect_day_seeded")
    elif config.lookahead != 3:
        raise ValueError("ddpg_collect_day_seeded bakes the reference 3-step observation lookahead")
    if tuple(batt_soc.shape) != (batch,):
        raise ValueError(f"batt_soc must be ({batch},), got {tuple(batt_soc.shape)}")
    _check_ou(config, ou_seq, batch)
    device = batt_soc.device
    traces = kernel_traces(params, device)
    weights = ddpg_weights(config, net, device)
    if not kernel_device(batt_soc):
        return ddpg_collect_day_seeded_plain(config, traces, weights, seed, ou_seq, batt_soc, batch)

    ou = _build.check_f32(ou_seq.contiguous(), "ou_seq")
    batt = _build.check_f32(batt_soc.contiguous(), "batt_soc")
    outs = _outputs(config, batch, device)
    lib = _library(config, traces, weights, device)
    _build.launch(
        "ddpg_collect_day_seeded", lib.ngk_ddpg_collect_day_seeded,
        traces.price, traces.price_norm, traces.price_norm.numel(), traces.rad_norm,
        traces.rad_norm.numel(), traces.solar, int(seed) & 0xFFFFFFFF, ou, batt, k9_block(weights, lib),
        *outs, batch, *_build.day_dims(config), device=device,
    )
    return outs
