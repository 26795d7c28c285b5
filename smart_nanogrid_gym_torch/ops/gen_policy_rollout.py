"""Fused day generation + deterministic actor closed loop: kernels K5 and K6
with their twins.

Replaces ``smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py`` with
f32 operands, for both actors of the JAX kernels: ``actor="ppo"`` (the PPO
actor's mean, 64-64 tanh torso, clipped to the action box) and
``actor="ddpg"`` (the DDPG actor, 400-300 ReLU torso, squashed into the box
by ``tanh`` with no clip, pallas_gen_policy_rollout.py:148-154):

- :func:`gen_policy_day` (K5, ``pallas_gen_policy_day``): one day per env from
  an explicit uniform block, the deterministic actor, bidirectional charger
  and BESS physics (v2x included); returns ``rewards (T, B)``, ``actions (T,
  A, B)``, ``soc_final (N, B)`` and ``batt_final (B,)``;
- :func:`gen_policy_multiday` (K6, ``pallas_gen_policy_multiday``):
  ``num_days`` Philox days per env in one launch with the battery carried
  across days; returns ``stats (3, B)``: Σ day return, Σ (day return)², final
  battery SoC.

K6 takes the JAX kernel's bf16 operand option, ``mlp_dtype`` (for both
actors; K5 has none, as in the JAX package): the weight matrices are rounded
to bf16 (:func:`actor_weights`), the observation, h1 and h2 right before
their products, and the products accumulate in f32; biases, tanh, ReLU, the
clip and the squash stay f32 (pallas_gen_policy_rollout.py:140-154,
404-420).

The twins mirror the Pallas step body; the actor's products run as
multiply-add loops in input order, the order the CUDA kernels use in f32, so
the f32 kernels are bit-equal to them (the product of two bf16 values is
exact in f32).  K5 and K6 run K9's design for every torso (an env warp,
register-tiled products, W1 and W2 streamed through a shared-memory ring in
the layout of :func:`k6_block`, its shared memory checked by
:func:`check_k6_block`); K6's bf16 option runs there on the tensor cores, so
that option meets its twin to a stated tolerance, not bit for bit.  The
launches of the DDPG actor count under ``*_ddpg`` names, those of a PPO
torso whose f32 block alone leaves no room for the traces in shared memory
(the bench's 256x256: the library says which, ``ngk_block_actor``) under
``*_block`` names.  K11b (:mod:`.policy_rollout`) takes K6's design for
every PPO torso.  K6 refuses torsos of more than 768 hidden units, as the
JAX kernel does.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, NamedTuple

import torch
from torch import nn

from ..core.config import NanogridConfig
from ..core.params import NanogridParams
from ..utils.profiling import spanned
from . import _build
from ._build import MAX_SHARED_BYTES, bf16_operands, kernel_device, round_bf16
from .gen_rollout import (
    F32,
    Traces,
    div,
    fresh_carry,
    generate_column,
    kernel_traces,
    next_carry,
    pv_shift_from_uniform,
    step_kwargs,
    sum_rows,
    vehicle_penalty,
)
from .param_guard import (B_CAP, B_EFF, B_MAXP, BATT_DOD, BATT_INIT_SOC, DEFAULT_CAP, EFF, GAIN, GRID_W, MAX_P, SELL,
                          W_BATT, W_VEH, check_baked_params)
from .philox import day_uniforms

if TYPE_CHECKING:
    from ..solvers.networks import ActorCritic, DDPGActor

MAX_HIDDEN_SUM = 768                 # K6's torso limit (pallas_gen_policy_rollout.py:590-596)


class ActorWeights(NamedTuple):
    """The actor torso in the kernels' layout (f32): ``w (out, in)``, ``b (out, 1)``."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    low: torch.Tensor   # (A, 1)
    high: torch.Tensor  # (A, 1)

    def packed(self) -> torch.Tensor:
        """One contiguous block in the order of ``Cfg::WEIGHTS`` (the actor
        part of K1/K2's block, ``ops/collect.py``)."""
        return torch.cat([x.reshape(-1) for x in self]).contiguous()


def actor_weights(config: NanogridConfig, net: ActorCritic | DDPGActor, device: torch.device,
                  actor: str = "ppo", mlp_dtype=torch.float32) -> ActorWeights:
    """The actor torso of ``net`` (``pi`` of an :class:`ActorCritic` for
    ``actor="ppo"``, ``mu`` of a :class:`DDPGActor` for ``"ddpg"``) and the
    action bounds as f32 on ``device``; with ``mlp_dtype=torch.bfloat16``
    the weight matrices hold their bf16 roundings (``_actor_blocks``)."""
    if actor not in _build.ACTORS:
        raise ValueError(f"actor must be one of {tuple(_build.ACTORS)}, got {actor!r}")
    pi = getattr(net, "pi" if actor == "ppo" else "mu", None)
    if pi is None:
        raise ValueError(f"actor={actor!r} needs {'an ActorCritic' if actor == 'ppo' else 'a DDPGActor'}, "
                         f"got {type(net).__name__}")
    if pi.num_layers != 3:
        raise ValueError("the actor kernels take a torso of two hidden layers")
    if net.obs_dim != config.obs_dim or net.action_dim != config.num_actions:
        raise ValueError(f"actor is {net.obs_dim}->{net.action_dim}, config needs "
                         f"{config.obs_dim}->{config.num_actions}")

    def t(x):
        return x.detach().to(device=device, dtype=F32).contiguous()

    bf16 = bf16_operands(mlp_dtype)

    def weight(x):
        return round_bf16(t(x)) if bf16 else t(x)

    layers = [getattr(pi, f"Dense_{i}") for i in range(3)]
    low, high = config.action_bounds()
    return ActorWeights(
        weight(layers[0].weight), t(layers[0].bias)[:, None],
        weight(layers[1].weight), t(layers[1].bias)[:, None],
        weight(layers[2].weight), t(layers[2].bias)[:, None],
        torch.as_tensor(low, device=device)[:, None], torch.as_tensor(high, device=device)[:, None],
    )


def dense(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``w @ x + b`` as a multiply-add loop over the input in index order;
    with ``bf16`` the operand ``x`` is rounded to bf16 first (``w`` holds
    bf16 values already)."""
    if bf16:
        x = round_bf16(x)
    acc = w[:, 0:1] * x[0:1]
    for k in range(1, w.shape[1]):
        acc = acc + w[:, k:k + 1] * x[k:k + 1]
    return acc + b


def actor_mean(w: ActorWeights, obs: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Deterministic PPO action ``(A, B)`` for observations ``(F, B)``."""
    h1 = torch.tanh(dense(w.w1, w.b1, obs, bf16))
    h2 = torch.tanh(dense(w.w2, w.b2, h1, bf16))
    return torch.clamp(dense(w.w3, w.b3, h2, bf16), w.low, w.high)


def relu(x: torch.Tensor) -> torch.Tensor:
    """``x > 0 ? x : 0``, as the kernels write it."""
    return torch.where(x > 0, x, torch.zeros((), dtype=x.dtype, device=x.device))


def ddpg_action(w: ActorWeights, obs: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Deterministic DDPG action ``(A, B)`` for observations ``(F, B)``:
    ``low + (tanh(mu) + 1)·0.5·(high − low)``, no clip."""
    h1 = relu(dense(w.w1, w.b1, obs, bf16))
    h2 = relu(dense(w.w2, w.b2, h1, bf16))
    return w.low + (torch.tanh(dense(w.w3, w.b3, h2, bf16)) + 1.0) * 0.5 * (w.high - w.low)


def _policy(actor: str, weights: ActorWeights, bf16: bool = False):
    return functools.partial(actor_mean if actor == "ppo" else ddpg_action, weights, bf16=bf16)


def trace_floats(config: NanogridConfig, traces: Traces) -> int:
    """Floats of the traces a day kernel keeps in shared memory."""
    return traces.rad_norm.numel() + traces.price_norm.numel() + 2 * config.steps_per_day


def check_collect_block(config: NanogridConfig, traces: Traces, lib, hidden: tuple[int, int]) -> None:
    """Raise before any launch when a collection kernel's shared memory (the
    library's ``ngk_collect_smem_floats``: K1/K2's actor-critic or K9's
    weight ring, the block's activations and draws) and the traces exceed a
    block's."""
    need = 4 * (lib.ngk_collect_smem_floats() + trace_floats(config, traces))
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"torsos {hidden[0]}x{hidden[1]} and the traces need {need} bytes of shared memory "
                         f"per block in the collection kernel, more than {MAX_SHARED_BYTES}; "
                         f"use collect_impl='plain'")


def check_k6_block(config: NanogridConfig, traces: Traces, lib, hidden: tuple[int, int], bf16: bool,
                   tables: bool = False) -> None:
    """Raise before any launch when the shared memory of K6's block-actor
    kernel, or K5's (the library's ``ngk_k6_smem_floats``: its weight ring,
    the activations, the head, the actions and the draws), or with
    ``tables`` K11b's instance of it (``ngk_k11b_smem_floats``: the table
    rows in place of the draws), and the traces exceed a block's (the
    port's counterpart of the JAX kernels' VMEM guard)."""
    floats = lib.ngk_k11b_smem_floats() if tables else lib.ngk_k6_smem_floats(int(bf16))
    need = 4 * (floats + trace_floats(config, traces))
    if need > MAX_SHARED_BYTES:
        kernels = "policy_day_rollout" if tables else "gen_policy_multiday and gen_policy_day"
        raise ValueError(f"actor torso {hidden[0]}x{hidden[1]} and the traces need {need} bytes of shared memory "
                         f"per block in the block actor of {kernels}, more than {MAX_SHARED_BYTES}; "
                         f"use the plain engine")


def k_major(w: torch.Tensor, pad: int) -> torch.Tensor:
    """``w (J, K)`` transposed to ``(K, J)`` with each k-row padded with zeros to a multiple of ``pad``."""
    return nn.functional.pad(w.T, (0, -w.shape[0] % pad))


def ring_block(weights: ActorWeights, pad1: int, pad2: int) -> torch.Tensor:
    """The actor in the f32 weight-ring layout of K6's block actor and K9
    (``csrc/day_step.cuh::F32Ring``): ``W1`` and ``W2`` k-major with their
    k-rows padded to whole tiles (``pad1``, ``pad2`` rows), so that each
    chunk of k-rows is one bulk copy, then ``b1, b2, W3, b3, low, high``."""
    w = weights
    parts = (k_major(w.w1, pad1), k_major(w.w2, pad2), w.b1, w.b2, w.w3, w.b3, w.low, w.high)
    return torch.cat([x.reshape(-1) for x in parts]).contiguous()


def mma_fragments(w: torch.Tensor) -> torch.Tensor:
    """``w (J, K)`` (bf16 values) as the A fragments of ``mma.m16n8k16`` in
    the order K6's bf16 kernel streams them (``csrc/day_step.cuh::Bf16Ring``):
    zero-padded to 16-row m-tiles and 16-input k-steps; k-step by k-step, m-tile
    by m-tile, lane ``(g, t)`` by lane, its words a0..a3 (rows g and g + 8,
    inputs 2t, 2t + 1 and then 2t + 8, 2t + 9), each word two bf16 of
    consecutive inputs, the lower input in the low half.  Returned as f32
    words (2 bytes a weight)."""
    J, K = w.shape
    MT, KS = -(-J // 16), -(-K // 16)
    padded = torch.zeros((MT * 16, KS * 16), dtype=torch.bfloat16, device=w.device)
    padded[:J, :K] = w.to(torch.bfloat16)
    # (mt, row half, g, ks, k half, t, pair) -> (ks, mt, g, t, k half, row half, pair)
    frags = padded.reshape(MT, 2, 8, KS, 2, 4, 2).permute(3, 0, 2, 5, 4, 1, 6)
    return frags.contiguous().reshape(-1).view(torch.float32)


def k6_block(weights: ActorWeights, lib, bf16: bool) -> torch.Tensor:
    """The actor in the layout of K6's block-actor kernel: the f32 ring
    layout with the library's tile pads (``ngk_k6_pad``), or with ``bf16``
    W1 and W2 as :func:`mma_fragments` (``weights`` from :func:`actor_weights`
    with ``mlp_dtype=torch.bfloat16``) and the rest f32; checked against the
    size the library reports."""
    w = weights
    if bf16:
        parts = (mma_fragments(w.w1), mma_fragments(w.w2), w.b1, w.b2, w.w3, w.b3, w.low, w.high)
        block = torch.cat([x.reshape(-1) for x in parts]).contiguous()
    else:
        block = ring_block(w, lib.ngk_k6_pad(1), lib.ngk_k6_pad(2))
    if block.numel() != lib.ngk_k6_weights_size(int(bf16)):
        raise ValueError(f"actor block has {block.numel()} floats, the kernel library "
                         f"expects {lib.ngk_k6_weights_size(int(bf16))}")
    return block


def policy_obs(traces: Traces, o: int, pv_shift, soc_rows, dep_o, batt_soc, *, pv: bool, batt: bool):
    """The observation ``(F, B)`` at trace offset ``o``: radiation and price
    now and three steps ahead, the SoC rows, the departure rows / 24 and the
    battery SoC."""
    B = pv_shift.shape[0]
    price_norm, rad_norm = traces.price_norm, traces.rad_norm
    if pv:
        rows = [rad_norm[o] * pv_shift, price_norm[o].expand(B)]
        rows += [rad_norm[o + i] * pv_shift for i in range(1, 4)]
        rows += [price_norm[o + i].expand(B) for i in range(1, 4)]
    else:
        rows = [price_norm[o + i].expand(B) for i in range(4)]
    parts = [torch.stack(rows), soc_rows, div(dep_o, 24.0)]
    if batt:
        parts.append(batt_soc[None])
    return torch.cat(parts)


def charger_physics(ch_act, soc_eff, cap_eff, calc, dt, occupied):
    """Power and new SoC ``(N, B)`` of the chargers, both branches, with the
    inverted discharge flag quirk (charger.py:122-132)."""
    zero = torch.zeros((), dtype=F32, device=ch_act.device)
    p_raw = ch_act * (MAX_P * EFF)
    p_dis = torch.where(calc >= 0.0, div(-(soc_eff * cap_eff), dt), p_raw)
    is_pos, is_neg = ch_act > 0, ch_act < 0
    power = torch.where(is_pos, p_raw, torch.where(is_neg, p_dis, zero))
    soc_new = torch.where(is_pos, torch.clamp(calc, max=1.0),
                          torch.where(is_neg, torch.clamp(calc, min=0.0), soc_eff))
    return torch.where(occupied, power, zero), soc_new


def battery_physics(ba, batt_soc, dt):
    """BESS physics under action ``ba (B,)``: ``(new SoC, power used, DoD
    penalty)``."""
    zero = torch.zeros((), dtype=F32, device=ba.device)
    p_calc = ba * (B_MAXP * B_EFF)
    b_calc = batt_soc + div(p_calc * dt, B_CAP)
    p_b_dis = torch.where(b_calc < 0.0, div(-(batt_soc * B_CAP), dt), p_calc)
    b_pos, b_neg = ba > 0, ba < 0
    batt_soc = torch.where(b_pos, torch.clamp(b_calc, max=1.0),
                           torch.where(b_neg, torch.clamp(b_calc, min=0.0), batt_soc))
    p_used = torch.where(b_pos, p_calc, torch.where(b_neg, p_b_dis, zero))
    gap = (BATT_DOD - batt_soc) * GAIN
    return batt_soc, p_used, torch.where(batt_soc < BATT_DOD, gap * gap, zero)


def charger_flows(power):
    """Total charging plus total discharging ``(B,)``, each summed in charger order."""
    zero = torch.zeros((), dtype=F32, device=power.device)
    return sum_rows(torch.where(power > 0, power, zero)) + sum_rows(torch.where(power < 0, power, zero))


def gen_policy_step(t, u5, c, batt_soc, traces: Traces, pv_shift, policy, *,
                    T, N, dt, pv, batt, penalty_mode, diff_caps, req_soc, k4, k10, k1):
    """One step (``_gen_policy_step`` + ``_gen_policy_physics``,
    pallas_gen_policy_rollout.py:63-277): generate column t, run ``policy``
    (``obs (F, B) -> clipped actions (A, B)``, the counterpart of the JAX
    ``policy_override``) on the step-(t-1) observation, apply the physics.
    Returns ``(rows, actions (A, B), carry, batt_soc)``; ``rows`` holds the
    ``(B,)`` inputs of the cost (``flows``, ``p_used``, ``dod``) and the
    per-charger penalty ``pen (N, B)``."""
    cols, gen = generate_column(t, u5, c, T=T, penalty_mode=penalty_mode, diff_caps=diff_caps,
                                req_soc=req_soc, k4=k4, k10=k10, k1=k1)
    arrives, occupied = cols["arrives"], cols["occupied"]
    zero = torch.zeros((), dtype=F32, device=pv_shift.device)

    if t == 0:  # reset's observation: generated column 0, reset-time check set
        pmask, dep_o = cols["mask_col"], cols["dep_col"]
        soc_rows = torch.where(arrives, cols["soc_t"], zero)
    else:
        pmask, dep_o, soc_rows = c["pmask"], c["prev_depcol"], c["prev_col"]

    actions = policy(policy_obs(traces, max(t - 1, 0), pv_shift, soc_rows, dep_o, batt_soc, pv=pv, batt=batt))

    # ---- charger physics, both branches (inverted discharge flag quirk) ----
    ch_act = actions[:N]
    soc_eff = torch.where(arrives, cols["soc_t"], c["prev_col"])
    p_raw = ch_act * (MAX_P * EFF)
    if diff_caps:
        cap_eff = torch.where(arrives, cols["cap_col"], c["prev_capcol"])
        calc = soc_eff + (p_raw * dt) / torch.where(cap_eff > 0, cap_eff, torch.ones_like(cap_eff))
    else:
        cap_eff = cols["occ_f"] * DEFAULT_CAP
        calc = soc_eff + div(p_raw * dt, DEFAULT_CAP)
    power, soc_new = charger_physics(ch_act, soc_eff, cap_eff, calc, dt, occupied)
    new_col = torch.where(occupied, soc_new, zero)

    out = {"flows": charger_flows(power), "pen": vehicle_penalty(c, pmask, req_soc)}
    if batt:
        batt_soc, out["p_used"], out["dod"] = battery_physics(actions[N], batt_soc, dt)
    return out, actions, next_carry(gen, cols, new_col, diff_caps, req_soc), batt_soc


def policy_day_costs(rows, price_col, solar_col, pv_shift, *, dt, pv, batt):
    """Grid cost of every step without the vehicle penalty
    (``_policy_day_rewards``); ``rows`` holds ``(T, B)`` stacks."""
    remaining = rows["flows"] - solar_col * pv_shift if pv else rows["flows"]
    grid_power = remaining + rows["p_used"] if batt else remaining
    grid_energy = grid_power * dt
    g_cost = torch.where(grid_energy < 0, grid_energy * (SELL * price_col), grid_energy * price_col)
    return GRID_W * torch.abs(g_cost) + W_BATT * (rows["dod"] if batt else 0.0)


def policy_kwargs(config: NanogridConfig) -> dict:
    return dict(N=config.num_chargers, batt=config.battery_system, **step_kwargs(config))


def _stack(rows_list, key):
    return torch.stack([r[key] for r in rows_list])


def check_policy_config(config: NanogridConfig, params: NanogridParams, kernel: str, **guard):
    check_baked_params(config, params, kernel, generation=True, **guard)
    if config.lookahead != 3:
        raise ValueError(f"{kernel} bakes the reference 3-step observation lookahead; "
                         "use the plain engine for other lookaheads")


def policy_library(config, device, weights, hidden, actor, traces, name, bf16=False):
    """The library of the actor, the actor block in the layout that kernel
    ``name`` reads, and its launch-count name: ``name`` with ``_ddpg`` for
    the DDPG actor, ``_block`` for a PPO torso whose f32 block alone fills
    shared memory (``ngk_block_actor``) and ``_bf16`` for bf16 operands.  K5
    (``gen_policy_day``), K6 (``gen_policy_multiday``) and K11b
    (``policy_day_rollout``) run K9's ring block for every torso: the block
    of :func:`k6_block`, checked by :func:`check_k6_block`, which raises a
    ``ValueError`` naming the limit, before any launch, for a torso the
    design cannot hold."""
    lib = _build.load(_build.config_spec(config, hidden, actor), device)
    check_k6_block(config, traces, lib, hidden, bf16, name == "policy_day_rollout")
    packed = k6_block(weights, lib, bf16)
    suffix = "_ddpg" if actor == "ddpg" else ("_block" if lib.ngk_block_actor() else "")
    return lib, packed, name + suffix + ("_bf16" if bf16 else "")


# --------------------------------------------------------------------- K5 ---

def gen_policy_day_plain(config, traces: Traces, weights: ActorWeights, uniforms, pv_shift, batt_soc,
                         actor: str = "ppo", mlp_dtype=torch.float32):
    """Plain twin of K5 on f32 tensors.  ``mlp_dtype`` runs K6's step body
    under its bf16 option on explicit days (K5 itself has none), with
    ``weights`` from :func:`actor_weights` with the same ``mlp_dtype``."""
    T = config.steps_per_day
    kw = policy_kwargs(config)
    B = pv_shift.shape[0]
    carry = fresh_carry(kw["N"], B, pv_shift.device, kw["diff_caps"], kw["req_soc"])
    policy = _policy(actor, weights, bf16_operands(mlp_dtype))
    rows_list, actions = [], []
    for t in range(T):
        rows, act, carry, batt_soc = gen_policy_step(
            t, uniforms[t].unbind(0), carry, batt_soc, traces, pv_shift, policy, T=T, **kw)
        rows["pen"] = sum_rows(rows["pen"])
        rows_list.append(rows)
        actions.append(act)
    stacked = {k: _stack(rows_list, k) for k in rows_list[0]}
    cost = policy_day_costs(stacked, traces.price[:T, None], traces.solar[:T, None], pv_shift,
                            dt=kw["dt"], pv=kw["pv"], batt=kw["batt"])
    rewards = -(cost + W_VEH * stacked["pen"])
    return rewards, torch.stack(actions), carry["prev_col"], batt_soc


def gen_policy_day(config: NanogridConfig, params: NanogridParams, net: ActorCritic | DDPGActor,
                   uniforms: torch.Tensor, pv_shift: torch.Tensor,
                   batt_soc: torch.Tensor | None = None, actor: str = "ppo"):
    """Generate a fresh day per env and roll the deterministic actor over it (K5).

    ``uniforms (T, 5, N, B)``, ``pv_shift (B,)``, ``batt_soc (B,)`` (0.5 when
    omitted); ``net`` is an :class:`ActorCritic` for ``actor="ppo"``, a
    :class:`DDPGActor` for ``"ddpg"``.  Returns ``(rewards (T, B), actions
    (T, A, B), soc_final (N, B), batt_final (B,))``.
    """
    check_policy_config(config, params, "gen_policy_day")
    T, N, A = config.steps_per_day, config.num_chargers, config.num_actions
    B = pv_shift.shape[0]
    if tuple(uniforms.shape) != (T, 5, N, B):
        raise ValueError(f"uniforms must be ({T}, 5, {N}, {B}), got {tuple(uniforms.shape)}")
    device = uniforms.device
    if batt_soc is None:
        batt_soc = params.batt_init_soc.reshape(-1)[0].to(device=device, dtype=F32).expand(B)
    traces = kernel_traces(params, device)
    weights = actor_weights(config, net, device, actor)
    if not kernel_device(uniforms):
        return gen_policy_day_plain(config, traces, weights, uniforms.to(F32), pv_shift.to(F32),
                                    batt_soc.to(F32), actor)

    u = _build.check_f32(uniforms, "uniforms")
    pv = _build.check_f32(pv_shift, "pv_shift")
    batt = _build.check_f32(batt_soc.contiguous(), "batt_soc")
    rewards = torch.empty((T, B), dtype=F32, device=device)
    actions = torch.empty((T, A, B), dtype=F32, device=device)
    soc_final = torch.empty((N, B), dtype=F32, device=device)
    batt_final = torch.empty((B,), dtype=F32, device=device)
    lib, block, name = policy_library(config, device, weights, net.hidden, actor, traces, "gen_policy_day")
    _build.launch(
        name, lib.ngk_gen_policy_day,
        traces.price, traces.price_norm, traces.price_norm.numel(), traces.rad_norm,
        traces.rad_norm.numel(), traces.solar, u, batt, pv, block,
        rewards, actions, soc_final, batt_final, B, *_build.day_dims(config), device=device,
    )
    return rewards, actions, soc_final, batt_final


# --------------------------------------------------------------------- K6 ---

def gen_policy_multiday_plain(config, traces: Traces, weights: ActorWeights, num_days: int,
                              seed: int, batch: int, actor: str = "ppo", mlp_dtype=torch.float32):
    """Plain twin of K6: ``stats (3, batch)``, same Philox draws as the kernel;
    with bf16 ``mlp_dtype``, ``weights`` come from :func:`actor_weights`
    with the same ``mlp_dtype``."""
    T = config.steps_per_day
    kw = policy_kwargs(config)
    N = kw["N"]
    device = traces.price.device
    batt_soc = torch.full((batch,), BATT_INIT_SOC, dtype=F32, device=device)
    policy = _policy(actor, weights, bf16_operands(mlp_dtype))
    rew_total = torch.zeros(batch, dtype=F32, device=device)
    sq_total = torch.zeros(batch, dtype=F32, device=device)
    for day in range(num_days):
        u, u_pv = day_uniforms(seed, day, batch, T, N, device)
        pv_shift = pv_shift_from_uniform(u_pv)
        carry = fresh_carry(N, batch, device, kw["diff_caps"], kw["req_soc"])
        pen_acc = torch.zeros((N, batch), dtype=F32, device=device)
        rows_list = []
        for t in range(T):
            rows, _, carry, batt_soc = gen_policy_step(
                t, u[t].unbind(0), carry, batt_soc, traces, pv_shift, policy, T=T, **kw)
            pen_acc = pen_acc + rows.pop("pen")
            rows_list.append(rows)
        stacked = {k: _stack(rows_list, k) for k in rows_list[0]}
        rewards = -policy_day_costs(stacked, traces.price[:T, None], traces.solar[:T, None],
                                    pv_shift, dt=kw["dt"], pv=kw["pv"], batt=kw["batt"])
        day_return = sum_rows(rewards) - W_VEH * sum_rows(pen_acc)
        rew_total = rew_total + day_return
        sq_total = sq_total + day_return * day_return
    return torch.stack([rew_total, sq_total, batt_soc])


@spanned("policy_days")
def gen_policy_multiday(config: NanogridConfig, params: NanogridParams, net: ActorCritic | DDPGActor,
                        num_days: int, seed: int, batch: int, actor: str = "ppo", mlp_dtype=torch.float32):
    """``num_days`` fresh actor-driven days × ``batch`` envs in one launch (K6).

    Runs on the device of ``params``; the battery starts at 0.5 and carries
    across days; ``actor`` as for :func:`gen_policy_day`.  ``mlp_dtype``:
    the operand dtype of the actor's products, ``torch.float32`` (exact) or
    ``torch.bfloat16`` (weights, observation, h1 and h2 rounded to bf16,
    products accumulated in f32).  Torsos of more than 768 hidden units
    raise ``ValueError``.  Returns ``stats (3, batch)``: Σ day return, Σ
    (day return)², final battery SoC.
    """
    check_policy_config(config, params, "gen_policy_multiday", battery_init=True)
    if sum(net.hidden) > MAX_HIDDEN_SUM:  # before any launch, as the JAX kernel checks it
        raise ValueError(f"gen_policy_multiday: actor torso {net.hidden[0]}x{net.hidden[1]} exceeds "
                         f"{MAX_HIDDEN_SUM} hidden units (the JAX kernel's VMEM budget); use the plain engine")
    bf16 = bf16_operands(mlp_dtype)
    device = params.device
    traces = kernel_traces(params, device)
    weights = actor_weights(config, net, device, actor, mlp_dtype)
    if not kernel_device(params.price):
        return gen_policy_multiday_plain(config, traces, weights, num_days, seed, batch, actor, mlp_dtype)

    stats = torch.empty((3, batch), dtype=F32, device=device)
    lib, block, name = policy_library(config, device, weights, net.hidden, actor, traces, "gen_policy_multiday",
                                      bf16)
    _build.launch(
        name, lib.ngk_gen_policy_multiday,
        traces.price, traces.price_norm, traces.price_norm.numel(), traces.rad_norm,
        traces.rad_norm.numel(), traces.solar, seed & 0xFFFFFFFF, num_days, block,
        stats, batch, *_build.day_dims(config), int(bf16), device=device,
    )
    return stats
