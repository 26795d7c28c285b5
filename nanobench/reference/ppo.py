"""PPO updates of the SB3-default actor-critic in plain torch, with autograd.

One update collects one fresh day per env with the stochastic actor (the
BESS carried from the previous update), computes GAE, and runs ``epochs ×
minibatches`` clipped-PPO steps, each with ``clip_by_global_norm`` and Adam
(SB3's PPO defaults).  The minibatches are the learner's documented
partition: the day's ``(T, B)`` samples cut into blocks of ``slab`` envs at
one step, block ``t·(B / slab) + s``, each epoch a permutation of the
blocks cut into ``minibatches`` runs; advantages normalised per minibatch.
The update's draws (the collection seed and the permutations) come from a
CPU ``torch.Generator`` in the learner's documented order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import philox
from .day import mlp, pv_shift, run_day
from .tables import Tables

LOG_2PI = math.log(2.0 * math.pi)
ENTROPY_CONST = 0.5 * math.log(2.0 * math.pi * math.e)


class Hypers(NamedTuple):
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    epochs: int = 10
    minibatches: int = 4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class Update(NamedTuple):
    loss: float          # mean over the update's steps of policy loss + vf_coef · value loss
    mean_return: float   # mean day return of the collection
    params: list
    mu: list
    nu: list
    batt: torch.Tensor
    value: torch.Tensor  # (T, B) the critic's values the collection recorded
    obs: torch.Tensor    # (T, B, F) the collection's observations


def slab_size(B: int, T: int, F: int, A: int, hidden, minibatches: int) -> int:
    """The learner's slab: the largest divisor of ``B`` up to the granule
    that divides a minibatch's ``(B / minibatches)·T`` samples under a
    9 MiB budget of ``per_sample`` bytes (the JAX kernel's partition rule)."""
    lane = lambda n: -(-n // 128) * 128  # noqa: E731
    H1, H2 = hidden
    per_sample = 4 * (2 * (lane(F) + lane(A)) + 48 + 2 * (H1 + H2) + 48 + (H1 + H2))
    M = (B // minibatches) * T
    target = max(1, 9 * 2 ** 20 // per_sample)
    chunk = next((c for c in range(min(M, target), 0, -1) if M % c == 0), M)
    return next(c for c in range(min(chunk, B), 0, -1) if B % c == 0)


def draws(generator: torch.Generator, n_blocks: int, epochs: int):
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
    perms = torch.stack([torch.randperm(n_blocks, generator=generator) for _ in range(epochs)])
    return seed, perms


def collect(grid: dict, tab: Tables, leaves, seed: int, batt: torch.Tensor, low, high):
    """One collection day of ``B = batt.numel()`` envs: ``(obs (T, B, F),
    act (T, B, A), logp, value, rewards (T, B), batt_end)``."""
    T = int(round(24.0 / float(grid["time_interval_h"])))
    N = int(grid["chargers"])
    B, A = batt.numel(), leaves[4].shape[0]
    u, normals, u_pv = philox.collect_draws(seed, torch.arange(B, device=batt.device), T, N, A)
    pi, vf, log_std = leaves[:6], leaves[6:12], leaves[12]
    rec = {"obs": [], "act": [], "logp": [], "value": []}

    def controller(view):
        t = len(rec["obs"])
        obs = view.obs
        mean, value = mlp(pi, obs), mlp(vf, obs)[:, 0]
        std = torch.exp(log_std)
        a_raw = mean + std * normals[t]
        logp = (-0.5 * ((a_raw - mean) ** 2 / (std * std) + 2.0 * log_std + LOG_2PI)).sum(1)
        for k, x in (("obs", obs), ("act", a_raw), ("logp", logp), ("value", value)):
            rec[k].append(x)
        return torch.clamp(a_raw, low, high)

    day = run_day(grid, tab, u, pv_shift(u_pv), batt, controller)
    return (*(torch.stack(rec[k]) for k in ("obs", "act", "logp", "value")), day.rewards, day.batt)


def gae(rewards, values, hp: Hypers):
    """Advantages and returns of one day that ends at its last step."""
    T = rewards.shape[0]
    adv, nxt, gae_t = [], torch.zeros_like(values[0]), torch.zeros_like(values[0])
    for t in range(T - 1, -1, -1):
        nonterminal = 0.0 if t == T - 1 else 1.0
        delta = rewards[t] + hp.gamma * nxt * nonterminal - values[t]
        gae_t = delta + hp.gamma * hp.gae_lambda * nonterminal * gae_t
        nxt = values[t]
        adv.append(gae_t)
    adv = torch.stack(adv[::-1])
    return adv, adv + values


def loss_fn(leaves, obs, act, old_logp, nadv, ret, hp: Hypers):
    pi, vf, log_std = leaves[:6], leaves[6:12], leaves[12]
    mean, value = mlp(pi, obs), mlp(vf, obs)[:, 0]
    var = torch.exp(2.0 * log_std)
    logp = (-0.5 * ((act - mean) ** 2 / var + 2.0 * log_std + LOG_2PI)).sum(1)
    ratio = torch.exp(logp - old_logp)
    pg = torch.minimum(ratio * nadv, torch.clamp(ratio, 1.0 - hp.clip, 1.0 + hp.clip) * nadv)
    policy_loss = -pg.mean()
    value_loss = 0.5 * ((value - ret) ** 2).mean()
    entropy = (log_std + ENTROPY_CONST).sum()
    return policy_loss + hp.vf_coef * value_loss - hp.ent_coef * entropy


def update(grid: dict, tab: Tables, params, mu, nu, count: int, batt, generator: torch.Generator,
           hidden, low, high, hp: Hypers = Hypers(), keep: float = 1.0, sweep_tf32: bool = False) -> Update:
    """One PPO update from ``params`` and Adam's ``(mu, nu, count)``;
    ``keep < 1`` takes each gradient step over that share of its minibatch
    only (a planted fault, for setting limits); ``sweep_tf32`` runs the
    gradient steps' products in TF32 (a control)."""
    T = int(round(24.0 / float(grid["time_interval_h"])))
    B, F, A = batt.numel(), params[0].shape[1], params[4].shape[0]
    slab = slab_size(B, T, F, A, hidden, hp.minibatches)
    n_blocks = T * (B // slab)
    seed, perms = draws(generator, n_blocks, hp.epochs)
    with torch.no_grad():
        obs, act, logp, value, rewards, batt_end = collect(grid, tab, params, seed, batt, low, high)
        adv, ret = gae(rewards, value, hp)
    blocks = [x.reshape((n_blocks, slab) + tuple(x.shape[2:])) for x in (obs, act, logp, adv, ret)]
    K = n_blocks // hp.minibatches
    order = perms.reshape(hp.epochs * hp.minibatches, K).to(obs.device)
    params, mu, nu = [p.detach().clone() for p in params], list(mu), list(nu)
    losses = []
    for g in range(order.shape[0]):
        used = order[g][:max(1, int(K * keep))]
        o, a, lp, ad, r = (b[used].reshape((used.numel() * slab,) + tuple(b.shape[2:])) for b in blocks)
        centred = ad - ad.mean()
        nadv = centred / (torch.sqrt((centred * centred).mean()) + 1e-8)
        leaves = [p.clone().requires_grad_(True) for p in params]
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = was or sweep_tf32
        try:
            loss = loss_fn(leaves, o, a, lp, nadv, r, hp)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
        losses.append(loss.detach())
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in grads)).to(grads[0].dtype)
        if norm >= hp.max_grad_norm:
            grads = [x / norm * hp.max_grad_norm for x in grads]
        t = count + g + 1
        bc1, bc2 = 1.0 - hp.b1 ** t, 1.0 - hp.b2 ** t
        mu = [hp.b1 * m + (1.0 - hp.b1) * x for m, x in zip(mu, grads)]
        nu = [hp.b2 * v + (1.0 - hp.b2) * x * x for v, x in zip(nu, grads)]
        params = [p - hp.lr * (m / bc1) / (torch.sqrt(v / bc2) + hp.eps) for p, m, v in zip(params, mu, nu)]
    mean_return = float(rewards.to(torch.float64).sum(0).mean())
    return Update(float(torch.stack(losses).double().mean()), mean_return, params, mu, nu, batt_end, value, obs)


def leaf_gaps(got, want, floor_of=None) -> list[float]:
    """Per leaf, the gap between the norms of ``got`` and ``want`` over the
    larger of the leaf's reference norm and the median leaf's."""
    g = np.array([float(torch.linalg.vector_norm(x.double())) for x in got])
    w = np.array([float(torch.linalg.vector_norm(x.double())) for x in want])
    scale = np.maximum(w, np.median(w if floor_of is None else floor_of))
    return list(np.abs(g - w) / scale)


def relative(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def moving_leaves(mu) -> list[int]:
    """The leaves whose first moment after the first update is at least a
    thousandth of the median leaf's: the others have no gradient to speak of
    and move by round-off alone."""
    norms = [float(torch.linalg.vector_norm(x.double())) for x in mu]
    return [i for i, n in enumerate(norms) if n >= 1e-3 * float(np.median(norms))]


def output_gap(got, want, start, obs: torch.Tensor) -> float:
    """The widest gap between the torso ``got``'s outputs and ``want``'s on
    ``obs``, over the mean size of what the update moved them by from
    ``start``'s (in f64, so that the comparison adds no rounding)."""
    x = obs.reshape(-1, obs.shape[-1]).double()
    out = [mlp([leaf.double().to(x.device) for leaf in torso], x) for torso in (got, want, start)]
    moved = (out[1] - out[2]).abs().mean()
    return float(torch.nan_to_num((out[0] - out[1]).abs(), nan=float("inf")).max() / moved)


def check_updates(program: list, reference: list, params0) -> dict:
    """The numbers compared for ``len(program)`` updates: the first
    collection's values by the widest gap over their mean size, each
    update's loss and mean return, the first update's Adam moment by the
    worst leaf, the parameters' change over all updates by the worst leaf
    (both over :func:`moving_leaves`), and the first update's critic and
    actor mean on the reference's first collection by :func:`output_gap`:
    these read each parameter the sweep wrote, not only the norms."""
    keep = moving_leaves(reference[0].mu)
    pick = lambda xs: [xs[i] for i in keep]  # noqa: E731
    change_p = [a - b for a, b in zip(program[-1].params, params0)]
    change_r = [a - b for a, b in zip(reference[-1].params, params0)]
    v_p, v_r = program[0].value.double(), reference[0].value.double().to(program[0].value.device)
    return {
        "value_gap": float(torch.nan_to_num((v_p - v_r).abs(), nan=float("inf")).max() / v_r.abs().mean()),
        "loss_gap": max(relative(p.loss, r.loss) for p, r in zip(program, reference)),
        "return_gap": max(relative(p.mean_return, r.mean_return) for p, r in zip(program, reference)),
        "moment_gap": float(max(leaf_gaps(pick(program[0].mu), pick(reference[0].mu)))),
        "change_gap": float(max(leaf_gaps(pick(change_p), pick(change_r)))),
        "critic_gap": output_gap(program[0].params[6:12], reference[0].params[6:12], params0[6:12], reference[0].obs),
        "actor_gap": output_gap(program[0].params[:6], reference[0].params[:6], params0[:6], reference[0].obs),
    }
