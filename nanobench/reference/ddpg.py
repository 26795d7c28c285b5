"""DDPG updates of SB3's 400-300 ReLU actor and critic in plain torch, with
autograd.

One update follows the port's documented DDPG update on its kernel path:

1. its draws come from a CPU ``torch.Generator`` in the learner's order: the
   day's seed ``randint(0, 2**31 - 1)``, the OU gaussians ``randn(T, A, B)``,
   the minibatches' step indices ``randint(0, max(filled, 1), (1, G, M))``
   and their env indices ``randint(0, B, (1, G, M))``, ``filled`` being the
   replay's fill after the update's day is written;
2. the OU states start from zero: ``x' = x + θ(0 − x)·dt + σ·√dt·g``;
3. one fresh day per env, generated from the Philox kinds of a collection
   day (:func:`.philox.collect_draws`), the BESS carried from the previous
   update, under ``clip(low + (tanh(μ(s)) + 1)/2·(high − low) + ou_t, low,
   high)``; a transition is ``(s, a, r, s', d)`` with ``s'`` at the last
   step the day-end observation and ``d`` set there alone;
4. the day is written into a ring of ``buffer_days`` days and ``G``
   minibatches of ``M`` are gathered from it;
5. each of the ``G`` steps: the target ``r + γ(1 − d)·Q'(s', μ'(s'))``, the
   critic's mean squared error and an Adam step, the actor's ``−Q(s, μ(s))``
   under the updated critic and an Adam step, and polyak averaging of both
   targets.  Adam is optax's: β 0.9 / 0.999, eps 1e-8 outside the square
   root, bias correction ``1 − βᵗ``, no eps_root.

Where this departs from SB3's ``DDPG("MlpPolicy")`` as the upstream trainer
runs it (``solvers/RL/ddpg_train.py:107-113``), it follows the port:

- the whole-day layout: a fresh day of every env, then ``G`` gradient steps,
  where SB3 alternates single env steps and gradient steps after
  ``learning_starts``; training starts at the first update;
- the OU noise restarts at zero at each day, one process per env, as SB3's
  reset at an episode's end does for a one-day episode;
- the noise is added in the env's action box and the replay stores that
  action, where SB3 adds it to the action scaled to ``[-1, 1]`` and stores
  the scaled one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import philox
from .day import (ARRIVAL, CAP_LOW, CAP_SPAN, DEFAULT_CAP, EFF, MAX_P, SOC_LOW, SOC_SPAN, StepView, pv_shift,
                  run_day)
from .ppo import leaf_gaps, moving_leaves, relative
from .tables import Tables


class Hypers(NamedTuple):
    lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 5e-3
    minibatch: int = 256
    gradient_steps: int = 24
    buffer_days: int = 10
    ou_sigma: float = 0.5
    ou_theta: float = 0.15
    ou_dt: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class Nets(NamedTuple):
    actor: list      # 6 leaves each: (W1, b1, W2, b2, W3, b3)
    critic: list
    t_actor: list
    t_critic: list


class Adam(NamedTuple):
    count: int
    mu: list
    nu: list


class Replay(NamedTuple):
    obs: torch.Tensor       # (C, B, F)
    act: torch.Tensor       # (C, B, A)
    rew: torch.Tensor       # (C, B)
    next_obs: torch.Tensor  # (C, B, F)
    done: torch.Tensor      # (C, B), 1.0 at a day's last step
    pos: int
    filled: int


class Update(NamedTuple):
    critic_loss: float       # mean over the update's steps
    actor_loss: float
    mean_return: float       # mean day return of the collection
    nets: Nets
    actor_opt: Adam
    critic_opt: Adam
    replay: Replay
    batt: torch.Tensor
    rewards: torch.Tensor    # (T, B) the day's transitions
    actions: torch.Tensor    # (T, B, A)
    next_obs: torch.Tensor   # (T, B, F)
    batch_obs: torch.Tensor  # (G, M, F) the minibatches
    batch_act: torch.Tensor  # (G, M, A)
    generator: torch.Tensor  # the host generator's state after the update's draws

    @property
    def carry(self) -> dict:
        """What the next update starts from besides the networks and Adam:
        the replay's filled rows, its insert position and fill, the
        batteries and the host generator's state."""
        rp = self.replay
        return {"replay": [x[:rp.filled] for x in rp[:5]], "pos": rp.pos, "filled": rp.filled, "batt": self.batt,
                "generator": self.generator}


def relu_mlp(leaves, x: torch.Tensor) -> torch.Tensor:
    """A ReLU torso ``(W1, b1, W2, b2, W3, b3)`` on ``x (L, in)``."""
    w1, b1, w2, b2, w3, b3 = leaves
    lin = torch.nn.functional.linear
    return lin(torch.relu(lin(torch.relu(lin(x, w1, b1)), w2, b2)), w3, b3)


def actor(leaves, obs, low, high):
    return low + (torch.tanh(relu_mlp(leaves, obs)) + 1.0) * 0.5 * (high - low)


def q_value(leaves, obs, act):
    return relu_mlp(leaves, torch.cat([obs, act], dim=-1))[..., 0]


def empty_replay(days: int, T: int, B: int, F: int, A: int, device) -> Replay:
    z = dict(dtype=torch.float32, device=device)
    C = days * T
    return Replay(torch.zeros((C, B, F), **z), torch.zeros((C, B, A), **z), torch.zeros((C, B), **z),
                  torch.zeros((C, B, F), **z), torch.zeros((C, B), **z), 0, 0)


def draws(generator: torch.Generator, T: int, A: int, B: int, filled: int, G: int, M: int):
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
    gaussians = torch.randn((T, A, B), generator=generator)
    t_idx = torch.randint(0, max(filled, 1), (1, G, M), generator=generator)[0]
    b_idx = torch.randint(0, B, (1, G, M), generator=generator)[0]
    return seed, gaussians, t_idx, b_idx


def ou_sequence(gaussians: torch.Tensor, hp: Hypers) -> torch.Tensor:
    """The OU states ``(T, A, B)`` of one day from zero."""
    x, out = torch.zeros_like(gaussians[0]), []
    for g in gaussians:
        x = x + hp.ou_theta * (0.0 - x) * hp.ou_dt + hp.ou_sigma * hp.ou_dt ** 0.5 * g
        out.append(x)
    return torch.stack(out)


def day_end_obs(grid: dict, tab: Tables, u: torch.Tensor, shift: torch.Tensor, act: torch.Tensor,
                batt: torch.Tensor) -> torch.Tensor:
    """The observation after a day's last step, the one a next step would
    see (trace offset ``T − 1``): the chargers' SoC and departure columns
    replayed from the day's draws ``u (T, 5, L, N)`` under its actions
    ``act (T, L, A)`` as :func:`.day.run_day` keeps them, and the BESS SoC
    ``batt (L,)`` at the day's end."""
    dt = float(grid["time_interval_h"])
    T, _, L, N = u.shape
    k4, k10, k1 = int(4 / dt), int(10 / dt), int(1 / dt)
    diff_caps = bool(grid["different_capacities"])
    zero = torch.zeros((L, N), dtype=u.dtype, device=u.device)
    present, dep, cap, col, prev_cap, dep_col = (zero,) * 6
    for t in range(T):
        u_arr, u_soc, u_cap, _, u_dep = u[t]
        arrives = (present == 0) & (u_arr > ARRIVAL)
        low, high = t + k4, min(t + k10, T + k1)
        dep_new = (torch.full_like(u_dep, float(low)) if low >= high
                   else low + torch.floor(u_dep * float(high - low)))
        dep = torch.where(arrives, dep_new, dep)
        occupied = (torch.maximum(present, arrives.to(u.dtype)) > 0) & (float(t) < dep)
        if diff_caps:
            cap = torch.where(arrives, CAP_LOW + torch.floor(u_cap * CAP_SPAN), cap)
            cap_col = torch.where(occupied, cap, zero)
            cap_eff = torch.where(arrives, cap_col, prev_cap)
            divisor = torch.where(cap_eff > 0, cap_eff, torch.ones_like(cap_eff))
        else:
            cap_col, divisor = zero, DEFAULT_CAP
        dep_col = torch.where(occupied, dep - float(t), zero)
        ch = act[t][:, :N]
        soc_eff = torch.where(arrives, SOC_LOW + SOC_SPAN * u_soc, col)
        calc = soc_eff + (ch * (MAX_P * EFF) * dt) / divisor
        soc_new = torch.where(ch > 0, torch.clamp(calc, max=1.0),
                              torch.where(ch < 0, torch.clamp(calc, min=0.0), soc_eff))
        col = torch.where(occupied, soc_new, zero)
        present, prev_cap = occupied.to(u.dtype), cap_col
    o = T - 1
    if grid["pv"]:
        rows = [tab.rad_norm[o] * shift, tab.price_norm[o].expand(L)]
        rows += [tab.rad_norm[o + i] * shift for i in range(1, 4)]
        rows += [tab.price_norm[o + i].expand(L) for i in range(1, 4)]
    else:
        rows = [tab.price_norm[o + i].expand(L) for i in range(4)]
    parts = [torch.stack(rows, dim=1), col, dep_col / 24.0]
    if grid["battery"]:
        parts.append(batt[:, None])
    return torch.cat(parts, dim=1)


def collect(grid: dict, tab: Tables, leaves, seed: int, ou: torch.Tensor, batt: torch.Tensor, low, high):
    """One day of ``B = batt.numel()`` envs under the actor ``leaves`` and the
    OU states ``ou (T, A, B)``: ``(obs (T, B, F), act (T, B, A), rewards (T,
    B), next_obs (T, B, F), batt_end (B,))``."""
    T = int(round(24.0 / float(grid["time_interval_h"])))
    N = int(grid["chargers"])
    B, A = batt.numel(), ou.shape[1]
    u, _, u_pv = philox.collect_draws(seed, torch.arange(B, device=batt.device), T, N, A)
    shift = pv_shift(u_pv)
    obs, act = [], []

    def controller(view: StepView) -> torch.Tensor:
        a = torch.clamp(actor(leaves, view.obs, low, high) + ou[len(obs)].T, low, high)
        obs.append(view.obs)
        act.append(a)
        return a

    day = run_day(grid, tab, u, shift, batt, controller)
    obs, act = torch.stack(obs), torch.stack(act)
    last = day_end_obs(grid, tab, u, shift, act, day.batt)
    return obs, act, day.rewards, torch.cat([obs[1:], last[None]]), day.batt


def adam_step(params, opt: Adam, grads, hp: Hypers):
    t = opt.count + 1
    mu = [hp.b1 * m + (1.0 - hp.b1) * g for m, g in zip(opt.mu, grads)]
    nu = [hp.b2 * v + (1.0 - hp.b2) * g * g for v, g in zip(opt.nu, grads)]
    bc1, bc2 = 1.0 - hp.b1 ** t, 1.0 - hp.b2 ** t
    new = [p - hp.lr * (m / bc1) / (torch.sqrt(v / bc2) + hp.eps) for p, m, v in zip(params, mu, nu)]
    return new, Adam(t, mu, nu)


def _grads(loss_of, leaves, tf32: bool):
    """``loss_of(leaves)`` and its gradients, the products in TF32 with ``tf32``."""
    leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = was or tf32
    try:
        loss = loss_of(leaves)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    return loss.detach(), grads


def update(grid: dict, tab: Tables, nets: Nets, a_opt: Adam, c_opt: Adam, replay: Replay, batt, generator,
           low, high, hp: Hypers = Hypers(), keep: float = 1.0, sweep_tf32: bool = False) -> Update:
    """One DDPG update; ``keep < 1`` takes each gradient step over that share
    of its minibatch only (a planted fault, for setting limits);
    ``sweep_tf32`` runs the gradient steps' products in TF32 (a control)."""
    T = int(round(24.0 / float(grid["time_interval_h"])))
    B, A = batt.numel(), nets.actor[4].shape[0]
    G, M = hp.gradient_steps, hp.minibatch
    C = replay.obs.shape[0]
    seed, gaussians, t_idx, b_idx = draws(generator, T, A, B, min(replay.filled + T, C), G, M)
    device = batt.device
    with torch.no_grad():
        ou = ou_sequence(gaussians.to(device), hp)
        obs, act, rewards, next_obs, batt_end = collect(grid, tab, nets.actor, seed, ou, batt, low, high)
    done = torch.zeros((T, B), dtype=torch.float32, device=device)
    done[-1] = 1.0
    rows = slice(replay.pos, replay.pos + T)
    for dst, src in zip(replay[:5], (obs, act, rewards, next_obs, done)):
        dst[rows] = src
    replay = replay._replace(pos=(replay.pos + T) % C, filled=min(replay.filled + T, C))
    t_idx, b_idx = t_idx.to(device), b_idx.to(device)
    batches = [x[t_idx, b_idx] for x in replay[:5]]

    actor_p, critic_p, t_actor, t_critic = (list(x) for x in nets)
    used = max(1, int(M * keep))
    c_losses, a_losses = [], []
    for g in range(G):
        o, a, r, n, d = (x[g][:used] for x in batches)
        with torch.no_grad():
            y = r + hp.gamma * (1.0 - d) * q_value(t_critic, n, actor(t_actor, n, low, high))
        c_loss, grads = _grads(lambda c: ((q_value(c, o, a) - y) ** 2).mean(), critic_p, sweep_tf32)
        critic_p, c_opt = adam_step(critic_p, c_opt, grads, hp)
        a_loss, grads = _grads(lambda p: -q_value(critic_p, o, actor(p, o, low, high)).mean(), actor_p, sweep_tf32)
        actor_p, a_opt = adam_step(actor_p, a_opt, grads, hp)
        t_actor = [(1.0 - hp.tau) * t + hp.tau * p for t, p in zip(t_actor, actor_p)]
        t_critic = [(1.0 - hp.tau) * t + hp.tau * p for t, p in zip(t_critic, critic_p)]
        c_losses.append(c_loss)
        a_losses.append(a_loss)
    mean_return = float(rewards.to(torch.float64).sum(0).mean())
    return Update(float(torch.stack(c_losses).double().mean()), float(torch.stack(a_losses).double().mean()),
                  mean_return, Nets(actor_p, critic_p, t_actor, t_critic), a_opt, c_opt, replay, batt_end,
                  rewards, act, next_obs, batches[0], batches[1], generator.get_state())


def _norm_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """``‖got − want‖ / ‖want‖`` in f64; a nonfinite entry reads infinite."""
    diff = torch.nan_to_num((got.double() - want.double().to(got.device)), nan=float("inf"))
    return float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want.double()))


def _worst(got, want, keep) -> float:
    return float(max(leaf_gaps([got[i] for i in keep], [want[i] for i in keep])))


def _carry_gaps(got: dict, want: dict) -> tuple[float, float]:
    """``got``'s carried state (:attr:`Update.carry`) against ``want``'s: the
    worst relative norm of the difference over the replay's five fields and
    the batteries (infinite where the fills differ), and the count of the
    insert position, the fill and the generator's state that differ."""
    mismatch = (int(got["pos"] != want["pos"]) + int(got["filled"] != want["filled"])
                + int(not torch.equal(got["generator"], want["generator"])))
    if got["filled"] != want["filled"]:
        return float("inf"), float(mismatch)
    pairs = zip([*got["replay"], got["batt"]], [*want["replay"], want["batt"]])
    return max(_norm_gap(a.to(b.device), b) for a, b in pairs), float(mismatch)


def check_update(program, reference: Update, start: Nets) -> dict:
    """The numbers compared for one update that the reference started where
    the program did, from the networks ``start``: the day's rewards, actions
    and next observations by the worst relative norm of their difference;
    what the program carries into the next update (``program.carry``, the
    state its next update starts from) against what the reference's update
    left, by :func:`_carry_gaps`;
    the critic and actor loss and the mean return; the Adam first moments,
    worst leaf of actor and critic; the change of the four networks over the
    update, worst leaf (both over :func:`.ppo.moving_leaves` of the first
    moments, the targets by their network's); and the critic's Q after the
    update on its minibatches, the widest gap over the mean size of what the
    update moved it by, in f64."""
    p, r = program, reference
    keep_a, keep_c = moving_leaves(r.actor_opt.mu), moving_leaves(r.critic_opt.mu)
    changes = []
    for i, keep in enumerate((keep_a, keep_c, keep_a, keep_c)):
        change_p = [a - b.to(a.device) for a, b in zip(p.nets[i], start[i])]
        change_r = [a - b.to(a.device) for a, b in zip(r.nets[i], start[i])]
        changes.append(_worst(change_p, change_r, keep))
    x_obs = r.batch_obs.reshape(-1, r.batch_obs.shape[-1]).double()
    x_act = r.batch_act.reshape(-1, r.batch_act.shape[-1]).double()
    q = [q_value([leaf.double().to(x_obs.device) for leaf in c], x_obs, x_act)
         for c in (p.nets.critic, r.nets.critic, start.critic)]
    carry_gap, carry_mismatch = _carry_gaps(p.carry, r.carry)
    return {
        "transition_gap": max(_norm_gap(getattr(p, k), getattr(r, k)) for k in ("rewards", "actions", "next_obs")),
        "carry_gap": carry_gap,
        "carry_mismatch": carry_mismatch,
        "critic_loss_gap": relative(p.critic_loss, r.critic_loss),
        "actor_loss_gap": relative(p.actor_loss, r.actor_loss),
        "return_gap": relative(p.mean_return, r.mean_return),
        "moment_gap": max(_worst(p.actor_opt.mu, r.actor_opt.mu, keep_a),
                          _worst(p.critic_opt.mu, r.critic_opt.mu, keep_c)),
        "change_gap": max(changes),
        "q_gap": float(torch.nan_to_num((q[0] - q[1]).abs(), nan=float("inf")).max() / (q[1] - q[2]).abs().mean()),
    }


def check_updates(program: list, reference: list, starts: list) -> dict:
    """Each number of :func:`check_update` at its worst over the updates,
    ``starts[i]`` the networks at the start of update ``i``; a number that
    is not a number reads infinite."""
    rows = [check_update(p, r, s) for p, r, s in zip(program, reference, starts)]
    return {k: max(float("inf") if math.isnan(row[k]) else row[k] for row in rows) for k in rows[0]}
