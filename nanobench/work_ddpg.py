"""The work of a DDPG update's two kernels, K9 seeded and K10: frozen copies
of ``chip_smoke.py::bounds``' DDPG counts, in :mod:`.work`'s form (its
``least_ms`` gives their least times).  Computed from shapes alone.
"""

from __future__ import annotations

from .work import day_dims, mlp_flops, philox_calls_per_day


def collect_day_seeded(grid: dict, hidden: tuple[int, int], batch: int) -> dict:
    """K9 seeded's work for one collection day: the OU sequence and the
    battery read; the day's observations, next observations, actions and
    rewards and the final battery written; the actor's forward each
    env-step (the squash, the noise and the clip not counted); the day's
    generation draws."""
    T, _, F, A = day_dims(grid)
    out = 4 * (2 * T * F * batch + T * A * batch + T * batch + batch)
    return {"bytes": 4 * (T * A * batch + batch) + out, "ops": mlp_flops(F, A, *hidden) * T * batch,
            "philox": philox_calls_per_day(grid) * batch}


def sweep(grid: dict, hidden: tuple[int, int], steps: int, minibatch: int) -> dict:
    """K10's work for ``steps`` gradient steps of ``minibatch`` samples: the
    minibatches read once; the four networks and both Adam states read and
    written; per sample and step the forwards of the target actor, the
    target critic, the critic, the actor and the critic on the actor's
    action, the critic's weight and input gradients, the input gradients
    back to the action and the actor's weight and input gradients (a
    multiply-add is 2 operations)."""
    _, _, F, A = day_dims(grid)
    H1, H2 = hidden
    FC = F + A
    actor_fwd, critic_fwd = H1 * F + H2 * H1 + A * H2, H1 * FC + H2 * H1 + H2
    macs = (2 * actor_fwd + 3 * critic_fwd + critic_fwd + (H2 + H2 * H1) + (H2 + H2 * H1 + H1 * A)
            + actor_fwd + (A * H2 + H2 * H1))
    p_actor, p_critic = actor_fwd + H1 + H2 + A, critic_fwd + H1 + H2 + 1
    n_bytes = 4 * steps * minibatch * (2 * F + A + 2) + 4 * 2 * 4 * (p_actor + p_critic) + 4 * 2 * steps
    return {"bytes": n_bytes, "ops": 2 * macs * steps * minibatch, "philox": 0}

