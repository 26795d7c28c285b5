"""Closed-loop scoring of a deterministic PPO actor: each unit is one call of
``solvers/evaluator.py::evaluate_policy_at_scale`` at ``days`` fresh days of
``batch`` envs on a new seed, as a checkpoint is scored; the call returns
host floats, so it ends synchronised.

The actor (the ``pi`` torso of an SB3-default actor-critic) is made on the
card from the run's seed.  The benchmark's span around the evaluator's call
into ``ops/gen_policy_rollout.py::gen_policy_multiday`` (K6) keeps each
call's per-env stats.  The check draws ``check_calls`` calls and
``check_envs`` envs of each from the run's seed and works their sums of day
returns and of squared day returns out again with the plain reference over
every day.  An env's days are chained by its BESS, so
the reference runs all the days at once from a guessed starting SoC and
repeats with each day started from the previous day's end until no start
changes (at most ``check_sweeps`` times): the result is then the chained
one exactly.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from nanobench import common
from nanobench import work as counts
from nanobench.drivers.eval_rbc import compare
from nanobench.reference import day as ref_day
from nanobench.reference import philox
from nanobench.reference.tables import grid_tables
from nanobench.spans import Wrapped

END_TO_END = "eval_env_steps_per_s"


def setup(ctx):
    from smart_nanogrid_gym_torch.core.params import make_params
    from smart_nanogrid_gym_torch.solvers import evaluator
    from smart_nanogrid_gym_torch.solvers.networks import actor_critic_from_leaves

    grid, net_cfg = ctx.config["grid"], ctx.config["network"]
    cfg = common.program_config(grid)
    _, _, F, A = counts.day_dims(grid)
    hidden = tuple(net_cfg["hidden"])
    leaves = common.actor_critic(F, A, hidden, common.seeds(ctx.seed, 1, salt=3)[0], ctx.device,
                                 float(net_cfg["eval_pi_out_gain"]))
    s = SimpleNamespace(ctx=ctx, cfg=cfg, params=make_params(cfg, torch.float32, ctx.device),
                        net=actor_critic_from_leaves(leaves), pi=[x.detach().clone() for x in leaves[:6]],
                        hidden=hidden, batch=int(ctx.traffic["batch"]), days=int(ctx.traffic["days"]),
                        call_seeds=iter(common.seeds(ctx.seed, 1 << 20, salt=1)), seeds=[],
                        kernel=Wrapped(evaluator, "gen_policy_multiday", "kernel_call", keep=True),
                        evaluate=evaluator.evaluate_policy_at_scale)
    s.evaluate(cfg, s.params, s.net, 1, s.batch, 0, algorithm="ppo")   # loads the library
    s.kernel.seen.clear()
    return s


def unit(s) -> int:
    seed = next(s.call_seeds)
    s.evaluate(s.cfg, s.params, s.net, s.days, s.batch, seed, algorithm="ppo")
    s.seeds.append(seed)
    return s.batch * s.days * s.cfg.steps_per_day


def work(s) -> dict:
    return {"policy_days": counts.policy_days(s.ctx.config["grid"], s.hidden, s.batch, s.days)}


def finish(s):
    calls, nonfinite = common.sample_calls(s.ctx.seed, list(zip(s.seeds, s.kernel.seen)), s.batch, s.ctx.traffic)
    low, high = s.cfg.action_bounds()
    return {"calls": calls, "nonfinite": nonfinite, "days": s.days, "pi": s.pi,
            "low": torch.as_tensor(low), "high": torch.as_tensor(high)}


def reference_stats(config: dict, traffic: dict, seed: int, envs, days: int, pi, low, high, root, device,
                    dtype=torch.float32):
    """``(2, len(envs))``: Σ day return and Σ day return² of ``envs`` over
    ``days`` chained days of the call seeded ``seed``, by the plain
    reference in ``dtype``; None when the chain did not settle."""
    grid = config["grid"]
    T, N, _, _ = counts.day_dims(grid)
    tab = grid_tables(grid, root, device, dtype)
    ctrl = ref_day.actor_mean([x.to(device=device, dtype=dtype) for x in pi], low.to(device=device, dtype=dtype),
                              high.to(device=device, dtype=dtype))
    S = len(envs)
    env_all = torch.as_tensor(envs, dtype=torch.int64, device=device)
    chunk = max(1, int(traffic.get("check_lanes", 1 << 16)) // S)
    us, shifts = [], []
    for d0 in range(0, days, chunk):
        d = torch.arange(d0, min(days, d0 + chunk), dtype=torch.int64, device=device)
        u, u_pv = philox.day_draws(seed, d.repeat_interleave(S), env_all.repeat(d.numel()), T, N)
        us.append(u.to(dtype))
        shifts.append(ref_day.pv_shift(u_pv.to(dtype)))
    u, shift = torch.cat(us, dim=2), torch.cat(shifts)
    del us
    first = torch.full((1, S), ref_day.BATT_INIT, dtype=dtype, device=device)
    start = first.expand(days, S).contiguous()
    for _ in range(int(traffic["check_sweeps"])):
        with torch.no_grad():
            day = ref_day.run_day(grid, tab, u, shift, start.reshape(-1), ctrl)
        end = day.batt.view(days, S)
        chained = torch.cat([first, end[:-1]])
        if torch.equal(chained, start):
            ret = day.day_return.view(days, S)
            return torch.stack([ret.sum(0), (ret * ret).sum(0)]).cpu()
        start = chained
    return None


def check(config: dict, traffic: dict, seed: int, outputs: dict, root, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    stats_gap = 0.0
    for call_seed, envs, got in outputs["calls"]:
        want = reference_stats(config, traffic, call_seed, envs, outputs["days"], outputs["pi"], outputs["low"],
                               outputs["high"], root, device)
        stats_gap = max(stats_gap, float("inf") if want is None else compare(got[:2], want))
    lim = traffic["limits"]
    return {"stats_gap": (stats_gap, lim["stats_gap"]), "nonfinite": (float(outputs["nonfinite"]), lim["nonfinite"])}


def control(config: dict, traffic: dict, seed: int, outputs: dict, root, device, dtype) -> dict:
    """The check with the reference in ``dtype`` put in the program's place
    (a chain that does not settle in ``dtype`` gives no number)."""
    calls = []
    for cs, envs, _ in outputs["calls"]:
        got = reference_stats(config, traffic, cs, envs, outputs["days"], outputs["pi"], outputs["low"],
                              outputs["high"], root, device, dtype)
        calls.append((cs, envs, got if got is not None else torch.full((2, len(envs)), float("nan"),
                                                                       dtype=torch.float64)))
    return check(config, traffic, seed, {**outputs, "calls": calls}, root, device)
