"""Closed-loop PPO training on the kernel path: each unit is one update of
``PPOLearner(PPOConfig(collect_impl="kernel", sweep_impl="kernel"))`` through
the step ``build_train_step`` returns (K2's collection day, GAE, K3's sweep
of ``epochs × minibatches`` gradient steps), the train state carried from
update to update, synchronised at its end as a trainer that checks each
update waits.  ``sweep_dtype`` (default ``float32``) sets the learner's
``update_matmul_dtype``: ``bfloat16`` runs K3's products on the tensor cores,
the program's own lower-precision path, which the control reads.

Set-up builds the one learner and train state from weights made on the card
from the run's seed, and drives it through its first ``check_updates``
updates, which the plain reference follows; the window goes on from that
state, and after it the check reads the window's final state: every
parameter and Adam moment finite, every leaf the reference moves moved over
the window, and Adam's step count advanced by each of the window's updates.  The benchmark's spans around the learner's calls into
``ops/collect.py`` and ``ops/ppo_sweep.py`` let a traced run attribute the
device's work to them.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from nanobench import common
from nanobench import work as counts
from nanobench.reference import ppo as ref_ppo
from nanobench.reference.tables import grid_tables
from nanobench.spans import Wrapped

END_TO_END = "train_env_steps_per_s"
# the program's own lower-precision path, read as a control: K3's products in bf16
PROGRAM_CONTROLS = {"program_bf16_sweep": {"sweep_dtype": "bfloat16"}}


def _reading(metrics, state, vf_coef: float, value, keep_mu: bool, keep_params: bool) -> SimpleNamespace:
    """One update as the check reads it (the fields of ``ref_ppo.Update``)."""
    return SimpleNamespace(loss=float(metrics.policy_loss) + vf_coef * float(metrics.value_loss), value=value,
                   mean_return=float(metrics.mean_return),
                   mu=[x.detach().clone() for x in state.opt_state.mu] if keep_mu else None,
                   params=[x.detach().clone() for x in state.params] if keep_params else None)


def setup(ctx):
    from smart_nanogrid_gym_torch.core.params import make_params
    from smart_nanogrid_gym_torch.ops.ppo_sweep import zeros_adam
    from smart_nanogrid_gym_torch.solvers import ppo

    grid, net_cfg, t = ctx.config["grid"], ctx.config["network"], ctx.traffic
    cfg = common.program_config(grid)
    _, _, F, A = counts.day_dims(grid)
    hidden = tuple(net_cfg["hidden"])
    wseed, gseed = common.seeds(ctx.seed, 2, salt=4)
    leaves = common.actor_critic(F, A, hidden, wseed, ctx.device, float(net_cfg["train_pi_out_gain"]))
    hp = ctx.config["learner"]
    learner = ppo.PPOLearner(cfg, ppo.PPOConfig(
        learning_rate=hp["learning_rate"], gamma=hp["gamma"], gae_lambda=hp["gae_lambda"], clip_eps=hp["clip"],
        entropy_coef=hp["ent_coef"], vf_coef=hp["vf_coef"], max_grad_norm=hp["max_grad_norm"],
        num_epochs=hp["epochs"], num_minibatches=hp["minibatches"], collect_impl="kernel", sweep_impl="kernel",
        update_matmul_dtype=getattr(torch, t.get("sweep_dtype", "float32"))), device=ctx.device)
    params = make_params(cfg, torch.float32, ctx.device)
    B = int(t["batch"])
    batt = torch.full((B,), float(grid["battery_initial_soc"]), device=ctx.device)
    state = learner.state_from(leaves, zeros_adam(leaves), batt, torch.Generator().manual_seed(gseed), params)
    s = SimpleNamespace(ctx=ctx, cfg=cfg, params=params, hidden=hidden, batch=B, step=learner.build_train_step(),
                        leaves0=[x.detach().clone() for x in leaves], gseed=gseed, hp=hp,
                        collect=Wrapped(ppo, "ppo_collect_day_seeded", "collect", keep=True),
                        sweep=Wrapped(ppo, "ppo_sweep_streamed", "sweep"), low_high=cfg.action_bounds())
    s.readings = []
    n = int(t["check_updates"])
    for i in range(n):
        state, metrics = s.step(state, params)
        value = s.collect.seen[0][3].clone() if i == 0 else None   # K2's (T, B) values
        s.collect.keep = False
        s.readings.append(_reading(metrics, state, hp["vf_coef"], value, i == 0, i in (0, n - 1)))
    s.collect.seen.clear()
    s.state = state
    s.window_start = ([x.detach().clone() for x in state.params], state.opt_state.count)
    s.window_updates = 0
    return s


def unit(s) -> int:
    s.state, metrics = s.step(s.state, s.params)
    common.sync(s.ctx.device)
    s.window_updates += 1
    return s.batch * s.cfg.steps_per_day


def work(s) -> dict:
    grid, hp = s.ctx.config["grid"], s.hp
    return {"collect": counts.collect_day(grid, s.hidden, s.batch),
            "sweep": counts.sweep(grid, s.hidden, s.batch, hp["epochs"], hp["minibatches"])}


def finish(s):
    low, high = s.low_high
    start, count = s.window_start
    final = s.state
    moments = final.opt_state.mu + final.opt_state.nu
    window = {"nonfinite": sum(int((~torch.isfinite(x)).sum()) for x in final.params + moments),
              "unmoved": [bool(torch.equal(a, b)) for a, b in zip(final.params, start)],
              "steps_missed": count + s.window_updates * s.hp["epochs"] * s.hp["minibatches"] - final.opt_state.count}
    return {"readings": s.readings, "leaves0": s.leaves0, "gseed": s.gseed, "batch": s.batch, "window": window,
            "hidden": s.hidden, "low": torch.as_tensor(low), "high": torch.as_tensor(high)}


def reference_updates(config: dict, outputs: dict, n: int, root, device, tf32: bool = False,
                      keep: float = 1.0, sweep_tf32: bool = False) -> list:
    """The first ``n`` updates by the plain reference, from the weights and
    the generator seed handed to the program; ``tf32`` runs its products in
    TF32 (the control), ``sweep_tf32`` only the gradient steps' products,
    ``keep`` leaves part of each minibatch out (a fault)."""
    grid, hp = config["grid"], config["learner"]
    hypers = ref_ppo.Hypers(lr=hp["learning_rate"], gamma=hp["gamma"], gae_lambda=hp["gae_lambda"],
                            clip=hp["clip"], vf_coef=hp["vf_coef"], ent_coef=hp["ent_coef"],
                            max_grad_norm=hp["max_grad_norm"], epochs=hp["epochs"], minibatches=hp["minibatches"])
    tab = grid_tables(grid, root, device)
    params = [x.to(device) for x in outputs["leaves0"]]
    mu = [torch.zeros_like(x) for x in params]
    nu = [torch.zeros_like(x) for x in params]
    batt = torch.full((outputs["batch"],), float(grid["battery_initial_soc"]), device=device)
    gen = torch.Generator().manual_seed(outputs["gseed"])
    low, high = outputs["low"].to(device), outputs["high"].to(device)
    out = []
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        for i in range(n):
            up = ref_ppo.update(grid, tab, params, mu, nu, i * hypers.epochs * hypers.minibatches, batt, gen,
                                outputs["hidden"], low, high, hypers, keep, sweep_tf32)
            params, mu, nu, batt = up.params, up.mu, up.nu, up.batt
            out.append(up)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return out


def check(config: dict, traffic: dict, seed: int, outputs: dict, root, device, tf32: bool = False,
          keep: float = 1.0, sweep_tf32: bool = False) -> dict:
    """The program's first updates against the reference's, and the window's
    final state; with ``tf32``, ``sweep_tf32`` or ``keep`` the reference so
    changed stands in the program's first updates."""
    n = len(outputs["readings"])
    swapped = tf32 or sweep_tf32 or keep < 1.0
    got = (reference_updates(config, outputs, n, root, device, tf32, keep, sweep_tf32) if swapped
           else outputs["readings"])
    want = reference_updates(config, outputs, n, root, device)
    numbers = ref_ppo.check_updates(got, want, [x.to(device) for x in outputs["leaves0"]])
    window = outputs["window"]
    moving = ref_ppo.moving_leaves(want[0].mu)
    numbers["window_nonfinite"] = float(window["nonfinite"])
    numbers["window_unmoved"] = float(sum(window["unmoved"][i] for i in moving))
    numbers["window_steps_missed"] = float(abs(window["steps_missed"]))
    lim = traffic["limits"]
    return {k: (v, lim[k]) for k, v in numbers.items()}


def control(config: dict, traffic: dict, seed: int, outputs: dict, root, device, dtype) -> dict:
    return check(config, traffic, seed, outputs, root, device, tf32=True)


def sweep_control(config: dict, traffic: dict, seed: int, outputs: dict, root, device) -> dict:
    """The reference with only its gradient steps' products in TF32 (its
    collection in f32) in the program's place: a sweep cut to TF32 alone."""
    return check(config, traffic, seed, outputs, root, device, sweep_tf32=True)


def fault(config: dict, traffic: dict, seed: int, outputs: dict, root, device) -> dict:
    """Half of each minibatch left out, the mean taken over the rest."""
    return check(config, traffic, seed, outputs, root, device, keep=0.5)
