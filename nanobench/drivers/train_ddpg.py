"""Closed-loop DDPG training on the kernel path: each unit is one update of
``DDPGLearner(DDPGConfig(collect_impl="kernel", sweep_impl="kernel"))``
through the step ``build_train_step`` returns (the host draws, the OU
sequence, K9 seeded's collection day, its insert into the replay on the
card, the gather of ``gradient_steps`` minibatches from it and K10's sweep
over them), the train state carried from update to update, synchronised at
its end as a trainer that checks each update waits.  ``sweep_dtype``
(default ``float32``) sets the learner's ``update_matmul_dtype``:
``bfloat16`` runs K10's products on the tensor cores, the program's own
lower-precision path, which the control reads.  ``minibatch``,
``gradient_steps`` and ``buffer_days``, where the traffic gives them, take
the place of the configuration's.

Set-up makes the actor and the critic on the card from the run's seed (the
targets equal to them), builds the one learner and train state, and drives
it through its first ``check_updates`` updates, keeping the state each
starts from; the plain reference runs each of them again from that state
(networks, Adam states, the replay's rows, the batteries and the host
generator), so that rounding does not compound from one update into the
next, and the state the program carries into each next update is held
against what the reference's update left (``carry_gap``,
``carry_mismatch``), so that no link between updates goes unchecked.  The
window goes on from that state, and after it the check reads the window's
final state: every parameter, target and Adam moment finite,
every leaf the reference moves moved over the window, and each Adam step
count advanced by ``gradient_steps`` for each of the window's updates.  The
benchmark's spans around the learner's calls into ``ops/ddpg_collect.py``
and ``ops/ddpg_sweep.py`` let a traced run attribute the device's work to
them.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from nanobench import common
from nanobench import work as counts
from nanobench import work_ddpg
from nanobench.reference import ddpg as ref_ddpg
from nanobench.reference.tables import grid_tables
from nanobench.spans import Wrapped

END_TO_END = "train_env_steps_per_s"
# the program's own lower-precision path, read as a control: K10's products in bf16
PROGRAM_CONTROLS = {"program_bf16_sweep": {"sweep_dtype": "bfloat16"}}


def relu_torso(fan_in: int, hidden, out: int, gen: torch.Generator, device) -> list[torch.Tensor]:
    """The 6 leaves of a ReLU torso drawn on ``device``: weights normal with
    the standard deviation 1 / √fan_in, biases zero."""
    sizes = [fan_in, *hidden, out]
    leaves = []
    for rows, cols in zip(sizes[1:], sizes[:-1]):
        leaves.append(torch.randn((rows, cols), generator=gen, device=device) / math.sqrt(cols))
        leaves.append(torch.zeros(rows, device=device))
    return leaves


def hypers(config: dict, traffic: dict) -> dict:
    hp = dict(config["learner"])
    hp.update({k: traffic[k] for k in ("minibatch", "gradient_steps", "buffer_days") if k in traffic})
    return hp


def _leaves(xs) -> list:
    return [_host(x) for x in xs]


def _host(x: torch.Tensor) -> torch.Tensor:
    """A copy in host memory: what the check keeps takes no room on the card."""
    return x.detach().to("cpu", copy=True)


def _nets(state) -> ref_ddpg.Nets:
    return ref_ddpg.Nets(*(_leaves(x) for x in (state.actor, state.critic, state.target_actor, state.target_critic)))


def _start(state) -> dict:
    """What the reference needs to run an update from where the program did."""
    buf = state.buffer
    return {"nets": _nets(state),
            "opts": [ref_ddpg.Adam(o.count, _leaves(o.mu), _leaves(o.nu)) for o in (state.actor_opt, state.critic_opt)],
            "replay": [_host(x[:buf.filled]) for x in buf[:5]], "pos": buf.insert_pos, "filled": buf.filled,
            "batt": _host(state.batt_soc), "generator": state.generator.get_state()}


def _reading(metrics, state, day, carry: dict) -> SimpleNamespace:
    """One update as the check reads it (the fields of ``ref_ddpg.Update``);
    ``day`` is K9's ``(obs, act (T, A, B), rewards (T, B), next_obs (T, F, B),
    batt)``, ``carry`` the :func:`_start` of the state the update left."""
    _, act, rew, nxt, _ = day
    return SimpleNamespace(
        critic_loss=float(metrics.critic_loss), actor_loss=float(metrics.actor_loss),
        mean_return=float(metrics.mean_return), carry=carry,
        nets=_nets(state),
        actor_opt=ref_ddpg.Adam(state.actor_opt.count, _leaves(state.actor_opt.mu), None),
        critic_opt=ref_ddpg.Adam(state.critic_opt.count, _leaves(state.critic_opt.mu), None),
        rewards=_host(rew), actions=_host(act.permute(0, 2, 1)), next_obs=_host(nxt.permute(0, 2, 1)))


def setup(ctx):
    from smart_nanogrid_gym_torch.core.params import make_params
    from smart_nanogrid_gym_torch.ops.ppo_sweep import zeros_adam
    from smart_nanogrid_gym_torch.solvers import ddpg

    grid, t = ctx.config["grid"], ctx.traffic
    cfg = common.program_config(grid)
    T, _, F, A = counts.day_dims(grid)
    hidden = tuple(ctx.config["network"]["hidden"])
    hp = hypers(ctx.config, t)
    wseed, gseed = common.seeds(ctx.seed, 2, salt=5)
    gen = torch.Generator(device=ctx.device).manual_seed(wseed)
    actor = relu_torso(F, hidden, A, gen, ctx.device)
    critic = relu_torso(F + A, hidden, 1, gen, ctx.device)
    learner = ddpg.DDPGLearner(cfg, ddpg.DDPGConfig(
        learning_rate=hp["learning_rate"], gamma=hp["gamma"], tau=hp["tau"], batch_size=hp["minibatch"],
        buffer_days=hp["buffer_days"], ou_sigma=hp["ou_sigma"], ou_theta=hp["ou_theta"], ou_dt=hp["ou_dt"],
        steps_per_update=T, gradient_steps=hp["gradient_steps"], collect_impl="kernel", sweep_impl="kernel",
        update_matmul_dtype=getattr(torch, t.get("sweep_dtype", "float32"))), device=ctx.device)
    params = make_params(cfg, torch.float32, ctx.device)
    B = int(t["batch"])
    batt = torch.full((B,), float(grid["battery_initial_soc"]), device=ctx.device)
    state = learner.state_from(actor, critic, actor, critic, zeros_adam(actor), zeros_adam(critic), batt,
                               torch.Generator().manual_seed(gseed), params)
    s = SimpleNamespace(ctx=ctx, cfg=cfg, params=params, hidden=hidden, batch=B, hp=hp,
                        step=learner.build_train_step(), low_high=cfg.action_bounds(),
                        collect=Wrapped(ddpg, "ddpg_collect_day_seeded", "collect", keep=True),
                        sweep=Wrapped(ddpg, "ddpg_sweep", "sweep"))
    s.starts, s.readings = [], []
    start = _start(state)
    for _ in range(int(t["check_updates"])):
        s.starts.append(start)
        state, metrics = s.step(state, params)
        start = _start(state)
        s.readings.append(_reading(metrics, state, s.collect.seen.pop(), start))
    s.collect.keep = False
    s.state = state
    s.window_start = ([x.detach().clone() for x in state.actor + state.critic],
                      state.actor_opt.count, state.critic_opt.count)
    s.window_updates = 0
    return s


def unit(s) -> int:
    s.state, _ = s.step(s.state, s.params)
    common.sync(s.ctx.device)
    s.window_updates += 1
    return s.batch * s.cfg.steps_per_day


def work(s) -> dict:
    grid, hp = s.ctx.config["grid"], s.hp
    return {"collect": work_ddpg.collect_day_seeded(grid, s.hidden, s.batch),
            "sweep": work_ddpg.sweep(grid, s.hidden, hp["gradient_steps"], hp["minibatch"])}


def finish(s):
    low, high = s.low_high
    start, a_count, c_count = s.window_start
    final = s.state
    steps = s.window_updates * s.hp["gradient_steps"]
    leaves = final.actor + final.critic + final.target_actor + final.target_critic
    moments = final.actor_opt.mu + final.actor_opt.nu + final.critic_opt.mu + final.critic_opt.nu
    window = {"nonfinite": sum(int((~torch.isfinite(x)).sum()) for x in leaves + moments),
              "unmoved": [bool(torch.equal(a, b)) for a, b in zip(final.actor + final.critic, start)],
              "steps_missed": abs(a_count + steps - final.actor_opt.count)
              + abs(c_count + steps - final.critic_opt.count)}
    return {"readings": s.readings, "starts": s.starts, "batch": s.batch, "window": window,
            "low": torch.as_tensor(low), "high": torch.as_tensor(high)}


def reference_updates(config: dict, traffic: dict, outputs: dict, root, device, tf32: bool = False,
                      keep: float = 1.0, sweep_tf32: bool = False) -> list:
    """Each update of set-up by the plain reference, from the state the
    program started it from; ``tf32`` runs its products in TF32 (the
    control), ``sweep_tf32`` only the gradient steps' products, ``keep``
    leaves part of each minibatch out (a fault)."""
    grid, hp = config["grid"], hypers(config, traffic)
    ref_hp = ref_ddpg.Hypers(lr=hp["learning_rate"], gamma=hp["gamma"], tau=hp["tau"], minibatch=hp["minibatch"],
                             gradient_steps=hp["gradient_steps"], buffer_days=hp["buffer_days"],
                             ou_sigma=hp["ou_sigma"], ou_theta=hp["ou_theta"], ou_dt=hp["ou_dt"])
    T, _, F, A = counts.day_dims(grid)
    tab = grid_tables(grid, root, device)
    low, high = outputs["low"].to(device), outputs["high"].to(device)
    out = []
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        for st in outputs["starts"]:
            replay = ref_ddpg.empty_replay(ref_hp.buffer_days, T, outputs["batch"], F, A, device)
            for dst, src in zip(replay[:5], st["replay"]):
                dst[:len(src)] = src.to(device)
            replay = replay._replace(pos=st["pos"], filled=st["filled"])
            gen = torch.Generator()
            gen.set_state(st["generator"])
            nets = ref_ddpg.Nets(*([x.to(device) for x in net] for net in st["nets"]))
            a_opt, c_opt = (ref_ddpg.Adam(o.count, [x.to(device) for x in o.mu], [x.to(device) for x in o.nu])
                            for o in st["opts"])
            out.append(ref_ddpg.update(grid, tab, nets, a_opt, c_opt, replay, st["batt"].to(device), gen, low, high,
                                       ref_hp, keep, sweep_tf32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return out


def check(config: dict, traffic: dict, seed: int, outputs: dict, root, device, tf32: bool = False,
          keep: float = 1.0, sweep_tf32: bool = False) -> dict:
    """The program's first updates against the reference's, and the window's
    final state; with ``tf32``, ``sweep_tf32`` or ``keep`` the reference so
    changed stands in the program's first updates."""
    swapped = tf32 or sweep_tf32 or keep < 1.0
    got = (reference_updates(config, traffic, outputs, root, device, tf32, keep, sweep_tf32) if swapped
           else outputs["readings"])
    want = reference_updates(config, traffic, outputs, root, device)
    numbers = ref_ddpg.check_updates(got, want, [st["nets"] for st in outputs["starts"]])
    window = outputs["window"]
    moving = ref_ddpg.moving_leaves(want[0].actor_opt.mu)
    moving += [6 + i for i in ref_ddpg.moving_leaves(want[0].critic_opt.mu)]
    numbers["window_nonfinite"] = float(window["nonfinite"])
    numbers["window_unmoved"] = float(sum(window["unmoved"][i] for i in moving))
    numbers["window_steps_missed"] = float(window["steps_missed"])
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
