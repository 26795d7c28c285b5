"""PPO training CLI — the port of the JAX package's ``tools/train_ppo.py``,
the counterpart of the reference's solvers/RL/ppo_train.py.

The reference trains SB3 PPO for 50 epochs x 850 episodes x 24 steps = 1.02M
sequential env steps against one Python env (ppo_train.py:94-102).  Here each
update rolls a whole env *batch* for a day on the device, so an epoch's 850
episodes take ceil(850/batch) updates; checkpoints are written per epoch with
the reference's numbered convention and config-encoded directory names
(``PPO-{variant}-{charging_mode}-{penalty_mode}-{N}ch-{interval}``,
ppo_train.py:79): the params numbered in env-steps, the full train state under
``full/`` numbered by epoch (``--resume`` continues from the newest).

``--device`` (default ``cuda``) places the run; without a card ``cuda``
raises.  ``--impl kernel`` trains through K2 + K3 (one launch each per
update), ``plain`` (the default, the JAX CLI's ``xla``) through the plain
engine and autograd.

Run:  python -m smart_nanogrid_gym_torch.tools.train_ppo --variant b-pv \\
          --num-chargers 4 --batch 256 --epochs 5
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from ..core.config import NanogridConfig
from ..core.params import make_params
from ..solvers.ppo import PPOConfig, PPOLearner
from ..utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..utils.metrics import MetricsWriter

# The four model variants of the reference training scripts
# (solvers/RL/ppo_train.py:22-75).
VARIANTS = {
    "basic": dict(pv_system=False, battery_system=False, vehicle_to_everything=False),
    "b-pv": dict(pv_system=True, battery_system=True, vehicle_to_everything=False),
    "v2x": dict(pv_system=False, battery_system=False, vehicle_to_everything=True),
    "v2x-b-pv": dict(pv_system=True, battery_system=True, vehicle_to_everything=True),
}
PENALTY_MODES = ["no_penalty", "on_departure", "sparse", "dense"]
MESH_NOT_PORTED = ("--mesh/--distributed: multi-device training is not ported yet "
                   "(ROADMAP queue 1, the parallel/ item)")


def build_config(args) -> NanogridConfig:
    return NanogridConfig(
        num_chargers=args.num_chargers,
        time_interval=args.time_interval,
        price_model=args.price_model,
        penalty_mode=args.penalty_mode,
        **VARIANTS[args.variant],
    )


def resolve_device(name: str) -> torch.device:
    """The device of ``--device``; ``cuda`` without a card raises, it never
    runs on the CPU instead."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card and torch.cuda.is_available() is False; "
                           "pass --device cpu to run on the CPU")
    return device


def run_name(algo: str, args, config: NanogridConfig) -> str:
    """``{ALGO}-{variant}-{charging_mode}-{penalty}-{N}ch-{interval}h`` (ppo_train.py:79)."""
    return (f"{algo}-{args.variant}-{config.charging_mode}-{PENALTY_MODES[int(config.penalty_mode)]}-"
            f"{config.num_chargers}ch-{args.time_interval}h")


def updates_per_epoch(args) -> int:
    return max(1, math.ceil(args.episodes_per_epoch / args.batch))


def add_env_flags(p: argparse.ArgumentParser) -> None:
    """The env and placement flags every training CLI shares."""
    p.add_argument("--variant", choices=sorted(VARIANTS), default="b-pv")
    p.add_argument("--num-chargers", type=int, default=4)
    p.add_argument("--time-interval", type=float, default=1.0)
    p.add_argument("--price-model", type=int, default=0)
    p.add_argument("--penalty-mode", default="sparse", choices=PENALTY_MODES)
    p.add_argument("--device", default="cuda", help="torch device of the run (cuda raises without a card)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_env_flags(p)
    p.add_argument("--batch", type=int, default=256, help="parallel envs")
    p.add_argument("--epochs", type=int, default=50, help="reference: 50")
    p.add_argument("--episodes-per-epoch", type=int, default=850, help="reference: 850")
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models-dir", default="models")
    p.add_argument("--impl", choices=["plain", "kernel"], default="plain",
                   help="collection and update sweep: the plain engine, or K2 + K3")
    p.add_argument("--mesh", action="store_true", help="shard envs over all devices (not ported: raises)")
    p.add_argument("--distributed", action="store_true", help="multi-host training (not ported: raises)")
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--log-dir", default=None,
                   help="write progress.csv + TensorBoard events here "
                        "(default: <models-dir>/<run>/logs; reference: "
                        "ppo_train.py:92 tensorboard_log)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest full-state checkpoint in models-dir")
    p.add_argument("--guard", action="store_true",
                   help="wrap training in a NaN guard with auto-rollback")
    args = p.parse_args(argv)
    if args.mesh or args.distributed:
        raise NotImplementedError(MESH_NOT_PORTED)

    device = resolve_device(args.device)
    config = build_config(args)
    learner = PPOLearner(config, PPOConfig(learning_rate=args.learning_rate, collect_impl=args.impl,
                                           sweep_impl=args.impl), device=device)
    params = make_params(config, torch.float32, device)
    state = learner.init(args.seed, params, batch_size=args.batch)
    train_step = learner.build_train_step()

    name = run_name("PPO", args, config)
    models_dir = os.path.join(args.models_dir, name)
    full_state_dir = os.path.join(models_dir, "full")
    n_updates = updates_per_epoch(args)
    steps_per_update = args.batch * config.steps_per_day

    start_epoch = 0
    if args.resume:
        step = latest_step(full_state_dir)
        if step is not None:
            state = restore_checkpoint(full_state_dir, step, state)
            start_epoch = int(step)
            print(f"resumed from epoch {start_epoch}", flush=True)

    print(f"training {name}: {args.epochs} epochs x {n_updates} updates "
          f"x {steps_per_update} env-steps on {device}", flush=True)
    writer = MetricsWriter(args.log_dir or os.path.join(models_dir, "logs"))
    if args.guard:
        from ..utils.guard import TrainGuard

        guard = TrainGuard(lambda s: train_step(s, params), ckpt_dir=os.path.join(models_dir, "guard"),
                           save_every=n_updates)

    start = time.time()
    total_steps = 0
    for epoch in range(start_epoch, args.epochs):
        if args.guard:
            metrics = None

            def _capture(i, m):
                nonlocal metrics
                metrics = m

            state = guard.run(state, n_updates, on_metrics=_capture)
        else:
            for _ in range(n_updates):
                state, metrics = train_step(state, params)
        total_steps += steps_per_update * n_updates
        if epoch % args.log_every == 0 or epoch == args.epochs - 1:
            m = type(metrics)(*map(float, metrics))
            elapsed = time.time() - start
            print(json.dumps({
                "epoch": epoch,
                "mean_day_return": round(m.mean_return, 3),
                "policy_loss": round(m.policy_loss, 5),
                "value_loss": round(m.value_loss, 3),
                "approx_kl": round(m.approx_kl, 5),
                "env_steps": total_steps,
                "steps_per_sec": round(total_steps / elapsed, 1),
            }), flush=True)
            writer.add(
                total_steps,
                mean_day_return=m.mean_return,
                policy_loss=m.policy_loss,
                value_loss=m.value_loss,
                entropy=m.entropy,
                approx_kl=m.approx_kl,
                steps_per_sec=total_steps / elapsed,
            )
        save_checkpoint(models_dir, steps_per_update * n_updates * (epoch + 1), state.params, env_config=config)
        save_checkpoint(full_state_dir, epoch + 1, state)

    writer.close()
    elapsed = time.time() - start
    print(f"Training lasted: {elapsed/3600:.0f} h and {elapsed%3600/60:.1f} min "
          f"({total_steps/elapsed:,.0f} env-steps/s)", flush=True)
    return state


if __name__ == "__main__":
    main()
