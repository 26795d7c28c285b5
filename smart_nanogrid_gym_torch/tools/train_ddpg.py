"""DDPG training CLI — the port of the JAX package's ``tools/train_ddpg.py``,
the counterpart of the reference's solvers/RL/ddpg_train.py.

Matches the reference setup: OU action noise with sigma=0.5 (ddpg_train.py:111),
the same four env variants, per-epoch numbered checkpoints of the actor under a
config-encoded directory name (``DDPG-{variant}-...``).  ``--device`` and
``--impl`` as in :mod:`.train_ppo`: ``--impl kernel`` collects with K9 seeded
and updates with K10, one launch each per update.

Run:  python -m smart_nanogrid_gym_torch.tools.train_ddpg --variant b-pv --epochs 5
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..core.params import make_params
from ..solvers.ddpg import DDPGConfig, DDPGLearner
from ..utils.checkpoint import save_checkpoint
from ..utils.metrics import MetricsWriter
from .train_ppo import add_env_flags, build_config, resolve_device, run_name, updates_per_epoch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_env_flags(p)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--episodes-per-epoch", type=int, default=850)
    p.add_argument("--ou-sigma", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models-dir", default="models")
    p.add_argument("--impl", choices=["plain", "kernel"], default="plain",
                   help="collection and update sweep: the plain engine, or K9 seeded + K10")
    p.add_argument("--log-dir", default=None,
                   help="write progress.csv + TensorBoard events here "
                        "(default: <models-dir>/<run>/logs)")
    p.add_argument("--log-every", type=int, default=1)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    config = build_config(args)
    learner = DDPGLearner(config, DDPGConfig(ou_sigma=args.ou_sigma, collect_impl=args.impl,
                                             sweep_impl=args.impl), device=device)
    params = make_params(config, torch.float32, device)
    state = learner.init(args.seed, params, batch_size=args.batch)
    train_step = learner.build_train_step()

    models_dir = os.path.join(args.models_dir, run_name("DDPG", args, config))
    n_updates = updates_per_epoch(args)
    steps_per_update = args.batch * config.steps_per_day

    writer = MetricsWriter(args.log_dir or os.path.join(models_dir, "logs"))
    start = time.time()
    total_steps = 0
    for epoch in range(args.epochs):
        for _ in range(n_updates):
            state, metrics = train_step(state, params)
            total_steps += steps_per_update
        if epoch % args.log_every == 0 or epoch == args.epochs - 1:
            m = {k: float(v) for k, v in metrics._asdict().items()}
            elapsed = time.time() - start
            print(json.dumps({
                "epoch": epoch,
                "mean_day_return": round(m["mean_return"], 3),
                "critic_loss": round(m["critic_loss"], 4),
                "actor_loss": round(m["actor_loss"], 4),
                "env_steps": total_steps,
                "steps_per_sec": round(total_steps / elapsed, 1),
            }), flush=True)
            writer.add(
                total_steps,
                mean_day_return=m["mean_return"],
                critic_loss=m["critic_loss"],
                actor_loss=m["actor_loss"],
                steps_per_sec=total_steps / elapsed,
            )
        save_checkpoint(models_dir, steps_per_update * n_updates * (epoch + 1), state.actor, env_config=config)

    writer.close()
    elapsed = time.time() - start
    print(f"Training lasted: {elapsed/3600:.0f} h and {elapsed%3600/60:.1f} min", flush=True)
    return state


if __name__ == "__main__":
    main()
