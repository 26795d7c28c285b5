"""Multi-algorithm, multi-variant training sweep (port of the JAX package's
``tools/train_multi.py``).

The reference ships an *empty* ``solvers/RL/train_multi_algorithms.py``
placeholder; this is the working equivalent: train PPO and/or DDPG across any
subset of the four env variants in one command, with per-run checkpoints and a
final same-day cross-evaluation of every trained policy plus the RBC baseline,
all on ``--device``.

Run:  python -m smart_nanogrid_gym_torch.tools.train_multi \\
          --algos ppo ddpg --variants basic b-pv --epochs 2 --batch 64
"""

from __future__ import annotations

import argparse
import json

from .evaluate import main as evaluate_main
from .train_ddpg import main as train_ddpg_main
from .train_ppo import VARIANTS, main as train_ppo_main


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--algos", nargs="+", choices=["ppo", "ddpg"], default=["ppo", "ddpg"])
    p.add_argument("--variants", nargs="+", choices=sorted(VARIANTS), default=["basic", "b-pv"])
    p.add_argument("--num-chargers", type=int, default=4)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--episodes-per-epoch", type=int, default=850)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models-dir", default="models")
    p.add_argument("--eval-days", type=int, default=100)
    p.add_argument("--device", default="cuda", help="torch device of every run (cuda raises without a card)")
    args = p.parse_args(argv)

    common = [
        "--num-chargers", str(args.num_chargers),
        "--batch", str(args.batch),
        "--epochs", str(args.epochs),
        "--episodes-per-epoch", str(args.episodes_per_epoch),
        "--models-dir", args.models_dir,
        "--seed", str(args.seed),
        "--device", args.device,
    ]
    for variant in args.variants:
        for algo in args.algos:
            print(json.dumps({"training": algo, "variant": variant}), flush=True)
            train = train_ppo_main if algo == "ppo" else train_ddpg_main
            train(["--variant", variant] + common)

    results = {}
    for variant in args.variants:
        print(json.dumps({"evaluating_variant": variant}), flush=True)
        results[variant] = evaluate_main([
            "--variant", variant,
            "--num-chargers", str(args.num_chargers),
            "--days", str(args.eval_days),
            "--models-root", args.models_dir,
            "--device", args.device,
        ])
    return results


if __name__ == "__main__":
    main()
