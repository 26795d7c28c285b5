"""Evaluation CLI — the port of the JAX package's ``tools/evaluate.py``, the
counterpart of the reference's solvers/evaluator.py.

The reference loads every trained model, replays 100 *identical* days across
all of them via initial_values.json round-trips, and plots per-episode rewards
(solvers/evaluator.py:88-127).  Here the paired same-day comparison runs on
the device (days are the batch axis) and always includes the RBC baseline and
an idle policy; trained checkpoints come from --models-dir / --models-root.

A run directory's checkpoint step is read from the port's own
``<step>/state.pt`` or, for the committed artifacts, from ``<step>.npz``
(:mod:`..utils.weights`); a step that holds neither (an orbax directory of the
JAX package) is skipped with a ``# skipping`` line: the port never restores
orbax.  ``--at-scale DAYS`` scores each checkpoint with
``evaluate_policy_at_scale`` (kernel K6 on the card, PPO and DDPG actors).

Run:  python -m smart_nanogrid_gym_torch.tools.evaluate --variant b-pv --days 100
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core.params import make_params
from ..solvers.ddpg import DDPGLearner
from ..solvers.evaluator import evaluate_policies_same_days, evaluate_policy_at_scale
from ..solvers.networks import actor_critic_from_leaves, actor_critic_leaves, ddpg_actor_from_leaves, ddpg_leaves
from ..solvers.ppo import PPOLearner
from ..solvers.rbc import make_rbc_policy_fn
from ..utils.checkpoint import STATE_FILE, latest_step, restore_checkpoint
from ..utils.weights import load_actor_critic_npz, load_ddpg_actor_npz
from .train_ppo import add_env_flags, build_config, resolve_device


def load_checkpoint_leaves(run_dir: str, step: int, is_ddpg: bool, config, template: list) -> list:
    """The policy leaves of ``run_dir``'s checkpoint ``step`` on the
    template's device: the PPO actor-critic's 13 or the DDPG actor's 6, from
    ``<step>/state.pt`` or else ``<step>.npz``.  Raises ``FileNotFoundError``
    when the step holds neither and ``ValueError`` when its shapes do not
    fit the config."""
    if os.path.exists(os.path.join(run_dir, str(step), STATE_FILE)):
        return restore_checkpoint(run_dir, step, template)
    npz = os.path.join(run_dir, f"{step}.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(f"step {step} holds no {STATE_FILE} and no {step}.npz "
                                f"(an orbax checkpoint, which the port does not restore)")
    net = load_ddpg_actor_npz(npz, config) if is_ddpg else load_actor_critic_npz(npz)
    leaves = ddpg_leaves(net) if is_ddpg else actor_critic_leaves(net)
    for got, want in zip(leaves, template):
        if got.shape != want.shape:
            raise ValueError(f"{npz} holds a {tuple(got.shape)} leaf where the config needs {tuple(want.shape)}")
    device = template[0].device
    return [x.detach().to(device=device, dtype=torch.float32) for x in leaves]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_env_flags(p)
    p.add_argument("--days", type=int, default=100, help="reference: 100 episodes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models-dir", default=None,
                   help="PPO checkpoint dir to evaluate (optional)")
    p.add_argument("--models-root", default=None,
                   help="scan every run dir under this root (reference "
                        "evaluator style, solvers/evaluator.py:44-77)")
    p.add_argument("--checkpoint-step", type=int, default=None)
    p.add_argument("--at-scale", type=int, default=None, metavar="DAYS",
                   help="ALSO evaluate each checkpoint (PPO or DDPG) on DAYS "
                        "freshly generated days x 4096 envs in one launch of "
                        "kernel K6 (solvers.evaluator.evaluate_policy_at_scale)")
    p.add_argument("--sb3-zip", action="append", default=[], metavar="ZIP",
                   help="evaluate an SB3 PPO checkpoint zip as shipped by the "
                        "reference (solvers/RL/models/*/NNN.zip); repeatable")
    p.add_argument("--sb3-models-dir", default=None,
                   help="reference-style model dir of NNN.zip checkpoints; "
                        "picks --sb3-checkpoint (reference evaluator.py:49-51)")
    p.add_argument("--sb3-checkpoint", default="999600",
                   help="checkpoint number inside --sb3-models-dir")
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="save the per-episode reward comparison figure "
                        "(reference solvers/evaluator.py:111-127)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    config = build_config(args)
    params = make_params(config, torch.float32, device)
    rbc = make_rbc_policy_fn(config)

    policies = {
        "RBC": rbc,
        "idle": lambda obs: torch.zeros(obs.shape[:-1] + (config.num_actions,), dtype=obs.dtype, device=obs.device),
    }

    model_dirs = []
    at_scale_checkpoints: dict[str, tuple] = {}
    if args.models_dir:
        model_dirs.append(args.models_dir)
    if args.models_root and os.path.isdir(args.models_root):
        for name in sorted(os.listdir(args.models_root)):
            path = os.path.join(args.models_root, name)
            if os.path.isdir(path) and latest_step(path) is not None:
                model_dirs.append(path)

    # Algorithm inferred from the run-dir name prefix, like the reference
    # evaluator's name->algorithm mapping (solvers/evaluator.py:67-77).
    # Learners and their template leaves are built on the first matching run dir.
    learners: dict[bool, tuple] = {}

    def get_learner(is_ddpg: bool):
        if is_ddpg not in learners:
            if is_ddpg:
                learner = DDPGLearner(config, device=device)
                template = learner.init(0, params, batch_size=1).actor
            else:
                learner = PPOLearner(config, device=device)
                template = learner.init(0, params, batch_size=1).params
            learners[is_ddpg] = (learner, template)
        return learners[is_ddpg]

    low, high = config.action_bounds()
    for d in model_dirs:
        name = os.path.basename(os.path.normpath(d))
        step = args.checkpoint_step if args.checkpoint_step is not None else latest_step(d)
        is_ddpg = name.upper().startswith("DDPG")
        learner, template = get_learner(is_ddpg)
        try:
            leaves = load_checkpoint_leaves(d, step, is_ddpg, config, template)
        except (FileNotFoundError, ValueError) as exc:  # an orbax-only step, or another config's run dir
            print(f"# skipping {d}: {exc}", flush=True)
            continue
        policies[f"{name}@{step}"] = learner.policy_fn(leaves)
        net = ddpg_actor_from_leaves(leaves, low, high) if is_ddpg else actor_critic_from_leaves(leaves)
        at_scale_checkpoints[f"{name}@{step}"] = ("ddpg" if is_ddpg else "ppo", net)

    sb3_zips = list(args.sb3_zip)
    if args.sb3_models_dir:
        sb3_zips.append(os.path.join(args.sb3_models_dir, f"{args.sb3_checkpoint}.zip"))
    if sb3_zips:
        from ..compat.sb3_loader import load_sb3_actor_critic, make_sb3_policy_fn

        for zip_path in sb3_zips:
            leaves, _ = load_sb3_actor_critic(zip_path, config)
            leaves = [x.to(device) for x in leaves]
            tag = "SB3-" + os.path.splitext(os.path.basename(zip_path))[0]
            parent = os.path.basename(os.path.dirname(os.path.abspath(zip_path)))
            if parent:
                tag = f"SB3-{parent}@{os.path.splitext(os.path.basename(zip_path))[0]}"
            policies[tag] = make_sb3_policy_fn(config, leaves)
            at_scale_checkpoints[tag] = ("ppo", actor_critic_from_leaves(leaves))

    results = evaluate_policies_same_days(config, params, policies, num_days=args.days, seed=args.seed)
    report = {
        name: {
            "mean_day_return": float(np.mean(r)),
            "std": float(np.std(r)),
            "min": float(np.min(r)),
            "max": float(np.max(r)),
        }
        for name, r in results.items()
    }

    if args.at_scale:
        for name, (algo, net) in at_scale_checkpoints.items():
            report[f"{name} (at-scale)"] = evaluate_policy_at_scale(
                config, params, net, num_days=args.at_scale, seed=args.seed, algorithm=algo)

    if args.plot:
        plot_reward_comparison(results, args.plot)
        report["figure"] = args.plot

    print(json.dumps(report, indent=2))
    return results


def plot_reward_comparison(results: dict[str, np.ndarray], out_path: str) -> str:
    """Per-episode total-reward comparison across policies — the figure the
    reference evaluator produces (solvers/evaluator.py:111-127, shipped as
    images/Comparison_Evaluation_Reward.png): one line per model over the
    evaluation episodes, legend, grid."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(15, 10))
    for name, rewards in results.items():
        ax.plot(np.asarray(rewards), label=name)
    ax.set_xlabel("Evaluation episodes")
    ax.set_ylabel("Total reward per episode")
    ax.legend()
    ax.grid(True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    main()
