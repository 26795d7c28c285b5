"""Multi-process distributed worker, a runnable multi-process demonstration
(port of ``parallel/multihost_demo.py``).

One process per rank, wired by ``torch.distributed``: gloo on the CPU (N OS
processes, one rank each; torch has no virtual devices), NCCL with one card
per process.  Everything else is the path a multi-process run takes:
rank-local day generation (keyed by global env index), the env batch split
over the ranks, the collective-free sharded rollout, and the PPO train step
whose gradient mean crosses processes.

Launch one worker per rank (any order; they rendezvous at the coordinator):

    python -m smart_nanogrid_gym_torch.parallel.multihost_demo --platform cpu \\
        --process-id 0 --num-processes 2 --coordinator localhost:29500
    ... (the same with --process-id 1)

or all of them at once with ``torchrun --nproc-per-node 2 -m
smart_nanogrid_gym_torch.parallel.multihost_demo`` (the ids and the
coordinator then come from ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``).  ``--platform`` defaults to ``cuda``, which raises without
a card; one process runs alone unless it is given a coordinator.  Each worker
prints ONE JSON line: the rollout's mean day return over the global batch,
the PPO update's mean return, the process and rank counts.  The values are
identical on every process and equal to a one-process run of the same global
batch, the process-count-invariance that tests/test_torch_parallel.py pins.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--process-id", type=int, default=None, help="this rank (default: RANK, else 0)")
    p.add_argument("--num-processes", type=int, default=None, help="world size (default: WORLD_SIZE, else 1)")
    p.add_argument("--coordinator", default=None,
                   help="host:port or file:// init method of the rendezvous (default: MASTER_ADDR:MASTER_PORT; "
                        "needed with more than one process)")
    p.add_argument("--global-batch", type=int, default=32)
    p.add_argument("--train-batch", type=int, default=16)
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="cuda: one card per process on NCCL (raises without a card); cpu: one process per "
                        "rank on gloo")
    p.add_argument("--seed", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    from ..core import NanogridConfig, make_params
    from ..core.transition import draw_pv_shift
    from ..solvers.ppo import PPOConfig, PPOLearner
    from ..solvers.rbc import make_rbc_policy_fn
    from . import distributed as D
    from .mesh import make_mesh, sharded_rollout_fn

    if args.platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform cuda needs a CUDA card and torch.cuda.is_available() is False; "
                           "pass --platform cpu to run on gloo")
    num_processes = args.num_processes or int(os.environ.get("WORLD_SIZE", 1))
    process_id = args.process_id if args.process_id is not None else int(os.environ.get("RANK", 0))
    if num_processes > 1 and args.coordinator is None and not os.environ.get("MASTER_ADDR"):
        raise ValueError(f"{num_processes} processes need --coordinator host:port (or MASTER_ADDR and "
                         "MASTER_PORT, as torchrun sets them)")
    opened = not torch.distributed.is_initialized()
    D.initialize_distributed(args.coordinator, num_processes, process_id,
                             backend="gloo" if args.platform == "cpu" else "nccl")
    mesh = make_mesh("cpu" if args.platform == "cpu" else None)

    config = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
    params = make_params(config, torch.float32, mesh.device)

    # rank-local generation -> this rank's envs -> collective-free rollout
    _, states, obs = D.distributed_reset(config, params, mesh, args.global_batch, seed=args.seed)
    rollout = sharded_rollout_fn(config, mesh, make_rbc_policy_fn(config))
    shifts = draw_pv_shift(args.global_batch, torch.Generator().manual_seed(1), torch.float32, "cpu")[None]
    _, _, (_, rewards, _) = rollout(params, states, obs, shifts)
    day_returns = D.make_global_array(rewards.sum(dim=0), mesh, args.global_batch)
    rollout_mean = float(day_returns.double().mean())

    # distributed PPO: replicated learner, rank-local envs, cross-process gradient mean
    learner = PPOLearner(config, PPOConfig(num_epochs=1, num_minibatches=2), mesh=mesh)
    state = learner.init_distributed(0, params, global_batch=args.train_batch)
    state, metrics = learner.build_train_step()(state, params)

    print(json.dumps({
        "process": mesh.rank,
        "num_processes": mesh.world_size,
        "global_devices": mesh.world_size,
        "local_devices": 1,
        "rollout_mean_day_return": round(rollout_mean, 6),
        "ppo_mean_return": round(float(metrics.mean_return), 6),
    }), flush=True)
    if opened and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
