"""One rank of the two-process checks of ``tests/test_torch_parallel.py``,
on gloo over CPU tensors.  It imports neither JAX nor the JAX package: the
test hands it the JAX side's inputs in an ``.npz`` and reads back what each
rank wrote.

    python tests/torch_rank_worker.py INPUTS.npz OUT_DIR

run once per rank by ``torchrun --nproc-per-node 2`` (``tests/torch_launch.py``),
which sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.  Rank ``r``
writes ``OUT_DIR/rank{r}.npz`` and ``OUT_DIR/rank{r}.json``.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smart_nanogrid_gym_torch.core import NanogridConfig, make_params  # noqa: E402
from smart_nanogrid_gym_torch.core.state import DaySchedule, EnvState  # noqa: E402
from smart_nanogrid_gym_torch.ops.ppo_sweep import AdamState  # noqa: E402
from smart_nanogrid_gym_torch.parallel import distributed as D  # noqa: E402
from smart_nanogrid_gym_torch.parallel.mesh import make_mesh, replicate, shard_env_batch, sharded_rollout_fn  # noqa: E402
from smart_nanogrid_gym_torch.solvers import DDPGConfig, DDPGLearner, PPOConfig, PPOLearner  # noqa: E402
from smart_nanogrid_gym_torch.solvers.networks import ActorCritic  # noqa: E402
from smart_nanogrid_gym_torch.solvers.ppo import PlainDraws  # noqa: E402
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn  # noqa: E402

CFG = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
RESET_BATCH, KERNEL_BATCH = 16, 8
DDPG_KW = dict(buffer_days=1, batch_size=16, gradient_steps=2)


def jax_states(data: dict) -> tuple[EnvState, torch.Tensor]:
    """The JAX reset states of the rollout check (global batch, f64)."""
    t = lambda name: torch.from_numpy(data[name])  # noqa: E731
    schedule = DaySchedule(*(t(f"roll_sched_{name}") for name in DaySchedule._fields))
    state = EnvState(t("roll_t").long(), t("roll_soc"), schedule, t("roll_batt_soc"), t("roll_batt_init_soc"),
                     t("roll_pv_shift"), t("roll_pmask"), t("roll_day").long())
    return state, t("roll_obs")


def main(in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    rank, world = D.initialize_distributed(backend="gloo", timeout_s=120)
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.world_size) == (rank, world) == (rank, 2)
    data = dict(np.load(in_path))
    out, flags = {}, {}
    p32, p64 = make_params(CFG, torch.float32, "cpu"), make_params(CFG, torch.float64, "cpu")

    # the collective-free rollout of this rank's envs, two chained days
    states, obs = jax_states(data)
    rollout = sharded_rollout_fn(CFG, mesh, make_rbc_policy_fn(CFG), num_steps=2 * CFG.steps_per_day)
    final, last_obs, (obs_t, rewards, dones) = rollout(p64, shard_env_batch(states, mesh),
                                                       shard_env_batch(obs, mesh),
                                                       torch.from_numpy(data["roll_shifts"]))
    out.update(roll_obs=obs_t, roll_rewards=rewards, roll_dones=dones, roll_last_obs=last_obs,
               roll_batt=final.batt_soc, roll_pv=final.pv_shift, roll_soc=final.soc,
               roll_day_returns=D.make_global_array(rewards.sum(dim=0), mesh, states.t.shape[0]))

    # rank-local generation of a global batch, gathered
    _, reset_states, reset_obs = D.distributed_reset(CFG, p32, mesh, RESET_BATCH, seed=3)
    gathered = D.make_global_array(reset_states, mesh, RESET_BATCH)
    out.update({f"reset_{name}": x for name, x in zip(EnvState._fields, gathered) if name != "schedule"})
    out.update({f"reset_sched_{name}": x for name, x in zip(DaySchedule._fields, gathered.schedule)})
    out["reset_obs"] = D.make_global_array(reset_obs, mesh)

    # the multiday kernels' twins once per rank, gathered
    net = ActorCritic(CFG.obs_dim, CFG.num_actions, generator=torch.Generator().manual_seed(4))
    out["k8"] = D.sharded_multiday_kernel_fn(CFG, mesh, 2, KERNEL_BATCH, gather=True)(p32, 5)
    out["k6"] = D.sharded_multiday_kernel_fn(CFG, mesh, 1, KERNEL_BATCH, kernel="policy", net_params=net,
                                             gather=True)(p32, 6)
    out["replicated"] = replicate(torch.full((3,), float(rank + 1)), mesh)

    records = D.scaling_sweep(CFG, p32, mesh, batch_per_device=4, num_days=1, timed_calls=1, path="plain")
    flags["scaling"] = records
    if rank == 0:
        D.write_scaling_report(records, os.path.join(out_dir, "scaling.json"), {"world_size": world})

    # one PPO update of the plain path with the JAX mesh learner's draws of this rank
    learner = PPOLearner(CFG, PPOConfig(num_epochs=1, num_minibatches=2), mesh=mesh)
    leaves = [torch.from_numpy(data[f"ppo_param{i}"]) for i in range(13)]
    zeros = [torch.zeros_like(x) for x in leaves]
    batt = shard_env_batch(torch.from_numpy(data["ppo_batt"]), mesh)
    state = learner.state_from(leaves, AdamState(0, zeros, zeros), batt, torch.Generator().manual_seed(0), p32)
    draws = PlainDraws([tuple(torch.from_numpy(data[f"ppo_r{rank}_{k}"]) for k in ("u", "pv", "normals"))],
                       torch.from_numpy(data[f"ppo_r{rank}_perms"]).long())
    new, metrics = learner.build_train_step()(state, p32, draws)
    out.update({f"ppo_param{i}": x for i, x in enumerate(new.params)})
    out.update({f"ppo_mu{i}": x for i, x in enumerate(new.opt_state.mu)})
    out.update({f"ppo_nu{i}": x for i, x in enumerate(new.opt_state.nu)})
    out["ppo_metrics"] = torch.stack(list(metrics))
    flags["ppo_count"] = new.opt_state.count

    # two updates with the learner's own draws, from init_distributed
    state = learner.init_distributed(2, p32, global_batch=RESET_BATCH, env_seed=1)
    step = learner.build_train_step()
    for _ in range(2):
        state, metrics = step(state, p32)
    out.update({f"ppo_own{i}": x for i, x in enumerate(state.params)})
    out["ppo_own_batt"] = state.batt_soc

    # one DDPG update at test widths
    ddpg = DDPGLearner(CFG, DDPGConfig(**DDPG_KW), mesh=mesh)
    dstate, dmetrics = ddpg.build_train_step()(ddpg.init(0, p32, 4), p32)
    out.update({f"ddpg_actor{i}": x for i, x in enumerate(dstate.actor)})
    out.update({f"ddpg_critic{i}": x for i, x in enumerate(dstate.critic)})
    out["ddpg_metrics"] = torch.stack(list(dmetrics))
    out["ddpg_rewards"] = dstate.buffer.rewards[:CFG.steps_per_day]

    # the kernel paths apply Adam locally: refused at world size 2
    refusals = []
    for make in (lambda: PPOLearner(CFG, PPOConfig(collect_impl="kernel", sweep_impl="kernel"), mesh=mesh),
                 lambda: PPOLearner(CFG, PPOConfig(sweep_impl="kernel"), mesh=mesh),
                 lambda: DDPGLearner(CFG, DDPGConfig(collect_impl="kernel", sweep_impl="kernel"), mesh=mesh),
                 lambda: DDPGLearner(CFG, DDPGConfig(collect_impl="kernel"), mesh=mesh)):
        try:
            make()
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    flags["refusals"] = refusals

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **{k: v.numpy() for k, v in out.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fp:
        json.dump(flags, fp)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
