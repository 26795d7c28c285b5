"""The port's env mesh and multi-process runtime (``smart_nanogrid_gym_torch/
parallel``) against the JAX package's, on the CPU.

One run of ``tests/torch_rank_worker.py`` on two gloo ranks (no JAX in the
ranks: the JAX side's inputs go in through an ``.npz``) feeds most checks:

- ``sharded_rollout_fn`` on two ranks equals the unsharded rollout bit for
  bit, and JAX's ``sharded_rollout_fn`` on a 2-device mesh from the same
  states at 1e-12 in f64;
- ``distributed_reset`` of a global batch at W=2 equals W=1;
- ``sharded_multiday_kernel_fn`` (``gather=True``) equals the direct calls at
  ``seed·W + rank``;
- one PPO update of the plain path equals JAX's ``PPOLearner(mesh=2
  devices)`` update with its draws sliced per rank: the Adam moments and the
  params at rtol 1e-5 of each leaf's scale; the ranks end with equal params;
- one DDPG update leaves finite params equal on both ranks;
- the kernel paths raise ``ValueError`` at W=2;
- the scaling sweep of two ranks and its report.

In-process: ``host_shard_bounds``, ``global_env_keys`` indexed globally, the
multiday kernels' seeds and refusals, ``scaling_sweep(path="plain")``, the
tests' launcher's failure handling, the two-process ``multihost_demo`` against its
one-process run, and ``train_ppo --distributed`` on two ranks resumed from
its full-state checkpoint equal to the straight run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from smart_nanogrid_gym_tpu.core import NanogridConfig as JaxConfig, SmartNanogridTPU, make_params as jax_make_params
from smart_nanogrid_gym_tpu.parallel.mesh import ENV_AXIS, shard_env_batch as jax_shard, sharded_rollout_fn as jax_rollout_fn
from smart_nanogrid_gym_tpu.solvers.ppo import PPOConfig as JaxPPOConfig, PPOLearner as JaxPPOLearner
from smart_nanogrid_gym_tpu.solvers.rbc import make_rbc_policy_fn as jax_rbc

from smart_nanogrid_gym_torch.core import NanogridConfig, make_params
from smart_nanogrid_gym_torch.core.state import DaySchedule, EnvState
from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_multiday
from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_multiday
from smart_nanogrid_gym_torch.ops.philox import day_uniforms
from smart_nanogrid_gym_torch.parallel import EnvMesh, make_mesh, sharded_rollout_fn
from smart_nanogrid_gym_torch.parallel import distributed as D
from smart_nanogrid_gym_torch.parallel import multihost_demo
from smart_nanogrid_gym_torch.solvers.networks import ActorCritic
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn
from smart_nanogrid_gym_torch.utils.weights import find_adam_state, leaves_from_flax
from torch_launch import torchrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_rank_worker.py")
KW = dict(num_chargers=4, pv_system=True, battery_system=True)
CFG, JCFG = NanogridConfig(**KW), JaxConfig(**KW)
T = CFG.steps_per_day
ROLL_BATCH, PPO_BATCH = 8, 16
RANK_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n):
    return Mesh(np.asarray(jax.devices("cpu")[:n]), (ENV_AXIS,))


def jax_redraw(keys):
    """The day-end PV shift a JAX fused day draws from each env's key
    (core/rollout.py:308-318): ``T`` splits, then randint on the last."""
    def one(k):
        for _ in range(T):
            k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (), 0, 181).astype(jnp.float64) / 100.0

    return jax.vmap(one)(keys)


def rollout_inputs():
    """JAX reset states of ``ROLL_BATCH`` envs (f64), JAX's two-day sharded
    rollout of them on a 2-device mesh, and the two day-end PV shifts."""
    env = SmartNanogridTPU(JCFG)
    bparams = env.broadcast_params(env.default_params(dtype=jnp.float64), ROLL_BATCH)
    states, obs = env.reset_batch(bparams, jax.random.split(jax.random.PRNGKey(0), ROLL_BATCH))
    policy = jax_rbc(JCFG)
    mesh = cpu_mesh(2)
    out = jax_rollout_fn(JCFG, mesh, lambda ob, k: policy(ob), num_steps=2 * T)(
        jax_shard(bparams, mesh), jax_shard(states, mesh), jax_shard(obs, mesh), jax.random.split(jax.random.PRNGKey(1), 2))
    keys, first = jax_redraw(states.key)
    _, second = jax_redraw(keys)
    np.testing.assert_array_equal(np.asarray(out[0].pv_shift), np.asarray(second))  # the redraw is JAX's
    inputs = {f"roll_{name}": np.asarray(getattr(states, name)) for name in
              ("t", "soc", "batt_soc", "batt_init_soc", "pv_shift", "pmask", "day")}
    inputs.update({f"roll_sched_{name}": np.asarray(getattr(states.schedule, name)) for name in DaySchedule._fields})
    inputs["roll_obs"] = np.asarray(obs)
    inputs["roll_shifts"] = np.stack([np.asarray(first), np.asarray(second)])
    return inputs, jax.tree.map(np.asarray, out)


def ppo_inputs():
    """JAX's PPO mesh update (2 devices, 1 epoch x 2 minibatches) and its
    draws, re-derived per shard as ``_shard_train_step`` derives them: the day
    and step keys folded with the shard index, the permutation key shared."""
    with jax.enable_x64(False):
        jl = JaxPPOLearner(JCFG, JaxPPOConfig(num_epochs=1, num_minibatches=2), mesh=cpu_mesh(2))
        jstate = jl.init(jax.random.PRNGKey(0), jax_make_params(JCFG, dtype=jnp.float32), batch_size=PPO_BATCH)
        jnew, jmet = jl.build_train_step()(jstate, jl.nanogrid_params_batched)
        _, sub = jax.random.split(jstate.key)
        k_roll, k_perm = jax.random.split(sub)
        _, k_day, k_steps = jax.random.split(k_roll, 3)
        local = PPO_BATCH // 2
        inputs = {f"ppo_param{i}": x.numpy() for i, x in enumerate(leaves_from_flax(jax.tree.map(np.asarray, jstate.params)))}
        inputs["ppo_batt"] = np.asarray(jstate.env_states.batt_soc)

        def per_env(key):
            k_sched, k_shift, _ = jax.random.split(key, 3)
            u = jax.random.uniform(k_sched, (T, 5, CFG.num_chargers), jnp.float32)
            return u, jax.random.randint(k_shift, (), 0, 181).astype(jnp.float32) / 100.0

        perms = np.asarray(jax.random.permutation(jax.random.split(k_perm, 1)[0], local))[None]
        for shard in range(2):
            u, pv = jax.vmap(per_env)(jax.random.split(jax.random.fold_in(k_day, shard), local))
            steps = jax.random.split(jax.random.fold_in(k_steps, shard), T)
            normals = jnp.stack([jax.random.normal(k, (local, CFG.num_actions), jnp.float32) for k in steps])
            inputs.update({f"ppo_r{shard}_u": np.asarray(u), f"ppo_r{shard}_pv": np.asarray(pv),
                           f"ppo_r{shard}_normals": np.asarray(normals), f"ppo_r{shard}_perms": perms})
        adam = find_adam_state(jax.tree.map(np.asarray, jnew.opt_state))
        want = dict(params=leaves_from_flax(jax.tree.map(np.asarray, jnew.params)), mu=leaves_from_flax(adam.mu),
                    nu=leaves_from_flax(adam.nu), count=int(adam.count), metrics=jax.tree.map(float, jmet))
    return inputs, want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX side's inputs and expectations, and what each of the two
    ranks of ``tests/torch_rank_worker.py`` wrote."""
    tmp = tmp_path_factory.mktemp("ranks")
    roll_in, roll_want = rollout_inputs()
    ppo_in, ppo_want = ppo_inputs()
    np.savez(tmp / "inputs.npz", **roll_in, **ppo_in)
    torchrun([WORKER, str(tmp / "inputs.npz"), str(tmp)], 2, timeout_s=240, env=RANK_ENV)
    outs = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    flags = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    return dict(tmp=tmp, roll_in=roll_in, roll_want=roll_want, ppo_want=ppo_want, outs=outs, flags=flags)


def both(ranks, name, axis=0):
    return np.concatenate([o[name] for o in ranks["outs"]], axis=axis)


def test_host_shard_bounds():
    cpu = torch.device("cpu")
    assert D.host_shard_bounds(EnvMesh(None, 0, 1, cpu), 64) == (0, 64)
    bounds = [D.host_shard_bounds(EnvMesh(None, r, 4, cpu), 64) for r in range(4)]
    assert bounds == [(0, 16), (16, 32), (32, 48), (48, 64)]
    with pytest.raises(ValueError, match="not divisible"):
        D.host_shard_bounds(EnvMesh(None, 1, 3, cpu), 64)
    assert make_mesh("cpu") == EnvMesh(None, 0, 1, cpu)
    assert D.initialize_distributed() == (0, 1) and not torch.distributed.is_initialized()


def test_global_env_keys_are_global_indexed():
    """The ``[32, 64)`` slice of a 64-env draw equals the draw of the global
    range ``[32, 64)`` directly: what makes generation process-count-invariant."""
    u_all, pv_all = D.global_env_keys(7, 0, 64, CFG, "cpu")
    u_tail, pv_tail = D.global_env_keys(7, 32, 64, CFG, "cpu")
    assert u_all.shape == (64, T, 5, CFG.num_chargers)
    assert torch.equal(u_all[32:], u_tail) and torch.equal(pv_all[32:], pv_tail)
    u, pv = day_uniforms(7, 0, 64, T, CFG.num_chargers, "cpu")  # env0 defaults to 0: unchanged calls
    assert torch.equal(u.permute(3, 0, 1, 2), u_all) and torch.equal(pv, pv_all)


def test_sharded_rollout_two_ranks_equals_unsharded_and_jax(ranks):
    inp, (jstates, jlast, (jobs, jrew, jdone)) = ranks["roll_in"], ranks["roll_want"]
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    states = EnvState(t["roll_t"].long(), t["roll_soc"], DaySchedule(*(t[f"roll_sched_{n}"] for n in DaySchedule._fields)),
                      t["roll_batt_soc"], t["roll_batt_init_soc"], t["roll_pv_shift"], t["roll_pmask"], t["roll_day"].long())
    rollout = sharded_rollout_fn(CFG, make_mesh("cpu"), make_rbc_policy_fn(CFG), num_steps=2 * T)
    final, last, (obs, rew, done) = rollout(make_params(CFG, torch.float64, "cpu"), states, t["roll_obs"],
                                            t["roll_shifts"])
    for name, got, want in (("obs", both(ranks, "roll_obs", 1), obs), ("rewards", both(ranks, "roll_rewards", 1), rew),
                            ("dones", both(ranks, "roll_dones", 1), done), ("last obs", both(ranks, "roll_last_obs"), last),
                            ("battery", both(ranks, "roll_batt"), final.batt_soc),
                            ("soc", both(ranks, "roll_soc"), final.soc), ("pv", both(ranks, "roll_pv"), final.pv_shift)):
        assert np.array_equal(got, want.numpy()), name  # bit for bit: no cross-env arithmetic
    assert obs.shape == (2 * T, ROLL_BATCH, CFG.obs_dim)
    for got, want in ((obs, jobs), (rew, jrew), (last, jlast), (final.soc, jstates.soc), (final.batt_soc, jstates.batt_soc),
                      (final.pv_shift, jstates.pv_shift)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert np.array_equal(done.numpy(), jdone)
    for o in ranks["outs"]:  # make_global_array gathers every rank's day returns
        assert np.array_equal(o["roll_day_returns"], rew.sum(dim=0).numpy())


def test_distributed_reset_equal_at_one_and_two_ranks(ranks):
    p = make_params(CFG, torch.float32, "cpu")
    bparams, states, obs = D.distributed_reset(CFG, p, make_mesh("cpu"), 16, seed=3)
    out = ranks["outs"][0]
    for name in EnvState._fields:
        if name != "schedule":
            assert np.array_equal(out[f"reset_{name}"], getattr(states, name).numpy()), name
    for name in DaySchedule._fields:
        assert np.array_equal(out[f"reset_sched_{name}"], getattr(states.schedule, name).numpy()), name
    assert np.array_equal(out["reset_obs"], obs.numpy()) and bparams.price.shape[0] == 16
    assert np.unique(states.pv_shift.numpy()).size > 1  # the PV shifts come from the envs' own keys


def test_sharded_multiday_kernel_fn_equals_the_direct_calls(ranks):
    """Rank ``r`` of ``W`` launches with ``seed·W + r``; at W=1 the run is the
    unsharded call.  Checked through the twins, on two real ranks (gathered)
    and on each rank of a world of 2 in this process."""
    p = make_params(CFG, torch.float32, "cpu")
    net = ActorCritic(CFG.obs_dim, CFG.num_actions, generator=torch.Generator().manual_seed(4))
    want_k8 = torch.cat([gen_rbc_multiday(CFG, p, 2, 5 * 2 + r, 8) for r in range(2)], dim=1)
    want_k6 = torch.cat([gen_policy_multiday(CFG, p, net, 1, 6 * 2 + r, 8) for r in range(2)], dim=1)
    for o in ranks["outs"]:
        assert np.array_equal(o["k8"], want_k8.numpy()) and np.array_equal(o["k6"], want_k6.numpy())
    cpu = torch.device("cpu")
    run = D.sharded_multiday_kernel_fn(CFG, EnvMesh(None, 1, 2, cpu), 2, 8)
    assert torch.equal(run(p, 5), want_k8[:, 8:])
    one = D.sharded_multiday_kernel_fn(CFG, make_mesh("cpu"), 1, 8, kernel="policy", net_params=net)
    assert torch.equal(one(p, 6), gen_policy_multiday(CFG, p, net, 1, 6, 8))


def test_sharded_multiday_kernel_fn_refuses():
    cpu = torch.device("cpu")
    p = make_params(CFG, torch.float32, "cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        D.sharded_multiday_kernel_fn(CFG, make_mesh("cpu"), 1, 8, kernel="xla")
    with pytest.raises(ValueError, match="net_params"):
        D.sharded_multiday_kernel_fn(CFG, make_mesh("cpu"), 1, 8, kernel="policy")
    run = D.sharded_multiday_kernel_fn(CFG, EnvMesh(None, 1, 2, cpu), 1, 8)
    with pytest.raises(ValueError, match="32"):
        run(p, 2 ** 31)  # 2**32 + 1 would wrap onto seed 1's streams
    assert D.rank_seed(2 ** 31 - 1, EnvMesh(None, 1, 2, cpu)) == 2 ** 32 - 1
    with pytest.raises(ValueError, match="32"):
        run(p, -1)
    with pytest.raises(ValueError, match="batt_init_soc"):
        run(p._replace(batt_init_soc=torch.tensor(0.3)), 0)


def test_scaling_sweep_plain_and_report(ranks, tmp_path):
    records = D.scaling_sweep(CFG, make_params(CFG, torch.float32, "cpu"), make_mesh("cpu"), batch_per_device=4,
                              num_days=1, timed_calls=1)
    assert [r["devices"] for r in records] == [1] and records[0]["efficiency"] == 1.0
    assert records[0]["path"] == "plain" and records[0]["steps_per_sec"] > 0
    D.write_scaling_report(records, str(tmp_path / "s.json"), {"platform": "cpu"})
    assert json.loads((tmp_path / "s.json").read_text()) == {"records": records, "platform": "cpu"}
    two = ranks["flags"][0]["scaling"]
    assert two == ranks["flags"][1]["scaling"]  # the slowest rank's time, on every rank
    assert [r["devices"] for r in two] == [1, 2] and [r["global_batch"] for r in two] == [4, 8]
    assert set(two[0]) == {"devices", "global_batch", "steps_per_sec", "efficiency", "path"}
    report = json.loads((ranks["tmp"] / "scaling.json").read_text())
    assert report == {"records": two, "world_size": 2}
    with pytest.raises(ValueError, match="unknown path"):
        D.scaling_sweep(CFG, make_params(CFG, torch.float32, "cpu"), make_mesh("cpu"), path="xla")


def test_ppo_update_two_ranks_matches_the_jax_mesh_learner(ranks):
    """Each element within 1e-5 of the leaf's largest magnitude (elements
    near zero come from cancelling f32 sums, whose last bits differ)."""
    want = ranks["ppo_want"]

    def close(got, ref, name):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(), err_msg=name)

    for o in ranks["outs"]:
        for i in range(13):
            close(o[f"ppo_mu{i}"], want["mu"][i].numpy(), f"mu {i}")
            close(o[f"ppo_nu{i}"], want["nu"][i].numpy(), f"nu {i}")
            close(o[f"ppo_param{i}"], want["params"][i].numpy(), f"param {i}")
    m = want["metrics"]
    np.testing.assert_allclose(ranks["outs"][0]["ppo_metrics"][4], m.mean_return, rtol=1e-5)
    np.testing.assert_allclose(ranks["outs"][0]["ppo_metrics"][:4], [m.policy_loss, m.value_loss, m.entropy, m.approx_kl],
                               rtol=1e-3, atol=1e-6)
    assert ranks["flags"][0]["ppo_count"] == want["count"] == 2
    a, b = ranks["outs"]
    for i in range(13):  # the gradient mean keeps the replicas equal
        assert np.array_equal(a[f"ppo_param{i}"], b[f"ppo_param{i}"]) and np.array_equal(a[f"ppo_own{i}"], b[f"ppo_own{i}"])
    assert np.array_equal(a["ppo_metrics"], b["ppo_metrics"])
    assert not np.array_equal(a["ppo_own_batt"], b["ppo_own_batt"])  # each rank's own envs


def test_ddpg_update_two_ranks_equal_params(ranks):
    a, b = ranks["outs"]
    for name in [f"ddpg_actor{i}" for i in range(6)] + [f"ddpg_critic{i}" for i in range(6)]:
        assert np.isfinite(a[name]).all() and np.array_equal(a[name], b[name]), name
    assert np.array_equal(a["ddpg_metrics"], b["ddpg_metrics"]) and np.isfinite(a["ddpg_metrics"]).all()
    assert not np.array_equal(a["ddpg_rewards"], b["ddpg_rewards"])  # decorrelated days per rank


def test_kernel_paths_refuse_two_ranks(ranks):
    for flags in ranks["flags"]:
        got = flags["refusals"]
        assert all(msg is not None and "supports world size 1 only" in msg for msg in got), got
        assert "the kernel applies Adam locally" in got[1]
    assert [o["replicated"].tolist() for o in ranks["outs"]] == [[1.0] * 3] * 2


def test_launch_local_fails_loudly(tmp_path):
    """The tests' launcher: a rank that fails fails the run (torchrun stops
    the other rank), and a hung run is stopped at its time limit."""
    script = tmp_path / "rank.py"
    script.write_text("import os, sys, time\nsys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)\n")
    with pytest.raises(RuntimeError, match=r"torchrun exited with [\s\S]*exitcode\s*: 3"):
        torchrun([str(script)], 2, timeout_s=30)
    hang = tmp_path / "hang.py"
    hang.write_text("import time\ntime.sleep(60)\n")
    with pytest.raises(RuntimeError, match="timed out"):
        torchrun([str(hang)], 1, timeout_s=3)


def test_multihost_demo_two_processes_match_one(capsys):
    outs = torchrun(["-m", "smart_nanogrid_gym_torch.parallel.multihost_demo", "--platform", "cpu"], 2,
                    timeout_s=180, env=RANK_ENV, cwd=REPO)
    two = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    multihost_demo.main(["--process-id", "0", "--num-processes", "1", "--platform", "cpu"])
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [o["process"] for o in two] == [0, 1] and two[0]["num_processes"] == 2
    for key in ("rollout_mean_day_return", "ppo_mean_return"):
        assert two[0][key] == two[1][key] and np.isfinite(two[0][key])
        assert one[key] == pytest.approx(two[0][key], rel=1e-6), key
    assert one["num_processes"] == 1


def test_train_ppo_distributed_two_ranks_resume_equals_straight_run(tmp_path):
    """``train_ppo --distributed`` on two gloo ranks: rank 0 alone writes the
    checkpoints, the full state holds the global batch's batteries, and one
    epoch resumed to two equals two straight epochs (params, Adam moments,
    batteries of both ranks)."""
    def run(models, epochs, *extra):
        argv = ["-m", "smart_nanogrid_gym_torch.tools.train_ppo", "--distributed", "--variant", "basic",
                "--num-chargers", "4", "--batch", "16", "--episodes-per-epoch", "16", "--device", "cpu", "--seed", "3",
                "--models-dir", str(tmp_path / models), "--epochs", str(epochs), *extra]
        return torchrun(argv, 2, timeout_s=180, env=RANK_ENV, cwd=REPO)

    straight = run("straight", 2)
    assert straight[0].startswith("process 0/2") and straight[1].strip() == "process 1/2"  # rank 1 prints no metrics
    run("resumed", 1)
    assert "resumed from epoch 1" in run("resumed", 2, "--resume")[0]
    full = "PPO-basic-bounded-sparse-4ch-1.0h/full/2/state.pt"
    a, b = (torch.load(tmp_path / d / full, weights_only=True)["leaves"] for d in ("straight", "resumed"))
    assert len(a) == len(b) > 13
    for x, y in zip(a, b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert any(isinstance(x, torch.Tensor) and x.shape == (16,) for x in a)  # the global batch's batteries
    assert not (tmp_path / "straight" / "PPO-basic-bounded-sparse-4ch-1.0h" / "guard-rank1").exists()
