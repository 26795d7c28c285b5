"""The CUDA kernels K1-K11 of the PyTorch port against their plain twins.

Marked ``cuda``: each test skips without a CUDA device (and needs ``nvcc``
to build the kernels at first use).  The file imports no JAX, so it also
runs on a machine that has only PyTorch: ``python -m pytest
tests/test_torch_cuda.py -m cuda``.  Batches of 300 leave a ragged last
block of threads; the collection kernels and the block actor of K5 and K6
are also held at 1, 33 and 8192 envs, bit for bit, K8 and K11a at 1 and
300 envs off the 1 h grid, K11b at 300 and 4096 envs at 0.25-1 h, and K7
and K5's 64x64 torso at 1 to 4133 envs at 0.25-2 h.
"""

import numpy as np
import pytest
import torch

from smart_nanogrid_gym_torch.core.config import NanogridConfig
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops import (
    gen_policy_day,
    gen_policy_multiday,
    gen_rbc_day,
    gen_rbc_multiday,
    launch_counts,
    ppo_collect_day,
    ppo_collect_day_seeded,
    ppo_sweep,
    ppo_sweep_streamed,
    reset_launch_counts,
)
from smart_nanogrid_gym_torch.ops.collect import (
    collect_weights,
    ppo_collect_day_plain,
    ppo_collect_day_seeded_plain,
)
from smart_nanogrid_gym_torch.ops.ppo_sweep import SweepHypers, ppo_sweep_plain, ppo_sweep_streamed_plain, zeros_adam
from smart_nanogrid_gym_torch.solvers.networks import actor_critic_leaves
from smart_nanogrid_gym_torch.solvers.ppo import PPOConfig, PPOLearner
from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
    actor_weights,
    gen_policy_day_plain,
    gen_policy_multiday_plain,
)
from smart_nanogrid_gym_torch.ops.gen_rollout import (
    gen_rbc_day_plain,
    gen_rbc_multiday_plain,
    kernel_traces,
)
from smart_nanogrid_gym_torch.solvers.networks import ActorCritic

from torch_parity import assert_bf16_close, k6_bf16_close, kernel_inputs

pytestmark = pytest.mark.cuda

RBC_CONFIGS = {
    "b-pv-sparse": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True),
    "b-pv-reqsoc-fixedcap": NanogridConfig(num_chargers=8, different_battery_capacities=False,
                                           requested_state_of_charge=True, penalty_mode="dense"),
    "basic-ondep": NanogridConfig(num_chargers=4, pv_system=False, battery_system=False,
                                  penalty_mode="on_departure"),
    "b-pv-2h": NanogridConfig(num_chargers=5, time_interval=2.0, penalty_mode="no_penalty"),
}
POLICY_CONFIGS = {
    "b-pv-4ch": NanogridConfig(num_chargers=4, pv_system=True, battery_system=True),
    "v2x-b-pv": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True,
                               vehicle_to_everything=True),
    "v2x-reqsoc": NanogridConfig(num_chargers=4, pv_system=False, battery_system=False,
                                 vehicle_to_everything=True, penalty_mode="dense",
                                 requested_state_of_charge=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(config, seed, batch, device):
    u, pv = kernel_inputs(config, seed, batch)
    return torch.from_numpy(u).to(device), torch.from_numpy(pv).to(device)


def shifted_actor(config, seed, device):
    """A random actor with the action-mean biases pushed off the 0 branch
    boundaries; with v2x, chargers alternate charge and discharge."""
    torch.manual_seed(seed)
    net = ActorCritic(config.obs_dim, config.num_actions)
    if config.vehicle_to_everything:
        ch_bias = np.where(np.arange(config.num_chargers) % 2 == 0, 0.5, -0.4)
    else:
        ch_bias = np.full(config.num_chargers, 0.5)
    bias = np.concatenate([ch_bias, [-0.3]] if config.battery_system else [ch_bias])
    with torch.no_grad():
        net.pi.Dense_2.bias.copy_(torch.as_tensor(bias))
    return net.to(device)


@pytest.mark.parametrize("name", list(RBC_CONFIGS))
def test_rbc_kernels_match_twins(cuda, name):
    config = RBC_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    u, pv = _inputs(config, 5, 300, cuda)
    reset_launch_counts()
    assert_equal_outputs(gen_rbc_day(config, params, u, pv),
                         gen_rbc_day_plain(config, traces, u, pv, torch.full_like(pv, 0.5)), ("rewards", "soc_final"))
    stats = gen_rbc_multiday(config, params, 3, 17, 300)
    stats_p = gen_rbc_multiday_plain(config, traces, 3, 17, 300)
    assert_equal_outputs((stats,), (stats_p,), ("stats",))  # K8's lanes sum in the twin's order
    assert launch_counts["gen_rbc_day"] == 1 and launch_counts["gen_rbc_multiday"] == 1


@pytest.mark.parametrize("name", list(POLICY_CONFIGS))
def test_policy_kernels_match_twins(cuda, name):
    config = POLICY_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = shifted_actor(config, 13, cuda)
    weights = actor_weights(config, net, cuda)
    u, pv = _inputs(config, 6, 300, cuda)
    reset_launch_counts()
    assert_equal_outputs(gen_policy_day(config, params, net, u, pv),
                         gen_policy_day_plain(config, traces, weights, u, pv, torch.full_like(pv, 0.5)),
                         ("rewards", "actions", "soc_final", "batt_final"))
    assert_equal_outputs((gen_policy_multiday(config, params, net, 3, 17, 300),),
                         (gen_policy_multiday_plain(config, traces, weights, 3, 17, 300),), ("stats",))
    assert launch_counts["gen_policy_day"] == 1 and launch_counts["gen_policy_multiday"] == 1


def test_kernel_rejects_wrong_operands(cuda):
    config = RBC_CONFIGS["b-pv-sparse"]
    params = make_params(config, torch.float32, cuda)
    u, pv = _inputs(config, 1, 64, cuda)
    with pytest.raises(ValueError, match="float32"):
        gen_rbc_day(config, params, u.double(), pv)


COLLECT_CONFIGS = {
    "b-pv-8ch": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True),
    "basic-4ch-dense": NanogridConfig(num_chargers=4, pv_system=False, battery_system=False,
                                      penalty_mode="dense", requested_state_of_charge=True),
    "b-pv-2h": NanogridConfig(num_chargers=6, time_interval=2.0, penalty_mode="on_departure"),
    # the CLIs' --time-interval below 1 h (96 and 48 steps a day)
    "b-pv-0.25h": NanogridConfig(num_chargers=4, time_interval=0.25),
    "b-pv-0.5h": NanogridConfig(num_chargers=8, time_interval=0.5, penalty_mode="dense"),
}
# batches of 1 and 33 leave a block of one env and a ragged one; 300 spans ten blocks;
# 8192 is 256 blocks of 32 envs, more than one wave of the 132 SMs
COLLECT_BATCHES = (1, 33, 300, 8192)


def batch_cases(names, batches):
    """``(name, batch)`` pairs: every batch, and only the small ones (up to
    300, ten blocks) for the sub-hour cases."""
    return [(n, b) for n in names for b in batches if b <= 300 or not n.endswith(("0.25h", "0.5h"))]


def assert_equal_outputs(got, want, names):
    """Every output bit-equal to the twin's (the collection kernels sum in
    the twin's order, with no FMA)."""
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: max |d| {float((g - w).abs().max()):.3e}"
HYPERS = SweepHypers(lr=3e-4, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, max_grad_norm=0.5)


def _leaves(config, seed, device):
    return [x.detach() for x in actor_critic_leaves(shifted_actor(config, seed, device))]


@pytest.mark.parametrize("name, batch", batch_cases(COLLECT_CONFIGS, COLLECT_BATCHES))
def test_collect_kernels_match_twins(cuda, name, batch):
    config = COLLECT_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    leaves = _leaves(config, 21, cuda)
    weights = collect_weights(config, leaves, cuda)
    u, pv = _inputs(config, 7, batch, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    normals = torch.randn((config.steps_per_day, config.num_actions, batch), generator=gen, device=cuda)
    batt = torch.rand(batch, generator=gen, device=cuda)
    names = ("obs", "act_raw", "logp", "value", "rewards", "batt")
    reset_launch_counts()
    assert_equal_outputs(ppo_collect_day(config, params, leaves, u, normals, pv, batt),
                         ppo_collect_day_plain(config, traces, weights, u, normals, pv, batt), names)
    assert_equal_outputs(ppo_collect_day_seeded(config, params, leaves, 99, batt, batch),
                         ppo_collect_day_seeded_plain(config, traces, weights, 99, batt, batch), names)
    assert launch_counts["ppo_collect_day"] == 1 and launch_counts["ppo_collect_day_seeded"] == 1


def test_collect_kernels_refuse_blocks_beyond_shared_memory(cuda):
    """K1/K2's shared memory, as the library reports it, holds the learner's
    64x64 actor-critic but not a 256x256 one: that raises before any launch."""
    from smart_nanogrid_gym_torch.ops import _build

    config = COLLECT_CONFIGS["b-pv-8ch"]
    params = make_params(config, torch.float32, cuda)
    assert 4 * _build.library(config, cuda, (64, 64)).ngk_collect_smem_floats() < 232448
    net = ActorCritic(config.obs_dim, config.num_actions, (256, 256)).to(cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="collect_impl='plain'"):
        ppo_collect_day_seeded(config, params, net, 1, torch.rand(64, device=cuda), 64)
    assert not launch_counts


def _sweep_data(shape, F, A, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    return rnd(*shape, F), 0.5 * rnd(*shape, A), -8.5 + 0.3 * rnd(*shape), rnd(*shape), rnd(*shape)


def test_sweep_kernels_match_twin(cuda):
    """K4 on a ragged minibatch (M = 300), K3 in both layouts, G = 4 steps:
    rtol 1e-4 / atol 1e-6 (the JAX full-sweep bar); a K3 rerun is bit-identical."""
    config = COLLECT_CONFIGS["b-pv-8ch"]
    F, A = config.obs_dim, config.num_actions
    leaves = _leaves(config, 5, cuda)
    adam = zeros_adam(leaves)
    reset_launch_counts()
    obs, act, logp, adv, ret = _sweep_data((4, 300), F, A, cuda, 1)
    got = ppo_sweep(leaves, adam, obs, act, logp, adv, ret, HYPERS)
    want = ppo_sweep_plain(leaves, adam, zip(obs, act, logp, adv, ret), HYPERS)
    for g, w in zip(got[0] + got[1].mu + got[1].nu + [got[2]], want[0] + want[1].mu + want[1].nu + [want[2]]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    assert launch_counts["ppo_sweep"] == 1  # one cooperative launch per update

    T, B, granule = 6, 128, 32
    featlane = _sweep_data((T, B), F, A, cuda, 2)
    featlane = (featlane[0].permute(0, 2, 1).contiguous(), featlane[1].permute(0, 2, 1).contiguous()) + featlane[2:]
    sample = _sweep_data((T * B,), F, A, cuda, 3)
    block_perm = torch.stack([torch.randperm(T * B // granule, generator=torch.Generator().manual_seed(g))[:6]
                              for g in range(4)])
    for layout, data in (("featlane", featlane), ("sample", sample)):
        got = ppo_sweep_streamed(leaves, adam, *data, block_perm, granule, HYPERS, data_layout=layout)
        cpu = [x.cpu() for x in data]
        want = ppo_sweep_streamed([x.cpu() for x in leaves], zeros_adam([x.cpu() for x in leaves]), *cpu,
                                  block_perm, granule, HYPERS, data_layout=layout)
        for g, w in zip(got[0] + got[1].mu + got[1].nu + [got[2]], want[0] + want[1].mu + want[1].nu + [want[2]]):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-6)
        again = ppo_sweep_streamed(leaves, adam, *data, block_perm, granule, HYPERS, data_layout=layout)
        for g, a in zip(got[0] + [got[2]], again[0] + [again[2]]):
            assert torch.equal(g, a)


def test_kernel_learner_launches_one_collection_and_two_per_step(cuda):
    config = COLLECT_CONFIGS["b-pv-8ch"]
    params = make_params(config, torch.float32, cuda)
    learner = PPOLearner(config, PPOConfig(num_epochs=2, num_minibatches=4, collect_impl="kernel",
                                           sweep_impl="kernel"), device=cuda)
    state = learner.init(0, params, 256)
    step = learner.build_train_step()
    reset_launch_counts()
    state, metrics = step(state, params)
    torch.cuda.synchronize()
    assert dict(launch_counts) == {"ppo_collect_day_seeded": 1, "ppo_sweep_streamed": 1}
    assert all(bool(torch.isfinite(x)) for x in metrics)


# ---------------------------------------------------------------- DDPG ---

DDPG_CONFIGS = {
    "b-pv-4ch": NanogridConfig(num_chargers=4, pv_system=True, battery_system=True),
    "v2x-b-pv": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True,
                               vehicle_to_everything=True),
}


def shifted_ddpg_actor(config, seed, device):
    """A random 400-300 DDPG actor with the output biases pushed off the 0
    branch boundaries (tests/test_pallas.py:252-263); with v2x, chargers
    alternate charge and discharge."""
    from smart_nanogrid_gym_torch.solvers.networks import DDPGActor

    low, high = config.action_bounds()
    net = DDPGActor(config.obs_dim, config.num_actions, low, high, generator=torch.Generator().manual_seed(seed))
    if config.vehicle_to_everything:
        ch_bias = np.where(np.arange(config.num_chargers) % 2 == 0, 0.5, -0.4)
    else:
        ch_bias = np.full(config.num_chargers, 0.4)
    with torch.no_grad():
        net.mu.Dense_2.bias.copy_(torch.as_tensor(np.concatenate([ch_bias, [-0.6]])))
    return net.to(device)


@pytest.mark.parametrize("name", list(DDPG_CONFIGS))
def test_ddpg_policy_kernels_match_twins(cuda, name):
    config = DDPG_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = shifted_ddpg_actor(config, 13, cuda)
    weights = actor_weights(config, net, cuda, actor="ddpg")
    u, pv = _inputs(config, 6, 300, cuda)
    reset_launch_counts()
    out = gen_policy_day(config, params, net, u, pv, actor="ddpg")
    out_p = gen_policy_day_plain(config, traces, weights, u, pv, torch.full_like(pv, 0.5), actor="ddpg")
    for got, want in zip(out, out_p):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    stats = gen_policy_multiday(config, params, net, 2, 17, 300, actor="ddpg")
    stats_p = gen_policy_multiday_plain(config, traces, weights, 2, 17, 300, actor="ddpg")
    assert torch.equal(stats, stats_p), float((stats - stats_p).abs().max())
    assert dict(launch_counts) == {"gen_policy_day_ddpg": 1, "gen_policy_multiday_ddpg": 1}


DDPG_COLLECT_CONFIGS = {
    "b-pv-8ch": COLLECT_CONFIGS["b-pv-8ch"],
    "b-pv-4ch": DDPG_CONFIGS["b-pv-4ch"],
    "b-pv-2h": COLLECT_CONFIGS["b-pv-2h"],
    "b-pv-0.25h": COLLECT_CONFIGS["b-pv-0.25h"],
    "b-pv-0.5h": COLLECT_CONFIGS["b-pv-0.5h"],
}


@pytest.mark.parametrize("name, batch", batch_cases(DDPG_COLLECT_CONFIGS, COLLECT_BATCHES))
def test_ddpg_collect_kernels_match_twins(cuda, name, batch):
    from smart_nanogrid_gym_torch.ops.ddpg_collect import (
        ddpg_collect_day, ddpg_collect_day_plain, ddpg_collect_day_seeded, ddpg_collect_day_seeded_plain,
        ddpg_weights)

    config = DDPG_COLLECT_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = shifted_ddpg_actor(config, 21, cuda)
    weights = ddpg_weights(config, net, cuda)
    u, pv = _inputs(config, 7, batch, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ou = 0.3 * torch.randn((config.steps_per_day, config.num_actions, batch), generator=gen, device=cuda)
    batt = torch.rand(batch, generator=gen, device=cuda)
    names = ("obs", "act", "rewards", "next_obs", "batt")
    reset_launch_counts()
    assert_equal_outputs(ddpg_collect_day(config, params, net, u, ou, pv, batt),
                         ddpg_collect_day_plain(config, traces, weights, u, ou, pv, batt), names)
    assert_equal_outputs(ddpg_collect_day_seeded(config, params, net, 99, ou, batt, batch),
                         ddpg_collect_day_seeded_plain(config, traces, weights, 99, ou, batt, batch), names)
    assert dict(launch_counts) == {"ddpg_collect_day": 1, "ddpg_collect_day_seeded": 1}


def test_ddpg_sweep_kernel_matches_twin(cuda):
    """K10 over G = 3 steps of a ragged minibatch (M = 200) with the 400-300
    networks, against its twin; a rerun is bit-identical."""
    from smart_nanogrid_gym_torch.ops.ddpg_sweep import DDPGSweepHypers, ddpg_sweep, ddpg_sweep_plain
    from smart_nanogrid_gym_torch.solvers.networks import DDPGCritic, ddpg_leaves

    config = COLLECT_CONFIGS["b-pv-8ch"]
    F, A = config.obs_dim, config.num_actions
    actor = [x.detach() for x in ddpg_leaves(shifted_ddpg_actor(config, 5, cuda))]
    critic = [x.detach().to(cuda) for x in ddpg_leaves(DDPGCritic(F, A, generator=torch.Generator().manual_seed(6)))]
    gen = torch.Generator(device=cuda).manual_seed(1)
    G, M = 3, 200
    data = (torch.randn((G, M, F), generator=gen, device=cuda), torch.rand((G, M, A), generator=gen, device=cuda),
            -torch.rand((G, M), generator=gen, device=cuda) * 10, torch.randn((G, M, F), generator=gen, device=cuda),
            (torch.rand((G, M), generator=gen, device=cuda) < 0.05).float())
    low, high = (torch.as_tensor(b, device=cuda) for b in config.action_bounds())
    hp = DDPGSweepHypers(lr=1e-3, gamma=0.99, tau=5e-3)
    args = (actor, critic, actor, critic, zeros_adam(actor), zeros_adam(critic), *data, low, high, hp)
    reset_launch_counts()
    got = ddpg_sweep(*args)
    want = ddpg_sweep_plain(*args)

    def leaves(out):
        a, c, ta, tc, ao, co, metrics = out
        return a + c + ta + tc + ao.mu + ao.nu + co.mu + co.nu + [metrics]

    err = max(float((g - w).abs().max()) for g, w in zip(leaves(got), leaves(want)))
    print(f"K10 vs twin max |d| {err:.3e}")
    for g, w in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    again = ddpg_sweep(*args)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(again)))
    assert got[4].count == got[5].count == G and launch_counts["ddpg_sweep"] == 2  # one launch per call


def test_ddpg_kernel_learner_launches_one_collection_and_one_per_step(cuda):
    from smart_nanogrid_gym_torch.solvers.ddpg import DDPGConfig, DDPGLearner

    config = COLLECT_CONFIGS["b-pv-8ch"]
    params = make_params(config, torch.float32, cuda)
    learner = DDPGLearner(config, DDPGConfig(buffer_days=2, gradient_steps=4, collect_impl="kernel",
                                             sweep_impl="kernel"), device=cuda)
    state = learner.init(0, params, 256)
    step = learner.build_train_step()
    reset_launch_counts()
    state, metrics = step(state, params)
    torch.cuda.synchronize()
    assert dict(launch_counts) == {"ddpg_collect_day_seeded": 1, "ddpg_sweep": 1}
    assert all(bool(torch.isfinite(x)) for x in metrics)
    assert state.buffer.filled == config.steps_per_day


# ----------------------------------------------------------- tables-in days ---

TABLES_IN_CONFIGS = {
    "b-pv-8ch": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True),
    "b-pv-4ch": NanogridConfig(num_chargers=4, pv_system=True, battery_system=True),
}


def _day_states(config, params, batch, device):
    """Reset states of ``batch`` envs and the same envs rolled over into day 2
    by one plain RBC day (a carried SoC column and penalty mask)."""
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch, fused_day_rollout
    from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

    env = SmartNanogridTorch(config)
    gen = torch.Generator(device=device).manual_seed(4)
    state, _ = env.reset_batch(params, batch, gen)
    day2, _ = fused_day_rollout(config, params, state, make_rbc_policy_fn(config), generator=gen)
    return state, day2


@pytest.mark.parametrize("name", list(TABLES_IN_CONFIGS))
def test_tables_in_kernels_match_twins(cuda, name):
    """K11a and K11b at B=300 (a ragged last block) on a fresh and a
    continued state, bit for bit against their twins."""
    from smart_nanogrid_gym_torch.ops.policy_rollout import policy_day_rollout, policy_day_rollout_plain
    from smart_nanogrid_gym_torch.ops.rollout import rbc_day_rollout, rbc_day_rollout_plain, state_tables

    config = TABLES_IN_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = shifted_actor(config, 17, cuda)
    weights = actor_weights(config, net, cuda)
    reset_launch_counts()
    for state in _day_states(config, params, 300, cuda):
        st = state_tables(config, params, state)
        assert_equal_outputs(rbc_day_rollout(config, params, state), rbc_day_rollout_plain(config, traces, st),
                             ("rewards", "soc_final"))
        assert_equal_outputs(policy_day_rollout(config, params, state, net),
                             policy_day_rollout_plain(config, traces, weights, st), ("rewards", "actions", "soc_final"))
    assert dict(launch_counts) == {"rbc_day_rollout": 2, "policy_day_rollout": 2}


# K11b off the 1 h grid and on v2x (both charger branches), each torso: the
# artifact's 4ch 64x64, the bench's 8ch 64x64 and 256x256
K11B_CASES = {
    "b-pv-4ch-64-15min": (NanogridConfig(num_chargers=4, time_interval=0.25), (64, 64)),
    "b-pv-8ch-64-30min": (NanogridConfig(num_chargers=8, time_interval=0.5), (64, 64)),
    "b-pv-8ch-256-15min": (NanogridConfig(num_chargers=8, time_interval=0.25), (256, 256)),
    "b-pv-8ch-256-30min": (NanogridConfig(num_chargers=8, time_interval=0.5), (256, 256)),
    "v2x-b-pv-8ch-64-15min": (NanogridConfig(vehicle_to_everything=True, time_interval=0.25), (64, 64)),
    "v2x-b-pv-8ch-256-1h": (NanogridConfig(vehicle_to_everything=True), (256, 256)),
    "v2x-b-pv-8ch-256-30min": (NanogridConfig(vehicle_to_everything=True, time_interval=0.5), (256, 256)),
}


def k11b_net(config, hidden, seed, device):
    """A seeded PPO torso whose action-mean biases sit off the 0 branch
    boundaries, alternating charge and discharge on v2x (``shifted_actor``)."""
    net = ActorCritic(config.obs_dim, config.num_actions, hidden, generator=torch.Generator().manual_seed(seed))
    ch = [0.5 if n % 2 == 0 or not config.vehicle_to_everything else -0.4 for n in range(config.num_chargers)]
    with torch.no_grad():
        net.pi.Dense_2.bias.copy_(torch.tensor(ch + [-0.3] if config.battery_system else ch))
    return net.to(device)


@pytest.mark.parametrize("batch", [300, 4096])
@pytest.mark.parametrize("name", list(K11B_CASES))
def test_k11b_block_kernel_equals_twin(cuda, name, batch):
    """K11b on the block-actor template at 0.25 h, 0.5 h and 1 h, on a fresh
    and a continued state: rewards, actions and soc_final ``torch.equal`` to
    ``policy_day_rollout_plain``, one launch a call under the torso's name;
    the library's K11b shared memory is the layout's (``k6_layout`` with
    the seven table rows); on v2x both charger branches run."""
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.policy_rollout import policy_day_rollout, policy_day_rollout_plain
    from smart_nanogrid_gym_torch.ops.rollout import state_tables

    from test_torch_k6_block import k6_layout

    config, hidden = K11B_CASES[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = k11b_net(config, hidden, 19, cuda)
    weights = actor_weights(config, net, cuda)
    assert _build.library(config, cuda, hidden).ngk_k11b_smem_floats() == k6_layout(config, hidden, kinds=7)[0]
    label = "policy_day_rollout" + ("_block" if hidden[0] > 64 else "")
    for state in _day_states(config, params, batch, cuda):
        reset_launch_counts()
        got = policy_day_rollout(config, params, state, net)
        assert dict(launch_counts) == {label: 1}
        want = policy_day_rollout_plain(config, traces, weights, state_tables(config, params, state))
        assert_equal_outputs(got, want, ("rewards", "actions", "soc_final"))
        if config.vehicle_to_everything:
            chargers = got[1][:, :config.num_chargers]
            assert bool((chargers > 0).any() and (chargers < 0).any())


# K8's lane layout and K11a's ring off the 1 h grid: 96 steps a day, one
# charger (one group of 4 lanes, 3 of them drawing for no charger), 6
# chargers (two groups, the second half used), 5 kinds a step
RBC_LAYOUT_CONFIGS = {
    "b-pv-1ch-15min": NanogridConfig(num_chargers=1, time_interval=0.25),
    "b-pv-6ch-30min-reqsoc": NanogridConfig(num_chargers=6, time_interval=0.5, requested_state_of_charge=True,
                                            penalty_mode="dense"),
    "basic-6ch-15min": NanogridConfig(num_chargers=6, pv_system=False, battery_system=False, time_interval=0.25,
                                      different_battery_capacities=False, penalty_mode="on_departure"),
    "b-pv-8ch-30min": NanogridConfig(num_chargers=8, time_interval=0.5),
}


@pytest.mark.parametrize("batch", [1, 300])
@pytest.mark.parametrize("name", list(RBC_LAYOUT_CONFIGS))
def test_rbc_lane_and_ring_kernels_equal_twins(cuda, name, batch):
    """K8 (2 days) and K11a (a fresh and a continued state) at 0.25 h and
    0.5 h, with 1, 6 and 8 chargers, ``torch.equal`` to their twins, one
    launch a call."""
    from smart_nanogrid_gym_torch.ops.rollout import rbc_day_rollout, rbc_day_rollout_plain, state_tables

    config = RBC_LAYOUT_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    reset_launch_counts()
    assert_equal_outputs((gen_rbc_multiday(config, params, 2, 23, batch),),
                         (gen_rbc_multiday_plain(config, traces, 2, 23, batch),), ("stats",))
    for state in _day_states(config, params, batch, cuda):
        assert_equal_outputs(rbc_day_rollout(config, params, state),
                             rbc_day_rollout_plain(config, traces, state_tables(config, params, state)),
                             ("rewards", "soc_final"))
    assert dict(launch_counts) == {"gen_rbc_multiday": 1, "rbc_day_rollout": 2}


# K7 on its ring block and K5 at 64x64 on the block actor: one env, a ragged
# block, the bench batch and a ragged batch past it (130 blocks)
DAY_BATCHES = (1, 300, 4096, 4133)
# K7's configs: the layouts above, and the 4-charger b-pv sparse 1 h config
# of the paired evaluation (chip_smoke.py's main path: a 4-warp ring block)
K7_CONFIGS = {**RBC_LAYOUT_CONFIGS, **RBC_CONFIGS, "b-pv-sparse-4ch-1h": POLICY_CONFIGS["b-pv-4ch"]}


@pytest.mark.parametrize("batch", DAY_BATCHES)
@pytest.mark.parametrize("name", list(K7_CONFIGS))
def test_k7_ring_kernel_equals_twin(cuda, name, batch):
    """K7 on K11a's ring block at 0.25, 0.5, 1 and 2 h with 1, 4, 5, 6 and 8
    chargers: rewards and soc_final ``torch.equal`` to the twin's from
    random starting batteries, one ``gen_rbc_day`` launch a call; the
    library's ring is the mirror's (``RbcRing<N, 5>``)."""
    from smart_nanogrid_gym_torch.ops import _build

    from test_torch_rbc_block import KINDS, rbc_ring

    config = K7_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    lib = _build.library(config, cuda)
    assert (lib.ngk_gen_rbc_ring_depth(), lib.ngk_gen_rbc_ring_floats()) == rbc_ring(config.num_chargers, KINDS)[1:]
    u, pv = _inputs(config, 8, batch, cuda)
    batt = torch.rand(batch, generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    reset_launch_counts()
    got = gen_rbc_day(config, params, u, pv, batt)
    assert dict(launch_counts) == {"gen_rbc_day": 1}
    assert_equal_outputs(got, gen_rbc_day_plain(config, kernel_traces(params, cuda), u, pv, batt),
                         ("rewards", "soc_final"))


K5_64_CONFIGS = {
    "b-pv-4ch-15min": NanogridConfig(num_chargers=4, time_interval=0.25),
    "b-pv-8ch-30min": NanogridConfig(num_chargers=8, time_interval=0.5),
    "v2x-b-pv-8ch-15min": NanogridConfig(vehicle_to_everything=True, time_interval=0.25),
    "v2x-reqsoc-4ch-30min": NanogridConfig(num_chargers=4, pv_system=False, battery_system=False,
                                           vehicle_to_everything=True, penalty_mode="dense",
                                           requested_state_of_charge=True, time_interval=0.5),
    "b-pv-4ch-1h": POLICY_CONFIGS["b-pv-4ch"],
    "v2x-b-pv-8ch-1h": POLICY_CONFIGS["v2x-b-pv"],
    "b-pv-6ch-2h": NanogridConfig(num_chargers=6, time_interval=2.0, penalty_mode="on_departure"),
}


@pytest.mark.parametrize("batch", DAY_BATCHES)
@pytest.mark.parametrize("name", list(K5_64_CONFIGS))
def test_k5_64x64_block_kernel_equals_twin(cuda, name, batch):
    """K5 with the 64x64 PPO torso on the block actor at 0.25, 0.5, 1 and 2
    h, v2x included (chargers alternate charge and discharge): rewards,
    actions, soc_final and batt_final ``torch.equal`` to the twin's from
    random starting batteries, one ``gen_policy_day`` launch a call."""
    config = K5_64_CONFIGS[name]
    params = make_params(config, torch.float32, cuda)
    net = shifted_actor(config, 17, cuda)
    u, pv = _inputs(config, 10, batch, cuda)
    batt = torch.rand(batch, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    reset_launch_counts()
    got = gen_policy_day(config, params, net, u, pv, batt)
    assert dict(launch_counts) == {"gen_policy_day": 1}
    want = gen_policy_day_plain(config, kernel_traces(params, cuda), actor_weights(config, net, cuda), u, pv, batt)
    assert_equal_outputs(got, want, ("rewards", "actions", "soc_final", "batt_final"))
    if config.vehicle_to_everything and batch >= 300:
        chargers = got[1][:, :config.num_chargers]
        assert bool((chargers > 0).any() and (chargers < 0).any())


@pytest.mark.parametrize("batch", [8192, 12289, 32768])
@pytest.mark.parametrize("name", ["b-pv-sparse", "b-pv-6ch-30min-reqsoc"])
def test_k8_at_every_lane_count_equals_twin(cuda, name, batch):
    """K8 takes the full layout (8 lanes an env) at 8192 and 12,289 envs (a
    ragged warp) and one lane an env at 32,768 (kernels.cu's rbc_lanes):
    ``torch.equal`` to the twin over 2 days, one launch a call."""
    from smart_nanogrid_gym_torch.ops import _build

    config = {**RBC_CONFIGS, **RBC_LAYOUT_CONFIGS}[name]
    params = make_params(config, torch.float32, cuda)
    assert _build.library(config, cuda).ngk_rbc_lanes(batch) == (1 if batch >= 32768 else 8)
    reset_launch_counts()
    assert_equal_outputs((gen_rbc_multiday(config, params, 2, 29, batch),),
                         (gen_rbc_multiday_plain(config, kernel_traces(params, cuda), 2, 29, batch),), ("stats",))
    assert dict(launch_counts) == {"gen_rbc_multiday": 1}


def test_tables_in_kernels_reject_f64_states(cuda):
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch
    from smart_nanogrid_gym_torch.ops.rollout import rbc_day_rollout

    config = TABLES_IN_CONFIGS["b-pv-4ch"]
    params = make_params(config, torch.float64, cuda)
    state, _ = SmartNanogridTorch(config).reset_batch(params, 64, torch.Generator(device=cuda).manual_seed(0))
    with pytest.raises(ValueError, match="float32"):
        rbc_day_rollout(config, params, state)


# ------------------------------------------------ bf16 options, 256x256 ---

BF16 = torch.bfloat16


@pytest.mark.parametrize("actor", ["ppo", "ddpg"])
def test_k6_bf16_matches_twin(cuda, actor):
    """K6 with ``mlp_dtype=bf16`` against its twin (the PPO 64x64 actor and
    the DDPG 400-300 one), 2 days at B=300.  Both run on K6's block actor,
    whose bf16 products go through the tensor cores in their own summation
    order, so both meet the bf16 contract of ``k6_bf16_close`` with the f32
    kernel as its reference."""
    config = DDPG_CONFIGS["v2x-b-pv"]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = shifted_actor(config, 13, cuda) if actor == "ppo" else shifted_ddpg_actor(config, 13, cuda)
    weights = actor_weights(config, net, cuda, actor, mlp_dtype=BF16)
    reset_launch_counts()
    stats = gen_policy_multiday(config, params, net, 2, 17, 300, actor=actor, mlp_dtype=BF16)
    want = gen_policy_multiday_plain(config, traces, weights, 2, 17, 300, actor=actor, mlp_dtype=BF16)
    f32 = gen_policy_multiday(config, params, net, 2, 17, 300, actor=actor)
    k6_bf16_close(stats, want, f32, f"K6 {actor} bf16, v2x 8ch, B=300")
    assert not torch.equal(stats, f32)
    name = "gen_policy_multiday" + ("_ddpg" if actor == "ddpg" else "")
    assert dict(launch_counts) == {f"{name}_bf16": 1, name: 1}


def test_policy_kernels_at_256x256_match_twins(cuda):
    """The bench's 256x256 PPO torso runs the block-level actor in K5, K6 (f32
    and bf16) and K11b, against their twins at B=300: K6 f32 and K11b bit for
    bit."""
    from smart_nanogrid_gym_torch.ops.policy_rollout import policy_day_rollout, policy_day_rollout_plain
    from smart_nanogrid_gym_torch.ops.rollout import state_tables

    config = TABLES_IN_CONFIGS["b-pv-8ch"]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    torch.manual_seed(3)
    net = ActorCritic(config.obs_dim, config.num_actions, (256, 256)).to(cuda)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.05)
    weights = actor_weights(config, net, cuda)
    u, pv = _inputs(config, 8, 300, cuda)
    reset_launch_counts()
    for got, want in zip(gen_policy_day(config, params, net, u, pv),
                         gen_policy_day_plain(config, traces, weights, u, pv, torch.full_like(pv, 0.5))):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    f32 = gen_policy_multiday(config, params, net, 2, 5, 300)
    assert torch.equal(f32, gen_policy_multiday_plain(config, traces, weights, 2, 5, 300))
    k6_bf16_close(gen_policy_multiday(config, params, net, 2, 5, 300, mlp_dtype=BF16),
                  gen_policy_multiday_plain(config, traces, actor_weights(config, net, cuda, mlp_dtype=BF16), 2, 5,
                                            300, mlp_dtype=BF16), f32, "K6 256x256 bf16, B=300")
    state = _day_states(config, params, 300, cuda)[1]
    assert_equal_outputs(policy_day_rollout(config, params, state, net),
                         policy_day_rollout_plain(config, traces, weights, state_tables(config, params, state)),
                         ("rewards", "actions", "soc_final"))
    assert dict(launch_counts) == {"gen_policy_day_block": 1, "gen_policy_multiday_block": 1,
                                   "gen_policy_multiday_block_bf16": 1, "policy_day_rollout_block": 1}


def test_sweep_kernels_bf16_match_twins(cuda):
    """K4 (M = 300, ragged) and K3 (featlane) with ``matmul_dtype=bf16``, G = 4,
    against their twins.  The large products run on the bf16 tensor cores,
    whose accumulation order is not the twin's, so the kernels state a
    tolerance (``assert_bf16_close``, its f32 reference the f32 kernel): at
    least 99 % of the entries as close to the bf16 twin as the f32 result is
    (rtol 1e-4, atol 1e-6), parameters within 4·G·lr and moments within 1e-2
    of the twin, the summed distance below half the f32 result's; metrics at
    rtol 1e-3.  A rerun is bit-identical."""
    config = COLLECT_CONFIGS["b-pv-8ch"]
    F, A = config.obs_dim, config.num_actions
    leaves = _leaves(config, 5, cuda)
    adam = zeros_adam(leaves)
    hp = HYPERS._replace(matmul_dtype=BF16)

    def check(got, want, f32, msg):
        for label, pick, bound in (("params", lambda o: o[0], 4 * 4 * hp.lr),
                                   ("moments", lambda o: o[1].mu + o[1].nu, 1e-2)):
            g, w, f = ([x.cpu().numpy() for x in pick(o)] for o in (got, want, f32))
            assert_bf16_close(g, w, f, 1e-4, 1e-6, bound, f"{msg} {label}", share=0.99)
        torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-6)

    reset_launch_counts()
    obs, act, logp, adv, ret = _sweep_data((4, 300), F, A, cuda, 1)
    check(ppo_sweep(leaves, adam, obs, act, logp, adv, ret, hp),
          ppo_sweep_plain(leaves, adam, zip(obs, act, logp, adv, ret), hp),
          ppo_sweep(leaves, adam, obs, act, logp, adv, ret, HYPERS), "K4 bf16")
    T, B, granule = 6, 128, 32
    data = _sweep_data((T, B), F, A, cuda, 2)
    data = (data[0].permute(0, 2, 1).contiguous(), data[1].permute(0, 2, 1).contiguous()) + data[2:]
    block_perm = torch.stack([torch.randperm(T * B // granule, generator=torch.Generator().manual_seed(g))[:6]
                              for g in range(4)])
    got = ppo_sweep_streamed(leaves, adam, *data, block_perm, granule, hp)
    # the twin on the card: a bf16 operand rounds on the card's tanh, which the CPU's may flip
    check(got, ppo_sweep_streamed_plain(leaves, adam, *data, block_perm, granule, hp),
          ppo_sweep_streamed(leaves, adam, *data, block_perm, granule, HYPERS), "K3 bf16")
    again = ppo_sweep_streamed(leaves, adam, *data, block_perm, granule, hp)
    assert all(torch.equal(g, a) for g, a in zip(got[0], again[0]))
    assert dict(launch_counts) == {"ppo_sweep_bf16": 1, "ppo_sweep": 1, "ppo_sweep_streamed_bf16": 2,
                                   "ppo_sweep_streamed": 1}


def test_ddpg_sweep_kernel_bf16_matches_twin(cuda):
    """K10 with ``matmul_dtype=bf16`` over G = 3 steps of a ragged minibatch
    (M = 200) with the 400-300 networks, against its twin.  The kernel's
    products run on the bf16 tensor cores, whose accumulation order is not
    the twin's, so it states a tolerance (``assert_bf16_close``, its f32
    reference the f32 kernel): at least 99 % of the entries are as close to
    the bf16 twin as the f32 result is (rtol 1e-4, atol 1e-6), the
    parameters lie within 4·G·lr of the twin and the moments within 1e-2,
    and the summed distance is below half the f32 result's.  A rerun is
    bit-identical."""
    from smart_nanogrid_gym_torch.ops.ddpg_sweep import DDPGSweepHypers, ddpg_sweep, ddpg_sweep_plain
    from smart_nanogrid_gym_torch.solvers.networks import DDPGCritic, ddpg_leaves

    config = COLLECT_CONFIGS["b-pv-8ch"]
    F, A = config.obs_dim, config.num_actions
    actor = [x.detach() for x in ddpg_leaves(shifted_ddpg_actor(config, 5, cuda))]
    critic = [x.detach().to(cuda) for x in ddpg_leaves(DDPGCritic(F, A, generator=torch.Generator().manual_seed(6)))]
    gen = torch.Generator(device=cuda).manual_seed(1)
    G, M = 3, 200
    data = (torch.randn((G, M, F), generator=gen, device=cuda), torch.rand((G, M, A), generator=gen, device=cuda),
            -torch.rand((G, M), generator=gen, device=cuda) * 10, torch.randn((G, M, F), generator=gen, device=cuda),
            (torch.rand((G, M), generator=gen, device=cuda) < 0.05).float())
    low, high = (torch.as_tensor(b, device=cuda) for b in config.action_bounds())
    hp = DDPGSweepHypers(lr=1e-3, gamma=0.99, tau=5e-3, matmul_dtype=BF16)
    args = (actor, critic, actor, critic, zeros_adam(actor), zeros_adam(critic), *data, low, high, hp)
    reset_launch_counts()
    got, want = ddpg_sweep(*args), ddpg_sweep_plain(*args)
    f32 = ddpg_sweep(*args[:-1], hp._replace(matmul_dtype=None))

    def params(out):
        return [x.cpu().numpy() for x in out[0] + out[1] + out[2] + out[3]]

    def moments(out):
        return [x.cpu().numpy() for x in out[4].mu + out[4].nu + out[5].mu + out[5].nu]

    assert_bf16_close(params(got), params(want), params(f32), 1e-4, 1e-6, 4 * G * hp.lr, "K10 bf16 params",
                      share=0.99)
    assert_bf16_close(moments(got), moments(want), moments(f32), 1e-4, 1e-6, 1e-2, "K10 bf16 moments", share=0.99)
    torch.testing.assert_close(got[6], want[6], rtol=1e-2, atol=1e-3)
    again = ddpg_sweep(*args)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1] + [got[6]], again[0] + again[1] + [again[6]]))
    assert dict(launch_counts) == {"ddpg_sweep_bf16": 2, "ddpg_sweep": 1}


# ------------------------------------------------------ K6's block actor ---

# the DDPG artifact's 4ch config and the bench 8ch at 400-300, the bench's
# 256x256 PPO torso on 8ch (its bf16 weights resident in shared memory), both
# actors at 2 h, a narrow torso (its f32 weights resident too), and the 64x64
# PPO torso of the artifact (4ch) and of the bench (8ch, also at 2 h), f32 and
# bf16 weights resident
K6_BLOCK_CASES = {
    "ddpg-4ch": (NanogridConfig(num_chargers=4, pv_system=True, battery_system=True), "ddpg", (400, 300)),
    "ddpg-8ch": (NanogridConfig(num_chargers=8, pv_system=True, battery_system=True), "ddpg", (400, 300)),
    "ppo-8ch-256": (NanogridConfig(num_chargers=8, pv_system=True, battery_system=True), "ppo", (256, 256)),
    "ddpg-4ch-2h": (NanogridConfig(num_chargers=4, time_interval=2.0), "ddpg", (400, 300)),
    "ppo-8ch-256-2h": (NanogridConfig(num_chargers=8, time_interval=2.0, penalty_mode="on_departure"), "ppo",
                       (256, 256)),
    "ddpg-4ch-64x48": (NanogridConfig(num_chargers=4, pv_system=True, battery_system=True), "ddpg", (64, 48)),
    "ppo-4ch-64": (NanogridConfig(num_chargers=4, pv_system=True, battery_system=True), "ppo", (64, 64)),
    "ppo-8ch-64": (NanogridConfig(num_chargers=8, pv_system=True, battery_system=True), "ppo", (64, 64)),
    "ppo-8ch-64-2h": (NanogridConfig(num_chargers=8, time_interval=2.0, penalty_mode="on_departure"), "ppo",
                      (64, 64)),
    # below 1 h, both actors (the collection cases' configs and libraries)
    "ppo-4ch-64-0.25h": (COLLECT_CONFIGS["b-pv-0.25h"], "ppo", (64, 64)),
    "ddpg-4ch-0.25h": (COLLECT_CONFIGS["b-pv-0.25h"], "ddpg", (400, 300)),
    "ppo-8ch-64-0.5h": (COLLECT_CONFIGS["b-pv-0.5h"], "ppo", (64, 64)),
    "ddpg-8ch-0.5h": (COLLECT_CONFIGS["b-pv-0.5h"], "ddpg", (400, 300)),
}
# the cases whose K5 runs the block actor too (the DDPG actor, the 256x256 PPO torso)
K5_BLOCK_CASES = [name for name, (_, actor, hidden) in K6_BLOCK_CASES.items() if actor == "ddpg" or hidden[0] > 64]
K6_BATCHES = (1, 33, 300, 4096, 8192)


def _block_net(config, actor, hidden, seed, device):
    """A seeded actor of the case: a shifted DDPG actor, or a PPO torso with
    every bias +0.05 (the bench row's actor, bench.py:403-414)."""
    if actor == "ddpg":
        from smart_nanogrid_gym_torch.solvers.networks import DDPGActor

        low, high = config.action_bounds()
        net = DDPGActor(config.obs_dim, config.num_actions, low, high, hidden,
                        generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            net.mu.Dense_2.bias.add_(0.3)
        return net.to(device)
    net = ActorCritic(config.obs_dim, config.num_actions, hidden, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.05)
    return net.to(device)


@pytest.mark.parametrize("name, batch", batch_cases(K6_BLOCK_CASES, K6_BATCHES))
def test_k6_block_kernel_f32_equals_twin(cuda, name, batch):
    """K6's block actor in f32 is ``torch.equal`` to its twin for both
    actors and every torso at every batch (one env, a ragged block, ten
    blocks, the bench batch, two waves of 132 SMs) over 1 and 3 days; each
    call launches the kernel once; the library's f32 tile pads are those of
    ``choose_tiles``, and its K5 design is the block actor for all but
    the 64x64 PPO torso."""
    from smart_nanogrid_gym_torch.ops import _build

    from test_torch_k6_block import choose_tiles

    config, actor, hidden = K6_BLOCK_CASES[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = _block_net(config, actor, hidden, 31, cuda)
    weights = actor_weights(config, net, cuda, actor)
    lib = _build.library(config, cuda, hidden, actor)
    assert lib.ngk_block_actor() == int(name in K5_BLOCK_CASES)
    assert (lib.ngk_k6_pad(1), lib.ngk_k6_pad(2)) == (choose_tiles(hidden[0])[0], choose_tiles(hidden[1])[0])
    label = "gen_policy_multiday" + ("_ddpg" if actor == "ddpg" else ("_block" if name in K5_BLOCK_CASES else ""))
    for days in (1, 3):
        reset_launch_counts()
        got = gen_policy_multiday(config, params, net, days, 40 + days, batch, actor=actor)
        assert dict(launch_counts) == {label: 1}
        want = gen_policy_multiday_plain(config, traces, weights, days, 40 + days, batch, actor=actor)
        assert torch.equal(got, want), (days, float((got - want).abs().max()))


@pytest.mark.parametrize("name", ["ddpg-4ch", "ddpg-8ch", "ppo-8ch-256", "ddpg-4ch-64x48", "ppo-8ch-64"])
def test_k6_block_kernel_bf16_meets_contract(cuda, name):
    """K6's block actor with ``mlp_dtype=bf16`` runs its hidden layers on the
    tensor cores: at B=4096 over 2 days, a rerun is bit-identical, one call is
    one launch, and it meets ``k6_bf16_close`` against the bf16 twin with
    the f32 kernel as the reference (99 % of envs' Σ return and final battery
    as close as f32's, the mean day return within 0.5 %)."""
    config, actor, hidden = K6_BLOCK_CASES[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = _block_net(config, actor, hidden, 33, cuda)
    label = ("gen_policy_multiday" + ("_ddpg" if actor == "ddpg" else ("_block" if name in K5_BLOCK_CASES else ""))
             + "_bf16")
    reset_launch_counts()
    got = gen_policy_multiday(config, params, net, 2, 7, 4096, actor=actor, mlp_dtype=BF16)
    assert dict(launch_counts) == {label: 1}
    assert torch.equal(got, gen_policy_multiday(config, params, net, 2, 7, 4096, actor=actor, mlp_dtype=BF16))
    want = gen_policy_multiday_plain(config, traces, actor_weights(config, net, cuda, actor, BF16), 2, 7, 4096,
                                     actor=actor, mlp_dtype=BF16)
    f32 = gen_policy_multiday(config, params, net, 2, 7, 4096, actor=actor)
    shares, rel, err = k6_bf16_close(got, want, f32, f"K6 {name} bf16")
    print(f"K6 {name} bf16 B=4096 x 2 days: shares {shares}, mean gap {rel:.3e}, max |d| {err:.3e}")


@pytest.mark.parametrize("name, batch", batch_cases(K5_BLOCK_CASES, K6_BATCHES))
def test_k5_block_kernel_equals_twin(cuda, name, batch):
    """K5 on K6's block and ring (the DDPG actor, the 256x256 PPO torso, 2 h,
    0.5 h and 0.25 h included): rewards, actions, soc_final and batt_final ``torch.equal`` to
    the twin's at every batch, from random starting batteries; one launch a
    call."""
    config, actor, hidden = K6_BLOCK_CASES[name]
    params = make_params(config, torch.float32, cuda)
    traces = kernel_traces(params, cuda)
    net = _block_net(config, actor, hidden, 35, cuda)
    weights = actor_weights(config, net, cuda, actor)
    u, pv = _inputs(config, 9, batch, cuda)
    batt = torch.rand(batch, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    reset_launch_counts()
    got = gen_policy_day(config, params, net, u, pv, batt, actor=actor)
    assert dict(launch_counts) == {"gen_policy_day" + ("_ddpg" if actor == "ddpg" else "_block"): 1}
    want = gen_policy_day_plain(config, traces, weights, u, pv, batt, actor=actor)
    assert_equal_outputs(got, want, ("rewards", "actions", "soc_final", "batt_final"))
