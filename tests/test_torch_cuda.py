"""The CUDA kernels K5-K8 of the PyTorch port against their plain twins.

Marked ``cuda``: each test skips without a CUDA device (and needs ``nvcc``
to build the kernels at first use).  The file imports no JAX, so it also
runs on a machine that has only PyTorch: ``python -m pytest
tests/test_torch_cuda.py -m cuda``.  Batches of 300 leave a ragged last
block of threads.
"""

import numpy as np
import pytest
import torch

from smart_nanogrid_gym_tpu.core.config import NanogridConfig
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops import (
    gen_policy_day,
    gen_policy_multiday,
    gen_rbc_day,
    gen_rbc_multiday,
    launch_counts,
    reset_launch_counts,
)
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

from torch_parity import kernel_inputs

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
    rew, soc = gen_rbc_day(config, params, u, pv)
    rew_p, soc_p = gen_rbc_day_plain(config, traces, u, pv, torch.full_like(pv, 0.5))
    torch.testing.assert_close(rew, rew_p, rtol=2e-5, atol=1e-5)
    torch.testing.assert_close(soc, soc_p, rtol=2e-5, atol=1e-5)
    stats = gen_rbc_multiday(config, params, 3, 17, 300)
    stats_p = gen_rbc_multiday_plain(config, traces, 3, 17, 300)
    torch.testing.assert_close(stats, stats_p, rtol=2e-5, atol=1e-3)
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
    out = gen_policy_day(config, params, net, u, pv)
    out_p = gen_policy_day_plain(config, traces, weights, u, pv, torch.full_like(pv, 0.5))
    for got, want in zip(out, out_p):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    stats = gen_policy_multiday(config, params, net, 3, 17, 300)
    stats_p = gen_policy_multiday_plain(config, traces, weights, 3, 17, 300)
    torch.testing.assert_close(stats, stats_p, rtol=2e-4, atol=1e-2)
    assert launch_counts["gen_policy_day"] == 1 and launch_counts["gen_policy_multiday"] == 1


def test_kernel_rejects_wrong_operands(cuda):
    config = RBC_CONFIGS["b-pv-sparse"]
    params = make_params(config, torch.float32, cuda)
    u, pv = _inputs(config, 1, 64, cuda)
    with pytest.raises(ValueError, match="float32"):
        gen_rbc_day(config, params, u.double(), pv)
