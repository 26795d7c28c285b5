"""Kernel twins K7 and K8 of the PyTorch port (``ops/gen_rollout.py``) and the
Philox generator of the multiday kernels, with the JAX package as the reference.

The twins run on CPU tensors.  K7's twin is held against
``pallas_gen_rbc_day`` in interpret mode on the same numpy uniforms and PV
shifts, at the tolerance tests/test_pallas.py uses.  K8 draws in-kernel
Philox numbers, which have no JAX counterpart: the generator is checked
against the Random123 known-answer vectors and K8's twin against K7's twin
fed the same draws.  The CUDA kernels are held against the twins in
tests/test_torch_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smart_nanogrid_gym_tpu.core import NanogridConfig, make_params as jax_make_params
from smart_nanogrid_gym_tpu.ops.pallas_gen_rollout import pallas_gen_rbc_day

from smart_nanogrid_gym_torch.core.generate import generate_schedule
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.core.rollout import fused_day_rollout
from smart_nanogrid_gym_torch.core.transition import reset
from smart_nanogrid_gym_torch.ops import gen_rbc_day, gen_rbc_multiday, launch_counts, reset_launch_counts
from smart_nanogrid_gym_torch.ops.gen_rollout import (
    gen_rbc_day_plain,
    gen_rbc_multiday_plain,
    kernel_traces,
    pv_shift_from_uniform,
)
from smart_nanogrid_gym_torch.ops.philox import day_uniforms, philox4x32_10
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

from torch_parity import kernel_inputs

RBC_CONFIGS = {
    "b-pv-sparse": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True),
    "b-pv-reqsoc": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True,
                                  different_battery_capacities=False,
                                  requested_state_of_charge=True),
    "b-pv-fixedcap": NanogridConfig(num_chargers=8, pv_system=True, battery_system=True,
                                    different_battery_capacities=False),
    "basic-ondep": NanogridConfig(num_chargers=4, pv_system=False, battery_system=False,
                                  penalty_mode="on_departure"),
}


@pytest.mark.parametrize("name", list(RBC_CONFIGS))
def test_rbc_day_twin_matches_pallas(name):
    config = RBC_CONFIGS[name]
    u, pv = kernel_inputs(config, 3)
    with jax.enable_x64(False):
        params = jax_make_params(config, dtype=jnp.float32)
        rew_ref, soc_ref = pallas_gen_rbc_day(config, params, jnp.asarray(u), jnp.asarray(pv),
                                              interpret=True)
    rew, soc = gen_rbc_day(config, make_params(config, torch.float32, "cpu"),
                           torch.from_numpy(u), torch.from_numpy(pv))
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_ref), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(soc.numpy(), np.asarray(soc_ref), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(RBC_CONFIGS))
def test_rbc_day_twin_matches_plain_engine(name):
    """K7's twin against the port's own engine (generate_schedule, reset and
    fused_day_rollout with the RBC) on the same uniforms, in f32."""
    config = RBC_CONFIGS[name]
    u, pv = kernel_inputs(config, 7, batch=64)
    params = make_params(config, torch.float32, "cpu")
    schedule = generate_schedule(config, params, torch.from_numpy(u).permute(3, 0, 1, 2))
    state, _ = reset(config, params, schedule, pv_shift=torch.from_numpy(pv))
    final, (_, rewards, _) = fused_day_rollout(config, params, state, make_rbc_policy_fn(config),
                                               next_pv_shift=state.pv_shift)
    rew, soc = gen_rbc_day(config, params, torch.from_numpy(u), torch.from_numpy(pv))
    np.testing.assert_allclose(rew.numpy(), rewards.numpy(), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(soc.numpy(), final.soc[..., config.steps_per_day - 1].T.numpy(),
                               rtol=2e-5, atol=1e-5)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        as_t = lambda v: torch.tensor(v, dtype=torch.int64)
        got = philox4x32_10(tuple(map(as_t, ctr)), tuple(map(as_t, key)))
        assert tuple(int(x) for x in got) == want


def test_day_uniforms_layout():
    u, u_pv = day_uniforms(seed=5, day=2, batch=16, steps=24, num_chargers=6, device="cpu")
    assert u.shape == (24, 5, 6, 16) and u_pv.shape == (16,)
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # charger 5 is word 1 of group 1 at counter (day, t, kind, 1), key (seed, env)
    t, k, env = 7, 3, 11
    as_t = lambda v: torch.tensor(v, dtype=torch.int64)
    words = philox4x32_10((as_t(2), as_t(t), as_t(k), as_t(1)), (as_t(5), as_t(env)))
    assert float(u[t, k, 5, env]) == float((words[1] >> 8).float() * 2.0 ** -24)
    # independent streams: other seed, other day
    assert not torch.equal(u, day_uniforms(6, 2, 16, 24, 6, "cpu")[0])
    assert not torch.equal(u, day_uniforms(5, 3, 16, 24, 6, "cpu")[0])


def test_rbc_multiday_twin_equals_explicit_days():
    """Two Philox days of K8's twin against K7's twin fed the same draws."""
    config = RBC_CONFIGS["b-pv-sparse"]
    traces = kernel_traces(make_params(config, torch.float32, "cpu"), torch.device("cpu"))
    stats = gen_rbc_multiday_plain(config, traces, num_days=2, seed=9, batch=64)
    batt = torch.full((64,), 0.5)
    returns = []
    for day in range(2):
        u, u_pv = day_uniforms(9, day, 64, config.steps_per_day, config.num_chargers, "cpu")
        rew, _ = gen_rbc_day_plain(config, traces, u, pv_shift_from_uniform(u_pv), batt)
        returns.append(rew.sum(0, dtype=torch.float64))
    days = torch.stack(returns)
    np.testing.assert_allclose(stats[0].double().numpy(), days.sum(0).numpy(), rtol=1e-5)
    np.testing.assert_allclose(stats[1].double().numpy(), (days ** 2).sum(0).numpy(), rtol=1e-5)


def test_wrappers_guard_baked_params():
    config = RBC_CONFIGS["b-pv-sparse"]
    params = make_params(config, torch.float32, "cpu")
    bad = params._replace(batt_capacity=torch.tensor(100.0))
    u, pv = kernel_inputs(config, 1, batch=8)
    with pytest.raises(ValueError, match="batt_capacity"):
        gen_rbc_day(config, bad, torch.from_numpy(u), torch.from_numpy(pv))
    with pytest.raises(ValueError, match="batt_init_soc"):
        gen_rbc_multiday(config, params._replace(batt_init_soc=torch.tensor(0.3)), 1, 0, 8)
    with pytest.raises(ValueError, match="non-v2x"):
        gen_rbc_day(NanogridConfig(vehicle_to_everything=True), params,
                    torch.from_numpy(u), torch.from_numpy(pv))


def test_cpu_tensors_take_the_plain_path():
    config = RBC_CONFIGS["b-pv-sparse"]
    reset_launch_counts()
    gen_rbc_multiday(config, make_params(config, torch.float32, "cpu"), 1, 0, 8)
    assert sum(launch_counts.values()) == 0


def test_library_path_reads_the_sources_once_per_process(monkeypatch):
    """Every launch names its library through ``library_path``: the digest of
    the sources is read on a process's first call and never again."""
    from pathlib import Path

    from smart_nanogrid_gym_torch.ops import _build

    _build.source_digest.cache_clear()
    reads = []
    read_bytes = Path.read_bytes
    monkeypatch.setattr(Path, "read_bytes", lambda self: reads.append(self.name) or read_bytes(self))
    flags = _build.config_flags(RBC_CONFIGS["b-pv-sparse"])
    first = _build.library_path(flags)
    assert sorted(reads) == sorted(_build.SOURCES)
    reads.clear()
    assert _build.library_path(flags) == first
    assert _build.library_path(_build.config_flags(RBC_CONFIGS["basic-ondep"])) != first
    assert reads == []
