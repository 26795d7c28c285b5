"""K11b's instance of the block-actor template (``csrc/day_step.cuh``:
``policy_day_rollout_tables_kernel``) on the CPU: its layout, its wrapper's
packing and shared-memory check, and the table rows it stages.

The kernel runs only on the card (tests/test_torch_cuda.py holds it against
``policy_day_rollout_plain`` there, bit for bit); what decides its inputs is
mirrored here:

- the layout is K6's with two slots of a step's seven table rows in place of
  the draws (``k6_layout`` with 7 kinds), its size what the library
  reports (``ngk_k11b_smem_floats``), checked before the launch;
- the wrapper hands the kernel ``k6_block``'s f32 layout for every torso;
- the product warps copy step t's rows of the ``(7, T, N, B)`` tables into
  a slot (``store_tables``: thread p takes env p mod 32 and the rows
  p / 32, p / 32 + warps, ... of table-major (table, charger) order, tail envs
  mirrored to the last), and the env warp reads the slot back
  (``observe_tables``), keeping the previous step's departure row: the
  emulation must give ``state_tables``' rows of every env of the block, and
  the observation's rows at o = max(t-1, 0) that the twin reads.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smart_nanogrid_gym_torch.core import SmartNanogridTorch, fused_day_rollout
from smart_nanogrid_gym_torch.core.config import NanogridConfig
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops._build import MAX_SHARED_BYTES
from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
    actor_weights,
    check_k6_block,
    k6_block,
    trace_floats,
)
from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
from smart_nanogrid_gym_torch.ops.rollout import state_tables
from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

from test_torch_k6_block import SHAPES, E, _net, _Recorder, k6_layout

CPU = torch.device("cpu")
TABLES = 7              # kTables
COLLECT_THREADS = 384   # kDdpgCollectThreads: the first step's store
PRODUCT_THREADS = 352   # kDdpgProductThreads: every later step's
SOC_COLS, DEP_OBS = 3, 5  # TableKind of kSocCols, kDepObs
# the PPO torsos K11b runs: the artifact's (4ch), the bench's 64x64 and 256x256 (8ch)
K11B_SHAPES = ["ppo-4ch-64x64", "ppo-8ch-64x64", "ppo-8ch-256x256"]


def _states(config, batch, seed):
    """A reset state and the same envs continued into day 2 by a plain RBC day."""
    params = make_params(config, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(seed)
    fresh, _ = SmartNanogridTorch(config).reset_batch(params, batch, gen)
    day2, _ = fused_day_rollout(config, params, fresh, make_rbc_policy_fn(config), generator=gen)
    return params, {"fresh": fresh, "continued": day2}


@pytest.mark.parametrize("interval", [1.0, 0.25], ids=["1h", "15min"])
@pytest.mark.parametrize("name", K11B_SHAPES)
def test_k11b_layout_keeps_the_draw_layouts_ring(name, interval):
    """K11b's table slots (7 rows a charger, 5 for the draws) keep K6's
    chunk and stage count for each torso (the 256x256 f32 ring its 7 stages,
    the 64x64 weights resident), and its shared memory and traces fit a
    block at 1 h and 0.25 h."""
    config, _, hidden = SHAPES[name]
    config = dataclasses.replace(config, time_interval=interval)
    floats, chunk, stages = k6_layout(config, hidden, kinds=TABLES)
    draws = k6_layout(config, hidden)
    assert (chunk, stages) == draws[1:] == ((16, 7) if hidden[0] == 256 else (16, 6))
    assert floats - draws[0] == 2 * 2 * config.num_chargers * E
    traces = kernel_traces(make_params(config, torch.float32, "cpu"), CPU)
    check_k6_block(config, traces, SimpleNamespace(ngk_k11b_smem_floats=lambda: floats), hidden, False,
                   tables=True)


@pytest.mark.parametrize("name", K11B_SHAPES)
def test_k11b_wrapper_hands_the_kernel_k6_block(monkeypatch, name):
    """With the library and the launch replaced, ``policy_day_rollout``
    launches ``ngk_policy_day_rollout`` once with the actor in
    ``k6_block``'s f32 layout (not ``ActorWeights.packed``) for every
    torso, counted as ``policy_day_rollout`` or, for the torso whose f32
    block alone fills shared memory, ``policy_day_rollout_block``."""
    from smart_nanogrid_gym_torch.ops import _build, policy_rollout

    config, actor, hidden = SHAPES[name]
    net = _net(config, actor, hidden, 6)
    w = actor_weights(config, net, CPU)
    rec = _Recorder(w, block_actor=hidden[0] > 64, smem_floats=k6_layout(config, hidden, kinds=TABLES)[0])
    monkeypatch.setattr(policy_rollout, "kernel_device", lambda t: True)
    monkeypatch.setattr(_build, "check_f32", lambda t, name: t)
    monkeypatch.setattr(_build, "load", lambda *a, **k: rec.lib)
    monkeypatch.setattr(_build, "launch", rec.launch)
    params, states = _states(config, 5, 3)
    rewards, actions, soc_final = policy_rollout.policy_day_rollout(config, params, states["continued"], net)
    (label, fn, args), = rec.calls
    assert label == "policy_day_rollout" + ("_block" if hidden[0] > 64 else "")
    assert fn == "ngk_policy_day_rollout"
    assert torch.equal(args[11], k6_block(w, rec.lib, False)) and not torch.equal(args[11], w.packed())
    st = state_tables(config, params, states["continued"])
    assert all(torch.equal(a, b) for a, b in zip(args[6:11], st))
    T, A, N = config.steps_per_day, config.num_actions, config.num_chargers
    assert args[-3:] == (5, T, config.time_interval)
    assert (rewards.shape, actions.shape, soc_final.shape) == ((T, 5), (T, A, 5), (N, 5))


def test_k11b_wrapper_checks_shared_memory_before_the_launch(monkeypatch):
    """A library whose K11b floats and the traces exceed 232,448 bytes raises
    from ``check_k6_block``, naming the bytes and the kernel, and launches
    nothing; one float fewer launches."""
    from smart_nanogrid_gym_torch.ops import _build, policy_rollout

    config, actor, hidden = SHAPES["ppo-8ch-256x256"]
    net = _net(config, actor, hidden, 6)
    params, states = _states(config, 3, 4)
    room = MAX_SHARED_BYTES // 4 - trace_floats(config, kernel_traces(params, CPU))
    monkeypatch.setattr(policy_rollout, "kernel_device", lambda t: True)
    monkeypatch.setattr(_build, "check_f32", lambda t, name: t)
    for floats, launches in ((room + 1, 0), (room, 1)):
        rec = _Recorder(actor_weights(config, net, CPU), block_actor=True, smem_floats=floats)
        monkeypatch.setattr(_build, "load", lambda *a, **k: rec.lib)
        monkeypatch.setattr(_build, "launch", rec.launch)
        if launches == 0:
            with pytest.raises(ValueError, match=f"{MAX_SHARED_BYTES + 4} bytes .* policy_day_rollout"):
                policy_rollout.policy_day_rollout(config, params, states["fresh"], net)
        else:
            policy_rollout.policy_day_rollout(config, params, states["fresh"], net)
        assert len(rec.calls) == launches


def store_tables(tables: np.ndarray, t: int, b0: int, threads: int, offset: int = 0) -> np.ndarray:
    """``csrc/day_step.cuh::store_tables`` for one block: the slot
    (kTables, N, E) that threads ``offset .. offset + threads - 1`` (product
    index p = thread - offset) write for step t of the envs b0 .. b0 + 31."""
    _, _, N, B = tables.shape
    flat = tables.reshape(-1)  # (7, T, N, B) in memory order
    plane = tables.shape[1] * N * B
    slot = np.full(TABLES * N * E, np.nan, dtype=np.float32)
    rows, warps = TABLES * N, threads // E
    for p in range(threads):
        e, r0 = p % E, p // E
        src = t * N * B + min(b0 + e, B - 1)
        for q in range(-(-rows // warps)):
            r = r0 + q * warps
            if r < rows:
                slot[r * E + e] = flat[src + (r // N) * plane + (r % N) * B]
    return slot


@pytest.mark.parametrize("state_kind", ["fresh", "continued"])
@pytest.mark.parametrize("interval", [1.0, 0.25], ids=["1h", "15min"])
def test_k11b_staged_slots_reproduce_the_state_tables(interval, state_kind):
    """Every step's slot, as the first store (all 384 threads) and the product
    warps' later stores write it and the env warp's lanes read it back, holds
    ``state_tables``' rows of the block's envs (tail lanes: the last env's);
    the observation rows the env warp forms (SoC rows from column 0 at t = 0,
    the departure row of step t - 1 kept in a register) are the twin's at
    o = max(t-1, 0)."""
    config = NanogridConfig(num_chargers=3, pv_system=True, battery_system=True, time_interval=interval)
    B, N, T = 37, config.num_chargers, config.steps_per_day  # two blocks, the second with 5 envs
    params, states = _states(config, B, 11)
    st = state_tables(config, params, states[state_kind])
    tables = st.tables.numpy()
    for b0 in (0, E):
        lanes = np.minimum(b0 + np.arange(E), B - 1)
        prev_dep = None
        for t in range(T):
            slot = (store_tables(tables, t, b0, COLLECT_THREADS) if t == 0
                    else store_tables(tables, t, b0, PRODUCT_THREADS))
            read = slot.reshape(TABLES, N, E)  # lane e reads slot[(k * N + n) * E + e]
            assert np.array_equal(read, tables[:, t][:, :, lanes])
            o = max(t - 1, 0)
            dep_row = read[DEP_OBS] if t == 0 else prev_dep
            assert np.array_equal(dep_row, tables[DEP_OBS, o][:, lanes])
            if t == 0:
                assert np.array_equal(read[SOC_COLS], tables[SOC_COLS, 0][:, lanes])
            prev_dep = read[DEP_OBS]


def test_stage_profiler_patches_the_shipped_source():
    """``tools/profile_rbc.py --stage`` swaps ``store_tables``' loads through
    registers for ``cp.async``: its anchor is found once in the shipped
    source, and the copy keeps the rest of the file."""
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.tools.profile_rbc import STAGE_ANCHOR, STAGE_ASYNC

    code = (_build.CSRC / "day_step.cuh").read_text()
    copy = _build.replace_once(code, STAGE_ANCHOR, STAGE_ASYNC, "day_step.cuh")
    assert copy.count("async_copy_f32(slot + r * E + e") == 1 and "__ldg(src + (r / N)" not in copy
    assert copy.replace(STAGE_ASYNC, STAGE_ANCHOR) == code
