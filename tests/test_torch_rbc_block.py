"""The layouts of the two RBC day kernels (``csrc/day_step.cuh``:
``gen_rbc_multiday_kernel`` K8 and ``rbc_day_rollout_kernel`` K11a) on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py holds them against
their twins there); what decides their layout is mirrored here:

- K8 gives an env L lanes, a lane a charger slot; lane j draws the Philox
  block of kind position j mod 4 of its slots' charger groups (and, when all
  five kinds are drawn, position 0 also the departure block), and a 4 x 4
  word transpose by shuffles within each group of 4 lanes hands every
  charger its words.  The emulation follows the shuffles' source lanes and
  word indices as the kernel computes them, and must reproduce
  ``ops/philox.py::day_uniforms`` for every kind the step draws, each used
  block drawn by one lane only.
- K11a keeps a ring of one-step stages of the day tables in shared memory;
  its size is what the library reports (``ngk_rbc_ring_floats``), checked by
  ``ops/rollout.py::check_rbc_ring`` before the launch.  K7 runs the same
  block and ring with the five uniform kinds a charger-step in place of the
  seven tables (``ngk_gen_rbc_ring_floats``), checked by the same function.
"""

from types import SimpleNamespace

import pytest
import torch

from smart_nanogrid_gym_torch.core.config import NanogridConfig
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops._build import MAX_SHARED_BYTES
from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
from smart_nanogrid_gym_torch.ops.philox import day_uniforms, philox4x32_10, to_uniform

CPU = torch.device("cpu")
TABLES, KINDS = 7, 5  # rows a charger-step: K11a's tables, K7's uniform kinds
RBC_ENVS, RBC_MAX_WARPS, RBC_RING_BYTES, RBC_MAX_DEPTH = 32, 8, 32 * 1024, 4


def lanes_for(slots: int) -> int:
    """``rbc_lanes_for``: the lanes of an env."""
    return 4 if slots <= 4 else 8 if slots <= 8 else 16 if slots <= 16 else 32


def drawn_kind(p: int, diff_caps: bool, req_soc: bool) -> int:
    """``drawn_kind``: the kind of the p-th block a step draws."""
    if p < 2:
        return p
    if p == 2:
        return 2 if diff_caps else 3 if req_soc else 4
    if p == 3:
        return 3 if diff_caps and req_soc else 4
    return 4


def k8_layout(N: int, diff_caps: bool, req_soc: bool, lanes: int | None = None) -> tuple[int, int, int, int]:
    """``RbcLanes``: charger groups, lanes of an env (the full layout's
    unless ``lanes``), slots of a lane, kinds drawn every step."""
    G = -(-N // 4)
    L = lanes or lanes_for(4 * G)
    return G, L, -(-4 * G // L), 2 + int(diff_caps) + int(req_soc)


def emulate_k8_draws(seed: int, day: int, batch: int, config: NanogridConfig, lanes: int | None = None):
    """The uniforms K8's lanes hand their chargers for one day: ``u (T, 5, N,
    B)`` (NaN where the kernel draws nothing) and the (kind, group) of every
    used block with the lane that drew it."""
    T, N = config.steps_per_day, config.num_chargers
    diff, req = config.different_battery_capacities, config.requested_state_of_charge
    k4, k10, k1 = int(4 / config.time_interval), int(10 / config.time_interval), int(1 / config.time_interval)
    G, L, SLOTS, KB = k8_layout(N, diff, req, lanes)
    i64 = dict(dtype=torch.int64)
    key = (torch.full((), seed, **i64), torch.arange(batch, **i64))
    t_ax = torch.arange(T, **i64).view(T, 1)

    def block(kind, g):  # (4, T, B) words of philox((day, t, kind, g), (seed, b))
        words = philox4x32_10((torch.full((), day, **i64), t_ax, torch.full((), kind, **i64),
                               torch.full((), g, **i64)), key)
        return torch.stack([w.expand(T, batch) for w in words])

    # draw_lane_blocks: first[j][i], second[j][i] (the departure block, five kinds only)
    first = [[block(drawn_kind(j & 3, diff, req), (j + i * L) >> 2) for i in range(SLOTS)] for j in range(L)]
    second = [[block(4, (j + i * L) >> 2) for i in range(SLOTS)] for j in range(L)] if KB == 4 else None
    u = torch.full((T, 5, N, batch), float("nan"))
    used = {}
    for j in range(L):
        q, quad = j & 3, j & ~3
        for i in range(SLOTS):
            c = j + i * L
            # quad_transpose: round r reads lane quad + (q + r) mod 4, which sends its
            # word (its place - r) mod 4
            got = [first[quad + ((q + r) & 3)][i][((((q + r) & 3) - r) & 3)] for r in range(4)]
            out = [got[(s - q) & 3] for s in range(4)]
            words = {0: out[0], 1: out[1]}
            if diff:
                words[2] = out[2]
            if req:
                words[3] = out[3 if diff else 2]
            # quad_word_of_first: word q of lane quad's departure block
            words[4] = second[quad][i][q] if KB == 4 else out[KB]
            if c >= N:
                continue
            for kind, w in words.items():
                u[:, kind, c] = to_uniform(w)
            for p in range(min(KB + 1, 4)):
                kind, lane = drawn_kind(p, diff, req), quad + p
                assert used.setdefault((kind, c >> 2), lane) == lane
            if KB == 4:
                assert used.setdefault((4, c >> 2), quad) == quad
    dep_drawn = torch.tensor([t + k4 < min(t + k10, T + k1) for t in range(T)])
    u[~dep_drawn, 4] = float("nan")  # the no-draw branch: the kernel's departure is `low`
    return u, used, dep_drawn


# (chargers, the capacity and requested-SoC kinds): 3, 4 and 5 kinds a step
K8_CASES = [(n, diff, req) for n in (1, 4, 5, 6, 8) for diff, req in ((False, False), (True, False), (True, True))]


@pytest.mark.parametrize("interval", [1.0, 0.25], ids=["1h", "15min"])
@pytest.mark.parametrize("n,diff,req", K8_CASES, ids=[f"{n}ch-{2 + d + r + 1}kinds" for n, d, r in K8_CASES])
def test_k8_lane_draws_reproduce_day_uniforms(n, diff, req, interval):
    """Every charger's uniforms after the transpose are the twin's
    ``day_uniforms`` for each kind the step draws; each used (kind, group)
    block comes from one lane, the one the kind position names."""
    config = NanogridConfig(num_chargers=n, different_battery_capacities=diff, requested_state_of_charge=req,
                            time_interval=interval)
    B = 6
    u, used, dep_drawn = emulate_k8_draws(71, 3, B, config)
    want, _ = day_uniforms(71, 3, B, config.steps_per_day, n, CPU)
    kinds = [0, 1] + [2] * diff + [3] * req
    assert torch.equal(u[:, kinds], want[:, kinds])
    assert torch.equal(u[dep_drawn, 4], want[dep_drawn, 4])
    assert bool(dep_drawn.any()) and not bool(dep_drawn.all())
    G, L, SLOTS, KB = k8_layout(n, diff, req)
    assert len(used) == G * (KB + 1) and L * SLOTS >= 4 * G and 32 % L == 0


@pytest.mark.parametrize("n", [33, 40, 64])
def test_k8_lanes_take_two_slots_each(n):
    """Past 32 chargers the full layout keeps 32 lanes and lane j owns
    chargers j and j + 32, drawing its kind position of both groups: the
    same uniforms."""
    config = NanogridConfig(num_chargers=n, requested_state_of_charge=True)
    u, used, dep_drawn = emulate_k8_draws(5, 0, 3, config)
    want, _ = day_uniforms(5, 0, 3, config.steps_per_day, n, CPU)
    assert torch.equal(u[:, :4], want[:, :4]) and torch.equal(u[dep_drawn, 4], want[dep_drawn, 4])
    G = -(-n // 4)
    assert k8_layout(n, True, True)[1:3] == (32, 2) and len(used) == G * 5


FILL_THREADS = 32768  # kernels.cu's kRbcFillThreads


def k8_lanes(batch: int, N: int) -> int:
    """``kernels.cu::rbc_lanes``: one lane an env once the batch alone gives
    FILL_THREADS threads, else the full layout."""
    return 1 if batch >= FILL_THREADS else k8_layout(N, True, False)[1]


def test_k8_lanes_follow_the_batch():
    """Below 32,768 envs the full layout (8 lanes at 8 chargers), from there
    one lane an env; both are layouts of the template (1, or a multiple of 4
    dividing 32)."""
    assert [k8_lanes(b, 8) for b in (1, 4096, 8192, 24576, 32767, 32768, 131072)] == [8, 8, 8, 8, 8, 1, 1]
    assert [k8_lanes(b, 4) for b in (4096, 32768)] == [4, 1]
    assert [k8_lanes(b, 16) for b in (1024, 8192, 32768)] == [16, 16, 1]


def test_rbc_profiler_patches_the_shipped_sources():
    """``tools/profile_rbc.py``'s variants patch a line the sources hold once:
    K8's lane rule in kernels.cu (also the value the test mirrors) and
    K11a's ring depth in day_step.cuh."""
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.tools.profile_rbc import DEPTH_ANCHOR, LANES_ANCHOR

    cu, cuh = (_build.CSRC / "kernels.cu").read_text(), (_build.CSRC / "day_step.cuh").read_text()
    assert cu.count(LANES_ANCHOR) == 1 and cuh.count(DEPTH_ANCHOR) == 1
    assert f"constexpr int64_t kRbcFillThreads = {FILL_THREADS};" in cu
    with pytest.raises(RuntimeError, match="has changed"):
        _build.replace_once(cu.replace(LANES_ANCHOR, ""), LANES_ANCHOR, "", "kernels.cu")


def test_k8_layout_fills_the_card_at_the_bench_batch():
    """8 chargers take 8 lanes (4 envs a warp, 4 kinds on 4 lanes of a group:
    one block a lane a step); B=4096 runs 32,768 threads, 256 blocks of 128."""
    G, L, SLOTS, KB = k8_layout(8, True, False)
    assert (G, L, SLOTS, KB) == (2, 8, 1, 3)
    assert 4096 * L // 128 == 256
    assert [k8_layout(n, True, False)[1:3] for n in (1, 5, 16, 17, 40)] == [(4, 1), (8, 1), (16, 1), (32, 1), (32, 2)]


def rbc_ring(N: int, rows: int = TABLES) -> tuple[int, int, int]:
    """``RbcRing<N, rows>``: charger warps of a block, steps in flight, floats before the traces."""
    warps = min(N, RBC_MAX_WARPS)
    step = rows * N * RBC_ENVS
    depth = min(max(RBC_RING_BYTES // (4 * step), 2), RBC_MAX_DEPTH)
    return warps, depth, depth * step + 2 * 2 * N * RBC_ENVS


def _ring_library(N, floats=None):
    """The library's ring numbers of K11a and K7 (``floats`` in place of both sizes)."""
    (_, depth, ring), (_, gen_depth, gen_ring) = rbc_ring(N), rbc_ring(N, KINDS)
    return SimpleNamespace(ngk_rbc_ring_floats=lambda: ring if floats is None else floats,
                           ngk_rbc_ring_depth=lambda: depth, ngk_rbc_day_rollout="ngk_rbc_day_rollout",
                           ngk_gen_rbc_ring_floats=lambda: gen_ring if floats is None else floats,
                           ngk_gen_rbc_ring_depth=lambda: gen_depth, ngk_gen_rbc_day="ngk_gen_rbc_day")


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("interval", [2.0, 1.0, 0.5, 0.25])
def test_k11a_ring_plan_fits_a_block(n, interval):
    """K11a's ring (4 steps of the tables) with its sums and traces fits a
    block for T in {12, 24, 48, 96}, six blocks and more an SM."""
    from smart_nanogrid_gym_torch.ops.rollout import check_rbc_ring

    config = NanogridConfig(num_chargers=n, time_interval=interval)
    traces = kernel_traces(make_params(config, torch.float32, "cpu"), CPU)
    warps, depth, ring = rbc_ring(n)
    assert (warps, depth) == ({1: 1, 4: 4, 8: 8}[n], 4)
    check_rbc_ring(config, traces, _ring_library(n).ngk_rbc_ring_floats(), "rbc_day_rollout")
    need = 4 * (ring + traces.rad_norm.numel() + 2 * config.steps_per_day)
    assert 6 * need <= MAX_SHARED_BYTES


def test_k11a_wrapper_checks_the_ring_before_the_launch(monkeypatch):
    """With the library and the launch replaced: a ring that fits launches
    ``rbc_day_rollout`` once on 32-env blocks' operands; one a float too
    large raises, naming the bytes, and launches nothing."""
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch
    from smart_nanogrid_gym_torch.ops import _build, rollout

    config = NanogridConfig(num_chargers=8, time_interval=0.25)
    params = make_params(config, torch.float32, "cpu")
    state, _ = SmartNanogridTorch(config).reset_batch(params, 5, torch.Generator().manual_seed(2))
    traces = kernel_traces(params, CPU)
    st = rollout.state_tables(config, params, state)
    calls = []
    monkeypatch.setattr(_build, "check_f32", lambda t, name: t)
    monkeypatch.setattr(_build, "launch", lambda name, fn, *args, device: calls.append((name, fn, args)))
    monkeypatch.setattr(_build, "load", lambda *a, **k: _ring_library(8))
    rewards, soc_final = rollout.launch_rbc_day(config, traces, st)
    (name, fn, args), = calls
    assert (name, fn) == ("rbc_day_rollout", "ngk_rbc_day_rollout")
    assert args[4] is st.tables and rewards.shape == (96, 5) and soc_final.shape == (8, 5)
    room = MAX_SHARED_BYTES // 4 - traces.rad_norm.numel() - 2 * 96
    monkeypatch.setattr(_build, "load", lambda *a, **k: _ring_library(8, room + 1))
    with pytest.raises(ValueError, match=f"{MAX_SHARED_BYTES + 4} bytes"):
        rollout.launch_rbc_day(config, traces, st)
    assert len(calls) == 1


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("interval", [2.0, 1.0, 0.5, 0.25])
def test_k7_ring_plan_fits_a_block(n, interval):
    """K7's ring, K11a's block with five uniform rows a charger-step
    (``RbcRing<N, 5>``): a warp a charger and a sum warp, 4 steps in flight, 5/7 of K11a's
    stage; with its sums and traces it passes ``check_rbc_ring`` for T in
    {12, 24, 48, 96}, seven blocks and more an SM."""
    from smart_nanogrid_gym_torch.ops.gen_rollout import check_rbc_ring

    config = NanogridConfig(num_chargers=n, time_interval=interval)
    traces = kernel_traces(make_params(config, torch.float32, "cpu"), CPU)
    warps, depth, ring = rbc_ring(n, KINDS)
    assert (warps, depth) == ({1: 1, 4: 4, 8: 8}[n], 4)
    assert ring - 2 * 2 * n * RBC_ENVS == depth * KINDS * n * RBC_ENVS
    assert 7 * (ring - 2 * 2 * n * RBC_ENVS) == 5 * (rbc_ring(n)[2] - 2 * 2 * n * RBC_ENVS)
    check_rbc_ring(config, traces, _ring_library(n).ngk_gen_rbc_ring_floats(), "gen_rbc_day")
    need = 4 * (ring + traces.rad_norm.numel() + 2 * config.steps_per_day)
    assert 7 * need <= MAX_SHARED_BYTES


def test_k7_wrapper_checks_the_ring_before_the_launch(monkeypatch):
    """With the library and the launch replaced: a ring that fits launches
    ``gen_rbc_day`` once on the explicit uniforms; one a float too large
    raises, naming the bytes and the kernel, and launches nothing."""
    from smart_nanogrid_gym_torch.ops import _build, gen_rollout

    config = NanogridConfig(num_chargers=8, time_interval=0.25)
    params = make_params(config, torch.float32, "cpu")
    traces = kernel_traces(params, CPU)
    u = torch.rand((96, 5, 8, 5), generator=torch.Generator().manual_seed(3))
    pv = torch.full((5,), 0.6)
    calls = []
    monkeypatch.setattr(gen_rollout, "kernel_device", lambda t: True)
    monkeypatch.setattr(_build, "check_f32", lambda t, name: t)
    monkeypatch.setattr(_build, "launch", lambda name, fn, *args, device: calls.append((name, fn, args)))
    monkeypatch.setattr(_build, "load", lambda *a, **k: _ring_library(8))
    rewards, soc_final = gen_rollout.gen_rbc_day(config, params, u, pv)
    (name, fn, args), = calls
    assert (name, fn) == ("gen_rbc_day", "ngk_gen_rbc_day")
    assert args[4] is u and rewards.shape == (96, 5) and soc_final.shape == (8, 5)
    room = MAX_SHARED_BYTES // 4 - traces.rad_norm.numel() - 2 * 96
    monkeypatch.setattr(_build, "load", lambda *a, **k: _ring_library(8, room + 1))
    with pytest.raises(ValueError, match=f"{MAX_SHARED_BYTES + 4} bytes of shared memory per block in gen_rbc_day"):
        gen_rollout.gen_rbc_day(config, params, u, pv)
    assert len(calls) == 1
