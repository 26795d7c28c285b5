"""The layout of K6's block-actor kernel (``csrc/day_step.cuh``:
``gen_policy_multiday_block_kernel``, and K5's ``gen_policy_day_block_kernel``
on the same template) on the CPU: the packing of its weight block, an
emulation of its products in the kernel's order against the twin's
``dense()``, its shared-memory check, and the wrappers' use of both.

The kernel runs only on the card (tests/test_torch_cuda.py holds it against
its twin there); what surrounds it is Python that runs here.  The f32 path
sums each output over k in index order through R x V register tiles and the
chunks of its weight ring: the emulation reads the packed block chunk by
chunk, with the chunk offsets of ``F32Ring``, and must equal the twin bit for
bit.  The bf16 path's mma fragments are decoded with the kernel's lane
formulas and multiplied exactly (float64): that must meet the twin's f32 sums
of the same bf16 operands to f32 rounding, since only the summation order
differs.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smart_nanogrid_gym_torch.core.config import NanogridConfig
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops._build import MAX_SHARED_BYTES
from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
    actor_weights,
    check_k6_block,
    dense,
    k6_block,
    relu,
    trace_floats,
)
from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
from smart_nanogrid_gym_torch.solvers.networks import ActorCritic, DDPGActor

CPU = torch.device("cpu")
B8 = NanogridConfig(num_chargers=8, pv_system=True, battery_system=True)
ART4 = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)
E = 32            # envs a block (kCollectEnvs)
THREADS = 352     # product threads (kDdpgProductThreads)
PAIR_LD = 40      # words a row of bf16 pairs (kPairLd)
BF16 = torch.bfloat16
# (config, actor, hidden): the DDPG artifact's 4ch and the bench 8ch at 400-300,
# the bench's 256x256 PPO torso, the PPO 64x64 torso of the artifact (4ch) and
# of the bench (8ch), one narrow DDPG torso
SHAPES = {
    "ddpg-4ch-400x300": (ART4, "ddpg", (400, 300)),
    "ddpg-8ch-400x300": (B8, "ddpg", (400, 300)),
    "ppo-8ch-256x256": (B8, "ppo", (256, 256)),
    "ppo-4ch-64x64": (ART4, "ppo", (64, 64)),
    "ppo-8ch-64x64": (B8, "ppo", (64, 64)),
    "ddpg-4ch-50x30": (ART4, "ddpg", (50, 30)),
}


def tile_cost(J: int, R: int, V: int) -> int:
    """``csrc/day_step.cuh::tile_cost``: instructions a k-row on the busiest scheduler."""
    tiles = -(-J // R) * (E // V)
    load = [0, 0, 0, 0]
    for w in range(THREADS // 32):
        load[(w + 1) % 4] += len(range(32 * w, tiles, THREADS))
    cost = max(load) * (2 * R * V + -(-R // 4) + -(-V // 4))
    return cost if tiles > 7 * 32 else 2 * cost


def choose_tiles(J: int) -> tuple[int, int]:
    """``csrc/day_step.cuh::choose_tiles``: the R x V tiles of an f32 layer of J rows."""
    best, best_cost = (4, 4), None
    for R, V in ((4, 4), (4, 8), (8, 4), (8, 8), (4, 2)):
        rounds = -(-(-(-J // R) * (E // V)) // THREADS)
        if R * V * rounds > 64:
            continue
        cost = tile_cost(J, R, V)
        if best_cost is None or cost < best_cost:
            best, best_cost = (R, V), cost
    return best


def k6_layout(config, hidden, kinds: int = 5, bf16: bool = False) -> tuple[int, int, int]:
    """``csrc/day_step.cuh::K6<C, BF16, SOURCE>``: the block actor's floats
    before the traces, its chunk (f32 k-rows or bf16 k-steps) and its ring
    stages, for step slots of ``kinds`` rows a charger (5 draws: K6 and K5;
    7 tables: K11b)."""
    F, A, N = config.obs_dim, config.num_actions, config.num_chargers
    H1, H2 = hidden

    def ring(chunk, stages):  # (floats, chunks a step): ring_shared_floats + two slots
        if bf16:
            mt1, mt2, ks1 = -(-H1 // 16), -(-H2 // 16), -(-F // 16)
            stage, nc = chunk * max(mt1, mt2) * 128, -(-ks1 // chunk) + -(-mt1 // chunk)
            acts = (ks1 + mt1 + mt2) * 8 * PAIR_LD
        else:
            p1, p2 = (-(-J // choose_tiles(J)[0]) * choose_tiles(J)[0] for J in (H1, H2))
            stage, nc = chunk * max(p1, p2), -(-F // chunk) + -(-H1 // chunk)
            acts = (F + p1 + p2) * E
        floats = 4 * stages + stages * stage + acts + A * H2 + H1 + H2 + 3 * A + A * E + 2 * kinds * N * E
        return floats, nc

    def fits(chunk, stages):  # kTraceReserveBytes kept for the traces
        return 4 * ring(chunk, stages)[0] + 16384 <= MAX_SHARED_BYTES

    chunk = next((c for c in ((2,) if bf16 else (16, 8, 4, 2)) if fits(c, 3)), 1)
    stages, nc = 3, ring(chunk, 3)[1]
    while stages < nc and fits(chunk, stages + 1):
        stages += 1
    stages = min(stages, nc)
    return ring(chunk, stages)[0], chunk, stages


def test_k6_layout_mirrors_the_template():
    """The mirror gives the template's own constants (the host compiler's
    evaluation of ``K6<C, BF16, SOURCE>`` for these torsos): K11b's table
    slots leave the 256x256 f32 ring its 7 stages and the 64x64 one
    resident (6 chunks)."""
    assert k6_layout(ART4, (64, 64)) == (12711, 16, 6)
    assert k6_layout(ART4, (64, 64), kinds=7) == (13223, 16, 6)
    assert k6_layout(B8, (64, 64), kinds=7) == (15667, 16, 6)
    assert k6_layout(B8, (256, 256)) == (51575, 16, 7)
    assert k6_layout(B8, (256, 256), kinds=7) == (52599, 16, 7)
    assert k6_layout(B8, (256, 256), bf16=True) == (53471, 2, 9)
    assert k6_layout(B8, (64, 64), bf16=True)[0] == 9863


def test_choose_tiles_keeps_wide_layers_and_fills_the_64_row_layer():
    """The 400-, 300- and 256-row layers keep their tiles (4 x 4, 4 x 4, 4 x
    8); a 64-row layer takes 4 x 2, 256 tiles for the 352 product threads,
    where 4 x 4 would give 128."""
    assert [choose_tiles(J) for J in (400, 300, 256, 64)] == [(4, 4), (4, 4), (4, 8), (4, 2)]
    assert -(-64 // 4) * (E // 2) == 256 and -(-64 // 4) * (E // 4) == 128


def test_tile_profiler_patches_the_shipped_shape_list():
    """``tools/profile_k6.py --tiles`` times the 64x64 rows against a copy of
    ``day_step.cuh`` whose ``choose_tiles`` lacks 4 x 2: its anchor is the
    shipped shape list, found once, and the copy keeps the other four."""
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.tools.profile_k6 import NARROW, WIDE

    assert (_build.CSRC / "day_step.cuh").read_text().count(NARROW) == 1
    assert "{4, 2}" in NARROW and "{4, 2}" not in WIDE
    assert WIDE.replace("[4]", "[5]").replace("i < 4", "i < 5") == NARROW.replace(", {4, 2}", "")


def _net(config, actor, hidden, seed):
    gen = torch.Generator().manual_seed(seed)
    if actor == "ddpg":
        return DDPGActor(config.obs_dim, config.num_actions, *config.action_bounds(), hidden, generator=gen)
    return ActorCritic(config.obs_dim, config.num_actions, hidden, generator=gen)


def _weights(name, mlp_dtype=torch.float32, seed=3):
    config, actor, hidden = SHAPES[name]
    return config, actor, actor_weights(config, _net(config, actor, hidden, seed), CPU, actor, mlp_dtype)


def _fake_library(w, bf16):
    (H1, F), H2 = w.w1.shape, w.w2.shape[0]
    pads = {1: choose_tiles(H1)[0], 2: choose_tiles(H2)[0]}
    tail = sum(x.numel() for x in (w.b1, w.b2, w.w3, w.b3, w.low, w.high))
    if bf16:
        mt1, mt2, ks1 = -(-H1 // 16), -(-H2 // 16), -(-F // 16)
        size = (ks1 * mt1 + mt1 * mt2) * 128 + tail
    else:
        size = F * (-(-H1 // pads[1]) * pads[1]) + H1 * (-(-H2 // pads[2]) * pads[2]) + tail
    return SimpleNamespace(ngk_k6_pad=lambda layer: pads[layer], ngk_k6_weights_size=lambda _: size)


def unpack_fragments(words: torch.Tensor, J: int, K: int) -> torch.Tensor:
    """The inverse of ``gen_policy_rollout.mma_fragments``: ``(J, K)`` f32 from the fragment words."""
    MT, KS = -(-J // 16), -(-K // 16)
    frags = words.contiguous().view(BF16).reshape(KS, MT, 8, 4, 2, 2, 2)
    # (ks, mt, g, t, k half, row half, pair) -> (mt, row half, g, ks, k half, t, pair)
    return frags.permute(1, 5, 2, 0, 4, 3, 6).reshape(MT * 16, KS * 16)[:J, :K].float()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["ddpg-4ch-400x300", "ppo-8ch-256x256", "ppo-4ch-64x64", "ppo-8ch-64x64",
                                  "ddpg-4ch-50x30"])
def test_k6_block_round_trips_to_actor_weights(name, bf16):
    """The packed block holds W1 and W2 (k-major with each k-row padded to
    the library's tile, or as bf16 mma fragments, 2 bytes a weight) and then
    b1, b2, W3, b3 and the box unchanged; the size the library reports is
    checked."""
    config, actor, w = _weights(name, BF16 if bf16 else torch.float32)
    (H1, F), H2 = w.w1.shape, w.w2.shape[0]
    lib = _fake_library(w, bf16)
    block = k6_block(w, lib, bf16)
    tail = torch.cat([x.reshape(-1) for x in (w.b1, w.b2, w.w3, w.b3, w.low, w.high)])
    if bf16:
        n1, n2 = -(-F // 16) * -(-H1 // 16) * 128, -(-H1 // 16) * -(-H2 // 16) * 128
        assert 4 * n1 == 2 * (-(-F // 16) * 16) * (-(-H1 // 16) * 16)  # 2 bytes a (padded) weight
        assert torch.equal(unpack_fragments(block[:n1], H1, F), w.w1)
        assert torch.equal(unpack_fragments(block[n1:n1 + n2], H2, H1), w.w2)
    else:
        P1, P2 = (-(-h // lib.ngk_k6_pad(i)) * lib.ngk_k6_pad(i) for i, h in ((1, H1), (2, H2)))
        n1, n2 = F * P1, H1 * P2
        w1, w2 = block[:n1].reshape(F, P1), block[n1:n1 + n2].reshape(H1, P2)
        assert torch.equal(w1[:, :H1], w.w1.T) and not w1[:, H1:].any()
        assert torch.equal(w2[:, :H2], w.w2.T) and not w2[:, H2:].any()
    assert torch.equal(block[n1 + n2:], tail)
    wrong = SimpleNamespace(ngk_k6_pad=lib.ngk_k6_pad, ngk_k6_weights_size=lambda _: block.numel() + 1)
    with pytest.raises(ValueError, match="expects"):
        k6_block(w, wrong, bf16)


def ring_layer(block: np.ndarray, offset: int, rows: int, P: int, K: int, J: int, R: int, V: int,
               x: np.ndarray, bias: np.ndarray, act) -> np.ndarray:
    """``F32Ring``'s layer as the kernel runs it: chunk by chunk of ``rows``
    k-rows (each read from the packed block at its chunk offset), within a
    chunk k by k, the R x V tiles of each round of the product threads; each
    sum starts at its first product and adds the next in f32, product and add
    apart.  Returns ``act(acc + b)`` for the J rows (P padded)."""
    tiles = [(i // (E // V) * R, i % (E // V) * V) for i in range(P // R * (E // V))]
    rounds = [tiles[q:q + THREADS] for q in range(0, len(tiles), THREADS)]
    acc = np.zeros((P, E), np.float32)
    for c in range(-(-K // rows)):
        k0 = c * rows
        n = min(rows, K - k0)
        chunk = block[offset + k0 * P: offset + (k0 + n) * P].reshape(n, P)
        for kk in range(n):
            k = k0 + kk
            for tiles_q in rounds:
                j0 = np.array([t[0] for t in tiles_q])[:, None, None] + np.arange(R)[None, :, None]
                e0 = np.array([t[1] for t in tiles_q])[:, None, None] + np.arange(V)[None, None, :]
                term = chunk[kk][j0] * x[k][e0]
                acc[j0, e0] = term if k == 0 else acc[j0, e0] + term
    return act(acc[:J] + bias[:, None])


@pytest.mark.parametrize("rows", [16, 8])
@pytest.mark.parametrize("name", ["ddpg-8ch-400x300", "ppo-8ch-256x256", "ppo-4ch-64x64", "ppo-8ch-64x64",
                                  "ddpg-4ch-50x30"])
def test_ring_tile_order_equals_twin_dense(name, rows):
    """Both hidden layers of the f32 block actor, emulated in the kernel's
    order from the packed block (the tiles of ``choose_tiles``, chunks of 16
    k-rows as the bench's libraries use and of 8 as a wide torso's), equal
    the twin's ``dense()`` and activation bit for bit."""
    config, actor, w = _weights(name, seed=5)
    (H1, F), H2 = w.w1.shape, w.w2.shape[0]
    lib = _fake_library(w, False)
    block = k6_block(w, lib, False).numpy()
    (R1, V1), (R2, V2) = choose_tiles(H1), choose_tiles(H2)
    P1, P2 = -(-H1 // R1) * R1, -(-H2 // R2) * R2
    x = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1.5, (F, E)).astype(np.float32))
    torch_act = relu if actor == "ddpg" else torch.tanh

    def np_act(v):
        return torch_act(torch.from_numpy(v)).numpy()
    h1 = ring_layer(block, 0, rows, P1, F, H1, R1, V1, x.numpy(), w.b1[:, 0].numpy(), np_act)
    h2 = ring_layer(block, F * P1, rows, P2, H1, H2, R2, V2, h1, w.b2[:, 0].numpy(), np_act)
    want1 = torch_act(dense(w.w1, w.b1, x))
    want2 = torch_act(dense(w.w2, w.b2, want1))
    np.testing.assert_array_equal(h1, want1.numpy())
    np.testing.assert_array_equal(h2, want2.numpy())


def mma_layer(frags: torch.Tensor, x_words: np.ndarray, J: int, K: int, bias: np.ndarray, act) -> np.ndarray:
    """``mma_layer`` of the kernel with exact products: A and B assembled from
    each lane's fragment words by the kernel's lane formulas (A from the
    packed fragments, B from the bf16 pair rows of the activations), D = A B
    per m-tile, n-tile and k-step summed in float64, and D's lane (g, t)
    elements stored at unit 16 mt + g (+ 8), env 8 nt + 2 t (+ 1).  Returns
    the layer's output as bf16 pair rows."""
    MT, KS = -(-J // 16), -(-K // 16)
    a_words = frags.contiguous().view(BF16).float().numpy().reshape(KS, MT, 32, 4, 2)
    x_vals = x_words.view(np.uint16).astype(np.uint32) << 16  # bf16 halves as f32 bits
    x_vals = x_vals.view(np.float32).reshape(-1, PAIR_LD, 2)   # (pair row, word, half)
    out = np.zeros((MT * 16, E), np.float64)
    for ks in range(KS):
        for mt in range(MT):
            A = np.zeros((16, 16))
            B = np.zeros((16, E))
            for lane in range(32):
                g, t = lane // 4, lane % 4
                a = a_words[ks, mt, lane]
                A[g, 2 * t:2 * t + 2], A[g + 8, 2 * t:2 * t + 2] = a[0], a[1]
                A[g, 2 * t + 8:2 * t + 10], A[g + 8, 2 * t + 8:2 * t + 10] = a[2], a[3]
                for nt in range(E // 8):
                    B[2 * t:2 * t + 2, 8 * nt + g] = x_vals[8 * ks + t, 8 * nt + g]
                    B[2 * t + 8:2 * t + 10, 8 * nt + g] = x_vals[8 * ks + 4 + t, 8 * nt + g]
            out[16 * mt:16 * mt + 16] += A @ B
    y = np.zeros((MT * 8, PAIR_LD, 2), np.float32)
    units = np.arange(MT * 16)
    vals = np.where(units[:, None] < J, act(out.astype(np.float32) + np.pad(bias, (0, MT * 16 - J))[:, None]), 0)
    y[units // 2, :E, units % 2] = vals
    return torch.from_numpy(y).to(BF16).view(torch.int32).numpy()


def to_pairs(x: torch.Tensor, KS: int) -> np.ndarray:
    """The bf16 pair rows of activations ``x (K, E)``: row kp, word e = inputs 2 kp and 2 kp + 1."""
    rows = torch.zeros((KS * 16, PAIR_LD), dtype=BF16)
    rows[:x.shape[0], :E] = x.to(BF16)
    return rows.reshape(KS * 8, 2, PAIR_LD).permute(0, 2, 1).contiguous().view(torch.int32).numpy()


def from_pairs(words: np.ndarray, J: int) -> torch.Tensor:
    halves = torch.from_numpy(words).view(BF16).reshape(-1, PAIR_LD, 2)
    return halves.permute(0, 2, 1).reshape(-1, PAIR_LD)[:J, :E].float()


@pytest.mark.parametrize("name", ["ddpg-4ch-400x300", "ppo-8ch-256x256", "ppo-4ch-64x64", "ppo-8ch-64x64",
                                  "ddpg-4ch-50x30"])
def test_mma_fragment_layer_matches_twin_dense(name):
    """Both hidden layers of the bf16 block actor with exact products from
    the packed fragments and the pair rows, by the kernel's lane formulas,
    against the bf16 twin (bf16 operands, f32 sums in index order): the
    pre-activation sums agree to f32 rounding of a few hundred terms (rtol
    1e-5, atol 1e-5), so every hidden unit is within one bf16 rounding step."""
    config, actor, w = _weights(name, BF16, seed=9)
    (H1, F), H2 = w.w1.shape, w.w2.shape[0]
    block = k6_block(w, _fake_library(w, True), True)
    n1 = -(-F // 16) * -(-H1 // 16) * 128
    n2 = -(-H1 // 16) * -(-H2 // 16) * 128
    x = torch.from_numpy(np.random.default_rng(11).uniform(-1, 1.5, (F, E)).astype(np.float32))
    ident = lambda v: v  # noqa: E731
    pre1 = from_pairs(mma_layer(block[:n1], to_pairs(x, -(-F // 16)), H1, F, w.b1[:, 0].numpy(), ident), H1)
    torch.testing.assert_close(pre1, dense(w.w1, w.b1, x, bf16=True).to(BF16).float(), rtol=1e-2, atol=1e-2)
    act = (lambda v: np.where(v > 0, v, np.float32(0))) if actor == "ddpg" else np.tanh
    h1_words = mma_layer(block[:n1], to_pairs(x, -(-F // 16)), H1, F, w.b1[:, 0].numpy(), act)
    h1 = from_pairs(h1_words, H1)
    twin1 = (relu if actor == "ddpg" else torch.tanh)(dense(w.w1, w.b1, x, bf16=True))
    # the twin's h1 rounded as the kernel stores it: within one bf16 step of the kernel's
    assert float((h1 - twin1.to(BF16).float()).abs().max()) <= 2.0 ** -7 * float(twin1.abs().max()) + 1e-6
    pre2 = from_pairs(mma_layer(block[n1:n1 + n2], h1_words, H2, H1, w.b2[:, 0].numpy(), ident), H2)
    want2 = dense(w.w2, w.b2, h1, bf16=True)  # the twin's sums of the same bf16 operands
    torch.testing.assert_close(pre2, want2.to(BF16).float(), rtol=1e-2, atol=1e-2)
    exact = torch.from_numpy((w.w2.double() @ h1.double() + w.b2.double()).numpy())
    torch.testing.assert_close(want2.double(), exact, rtol=1e-5, atol=1e-5)


def test_k6_shared_memory_check_raises_before_any_launch():
    """K6's block actor refuses, before any launch, a library whose shared
    memory (as ``ngk_k6_smem_floats`` reports it, f32 or bf16) and the traces
    exceed a block's, naming the bytes."""
    traces = kernel_traces(make_params(B8, torch.float32, "cpu"), CPU)
    room = MAX_SHARED_BYTES // 4 - trace_floats(B8, traces)
    for bf16 in (False, True):
        check_k6_block(B8, traces, SimpleNamespace(ngk_k6_smem_floats=lambda flag: room), (400, 300), bf16)
        over = SimpleNamespace(ngk_k6_smem_floats=lambda flag: room + 1 if flag == int(bf16) else 0)
        with pytest.raises(ValueError, match=f"{4 * (room + 1 + trace_floats(B8, traces))} bytes"):
            check_k6_block(B8, traces, over, (400, 300), bf16)


class _Recorder:
    """A stand-in for the kernel library and ``_build.launch``: the library
    reports the layout of ``_fake_library`` (and ``ngk_block_actor``), the
    launch records its name and operands instead of calling the card."""

    def __init__(self, w, block_actor, smem_floats=1024):
        fake = _fake_library(w, False)
        fake_bf16 = _fake_library(w, True)
        self.lib = SimpleNamespace(
            ngk_block_actor=lambda: int(block_actor),
            ngk_k6_pad=fake.ngk_k6_pad,
            ngk_k6_weights_size=lambda bf16: (fake_bf16 if bf16 else fake).ngk_k6_weights_size(bf16),
            ngk_k6_smem_floats=lambda bf16: smem_floats,
            ngk_k11b_smem_floats=lambda: smem_floats,
            ngk_gen_policy_day="ngk_gen_policy_day", ngk_gen_policy_multiday="ngk_gen_policy_multiday",
            ngk_policy_day_rollout="ngk_policy_day_rollout")
        self.calls = []

    def launch(self, name, fn, *args, device):
        self.calls.append((name, fn, args))


def _record_wrapper(monkeypatch, name, block_actor, smem_floats=1024, mlp_dtype=torch.float32):
    """Run K5 (``gen_policy_day``) or K6 (``gen_policy_multiday``) of shape
    ``name`` through its kernel path with the library and the launch
    replaced; returns the recorder and the actor's weights."""
    from smart_nanogrid_gym_torch.ops import _build, gen_policy_rollout as gpr

    config, actor, hidden = SHAPES[name]
    net = _net(config, actor, hidden, 4)
    w = actor_weights(config, net, CPU, actor, mlp_dtype)
    rec = _Recorder(w, block_actor, smem_floats)
    monkeypatch.setattr(gpr, "kernel_device", lambda t: True)
    monkeypatch.setattr(_build, "check_f32", lambda t, name: t)
    monkeypatch.setattr(_build, "load", lambda *a, **k: rec.lib)
    monkeypatch.setattr(_build, "launch", rec.launch)
    params = make_params(config, torch.float32, "cpu")
    return rec, w, config, params, net, actor


@pytest.mark.parametrize("name", ["ddpg-4ch-400x300", "ppo-8ch-256x256"])
def test_k5_block_library_packs_and_checks_through_k6_block(monkeypatch, name):
    """K5 in a block-design library (the DDPG actor, the 256x256 PPO torso)
    hands the kernel the f32 block of ``k6_block`` (the ring layout with the
    library's tile pads), under the ``_ddpg`` or ``_block`` launch name; a
    library whose K6 shared memory and traces exceed a block's raises from
    ``check_k6_block`` before any launch."""
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_day

    rec, w, config, params, net, actor = _record_wrapper(monkeypatch, name, block_actor=True)
    T, N, B = config.steps_per_day, config.num_chargers, 5
    u = torch.rand((T, 5, N, B), generator=torch.Generator().manual_seed(1))
    pv = torch.full((B,), 0.7)
    gen_policy_day(config, params, net, u, pv, actor=actor)
    (label, fn, args), = rec.calls
    assert label == "gen_policy_day" + ("_ddpg" if actor == "ddpg" else "_block") and fn == "ngk_gen_policy_day"
    block = args[9]
    assert torch.equal(block, k6_block(w, rec.lib, False))
    assert not torch.equal(block, w.packed())  # not K1/K2's layout
    traces = kernel_traces(params, CPU)
    over = MAX_SHARED_BYTES // 4 - trace_floats(config, traces) + 1
    rec, *_ = _record_wrapper(monkeypatch, name, block_actor=True, smem_floats=over)
    with pytest.raises(ValueError, match="block actor of gen_policy_multiday and gen_policy_day"):
        gen_policy_day(config, params, net, u, pv, actor=actor)
    assert not rec.calls


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k6_packs_the_64x64_torso_for_its_block_kernel(monkeypatch, bf16):
    """K6 with the 64x64 PPO torso (``ngk_block_actor`` 0) packs through
    ``k6_block`` (f32 ring layout or bf16 fragments) under the plain launch
    name, and so does K5 (f32: it has no bf16 option), whose launch gets the
    ring layout, not ``ActorWeights.packed``; a library whose K5 shared memory
    and traces exceed a block's is refused by ``check_k6_block``, naming
    ``gen_policy_day``, before any launch."""
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_day, gen_policy_multiday

    mm = BF16 if bf16 else torch.float32
    rec, w, config, params, net, actor = _record_wrapper(monkeypatch, "ppo-4ch-64x64", block_actor=False,
                                                         mlp_dtype=mm)
    gen_policy_multiday(config, params, net, 2, 3, 7, mlp_dtype=mm)
    (label, fn, args), = rec.calls
    assert label == "gen_policy_multiday" + ("_bf16" if bf16 else "") and fn == "ngk_gen_policy_multiday"
    assert torch.equal(args[8], k6_block(w, rec.lib, bf16)) and args[-1] == int(bf16)
    T, N = config.steps_per_day, config.num_chargers
    u, pv = torch.rand((T, 5, N, 3), generator=torch.Generator().manual_seed(2)), torch.full((3,), 0.4)
    gen_policy_day(config, params, net, u, pv)
    label, fn, args = rec.calls[-1]
    w32 = actor_weights(config, net, CPU)
    assert (label, fn) == ("gen_policy_day", "ngk_gen_policy_day") and len(rec.calls) == 2
    assert torch.equal(args[9], k6_block(w32, rec.lib, False)) and not torch.equal(args[9], w32.packed())
    traces = kernel_traces(params, CPU)
    over = MAX_SHARED_BYTES // 4 - trace_floats(config, traces) + 1
    rec, *_ = _record_wrapper(monkeypatch, "ppo-4ch-64x64", block_actor=False, smem_floats=over, mlp_dtype=mm)
    with pytest.raises(ValueError, match="block actor of gen_policy_multiday and gen_policy_day"):
        gen_policy_day(config, params, net, u, pv)
    assert not rec.calls
