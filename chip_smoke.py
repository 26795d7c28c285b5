"""Drive the PyTorch port's evaluation, training and stateful-env paths and its CLIs once on a CUDA card.

Run from the root of the repository, on a machine with one NVIDIA card and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written kernels K1-K11 from ``smart_nanogrid_gym_torch/csrc``
with nvcc (one process per library, all at once), holds each against its
plain-PyTorch twin on the card, and drives six paths through their user
entry points, each with the launch counts set to 0 just before it and read
just after:

- evaluation (K5-K8): paired explicit-day evaluation, the RBC multiday bench
  run, ``evaluate_policy_at_scale`` with the committed PPO artifact;
- training (K1-K4): ``PPOLearner(collect_impl="kernel", sweep_impl="kernel")``
  for 50 updates at B=4096 on the 8-charger bench config (K2 + K3), two
  updates of the ``env`` minibatch scheme (K4), the trained stochastic policy
  on explicit days against the RBC (K1), and the trained actor scored by
  ``evaluate_policy_at_scale`` (K6);
- DDPG evaluation (K5/K6 ``actor="ddpg"``): the committed DDPG artifact on
  paired explicit days against the RBC, and ``evaluate_policy_at_scale(
  algorithm="ddpg")``;
- DDPG training (K9, K10): ``DDPGLearner(collect_impl="kernel",
  sweep_impl="kernel")`` for 50 updates at B=4096 on the bench config, the
  trained actor with zero noise on explicit days (K9 explicit), and a
  learning run on the artifact's 4-charger config scored by K6;
- the stateful env (K11a, K11b): card resets rolled by ``rbc_day_rollout``
  (the bench's reset + RBC day row, 50 days at B=4096 and one day at
  B=131,072), the PPO artifact's day from given states
  (``policy_day_rollout``), ``VectorSmartNanogridEnv`` at 4096 envs against
  K11a, and the gym adapter's day, its same-day JSON replay and
  ``predict_single_day`` on that day;
- the bf16 operand options and the bench's 256x256 actor (phases 24-28):
  each new kernel variant against its twin, the bench row
  ``pallas_gen_policy_multiday_256x256_{f32,bf16}`` through
  ``gen_policy_multiday`` (bf16 against f32 within 0.5 % of the mean day
  return; at 64x64 the std within 2 %) and the 64x64 row
  ``pallas_gen_policy_multiday`` (2,500 days), the 256x256 actor through K5 and
  K11b, the DDPG artifact through K6 in bf16, PPO training with
  ``update_matmul_dtype=torch.bfloat16`` (50 updates, K2 + K3 bf16, and two
  ``env``-scheme updates, K4 bf16) and DDPG training (30 updates, K9 + K10
  bf16), and each new row timed against its f32 counterpart;
- the CLIs through their ``main(argv)`` (phases 29-32, outputs under
  ``build/chip_smoke_cli/``): ``train_ppo --impl kernel --guard`` at B=4096
  (K2 + K3 once per update, no recovery, 2 epochs + ``--resume`` to 3
  ``torch.equal`` to the straight run, the CLI's env-steps/s with and without
  the guard), ``train_ddpg --impl kernel`` (K9 seeded + K10), ``evaluate
  --models-root --at-scale 20`` over those runs (K6 once per checkpoint) and
  with the PPO artifact (its at-scale figure equal to a direct
  ``evaluate_policy_at_scale`` call, its same-day mean above the RBC's),
  ``predict --with-rbc`` with the artifact (28-key JSON) and ``visualize``
  (the PNGs only where matplotlib is installed; the HTML explorer always).

It checks the launch counts (each training sweep, K3, K4 and K10, is one
cooperative launch per update), the statistics of the in-kernel draws
against the plain engine, that training raises the mean day return, and
times each kernel against its twin and its bound; the f32 kernels must equal
their twins, the bf16 sweeps, whose products run on the tensor cores, must
meet the tolerance of ``tensor_core_close``, and K6's bf16 block actor (also
on the tensor cores, every torso) that of ``k6_bf16_close``; K7 on its ring
block, the collection kernels K1, K2 and K9, K6's f32 block actor (the 64x64
torso too), K5's (every torso, v2x included) and K11b's (both torsos, a
fresh and a continued state) are held to ``torch.equal`` at B=4096 or 1024
(phases 2, 3, 4, 8, 13, 14, 21 and 24).  Beside K10 it times the 28
products of its update as ``torch.matmul`` calls (cuBLAS, f32 with TF32 off
and bf16), beside K3 and K4 the 16 of theirs, beside K1, K2 and K9 the
products of a collection day, and beside the block-actor rows of K5, K6 and
K11b the actor's products of their days the same way: yardsticks of the
products only, which the port never calls.  Any failure raises and exits
non-zero.  The last lines are the card
(``nvidia-smi`` name and power limit), one JSON object with the kernels (for
the rows phase 28 profiles, the CUDA kernel instances the profiler saw and
their device time; for K5, K7, K8, K11a and K11b their layout and
ptxas's registers and spills), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT_NPZ = os.path.join(ROOT, "artifacts", "PPO-b-pv-bounded-sparse-4ch-1h", "108134400.npz")
DDPG_ARTIFACT_NPZ = os.path.join(ROOT, "artifacts", "DDPG-b-pv-bounded-sparse-4ch-1h", "49152000.npz")
DAY_SOURCE = "smart_nanogrid_gym_torch/csrc/day_step.cuh"
SWEEP_SOURCE = "smart_nanogrid_gym_torch/csrc/ppo_sweep.cuh"
DDPG_SWEEP_SOURCE = "smart_nanogrid_gym_torch/csrc/ddpg_sweep.cuh"
REPLACES = {
    "gen_rbc_day": "smart_nanogrid_gym_tpu/ops/pallas_gen_rollout.py:511",
    "gen_rbc_multiday": "smart_nanogrid_gym_tpu/ops/pallas_gen_rollout.py:580",
    "gen_policy_day": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:439",
    "gen_policy_multiday": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:522",
}
TRAIN_REPLACES = {
    "ppo_collect_day": "smart_nanogrid_gym_tpu/ops/pallas_collect.py:497",
    "ppo_collect_day_seeded": "smart_nanogrid_gym_tpu/ops/pallas_collect.py:535",
    "ppo_sweep_streamed": "smart_nanogrid_gym_tpu/ops/pallas_ppo_sweep.py:473",
    "ppo_sweep": "smart_nanogrid_gym_tpu/ops/pallas_ppo_sweep.py:375",
}
DDPG_REPLACES = {
    "gen_policy_day_ddpg": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:439",
    "gen_policy_multiday_ddpg": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:522",
}
TABLES_REPLACES = {
    "rbc_day_rollout": "smart_nanogrid_gym_tpu/ops/pallas_rollout.py:144",
    "policy_day_rollout": "smart_nanogrid_gym_tpu/ops/pallas_policy_rollout.py:186",
}
DDPG_TRAIN_REPLACES = {
    "ddpg_collect_day": "smart_nanogrid_gym_tpu/ops/pallas_collect.py:424",
    "ddpg_collect_day_seeded": "smart_nanogrid_gym_tpu/ops/pallas_collect.py:461",
    "ddpg_sweep": "smart_nanogrid_gym_tpu/ops/pallas_ddpg_sweep.py:235",
}
# the bf16 variants and the 256x256 torso's block-level actor (phases 24-28)
BIG_REPLACES = {
    "gen_policy_day_block": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:439",
    "gen_policy_multiday_block": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:522",
    "gen_policy_multiday_block_bf16": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:522",
    "gen_policy_multiday_bf16": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:522",
    "gen_policy_multiday_ddpg_bf16": "smart_nanogrid_gym_tpu/ops/pallas_gen_policy_rollout.py:522",
    "policy_day_rollout_block": "smart_nanogrid_gym_tpu/ops/pallas_policy_rollout.py:186",
}
BF16_TRAIN_REPLACES = {
    "ppo_sweep_streamed_bf16": "smart_nanogrid_gym_tpu/ops/pallas_ppo_sweep.py:473",
    "ppo_sweep_bf16": "smart_nanogrid_gym_tpu/ops/pallas_ppo_sweep.py:375",
}
BF16_DDPG_REPLACES = {"ddpg_sweep_bf16": "smart_nanogrid_gym_tpu/ops/pallas_ddpg_sweep.py:235"}
BENCH_BATCH = 4096
K11B_KERNEL = "policy_day_rollout_tables_kernel"  # K11b's instances on the block-actor template, every torso
TRAIN_UPDATES = 50
DDPG_LEARN_UPDATES = 150  # the 4-charger learning run, scored against its initial actor
DDPG_HIDDEN = (400, 300)
RESET_DAYS = 50  # the bench's card reset + RBC day row
FULL_BATCH = 131_072  # a batch that fills the card
BIG_HIDDEN = (256, 256)  # the bench row's actor (bench.py:403-414)
BIG_ROW_DAYS = 1000  # the bench row's days
SMALL_ROW_DAYS = 2500  # the bench row pallas_gen_policy_multiday (bench.py:394-401): 64x64, 8ch
ROW_SECONDS = 5.0  # a bench row that would take longer on its first run runs fewer days
BF16_TRAIN_UPDATES = 30  # the bf16 DDPG training run
CLI_UPDATES = 5  # updates an epoch of phase 29's train_ppo runs
# days of the new K6 rows where phase 24 times them against their twins
NEW_ROW_DAYS = {"gen_policy_multiday_bf16": 4, "gen_policy_multiday_block": 2, "gen_policy_multiday_block_bf16": 2,
                "gen_policy_multiday_ddpg_bf16": 2}
BF16 = torch.bfloat16
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s, float32 operations/s outside the tensor cores, dense bf16 tensor-core
# operations/s (the least time a bf16 row's products could take), and the SMs'
# clocks a second behind the float32 rate: 128 FMA lanes a clock an SM, an FMA
# counted as two operations
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
SM_CLOCKS_PER_S = F32_OPS_PER_S / (2 * 128)
# an SM's lanes a clock: each pipe's, and the four schedulers' issue (a warp
# instruction each a clock); the FMA pipe's two halves take 64 lanes each, and
# IMAD runs on one of them only
PIPE_LANES, ISSUE_LANES = 64, 128
# SASS opcodes (before the first '.') by pipe; vector instructions of other
# opcodes count toward the issue only, uniform-datapath ones (U...) not at all
FMA_OPCODES = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD"}
ALU_OPCODES = {"LOP3", "LOP", "IADD3", "IADD", "SHF", "SHL", "SHR", "ISETP", "SEL", "LEA", "PRMT", "MOV", "IMNMX",
               "VIMNMX", "IABS", "FSEL", "FSETP", "FMNMX", "PLOP3", "P2R", "R2P", "BMSK", "SGXT"}


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(name: str, got, want, rtol: float, atol: float, against: str = "twin") -> float:
    """Kernel against its twin (or ``against`` another reference), element
    for element; returns the max abs error."""
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")
        err = max(err, float((g - w).abs().max()))
    print(f"{name}: kernel vs {against} max_abs_err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def check_equal(name: str, got, want, names) -> float:
    """Every output bit-equal to the twin's (the f32 kernels sum in their
    twins' order, with no FMA); returns the max abs difference, 0."""
    err = 0.0
    for label, g, w in zip(names, got, want):
        check(g.shape == w.shape, f"{name} {label}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, float((g - w).abs().max()))
        check(torch.equal(g, w), f"{name} {label}: not bit-equal to the twin (max |d| {err:.3e})")
    print(f"{name}: every output bit-equal to the twin ({', '.join(names)})")
    return err


def tensor_core_close(name: str, got, want, ref, n_params: int, param_bound: float) -> float:
    """A tensor-core sweep row (its outputs: ``n_params`` parameter leaves,
    the moment leaves, the metrics) against its bf16 twin, under
    tests/torch_parity.py's ``assert_bf16_close`` contract with ``ref`` the f32
    kernel's result on the same inputs: at least 99 % of the entries as close
    to the twin as ``ref`` is (rtol 1e-4, atol 1e-6), parameters within
    ``param_bound`` (4·G·lr) and moments within 1e-2 of the twin, the summed
    distance below half of ``ref``'s, the metrics at rtol 1e-2 / atol 1e-4.
    The tensor cores sum in their own order, so a bit-equal twin is not the
    bar here.  Returns the max abs error."""
    err = 0.0
    for label, sl, bound in (("params", slice(0, n_params), param_bound), ("moments", slice(n_params, -1), 1e-2)):
        g, w, f = (torch.cat([x.double().reshape(-1) for x in xs[sl]]) for xs in (got, want, ref))
        share = float(((g - w).abs() <= (f - w).abs() + 1e-6 + 1e-4 * w.abs()).double().mean())
        worst, d_tc, d_f32 = float((g - w).abs().max()), float((g - w).abs().sum()), float((f - w).abs().sum())
        print(f"{name} {label}: {share:.5f} of entries as close as f32 (limit 0.99), max |d| {worst:.3e} "
              f"(limit {bound:.1e}), summed |d| {d_tc:.4e} against f32's {d_f32:.4e} (limit half)")
        check(share >= 0.99 and worst <= bound and d_tc < 0.5 * d_f32, f"{name} {label}: outside the bf16 contract")
        err = max(err, worst)
    torch.testing.assert_close(got[-1], want[-1], rtol=1e-2, atol=1e-4, msg=lambda m: f"{name} metrics: {m}")
    return max(err, float((got[-1] - want[-1]).abs().max()))


def k6_bf16_close(name: str, got, want, f32) -> float:
    """K6's bf16 block actor (its hidden layers on the tensor cores) against
    its bf16 twin, ``f32`` the f32 kernel's stats on the same days: for at
    least 99 % of the envs the Σ day return and the final battery are as
    close to the twin's as the f32 kernel's are (rtol 1e-4, atol 1e-6), and
    the mean day return lies within 0.5 % of the twin's (tests/torch_parity.py
    ``k6_bf16_close``).  Returns the max abs error."""
    g, w, f = (x.double() for x in (got, want, f32))
    check(g.shape == w.shape and bool(torch.isfinite(g).all()), f"{name}: shape or non-finite output")
    shares = [float(((g[r] - w[r]).abs() <= (f[r] - w[r]).abs() + 1e-6 + 1e-4 * w[r].abs()).double().mean())
              for r in (0, 2)]
    rel = abs(float(g[0].sum() - w[0].sum())) / abs(float(w[0].sum()))
    err = float((g - w).abs().max())
    print(f"{name}: {shares[0]:.5f} of envs' returns and {shares[1]:.5f} of their batteries as close to the twin "
          f"as f32 (limit 0.99), mean day return off by {rel:.3e} (limit 0.005), max |d| {err:.3e} "
          f"(f32 kernel against the bf16 twin {float((f - w).abs().max()):.3e})")
    check(min(shares) >= 0.99 and rel < 0.005, f"{name}: outside K6's bf16 contract")
    return err


def k6_products_ms(config, hidden: tuple[int, int], days: int, dtype) -> float:
    """The yardstick beside the block-actor rows of K5 and K6: the actor's three products
    for each of the days x T steps at B=4096, one ``torch.matmul`` (cuBLAS,
    f32 with TF32 off, or bf16) each, by CUDA events.  It covers the products
    only (no bias, activation, head, draws or physics, and none of the
    kernel's fusion); the port never calls it."""
    F, A, T = config.obs_dim, config.num_actions, config.steps_per_day
    gen = torch.Generator(device="cuda").manual_seed(37)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    x, h1, h2 = r(BENCH_BATCH, F), r(BENCH_BATCH, hidden[0]), r(BENCH_BATCH, hidden[1])
    w1, w2, w3 = r(F, hidden[0]), r(hidden[0], hidden[1]), r(hidden[1], A)

    def run():
        for _ in range(days * T):
            torch.matmul(x, w1)
            torch.matmul(h1, w2)
            torch.matmul(h2, w3)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_ms(run, 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def k10_products_ms(args, dtype) -> float:
    """The yardstick beside K10: the 28 products of each of the G gradient
    steps of one update at their shapes, one ``torch.matmul`` (cuBLAS) each,
    f32 with TF32 off or bf16, by CUDA events.  It covers the products only
    (no bias, activation, mask, Adam or polyak, and none of the kernel's
    fusion); the port never calls it."""
    actor, b_obs, b_act = args[0], args[6], args[7]
    G, M, F = b_obs.shape
    A, H1, H2 = b_act.shape[2], actor[0].shape[0], actor[2].shape[0]
    gen = torch.Generator(device=b_obs.device).manual_seed(29)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=b_obs.device).to(dtype)

    x, xa, h1, h2, g1, g2, gq, gu = r(M, F), r(M, F + A), r(M, H1), r(M, H2), r(M, H1), r(M, H2), r(M, 1), r(M, A)
    aw1, aw2, aw3, cw1, cw2, cw3 = r(H1, F), r(H2, H1), r(A, H2), r(H1, F + A), r(H2, H1), r(1, H2)
    products = (
        # the target actor and the target critic
        (x, aw1.T), (h1, aw2.T), (h2, aw3.T), (xa, cw1.T), (h1, cw2.T), (h2, cw3.T),
        # the critic's forward and backward
        (xa, cw1.T), (h1, cw2.T), (h2, cw3.T), (gq.T, h2), (gq, cw3), (g2.T, h1), (g2, cw2), (g1.T, xa),
        # the actor's forward, the critic on mu(s), dQ/da, the actor's backward
        (x, aw1.T), (h1, aw2.T), (h2, aw3.T), (xa, cw1.T), (h1, cw2.T), (h2, cw3.T), (gq, cw3), (g2, cw2),
        (g1, cw1[:, F:]), (gu.T, h2), (gu, aw3), (g2.T, h1), (g2, aw2), (g1.T, x),
    )
    check(len(products) == 28, "K10 has 28 products a step")

    def update():
        for _ in range(G):
            for a, b in products:
                torch.matmul(a, b)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_ms(update, 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def ppo_products_ms(gathered, hidden: tuple[int, int], dtype) -> float:
    """The yardstick beside K3 and K4: the 16 products of each of the G
    gradient steps of one update on its M samples, one ``torch.matmul``
    (cuBLAS, f32 with TF32 off or bf16) each, by CUDA events: the actor's
    and the critic's forward (3 each) and backward (3 weight gradients and 2
    input gradients each).  It covers the products only (no bias,
    activation, loss, norm clip or Adam, and none of the kernel's fusion);
    the port never calls it."""
    obs, act = gathered[0], gathered[1]
    G, M, F = obs.shape
    A, (H1, H2) = act.shape[2], hidden
    gen = torch.Generator(device=obs.device).manual_seed(33)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=obs.device).to(dtype)

    x, h1, h2, g1, g2, gu, gv = r(M, F), r(M, H1), r(M, H2), r(M, H1), r(M, H2), r(M, A), r(M, 1)
    pw1, pw2, pw3, vw1, vw2, vw3 = r(H1, F), r(H2, H1), r(A, H2), r(H1, F), r(H2, H1), r(1, H2)
    products = (
        (x, pw1.T), (h1, pw2.T), (h2, pw3.T), (x, vw1.T), (h1, vw2.T), (h2, vw3.T),
        (gu.T, h2), (gu, pw3), (g2.T, h1), (g2, pw2), (g1.T, x),
        (gv.T, h2), (gv, vw3), (g2.T, h1), (g2, vw2), (g1.T, x),
    )

    def update():
        for _ in range(G):
            for a, b in products:
                torch.matmul(a, b)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_ms(update, 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def collect_products_ms(config, hidden: tuple[int, int], critic: bool, device) -> float:
    """The yardstick beside K1, K2 and K9 (both): the products of a collection
    day at B=4096, one ``torch.matmul`` (cuBLAS, f32 with TF32 off) per layer
    and step: the actor's three layers (and with ``critic`` the value
    torso's three) for each of the T steps, by CUDA events.  It covers the
    products only (no bias, activation, head, draws, physics or writes, and
    none of the kernel's fusion); the port never calls it."""
    F, A, T = config.obs_dim, config.num_actions, config.steps_per_day
    H1, H2 = hidden
    gen = torch.Generator(device=device).manual_seed(31)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x, h1, h2 = r(BENCH_BATCH, F), r(BENCH_BATCH, H1), r(BENCH_BATCH, H2)
    torsos = [(r(F, H1), r(H1, H2), r(H2, A))] + ([(r(F, H1), r(H1, H2), r(H2, 1))] if critic else [])

    def day():
        for _ in range(T):
            for w1, w2, w3 in torsos:
                torch.matmul(x, w1)
                torch.matmul(h1, w2)
                torch.matmul(h2, w3)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_ms(day, 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def shifted_actor(config, seed: int, device):
    """A fresh PPO actor-critic with the action-mean biases pushed off the 0
    branch boundaries (tests/test_pallas.py:115-127): 0.5 per charger, or
    0.5/-0.4 alternating with v2x, and -0.3 for the battery."""
    from smart_nanogrid_gym_torch.solvers.networks import ActorCritic

    torch.manual_seed(seed)
    net = ActorCritic(config.obs_dim, config.num_actions)
    bias = [0.5 if n % 2 == 0 or not config.vehicle_to_everything else -0.4 for n in range(config.num_chargers)]
    with torch.no_grad():
        net.pi.Dense_2.bias.copy_(torch.tensor(bias + [-0.3] if config.battery_system else bias))
    return net.to(device)


def without_parameters(key: str) -> str:
    """A profiler key (a demangled kernel) without its return type and
    parameter list: the template instance."""
    depth = 0
    for i in range(len(key) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(key[i], 0)
        if depth == 0:
            key = key[:i] if i < len(key) - 1 else key
            break
    return key.removeprefix("void ")


def profile_kernels(fn, kernel: str | tuple, repeats: int, required: bool = True) -> tuple[float, str | None]:
    """Mean device milliseconds per call of the kernels whose name holds
    ``kernel`` (or one of the names in a tuple), by ``torch.profiler`` over
    ``repeats`` calls after a warm-up, and the instances the profiler saw;
    NaN and None when it records none and the number is not ``required``.
    The profiler can miss a launch's record (9 of 10 recorded on the H100),
    so the time is the mean over the launches it recorded, times the
    launches a call makes."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if any(k in e.key for k in names)]
    total_us, launches = sum(e.self_device_time_total for e in events), sum(e.count for e in events)
    if total_us <= 0 and not required:
        return float("nan"), None
    check(total_us > 0 and launches > 0, f"the profiler recorded no device time for {kernel}")
    per_call = max(1, round(launches / repeats))
    return total_us / launches * per_call / 1e3, "; ".join(sorted({without_parameters(e.key) for e in events}))


def device_ms(fn, kernel: str | tuple, repeats: int, required: bool = True) -> float:
    """The device milliseconds of :func:`profile_kernels`."""
    return profile_kernels(fn, kernel, repeats, required)[0]


def once_ms(fn):
    """Milliseconds of one call of a plain twin on the card (CUDA events) and
    its output.  No warm-up call: the twins are eager PyTorch taking tens of
    milliseconds to seconds, which a first call's allocations do not move."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def explicit_inputs(config, batch: int, seed: int, device):
    rng = np.random.default_rng(seed)
    u = rng.random((config.steps_per_day, 5, config.num_chargers, batch)).astype(np.float32)
    pv = (rng.integers(0, 181, batch) / 100.0).astype(np.float32)
    return torch.from_numpy(u).to(device), torch.from_numpy(pv).to(device)


def stats_match(label, kernel_fn, oracle_fn, n_kernel, n_oracle, attempts=3):
    """Day-return mean/std of a multiday kernel against the plain engine:
    z=6 bounds of the sampling error, floored at 1 % (mean) and 3 % (std),
    median of up to 3 fresh draws of both sides (tests/test_tpu_kernels.py)."""
    k_draws, o_draws = [], []
    for attempt in range(attempts):
        k_draws.append(kernel_fn(attempt))
        o_draws.append(oracle_fn(attempt))
        mean_k, std_k = (float(np.median(v)) for v in zip(*k_draws))
        mean_o, std_o = (float(np.median(v)) for v in zip(*o_draws))
        se_mean = std_o * math.sqrt(1.0 / n_kernel + 1.0 / n_oracle)
        se_std = std_o * math.sqrt(0.5 / n_kernel + 0.5 / n_oracle)
        mean_tol = max(6.0 * se_mean, 0.01 * abs(mean_o))
        std_tol = max(6.0 * se_std, 0.03 * std_o)
        line = (f"{label}: kernel mean {mean_k:.4f} std {std_k:.4f} | plain engine mean "
                f"{mean_o:.4f} std {std_o:.4f} | tol {mean_tol:.4f}/{std_tol:.4f} "
                f"(draw {attempt + 1})")
        print(line)
        if abs(mean_k - mean_o) < mean_tol and abs(std_k - std_o) < std_tol:
            return
    raise RuntimeError(f"{label}: statistics disagree after {attempts} draws: {line}")


def mean_std(stats: torch.Tensor, n: int) -> tuple[float, float]:
    s = stats.double()
    mean = float(s[0].sum()) / n
    return mean, math.sqrt(max(float(s[1].sum()) / n - mean * mean, 0.0))


def sm_ms(n_ops: float, philox_blocks: float = 0.0, pipes: dict | None = None) -> float:
    """The least time in ms the SMs' pipes take for ``n_ops`` f32 operations
    (FMAs on both halves of the FMA pipe) and ``philox_blocks`` Philox
    blocks of ``pipes`` lane instructions each by pipe
    (:func:`philox_pipes`): the busiest of the FMA pipe, its IMAD half, the
    integer ALU and the issue."""
    pipes = pipes or {"fma": 0, "alu": 0, "issue": 0}
    ffma = n_ops / 2
    fma, alu, issue = (philox_blocks * pipes[k] for k in ("fma", "alu", "issue"))
    clocks = max((ffma + fma) / ISSUE_LANES, fma / PIPE_LANES, alu / PIPE_LANES, (ffma + issue) / ISSUE_LANES)
    return clocks / SM_CLOCKS_PER_S * 1e3


def bound(n_bytes: float, n_ops: float, bf16_ops: float = 0.0, philox_blocks: float = 0.0,
          pipes: dict | None = None) -> tuple[float, str]:
    """The least time in ms for moving ``n_bytes``, doing ``n_ops`` f32
    operations and ``philox_blocks`` Philox blocks on the SMs' pipes
    (:func:`sm_ms`), and ``bf16_ops`` products of bf16 operands on the
    tensor cores, and which of the two bounds it: the operations' time is the
    longer of the SM pipes' and the tensor cores', which run side by side."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(sm_ms(n_ops, philox_blocks, pipes), bf16_ops / BF16_OPS_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_line(library, instance: str) -> str:
    """ptxas's registers, shared memory and spills of the kernel template
    ``instance`` (as the profiler names it), from the library's build log,
    its entry names demangled by ``c++filt`` as the profiler demangles them."""
    with open(library.with_suffix(".log")) as fp:
        lines = fp.read().splitlines()
    entries = [i for i, line in enumerate(lines) if "Compiling entry function" in line]
    names = subprocess.run(["c++filt"], input="\n".join(lines[i].split("'")[1] for i in entries),
                           capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()
    squeeze = lambda name: "".join(without_parameters(name).split())  # noqa: E731
    # a bare template name (no profiler record) matches the library's one instance of it
    same = ((lambda name: squeeze(name).startswith(f"ngk::{instance}<")) if "<" not in instance
            else (lambda name: squeeze(name) == squeeze(instance)))
    for i, name in zip(entries, names):
        if same(name):
            return "; ".join(x.split("ptxas info    :")[-1].strip() for x in lines[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
    near = [name for name in names if instance.split("<")[0] in name]
    raise RuntimeError(f"no ptxas entry for {instance} in {library.with_suffix('.log')}; entries of that "
                       f"kernel: {near}")


def philox_pipes(library) -> tuple[dict, dict]:
    """One Philox4x32-10 block's lane instructions in ``library`` (a
    day-kernel library) by pipe: ``fma`` (IMAD and the like), ``alu``
    (LOP3, IADD3, ...) and ``issue`` (every vector instruction), from its
    probe kernel's SASS (``cuobjdump -sass``) less that of the probe without
    the block.  NOPs and the uniform datapath's instructions are left out:
    the probe's key is a kernel argument, so its schedule is uniform, as the
    kernels could hoist it (an env's key is fixed for all its blocks).  Also
    the opcodes counted, by pipe."""
    from smart_nanogrid_gym_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    probes = ("ngk_philox_probe_kernel", "ngk_philox_probe_base_kernel")
    out = subprocess.run([tool, "-sass", "-fun", ",".join(probes), str(library)], capture_output=True, text=True,
                         check=True, timeout=300)
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = collections.Counter()
        elif name and line.strip().startswith("/*") and "*/" in line:
            tokens = line.split("*/", 1)[1].split(";")[0].split()
            if tokens and not tokens[0].startswith("/*"):
                counts[name][tokens[1 if tokens[0].startswith("@") else 0]] += 1
    diff = counts[probes[0]]
    diff.subtract(counts[probes[1]])
    opcodes = {"fma": {}, "alu": {}, "other": {}, "uniform": {}}
    for op, n in diff.items():
        base = op.split(".")[0]
        if n == 0 or base == "NOP":
            continue
        kind = ("fma" if base in FMA_OPCODES else "alu" if base in ALU_OPCODES
                else "uniform" if base.startswith("U") else "other")
        opcodes[kind][op] = n
    fma, alu, other = (sum(opcodes[k].values()) for k in ("fma", "alu", "other"))
    return {"fma": fma, "alu": alu, "issue": fma + alu + other}, opcodes


def mlp_flops(F: int, A: int, H1: int, H2: int) -> int:
    """Multiply-adds (2 operations each) of a 2-hidden-layer torso's forward."""
    return 2 * (H1 * F + H2 * H1 + A * H2)


def philox_calls_per_day(config) -> int:
    """Philox blocks one env-day of generation draws: arrival and SoC
    always, capacity and requested SoC when configured, departure on the
    steps whose window is open, plus the PV-shift draw."""
    T, N = config.steps_per_day, config.num_chargers
    k4, k10, k1 = int(4 / config.time_interval), int(10 / config.time_interval), int(1 / config.time_interval)
    kinds = 2 + int(config.different_battery_capacities) + int(config.requested_state_of_charge)
    dep_steps = sum(1 for t in range(T) if t + k4 < min(t + k10, T + k1))
    return ((N + 3) // 4) * (kinds * T + dep_steps) + 1


def collect_twin_checks(cfg, params, leaves, u, pv, device, errors):
    """Phase 8: K1 and K2 element for element against their twins at full
    width (B=4096); returns the explicit normals and batteries used."""
    from smart_nanogrid_gym_torch.ops.collect import (
        collect_weights, ppo_collect_day, ppo_collect_day_plain, ppo_collect_day_seeded,
        ppo_collect_day_seeded_plain)
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces

    gen = torch.Generator(device=device).manual_seed(8)
    normals = torch.randn((cfg.steps_per_day, cfg.num_actions, BENCH_BATCH), generator=gen, device=device)
    batt = torch.rand(BENCH_BATCH, generator=gen, device=device)
    traces, weights = kernel_traces(params, device), collect_weights(cfg, leaves, device)
    names = ("obs", "act_raw", "logp", "value", "rewards", "batt")
    for name, got, want in (
            ("K1 ppo_collect_day", ppo_collect_day(cfg, params, leaves, u, normals, pv, batt),
             ppo_collect_day_plain(cfg, traces, weights, u, normals, pv, batt)),
            ("K2 ppo_collect_day_seeded", ppo_collect_day_seeded(cfg, params, leaves, 2024, batt, BENCH_BATCH),
             ppo_collect_day_seeded_plain(cfg, traces, weights, 2024, batt, BENCH_BATCH))):
        print(f"phase 8 {name} (8ch b-pv, B={BENCH_BATCH}, 64x64) max |d| per output: "
              + ", ".join(f"{n} {float((g - w).abs().max()):.3e}" for n, g, w in zip(names, got, want)))
        key = "ppo_collect_day" if name.startswith("K1") else "ppo_collect_day_seeded"
        errors[key] = compare(f"phase 8 {name}", got, want, rtol=2e-4, atol=2e-4)
        check_equal(f"phase 8 {name}", got, want, names)
    return normals, batt


def k2_statistics(cfg, params, leaves, device):
    """Phase 9: K2's day returns against the plain engine with the same
    stochastic actor (z=6, median of 3 draws), and K2's action noise
    recovered as (a_raw - mean) / std against N(0, 1)."""
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch
    from smart_nanogrid_gym_torch.ops.collect import ppo_collect_day_seeded
    from smart_nanogrid_gym_torch.solvers.ppo import apply_actor_critic

    days = 4
    batt = torch.full((BENCH_BATCH,), 0.5, device=device)
    low, high = (torch.as_tensor(b, device=device) for b in cfg.action_bounds())
    env = SmartNanogridTorch(cfg)

    def k2_draw(attempt):
        rets = [ppo_collect_day_seeded(cfg, params, leaves, 7000 + 10 * attempt + d, batt, BENCH_BATCH)[4]
                .sum(0).double() for d in range(days)]
        r = torch.cat(rets)
        return float(r.mean()), float(r.std(unbiased=False))

    def plain_draw(attempt):
        gen = torch.Generator(device=device).manual_seed(500 + attempt)

        def policy(ob):
            mean, log_std, _ = apply_actor_critic(leaves, ob)
            noise = torch.randn(mean.shape, generator=gen, device=device)
            return torch.clamp(mean + torch.exp(log_std) * noise, low, high)

        rets = []
        with torch.no_grad():
            for _ in range(days):
                state, obs = env.reset_batch(params, BENCH_BATCH, gen, batt_soc=batt)
                _, _, (_, rewards, _, _) = env.rollout_day(params, state, policy, obs, gen)
                rets.append(rewards.sum(0).double())
        r = torch.cat(rets)
        return float(r.mean()), float(r.std(unbiased=False))

    n = days * BENCH_BATCH
    stats_match("phase 9 K2 vs plain engine (fresh days, stochastic actor)", k2_draw, plain_draw, n, n)
    obs, act, *_ = ppo_collect_day_seeded(cfg, params, leaves, 99, batt, BENCH_BATCH)
    with torch.no_grad():
        mean, log_std, _ = apply_actor_critic(leaves, obs.permute(0, 2, 1))
        z = ((act.permute(0, 2, 1) - mean) / torch.exp(log_std)).double()
    m, sd, count = float(z.mean()), float(z.std()), z.numel()
    print(f"phase 9 K2 recovered normals: mean {m:.5f} std {sd:.5f} over {count} draws "
          f"(bounds {6 / math.sqrt(count):.5f}, {6 * math.sqrt(0.5 / count):.5f})")
    check(abs(m) < 6 / math.sqrt(count) and abs(sd - 1.0) < 6 * math.sqrt(0.5 / count),
          "K2's action noise is not standard normal")


def update_inputs(learner, cfg, params, state):
    """One update's sweep inputs from a K2 collection: the featlane
    trajectory with GAE, the block permutation, and the env scheme's
    gathered minibatches."""
    from smart_nanogrid_gym_torch.ops.collect import ppo_collect_day_seeded
    from smart_nanogrid_gym_torch.ops.ppo_sweep import normalise_centred

    B, T = BENCH_BATCH, cfg.steps_per_day
    num_mb, slab, n_bl = learner.kernel_layout(B)
    seed, perms = learner.draw_kernel(torch.Generator().manual_seed(4), n_bl)
    obs, act, logp, val, rew, _ = ppo_collect_day_seeded(cfg, params, state.params, seed, state.batt_soc, B)
    dones = torch.zeros((T, B), dtype=torch.bool, device=rew.device)
    dones[-1] = True
    adv, ret = learner._gae(rew, val, dones, torch.zeros(B, device=rew.device))
    E = learner.ppo.num_epochs
    G, M = E * num_mb, (B // num_mb) * T
    featlane = (obs, act, logp, adv, ret, perms.reshape(G, n_bl // num_mb), slab)
    env_perm = torch.stack([torch.randperm(B, generator=torch.Generator().manual_seed(e)) for e in range(E)])
    idx = env_perm.to(rew.device)
    env_major = (obs.permute(2, 0, 1), act.permute(2, 0, 1), logp.T, adv.T, ret.T)
    obs_g, act_g, logp_g, adv_g, ret_g = (x[idx].reshape((G, M) + x.shape[2:]).contiguous() for x in env_major)
    mean, std = normalise_centred(adv_g)
    gathered = (obs_g, act_g, logp_g, (adv_g - mean[:, None]) / (std[:, None] + 1e-8), ret_g)
    return featlane, gathered


def sweep_twin_checks(learner, featlane, gathered, state, errors):
    """Phase 10: K3 (featlane) and K4, one full update (G=40) at full
    width, against their twins; a K3 rerun is bit-identical."""
    from smart_nanogrid_gym_torch.ops.ppo_sweep import (
        ppo_sweep, ppo_sweep_plain, ppo_sweep_streamed, ppo_sweep_streamed_plain)

    hp = learner._hypers()
    *data, block_perm, slab = featlane

    def flat(out):
        params, adam, metrics = out
        return list(params) + list(adam.mu) + list(adam.nu) + [metrics]

    got = ppo_sweep_streamed(state.params, state.opt_state, *data, block_perm, slab, hp, data_layout="featlane")
    want = ppo_sweep_streamed_plain(state.params, state.opt_state, *data, block_perm, slab, hp, "featlane")
    errors["ppo_sweep_streamed"] = compare("phase 10 K3 ppo_sweep_streamed (featlane, G=40, B=4096)",
                                           flat(got), flat(want), rtol=1e-4, atol=1e-6)
    again = ppo_sweep_streamed(state.params, state.opt_state, *data, block_perm, slab, hp, data_layout="featlane")
    check(all(torch.equal(a, b) for a, b in zip(flat(got), flat(again))), "K3 rerun is not bit-identical")
    print("phase 10 K3 rerun: bit-identical (params, mu, nu, metrics)")
    got = ppo_sweep(state.params, state.opt_state, *gathered, hp)
    want = ppo_sweep_plain(state.params, state.opt_state, zip(*gathered), hp)
    errors["ppo_sweep"] = compare("phase 10 K4 ppo_sweep (env scheme, G=40, M=24576)",
                                  flat(got), flat(want), rtol=1e-4, atol=1e-6)


def training_main_path(cfg, params, u, pv, device, card):
    """Phase 11, the training path through the entry points a user calls,
    with the launch counts set to 0 before it and read after it."""
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.collect import ppo_collect_day
    from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_day
    from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policy_at_scale
    from smart_nanogrid_gym_torch.solvers.networks import actor_critic_from_leaves
    from smart_nanogrid_gym_torch.solvers.ppo import PPOConfig, PPOLearner

    learner = PPOLearner(cfg, PPOConfig(collect_impl="kernel", sweep_impl="kernel"), device=device)
    state = learner.init(0, params, BENCH_BATCH)
    initial_actor = actor_critic_from_leaves(state.params)
    train_many = learner.build_train_many(TRAIN_UPDATES)
    G = learner.ppo.num_epochs * learner.ppo.num_minibatches
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = train_many(state, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    print(f"phase 11 train: {TRAIN_UPDATES} updates x B={BENCH_BATCH} (G={G}) in {seconds:.4f} s = "
          f"{seconds / TRAIN_UPDATES * 1e3:.3f} ms/update on {card}; launches {counts}")
    check(counts == {"ppo_collect_day_seeded": TRAIN_UPDATES, "ppo_sweep_streamed": TRAIN_UPDATES},
          f"launch counts {counts} are not 1 collection + 1 sweep launch per update")
    returns = metrics.mean_return.double().cpu()
    check(bool(torch.isfinite(returns).all()), "non-finite mean return")
    first, last = float(returns[0]), float(returns[-5:].mean())
    print(f"phase 11 mean day return: first update {first:.4f}, mean of the last 5 {last:.4f}; "
          f"policy loss {float(metrics.policy_loss[-1]):.5f}, value loss {float(metrics.value_loss[-1]):.3f}, "
          f"approx KL {float(metrics.approx_kl[-1]):.6f}, entropy {float(metrics.entropy[-1]):.4f}")
    check(last > first, "training did not raise the mean day return")

    # the env minibatch scheme after a plain collection runs K4
    env_learner = PPOLearner(cfg, PPOConfig(sweep_impl="kernel", minibatch_scheme="env"), device=device)
    env_state, env_metrics = env_learner.build_train_many(2)(state._replace(update_step=0), params)
    check(bool(torch.isfinite(env_metrics.mean_return).all()), "env-scheme update: non-finite return")
    # the trained stochastic policy on explicit days against the RBC on the same days (K1, K7)
    gen = torch.Generator(device=device).manual_seed(11)
    normals = torch.randn((cfg.steps_per_day, cfg.num_actions, BENCH_BATCH), generator=gen, device=device)
    batt = torch.full((BENCH_BATCH,), 0.5, device=device)
    ppo_rewards = ppo_collect_day(cfg, params, state.params, u, normals, pv, batt)[4]
    rbc_rewards, _ = gen_rbc_day(cfg, params, u, pv)
    check(bool(torch.isfinite(ppo_rewards).all()), "K1: non-finite rewards")
    print(f"phase 11 paired explicit days (B={BENCH_BATCH}): trained stochastic policy "
          f"{float(ppo_rewards.sum(0).mean()):.4f}, rbc {float(rbc_rewards.sum(0).mean()):.4f}")
    # the trained actor scored at scale (K6)
    trained = evaluate_policy_at_scale(cfg, params, actor_critic_from_leaves(state.params), num_days=64,
                                       batch=BENCH_BATCH, seed=3)
    untrained = evaluate_policy_at_scale(cfg, params, initial_actor, num_days=64, batch=BENCH_BATCH, seed=3)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"phase 11 evaluate_policy_at_scale (K6, 64 days x {BENCH_BATCH}): trained "
          f"{trained['mean_day_return']:.4f}, initial {untrained['mean_day_return']:.4f}")
    check(math.isfinite(trained["mean_day_return"]), "K6 score of the trained actor is not finite")
    print(f"training path launches: {launches}")
    for name in TRAIN_REPLACES:
        check(launches.get(name, 0) >= 1, f"kernel {name} was not launched on the training path")
    return learner, state, launches


def tables_in_timings(rbc_cfg, rbc_params, art_cfg, art_params, artifact, device, card, times):
    """Phase 7, K11a and K11b: the kernel's device time (profiler) on tables
    already built, the twin's time on the same tables, the wrapper's (table
    build included) and the table build's (CUDA events); returns each
    kernel's device ms and the instance the profiler saw."""
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import actor_weights
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
    from smart_nanogrid_gym_torch.ops.policy_rollout import (
        launch_policy_day, policy_day_rollout, policy_day_rollout_plain)
    from smart_nanogrid_gym_torch.ops.rollout import (
        launch_rbc_day, rbc_day_rollout, rbc_day_rollout_plain, state_tables)

    rbc_state = given_states(rbc_cfg, rbc_params, 70, device)["fresh"]
    art_state = given_states(art_cfg, art_params, 71, device)["fresh"]
    rbc_traces, art_traces = kernel_traces(rbc_params, device), kernel_traces(art_params, device)
    weights = actor_weights(art_cfg, artifact, device)
    rbc_st, art_st = state_tables(rbc_cfg, rbc_params, rbc_state), state_tables(art_cfg, art_params, art_state)
    cases = {
        "rbc_day_rollout": (f"B={BENCH_BATCH}, 1 day, 8ch b-pv, given state", "rbc_day_rollout_kernel",
                            lambda: launch_rbc_day(rbc_cfg, rbc_traces, rbc_st),
                            lambda: rbc_day_rollout_plain(rbc_cfg, rbc_traces, rbc_st),
                            lambda: rbc_day_rollout(rbc_cfg, rbc_params, rbc_state),
                            lambda: state_tables(rbc_cfg, rbc_params, rbc_state)),
        "policy_day_rollout": (f"B={BENCH_BATCH}, 1 day, artifact 4ch b-pv, given state", K11B_KERNEL,
                               lambda: launch_policy_day(art_cfg, art_traces, weights, art_st, artifact.hidden),
                               lambda: policy_day_rollout_plain(art_cfg, art_traces, weights, art_st),
                               lambda: policy_day_rollout(art_cfg, art_params, art_state, artifact),
                               lambda: state_tables(art_cfg, art_params, art_state)),
    }
    seen = {}
    for name, (shape, kernel_name, kernel, plain, wrapper, tables) in cases.items():
        seen[name] = profile_kernels(kernel, kernel_name, 20)
        times[name] = (shape, seen[name][0], once_ms(plain)[0])
        print(f"phase 7 {name} ({shape}): kernel {times[name][1]:.4f} ms of device time, plain twin "
              f"{times[name][2]:.4f} ms, wrapper with the table build {cuda_ms(wrapper, 20):.4f} ms, table build "
              f"{cuda_ms(tables, 20):.4f} ms, launch alone {cuda_ms(kernel, 20):.4f} ms on {card}")
    return seen


def training_timings(learner, cfg, params, state, featlane, gathered, u, pv, normals, batt, card, times):
    """Phase 12: each training kernel and its twin at the main path's shape,
    and one update's phases (collection, GAE, sweep) by CUDA events."""
    from smart_nanogrid_gym_torch.ops.collect import (
        collect_weights, ppo_collect_day, ppo_collect_day_plain, ppo_collect_day_seeded,
        ppo_collect_day_seeded_plain)
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
    from smart_nanogrid_gym_torch.ops.ppo_sweep import (
        ppo_sweep, ppo_sweep_plain, ppo_sweep_streamed, ppo_sweep_streamed_plain)

    device = batt.device
    traces, weights = kernel_traces(params, device), collect_weights(cfg, state.params, device)
    hp = learner._hypers()
    *data, block_perm, slab = featlane
    p, o = state.params, state.opt_state
    cases = {
        "ppo_collect_day": (f"B={BENCH_BATCH}, 1 day, 8ch b-pv, 64x64",
                            lambda: ppo_collect_day(cfg, params, p, u, normals, pv, batt),
                            lambda: ppo_collect_day_plain(cfg, traces, weights, u, normals, pv, batt), 20),
        "ppo_collect_day_seeded": (f"B={BENCH_BATCH}, 1 day, 8ch b-pv, 64x64",
                                   lambda: ppo_collect_day_seeded(cfg, params, p, 5, batt, BENCH_BATCH),
                                   lambda: ppo_collect_day_seeded_plain(cfg, traces, weights, 5, batt,
                                                                        BENCH_BATCH), 20),
        "ppo_sweep_streamed": ("G=40 x M=24576, featlane, F=25 A=9 64x64",
                               lambda: ppo_sweep_streamed(p, o, *data, block_perm, slab, hp),
                               lambda: ppo_sweep_streamed_plain(p, o, *data, block_perm, slab, hp), 3),
        "ppo_sweep": ("G=40 x M=24576, gathered, F=25 A=9 64x64",
                      lambda: ppo_sweep(p, o, *gathered, hp),
                      lambda: ppo_sweep_plain(p, o, zip(*gathered), hp), 3),
    }
    for name, (shape, kernel, plain, repeats) in cases.items():
        times[name] = (shape, cuda_ms(kernel, repeats), once_ms(plain)[0])
        print(f"phase 12 {name} ({shape}): kernel {times[name][1]:.4f} ms, "
              f"plain twin {times[name][2]:.4f} ms on {card}")

    # one update's phases, as _kernel_step runs them
    num_mb, slab, n_bl = learner.kernel_layout(BENCH_BATCH)
    T = cfg.steps_per_day
    dones = torch.zeros((T, BENCH_BATCH), dtype=torch.bool, device=device)
    dones[-1] = True
    gen = torch.Generator().manual_seed(12)
    sums, reps = [0.0, 0.0, 0.0], 5
    for rep in range(reps + 1):
        seed, perms = learner.draw_kernel(gen, n_bl)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        obs, act, logp, val, rew, _ = ppo_collect_day_seeded(cfg, params, p, seed, state.batt_soc, BENCH_BATCH,
                                                             check_params=False)
        ev[1].record()
        adv, ret = learner._gae(rew, val, dones, torch.zeros(BENCH_BATCH, device=device))
        ev[2].record()
        ppo_sweep_streamed(p, o, obs, act, logp, adv, ret, perms.reshape(-1, n_bl // num_mb), slab, hp)
        ev[3].record()
        torch.cuda.synchronize()
        if rep > 0:  # the first pass warms up
            for i in range(3):
                sums[i] += ev[i].elapsed_time(ev[i + 1]) / reps
    print(f"phase 12 one update (B={BENCH_BATCH}, G=40): collection {sums[0]:.4f} ms, GAE {sums[1]:.4f} ms, "
          f"sweep {sums[2]:.4f} ms (CUDA events, mean of {reps}) on {card}")


def ddpg_twin_checks(art_cfg, art_params, ddpg_art, u4, pv4, cfg, params, u, pv, device, errors):
    """Phases 13-14: K5/K6 with the DDPG artifact and K9 (explicit, seeded)
    on the bench config with a fresh 400-300 actor, at full width, element
    for element against their twins.  Returns the K9 inputs and outputs."""
    from smart_nanogrid_gym_torch.ops.ddpg_collect import (
        ddpg_collect_day, ddpg_collect_day_plain, ddpg_collect_day_seeded, ddpg_collect_day_seeded_plain,
        ddpg_weights)
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
        actor_weights, gen_policy_day, gen_policy_day_plain, gen_policy_multiday, gen_policy_multiday_plain)
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
    from smart_nanogrid_gym_torch.solvers.ddpg import DDPGLearner

    art_traces = kernel_traces(art_params, device)
    w = actor_weights(art_cfg, ddpg_art, device, actor="ddpg")
    k5_got = gen_policy_day(art_cfg, art_params, ddpg_art, u4, pv4, actor="ddpg")
    k5_want = gen_policy_day_plain(art_cfg, art_traces, w, u4, pv4, torch.full_like(pv4, 0.5), actor="ddpg")
    errors["gen_policy_day_ddpg"] = compare("phase 13 K5 gen_policy_day actor=ddpg (DDPG artifact, 4ch, B=4096)",
                                            k5_got, k5_want, rtol=2e-4, atol=2e-4)
    check_equal("phase 13 K5 gen_policy_day actor=ddpg", k5_got, k5_want,
                ("rewards", "actions", "soc_final", "batt_final"))
    k6_got = (gen_policy_multiday(art_cfg, art_params, ddpg_art, 2, 12, BENCH_BATCH, actor="ddpg"),)
    k6_want = (gen_policy_multiday_plain(art_cfg, art_traces, w, 2, 12, BENCH_BATCH, actor="ddpg"),)
    errors["gen_policy_multiday_ddpg"] = compare(
        "phase 13 K6 gen_policy_multiday actor=ddpg (DDPG artifact, B=4096 x 2 days)", k6_got, k6_want,
        rtol=2e-4, atol=1e-2)
    check_equal("phase 13 K6 gen_policy_multiday actor=ddpg", k6_got, k6_want, ("stats",))

    learner = DDPGLearner(cfg, device=device)
    leaves = learner.init(7, params, BENCH_BATCH).actor
    gen = torch.Generator(device=device).manual_seed(9)
    ou = learner._ou_sequence(torch.randn((cfg.steps_per_day, cfg.num_actions, BENCH_BATCH), generator=gen,
                                          device=device))
    batt = torch.rand(BENCH_BATCH, generator=gen, device=device)
    traces, weights = kernel_traces(params, device), ddpg_weights(cfg, leaves, device)
    names = ("obs", "act", "rewards", "next_obs", "batt")
    explicit = ddpg_collect_day(cfg, params, leaves, u, ou, pv, batt)
    for key, got, want in (
            ("ddpg_collect_day", explicit, ddpg_collect_day_plain(cfg, traces, weights, u, ou, pv, batt)),
            ("ddpg_collect_day_seeded", ddpg_collect_day_seeded(cfg, params, leaves, 2025, ou, batt, BENCH_BATCH),
             ddpg_collect_day_seeded_plain(cfg, traces, weights, 2025, ou, batt, BENCH_BATCH))):
        print(f"phase 14 K9 {key} (8ch b-pv, B={BENCH_BATCH}, 400-300) max |d| per output: "
              + ", ".join(f"{n} {float((g - w).abs().max()):.3e}" for n, g, w in zip(names, got, want)))
        errors[key] = compare(f"phase 14 K9 {key}", got, want, rtol=2e-4, atol=2e-4)
        check_equal(f"phase 14 K9 {key}", got, want, names)
    return learner, leaves, ou, batt, explicit


def k9_statistics(cfg, params, learner, leaves, device):
    """Phase 15: K9 seeded's day returns against the plain engine with the
    same actor and OU noise process on fresh days (z=6, median of 3 draws)."""
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch, fused_day_rollout
    from smart_nanogrid_gym_torch.ops.ddpg_collect import ddpg_collect_day_seeded
    from smart_nanogrid_gym_torch.solvers.ddpg import actor_apply

    days, T, A = 4, cfg.steps_per_day, cfg.num_actions
    batt = torch.full((BENCH_BATCH,), 0.5, device=device)
    low, high = (torch.as_tensor(b, device=device) for b in cfg.action_bounds())
    env = SmartNanogridTorch(cfg)

    def summary(rets):
        r = torch.cat(rets)
        return float(r.mean()), float(r.std(unbiased=False))

    def k9_draw(attempt):
        gen = torch.Generator(device=device).manual_seed(600 + attempt)
        rets = []
        for d in range(days):
            ou = learner._ou_sequence(torch.randn((T, A, BENCH_BATCH), generator=gen, device=device))
            rew = ddpg_collect_day_seeded(cfg, params, leaves, 8000 + 10 * attempt + d, ou, batt, BENCH_BATCH)[2]
            rets.append(rew.sum(0).double())
        return summary(rets)

    def plain_draw(attempt):
        gen = torch.Generator(device=device).manual_seed(700 + attempt)

        def policy(ob, ou_t):
            return torch.clamp(actor_apply(leaves, ob, low, high) + ou_t, low, high)

        rets = []
        with torch.no_grad():
            for _ in range(days):
                state, _ = env.reset_batch(params, BENCH_BATCH, gen, batt_soc=batt)
                ou = learner._ou_sequence(torch.randn((T, BENCH_BATCH, A), generator=gen, device=device))
                _, (_, rewards, _) = fused_day_rollout(cfg, params, state, policy, next_pv_shift=state.pv_shift,
                                                       policy_xs=ou)
                rets.append(rewards.sum(0).double())
        return summary(rets)

    n = days * BENCH_BATCH
    stats_match("phase 15 K9 seeded vs plain engine (fresh days, DDPG actor + OU)", k9_draw, plain_draw, n, n)


def gathered_batches(cfg, explicit, G, M, seed):
    """Phase 16's minibatches: G x M transitions of K9's explicit day."""
    obs, act, rew, nxt, _ = explicit
    T, B = rew.shape
    gen = torch.Generator().manual_seed(seed)
    t_idx = torch.randint(0, T, (G, M), generator=gen).to(rew.device)
    b_idx = torch.randint(0, B, (G, M), generator=gen).to(rew.device)
    done = (t_idx == T - 1).float()
    return (obs.permute(0, 2, 1)[t_idx, b_idx], act.permute(0, 2, 1)[t_idx, b_idx], rew[t_idx, b_idx],
            nxt.permute(0, 2, 1)[t_idx, b_idx], done)


def ddpg_sweep_twin_check(cfg, params, learner, explicit, device, errors):
    """Phase 16: K10 over one update (G=24, M=256, 400-300) against its twin;
    a rerun is bit-identical.  Returns the sweep's arguments."""
    from smart_nanogrid_gym_torch.ops.ddpg_sweep import ddpg_sweep, ddpg_sweep_plain

    state = learner.init(11, params, 8)
    batches = gathered_batches(cfg, explicit, learner.cfg.gradient_steps, learner.cfg.batch_size, 16)
    args = (state.actor, state.critic, state.target_actor, state.target_critic, state.actor_opt, state.critic_opt,
            *batches, learner._action_low, learner._action_high, learner._hypers())

    def flat(out):
        a, c, ta, tc, ao, co, metrics = out
        return a + c + ta + tc + ao.mu + ao.nu + co.mu + co.nu + [metrics]

    got = flat(ddpg_sweep(*args))
    errors["ddpg_sweep"] = compare("phase 16 K10 ddpg_sweep (G=24, M=256, 8ch, 400-300)", got,
                                   flat(ddpg_sweep_plain(*args)), rtol=1e-4, atol=1e-6)
    again = flat(ddpg_sweep(*args))
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "K10 rerun is not bit-identical")
    print("phase 16 K10 rerun: bit-identical (4 networks, 4 moment sets, metrics)")
    return args


def ddpg_evaluation_main_path(art_cfg, art_params, ddpg_art, u4, pv4, device, card):
    """Phase 17, the DDPG evaluation path through the entry points a user
    calls, with the launch counts set to 0 before it and read after it."""
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_day
    from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_day
    from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policy_at_scale
    from smart_nanogrid_gym_torch.solvers.networks import make_ddpg_policy_fn

    paired = 256
    u256, pv256 = u4[..., :paired].contiguous(), pv4[:paired].contiguous()
    eval_days = 16
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    ddpg_rewards, actions, _, _ = gen_policy_day(art_cfg, art_params, ddpg_art, u256, pv256, actor="ddpg")
    rbc_rewards, _ = gen_rbc_day(art_cfg, art_params, u256, pv256)
    t0 = time.perf_counter()
    at_scale = evaluate_policy_at_scale(art_cfg, art_params, ddpg_art, num_days=eval_days, batch=BENCH_BATCH,
                                        seed=0, algorithm="ddpg")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    print(f"phase 17 evaluate_policy_at_scale(algorithm='ddpg'): {at_scale} in {seconds:.4f} s "
          f"= {at_scale['total_days'] * 24 / seconds:.4e} env-steps/s on {card}; launches {launches}")
    for name in DDPG_REPLACES:
        check(launches.get(name, 0) >= 1, f"kernel {name} was not launched on the DDPG evaluation path")
    for name, x in (("ddpg rewards", ddpg_rewards), ("rbc rewards", rbc_rewards), ("actions", actions)):
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite")
    low, high = (torch.as_tensor(b, device=device)[None, :, None] for b in art_cfg.action_bounds())
    check(bool(((actions >= low) & (actions <= high)).all()), "DDPG actions outside the action box")
    paired_ddpg, paired_rbc = float(ddpg_rewards.sum(0).mean()), float(rbc_rewards.sum(0).mean())
    print(f"phase 17 paired explicit days ({paired}): ddpg artifact {paired_ddpg:.4f}, rbc {paired_rbc:.4f}")
    check(paired_ddpg > paired_rbc, "the DDPG artifact should beat the RBC on paired days")

    env = SmartNanogridTorch(art_cfg)
    policy = make_ddpg_policy_fn(ddpg_art)

    def k6_draw(attempt):
        if attempt == 0:
            return at_scale["mean_day_return"], at_scale["std_day_return"]
        res = evaluate_policy_at_scale(art_cfg, art_params, ddpg_art, eval_days, BENCH_BATCH, attempt,
                                       algorithm="ddpg")
        return res["mean_day_return"], res["std_day_return"]

    def k6_oracle(attempt):
        gen = torch.Generator(device=device).manual_seed(199 + attempt)
        batt = torch.full((BENCH_BATCH,), 0.5, device=device)
        sums = sq = 0.0
        for _ in range(eval_days):
            state, obs = env.reset_batch(art_params, BENCH_BATCH, gen, batt_soc=batt)
            final, _, (_, rewards, _, _) = env.rollout_day(art_params, state, policy, obs, gen)
            batt = final.batt_soc
            ret = rewards.sum(0).double()
            sums, sq = sums + ret.sum(), sq + (ret * ret).sum()
        n = eval_days * BENCH_BATCH
        mean = float(sums) / n
        return mean, math.sqrt(max(float(sq) / n - mean * mean, 0.0))

    stats_match(f"phase 17 K6 ddpg vs plain engine (DDPG artifact, 4096 x {eval_days} days, battery carried)",
                k6_draw, k6_oracle, eval_days * BENCH_BATCH, eval_days * BENCH_BATCH)
    return launches


def ddpg_training_main_path(cfg, params, art_cfg, art_params, u, pv, device, card):
    """Phase 18, the DDPG training path through the entry points a user
    calls, with the launch counts set to 0 before it and read after it:
    50 updates at B=4096 on the bench config (K9 seeded + K10), the trained
    actor with zero noise on explicit days (K9 explicit, equal to K5 there),
    and a learning run on the artifact's 4-charger config scored by K6."""
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.ddpg_collect import ddpg_collect_day
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_day
    from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_day
    from smart_nanogrid_gym_torch.solvers.ddpg import DDPGConfig, DDPGLearner
    from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policy_at_scale
    from smart_nanogrid_gym_torch.solvers.networks import ddpg_actor_from_leaves

    kernel_cfg = DDPGConfig(collect_impl="kernel", sweep_impl="kernel")
    learner = DDPGLearner(cfg, kernel_cfg, device=device)
    state = learner.init(0, params, BENCH_BATCH)
    low, high = cfg.action_bounds()
    initial_actor = ddpg_actor_from_leaves(state.actor, low, high)
    G = learner.cfg.gradient_steps
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = learner.build_train_many(TRAIN_UPDATES)(state, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    print(f"phase 18 DDPG train: {TRAIN_UPDATES} updates x B={BENCH_BATCH} (G={G}, M={learner.cfg.batch_size}) "
          f"in {seconds:.4f} s = {seconds / TRAIN_UPDATES * 1e3:.3f} ms/update on {card}; launches {counts} "
          f"(per update: {', '.join(f'{k} {v / TRAIN_UPDATES:g}' for k, v in counts.items())})")
    check(counts == {"ddpg_collect_day_seeded": TRAIN_UPDATES, "ddpg_sweep": TRAIN_UPDATES},
          f"launch counts {counts} are not 1 collection + 1 sweep launch per update")
    for name in metrics._fields:
        check(bool(torch.isfinite(getattr(metrics, name)).all()), f"DDPG {name}: non-finite")
    returns = metrics.mean_return.double().cpu()
    print(f"phase 18 DDPG mean day return: first update {float(returns[0]):.4f}, mean of the last 5 "
          f"{float(returns[-5:].mean()):.4f}; critic loss {float(metrics.critic_loss[-1]):.3f}, "
          f"actor loss {float(metrics.actor_loss[-1]):.3f}; buffer {state.buffer.filled} of "
          f"{state.buffer.obs.shape[0]} steps")
    # the trained actor with zero noise on explicit days: K9 explicit equals K5 there
    trained_actor = ddpg_actor_from_leaves(state.actor, low, high)
    zero = torch.zeros((cfg.steps_per_day, cfg.num_actions, BENCH_BATCH), device=device)
    batt = torch.full((BENCH_BATCH,), 0.5, device=device)
    k9_rewards = ddpg_collect_day(cfg, params, state.actor, u, zero, pv, batt)[2]
    k5_rewards = gen_policy_day(cfg, params, trained_actor, u, pv, actor="ddpg")[0]
    rbc_rewards, _ = gen_rbc_day(cfg, params, u, pv)
    check(torch.equal(k9_rewards, k5_rewards), "K9 with zero noise differs from K5 on the same days")
    print(f"phase 18 paired explicit days (B={BENCH_BATCH}): trained DDPG actor (K9, zero noise = K5) "
          f"{float(k9_rewards.sum(0).mean()):.4f}, rbc {float(rbc_rewards.sum(0).mean()):.4f}")
    bench_scores = [evaluate_policy_at_scale(cfg, params, net, num_days=16, batch=BENCH_BATCH, seed=3,
                                             algorithm="ddpg")["mean_day_return"]
                    for net in (trained_actor, initial_actor)]
    print(f"phase 18 bench config, K6 ddpg (16 days x {BENCH_BATCH}): after {TRAIN_UPDATES} updates "
          f"{bench_scores[0]:.4f}, initial actor {bench_scores[1]:.4f} (not asserted: SB3-default DDPG needs "
          f"more updates on 8 chargers)")
    # learning: the artifact's 4-charger config
    art_learner = DDPGLearner(art_cfg, kernel_cfg, device=device)
    art_state = art_learner.init(0, art_params, BENCH_BATCH)
    art_low, art_high = art_cfg.action_bounds()
    art_initial = ddpg_actor_from_leaves(art_state.actor, art_low, art_high)
    t0 = time.perf_counter()
    art_state, art_metrics = art_learner.build_train_many(DDPG_LEARN_UPDATES)(art_state, art_params)
    torch.cuda.synchronize()
    learn_seconds = time.perf_counter() - t0
    scores = [evaluate_policy_at_scale(art_cfg, art_params, net, num_days=16, batch=BENCH_BATCH, seed=3,
                                       algorithm="ddpg")["mean_day_return"]
              for net in (ddpg_actor_from_leaves(art_state.actor, art_low, art_high), art_initial)]
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"phase 18 4ch learning run: {DDPG_LEARN_UPDATES} updates in {learn_seconds:.4f} s; K6 ddpg "
          f"(16 days x {BENCH_BATCH}): trained {scores[0]:.4f}, initial {scores[1]:.4f}; collected return "
          f"first {float(art_metrics.mean_return[0]):.4f}, last 5 {float(art_metrics.mean_return[-5:].mean()):.4f}")
    check(scores[0] > scores[1], "DDPG training did not beat the initial actor")
    print(f"DDPG training path launches: {launches}")
    for name in DDPG_TRAIN_REPLACES:
        check(launches.get(name, 0) >= 1, f"kernel {name} was not launched on the DDPG training path")
    return learner, state, launches, seconds / TRAIN_UPDATES * 1e3


def ddpg_timings(art_cfg, art_params, ddpg_art, u4, pv4, cfg, params, learner, leaves, u, pv, ou, batt,
                 sweep_args, state, card, times, timing_days):
    """Phase 19: each DDPG kernel and its twin at the main path's shape, and
    one training update's phases (collection, sampling and gather, sweep) by
    CUDA events."""
    from smart_nanogrid_gym_torch.ops.ddpg_collect import (
        ddpg_collect_day, ddpg_collect_day_plain, ddpg_collect_day_seeded, ddpg_collect_day_seeded_plain,
        ddpg_weights)
    from smart_nanogrid_gym_torch.ops.ddpg_sweep import ddpg_sweep, ddpg_sweep_plain
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
        actor_weights, gen_policy_day, gen_policy_day_plain, gen_policy_multiday, gen_policy_multiday_plain)
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces

    device = batt.device
    art_traces, traces = kernel_traces(art_params, device), kernel_traces(params, device)
    aw, w = actor_weights(art_cfg, ddpg_art, device, actor="ddpg"), ddpg_weights(cfg, leaves, device)
    half = torch.full_like(pv4, 0.5)
    cases = {
        "gen_policy_day_ddpg": (f"B={BENCH_BATCH}, 1 day, DDPG artifact 4ch, 400-300",
                                lambda: gen_policy_day(art_cfg, art_params, ddpg_art, u4, pv4, actor="ddpg"),
                                lambda: gen_policy_day_plain(art_cfg, art_traces, aw, u4, pv4, half, actor="ddpg"),
                                10),
        "gen_policy_multiday_ddpg": (f"B={BENCH_BATCH}, {timing_days} days, DDPG artifact 4ch, 400-300",
                                     lambda: gen_policy_multiday(art_cfg, art_params, ddpg_art, timing_days, 5,
                                                                 BENCH_BATCH, actor="ddpg"),
                                     lambda: gen_policy_multiday_plain(art_cfg, art_traces, aw, timing_days, 5,
                                                                       BENCH_BATCH, actor="ddpg"), 3),
        "ddpg_collect_day": (f"B={BENCH_BATCH}, 1 day, 8ch b-pv, 400-300",
                             lambda: ddpg_collect_day(cfg, params, leaves, u, ou, pv, batt),
                             lambda: ddpg_collect_day_plain(cfg, traces, w, u, ou, pv, batt), 10),
        "ddpg_collect_day_seeded": (f"B={BENCH_BATCH}, 1 day, 8ch b-pv, 400-300",
                                    lambda: ddpg_collect_day_seeded(cfg, params, leaves, 5, ou, batt, BENCH_BATCH),
                                    lambda: ddpg_collect_day_seeded_plain(cfg, traces, w, 5, ou, batt, BENCH_BATCH),
                                    10),
        "ddpg_sweep": ("G=24 x M=256, F=25 A=9 400-300", lambda: ddpg_sweep(*sweep_args),
                       lambda: ddpg_sweep_plain(*sweep_args), 3),
    }
    for name, (shape, kernel, plain, repeats) in cases.items():
        times[name] = (shape, cuda_ms(kernel, repeats), once_ms(plain)[0])
        print(f"phase 19 {name} ({shape}): kernel {times[name][1]:.4f} ms, "
              f"plain twin {times[name][2]:.4f} ms on {card}")

    # one update's phases, as DDPGLearner._train_body runs them
    gen = torch.Generator().manual_seed(19)
    sums, reps = [0.0, 0.0, 0.0], 5
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        draws = learner.draw(gen, BENCH_BATCH, state.buffer.filled)
        _, _, _, buffer, _ = learner._collect(state, params, draws)
        ev[1].record()
        batches = learner._sample(buffer, learner._to_device(draws.t_idx), learner._to_device(draws.b_idx))
        ev[2].record()
        ddpg_sweep(state.actor, state.critic, state.target_actor, state.target_critic, state.actor_opt,
                   state.critic_opt, *batches, learner._action_low, learner._action_high, learner._hypers())
        ev[3].record()
        torch.cuda.synchronize()
        if rep > 0:  # the first pass warms up
            for i in range(3):
                sums[i] += ev[i].elapsed_time(ev[i + 1]) / reps
    print(f"phase 19 one DDPG update (B={BENCH_BATCH}, G=24, M=256): collection {sums[0]:.4f} ms, "
          f"sampling and gather {sums[1]:.4f} ms, sweep {sums[2]:.4f} ms (CUDA events, mean of {reps}) on {card}")


def given_states(config, params, seed: int, device):
    """Card reset states of BENCH_BATCH envs, and the same envs continued
    into day 2 by one plain RBC day (day-1 SoC history and a carried
    penalty mask)."""
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch, fused_day_rollout
    from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

    gen = torch.Generator(device=device).manual_seed(seed)
    fresh, _ = SmartNanogridTorch(config).reset_batch(params, BENCH_BATCH, gen)
    day2, _ = fused_day_rollout(config, params, fresh, make_rbc_policy_fn(config), generator=gen)
    return {"fresh": fresh, "continued": day2}


def tables_in_checks(rbc_cfg, rbc_params, art_cfg, art_params, artifact, v2x_cfg, v2x_params, device, errors):
    """Phases 20-21 (checks): K11a and K11b bit for bit against their twins
    at B=4096 on a fresh and a continued state (K11a also on a card reset at
    B=131,072), and against the plain engine (fused_day_rollout) on the same
    given states."""
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch, fused_day_rollout
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import actor_weights
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
    from smart_nanogrid_gym_torch.ops.policy_rollout import policy_day_rollout, policy_day_rollout_plain
    from smart_nanogrid_gym_torch.ops.rollout import rbc_day_rollout, rbc_day_rollout_plain, state_tables
    from smart_nanogrid_gym_torch.solvers.networks import make_actor_policy_fn
    from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

    T = rbc_cfg.steps_per_day
    traces, rbc = kernel_traces(rbc_params, device), make_rbc_policy_fn(rbc_cfg)
    err = 0.0
    for label, state in given_states(rbc_cfg, rbc_params, 20, device).items():
        if label == "continued":
            changed = int((state.soc[..., :T] != state.schedule.soc_init[..., :T]).sum())
            print(f"phase 20 continued state: {int(state.pmask.sum())} carried penalty-mask entries, {changed} SoC "
                  f"entries of day 1's history differ from the day's initial SoC")
        got = rbc_day_rollout(rbc_cfg, rbc_params, state)
        want = rbc_day_rollout_plain(rbc_cfg, traces, state_tables(rbc_cfg, rbc_params, state))
        label20 = f"phase 20 K11a rbc_day_rollout ({label} state, 8ch b-pv, B={BENCH_BATCH})"
        err = max(err, compare(label20, got, want, rtol=2e-5, atol=1e-5))
        check_equal(label20, got, want, ("rewards", "soc_final"))
        final, (_, rewards, _) = fused_day_rollout(rbc_cfg, rbc_params, state, rbc, next_pv_shift=state.pv_shift)
        compare(f"phase 20 K11a ({label} state)", got, (rewards, final.soc[..., T - 1].T), rtol=2e-5, atol=1e-5,
                against="plain engine (fused_day_rollout, RBC)")
    errors["rbc_day_rollout"] = err
    gen = torch.Generator(device=device).manual_seed(24)
    big, _ = SmartNanogridTorch(rbc_cfg).reset_batch(rbc_params, FULL_BATCH, gen)
    check_equal(f"phase 20 K11a rbc_day_rollout (card reset, 8ch b-pv, B={FULL_BATCH})",
                rbc_day_rollout(rbc_cfg, rbc_params, big),
                rbc_day_rollout_plain(rbc_cfg, traces, state_tables(rbc_cfg, rbc_params, big)),
                ("rewards", "soc_final"))
    del big

    err = 0.0
    cases = (("the PPO artifact, 4ch b-pv", art_cfg, art_params, artifact, 21),
             ("bench config, biases shifted, 8ch b-pv", rbc_cfg, rbc_params, shifted_actor(rbc_cfg, 22, device), 22),
             ("v2x-b-pv 8ch, alternating biases", v2x_cfg, v2x_params, shifted_actor(v2x_cfg, 23, device), 23))
    for label, cfg, params, net, seed in cases:
        for kind, state in given_states(cfg, params, seed, device).items():
            got = policy_day_rollout(cfg, params, state, net)
            want = policy_day_rollout_plain(cfg, kernel_traces(params, device), actor_weights(cfg, net, device),
                                            state_tables(cfg, params, state))
            label21 = f"phase 21 K11b policy_day_rollout ({label}, {kind} state, B={BENCH_BATCH})"
            err = max(err, compare(label21, got, want, rtol=2e-4, atol=2e-4))
            check_equal(label21, got, want, ("rewards", "actions", "soc_final"))
            final, (_, rewards, _) = fused_day_rollout(cfg, params, state, make_actor_policy_fn(cfg, net),
                                                       next_pv_shift=state.pv_shift)
            compare(f"phase 21 K11b ({label}, {kind} state)", (got[0], got[2]), (rewards, final.soc[..., T - 1].T),
                    rtol=2e-4, atol=2e-4, against="plain engine (fused_day_rollout, deterministic actor)")
            low, high = (torch.as_tensor(b, device=device)[None, :, None] for b in cfg.action_bounds())
            check(bool(((got[1] >= low) & (got[1] <= high)).all()), f"K11b ({label}): actions outside the box")
            if cfg.vehicle_to_everything:
                chargers = got[1][:, :cfg.num_chargers]
                check(bool((chargers > 0).any() and (chargers < 0).any()), "K11b v2x: not both charger branches ran")
    errors["policy_day_rollout"] = err


def rbc_actions_on(device, config):
    """The RBC as the adapters' caller runs it: numpy observations in, numpy
    actions out, the rule evaluated on ``device``."""
    from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

    rbc = make_rbc_policy_fn(config)
    return lambda obs: rbc(torch.from_numpy(obs).to(device)).cpu().numpy()


def stateful_env_main_path(rbc_cfg, rbc_params, art_cfg, art_params, artifact, device, card):
    """Phases 20-23, the stateful-env path through the entry points a user
    calls, with the launch counts set to 0 before it and read after it."""
    import shutil

    from smart_nanogrid_gym_torch.compat import SmartNanogridEnv, VectorSmartNanogridEnv
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch
    from smart_nanogrid_gym_torch.core.generate import load_initial_values_json
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
    from smart_nanogrid_gym_torch.ops.policy_rollout import policy_day_rollout
    from smart_nanogrid_gym_torch.ops.rollout import launch_rbc_day, rbc_day_rollout, state_tables
    from smart_nanogrid_gym_torch.solvers.evaluator import predict_single_day
    from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn

    T = rbc_cfg.steps_per_day
    env = SmartNanogridTorch(rbc_cfg)
    gen = torch.Generator(device=device).manual_seed(2020)
    torch.cuda.synchronize()
    _build.reset_launch_counts()

    # ---- phase 20: the bench row "card reset + K11a" ----
    returns = []
    t0 = time.perf_counter()
    for _ in range(RESET_DAYS):
        state, _ = env.reset_batch(rbc_params, BENCH_BATCH, gen)
        returns.append(rbc_day_rollout(rbc_cfg, rbc_params, state)[0].sum(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    returns = torch.cat(returns).double()
    check(bool(torch.isfinite(returns).all()), "K11a: non-finite day returns")
    print(f"phase 20 card reset + K11a: B={BENCH_BATCH} x {RESET_DAYS} days in {seconds:.4f} s = "
          f"{BENCH_BATCH * RESET_DAYS * T / seconds:.4e} env-steps/s on {card}; mean day return "
          f"{float(returns.mean()):.4f}")
    traces, split, reps = kernel_traces(rbc_params, device), [0.0, 0.0, 0.0], 5
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        state, _ = env.reset_batch(rbc_params, BENCH_BATCH, gen)
        ev[1].record()
        st = state_tables(rbc_cfg, rbc_params, state)
        ev[2].record()
        launch_rbc_day(rbc_cfg, traces, st)
        ev[3].record()
        torch.cuda.synchronize()
        if rep > 0:  # the first pass warms up
            for i in range(3):
                split[i] += ev[i].elapsed_time(ev[i + 1]) / reps
    print(f"phase 20 one day (B={BENCH_BATCH}) by CUDA events, mean of {reps}: reset {split[0]:.4f} ms, table build "
          f"{split[1]:.4f} ms, K11a launch {split[2]:.4f} ms on {card}")
    big, _ = env.reset_batch(rbc_params, FULL_BATCH, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big_rewards, _ = rbc_day_rollout(rbc_cfg, rbc_params, big)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(bool(torch.isfinite(big_rewards).all()), "K11a at full batch: non-finite rewards")
    table_mb = 7 * T * rbc_cfg.num_chargers * FULL_BATCH * 4 / 1e6
    print(f"phase 20 K11a at B={FULL_BATCH} ({table_mb:.0f} MB of tables): wrapper with table build "
          f"{seconds * 1e3:.3f} ms = {FULL_BATCH * T / seconds:.4e} env-steps/s on {card}")
    del big, big_rewards

    # ---- phase 21: the PPO artifact's day from given states, beside the RBC's ----
    art_state, _ = SmartNanogridTorch(art_cfg).reset_batch(art_params, BENCH_BATCH, gen)
    ppo_rewards, actions, _ = policy_day_rollout(art_cfg, art_params, art_state, artifact)
    rbc_rewards, _ = rbc_day_rollout(art_cfg, art_params, art_state)
    check(bool(torch.isfinite(ppo_rewards).all() and torch.isfinite(actions).all()), "K11b: non-finite output")
    ppo_mean, rbc_mean = float(ppo_rewards.sum(0).mean()), float(rbc_rewards.sum(0).mean())
    print(f"phase 21 given states (B={BENCH_BATCH}, 4ch): PPO artifact {ppo_mean:.4f}, rbc {rbc_mean:.4f}")
    check(ppo_mean > rbc_mean, "the artifact should beat the RBC on the same given states")

    # ---- phase 22: the vector env at 4096 envs, one day against K11a ----
    kw = dict(number_of_chargers=rbc_cfg.num_chargers, pv_system_available_in_model=True,
              battery_system_available_in_model=True, time_interval="1h", vehicle_uncharged_penalty_mode="sparse")
    venv = VectorSmartNanogridEnv(num_envs=BENCH_BATCH, seed=22, device=device, **kw)
    rbc_np = rbc_actions_on(device, venv.config)
    obs, _ = venv.reset()
    k11a_rewards, _ = rbc_day_rollout(venv.config, venv.params, venv.states)
    rewards, step_s = [], 0.0
    for _ in range(T):
        act = rbc_np(obs)
        t0 = time.perf_counter()
        obs, rew, term, trunc, infos = venv.step(act)
        step_s += time.perf_counter() - t0
        rewards.append(rew)
    compare(f"phase 22 vector env day (B={BENCH_BATCH}, RBC)", (k11a_rewards,),
            (torch.from_numpy(np.stack(rewards)).to(device),), rtol=2e-5, atol=1e-5,
            against="VectorSmartNanogridEnv's per-step rewards")
    check(bool(term.all()) and not trunc.any() and "final_observation" in infos, "vector env: no day end at step 24")
    check(bool((venv.states.t == 0).all()), "vector env: the autoreset did not start a new day")
    check(np.array_equal(obs[:, -1], infos["final_observation"][:, -1]), "vector env: battery not carried")
    hold = np.tile(np.append(np.full(rbc_cfg.num_chargers, 0.3), -0.4), (BENCH_BATCH, 1)).astype(np.float32)
    for _ in range(T):
        obs, _, term, _, infos = venv.step(hold)
    check(bool(term.all()) and np.array_equal(obs[:, -1], infos["final_observation"][:, -1])
          and bool((obs[:, -1] < 0.5).all()), "vector env: the discharged battery was not carried into day 3")
    print(f"phase 22 VectorSmartNanogridEnv(num_envs={BENCH_BATCH}): {step_s / T * 1e3:.3f} ms per step (host "
          f"clock, numpy in and out) on {card}; day end at step {T}, battery carried (mean "
          f"{float(obs[:, -1].mean()):.4f} after a discharging day)")

    # ---- phase 23: the gym adapter, its same-day replay, predict_single_day ----
    out = os.path.join(ROOT, "build", "chip_smoke_adapter")
    shutil.rmtree(out, ignore_errors=True)
    akw = dict(kw, algorithm_used="RBC", environment_mode="prediction", seed=23, device=device)
    adapter = SmartNanogridEnv(output_directory=os.path.join(out, "day"), **akw)

    def run_day(env, obs):
        rewards, dones, t0 = [], [], time.perf_counter()
        for _ in range(T):
            obs, reward, done, _, _ = env.step(rbc_np(obs))
            rewards.append(reward)
            dones.append(done)
        return rewards, dones, time.perf_counter() - t0

    obs, _ = adapter.reset()
    pv_shift = float(adapter._state.pv_shift)
    day_rewards, dones, seconds = run_day(adapter, obs)
    check(dones == [False] * (T - 1) + [True], "adapter: done must fire at step 24 only")
    dumps = os.path.join(out, "day", "RL", "single_prediction_files")
    root = f"RBC-b-pv-bounded-sparse-{rbc_cfg.num_chargers}ch-1h"
    for name in ("prediction_results.json", f"{root}-prediction_results.json", f"{root}-initial_values.json"):
        check(os.path.exists(os.path.join(dumps, name)), f"adapter: {name} was not written")
    with open(os.path.join(dumps, "prediction_results.json")) as fp:
        check(len(json.load(fp)) == 28, "adapter: prediction_results.json must hold 28 keys")
    day_json = os.path.join(out, "day", "initial_values.json")
    replay = SmartNanogridEnv(output_directory=os.path.join(out, "replay"), **akw)
    obs, _ = replay.reset(generate_new_initial_values=False, initial_values_path=day_json)
    check(float(replay._state.pv_shift) == pv_shift, "replay: another PV shift")
    replay_rewards, _, _ = run_day(replay, obs)
    check(replay_rewards == day_rewards, "the same-day replay did not reproduce the rewards bit for bit")
    rbc = make_rbc_policy_fn(adapter.config)
    predicted, info = predict_single_day(adapter.config, adapter.params, rbc, torch.Generator(device=device),
                                         schedule=load_initial_values_json(day_json, adapter.config,
                                                                           torch.float32, device),
                                         pv_shift=pv_shift)
    check(np.array_equal(predicted.astype(np.float64), np.asarray(day_rewards)),
          "predict_single_day differs from the adapter on the same day")
    check(len(info) == 26 and info.charger_actions.shape == (T, rbc_cfg.num_chargers), "predict_single_day telemetry")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"phase 23 SmartNanogridEnv on {card}: {seconds / T * 1e3:.3f} ms per single-env step; day return "
          f"{sum(day_rewards):.4f}; the JSON replay and predict_single_day give the same rewards bit for bit")
    print(f"stateful-env path launches: {launches}")
    for name in TABLES_REPLACES:
        check(launches.get(name, 0) >= 1, f"kernel {name} was not launched on the stateful-env path")
    return launches


def shifted_bias_actor(config, hidden, seed: int, device):
    """A fresh ActorCritic of the ``hidden`` torso from ``seed``, every bias
    (and log_std) shifted by +0.05 as tests/test_tpu_kernels.py:238-240
    shifts the bench row's actor (bench.py:403-414)."""
    from smart_nanogrid_gym_torch.solvers.networks import ActorCritic

    net = ActorCritic(config.obs_dim, config.num_actions, hidden, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.05)
    return net.to(device)


def bf16_rows(rbc_cfg, rbc_params, art_cfg, art_params, artifact, ddpg_art, big, u, pv, featlane, gathered,
              state0, learner0, ddpg_sweep_args, device, card, errors, times):
    """Phase 24: every new kernel variant against its twin at the shape its
    row is timed at, K6 with bf16 operands (the PPO artifact's 64x64 actor,
    the bench's 256x256 one, the DDPG artifact's 400-300 one), K6 f32, K5 and
    K11b with the 256x256 block-level actor, K3/K4 and K10 bf16 over one full
    update; each twin runs once, timed by CUDA events, and each kernel's
    wrapper is timed by CUDA events after a warm-up."""
    from smart_nanogrid_gym_torch.ops.ddpg_sweep import ddpg_sweep, ddpg_sweep_plain
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
        actor_weights, gen_policy_day, gen_policy_day_plain, gen_policy_multiday, gen_policy_multiday_plain)
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
    from smart_nanogrid_gym_torch.ops.policy_rollout import policy_day_rollout, policy_day_rollout_plain
    from smart_nanogrid_gym_torch.ops.ppo_sweep import (
        ppo_sweep, ppo_sweep_plain, ppo_sweep_streamed, ppo_sweep_streamed_plain)
    from smart_nanogrid_gym_torch.ops.rollout import state_tables

    traces, art_traces = kernel_traces(rbc_params, device), kernel_traces(art_params, device)
    w_big = actor_weights(rbc_cfg, big, device)
    state = given_states(rbc_cfg, rbc_params, 24, device)["continued"]
    st = state_tables(rbc_cfg, rbc_params, state)
    hp16 = learner0._hypers()._replace(matmul_dtype=BF16)
    *data, block_perm, slab = featlane
    p, o = state0.params, state0.opt_state
    d16 = ddpg_sweep_args[:-1] + (ddpg_sweep_args[-1]._replace(matmul_dtype=BF16),)

    def multiday(name, label, cfg, params, tr, net, actor, mm):
        days = NEW_ROW_DAYS[name]
        w = actor_weights(cfg, net, device, actor, mm)
        return (f"B={BENCH_BATCH}, {days} days, {label}",
                lambda: (gen_policy_multiday(cfg, params, net, days, 12, BENCH_BATCH, actor=actor, mlp_dtype=mm),),
                lambda: (gen_policy_multiday_plain(cfg, tr, w, days, 12, BENCH_BATCH, actor=actor, mlp_dtype=mm),),
                3, 2e-4, 1e-2)

    def sweep(out):
        params, adam, metrics = out
        return list(params) + list(adam.mu) + list(adam.nu) + [metrics]

    def ddpg(out):
        a, c, ta, tc, ao, co, metrics = out
        return a + c + ta + tc + ao.mu + ao.nu + co.mu + co.nu + [metrics]

    cases = {
        "gen_policy_multiday_bf16": multiday("gen_policy_multiday_bf16", "PPO artifact 4ch, 64x64, bf16", art_cfg,
                                             art_params, art_traces, artifact, "ppo", BF16),
        "gen_policy_multiday_block": multiday("gen_policy_multiday_block", "bench 8ch, 256x256", rbc_cfg, rbc_params,
                                              traces, big, "ppo", None),
        "gen_policy_multiday_block_bf16": multiday("gen_policy_multiday_block_bf16", "bench 8ch, 256x256, bf16",
                                                   rbc_cfg, rbc_params, traces, big, "ppo", BF16),
        "gen_policy_multiday_ddpg_bf16": multiday("gen_policy_multiday_ddpg_bf16", "DDPG artifact 4ch, 400-300, bf16",
                                                  art_cfg, art_params, art_traces, ddpg_art, "ddpg", BF16),
        "gen_policy_day_block": (f"B={BENCH_BATCH}, 1 day, bench 8ch, 256x256",
                                 lambda: gen_policy_day(rbc_cfg, rbc_params, big, u, pv),
                                 lambda: gen_policy_day_plain(rbc_cfg, traces, w_big, u, pv, torch.full_like(pv, 0.5)),
                                 10, 2e-4, 2e-4),
        "policy_day_rollout_block": (f"B={BENCH_BATCH}, 1 day, bench 8ch, 256x256, continued state",
                                     lambda: policy_day_rollout(rbc_cfg, rbc_params, state, big),
                                     lambda: policy_day_rollout_plain(rbc_cfg, traces, w_big, st), 10, 2e-4, 2e-4),
        "ppo_sweep_streamed_bf16": ("G=40 x M=24576, featlane, F=25 A=9 64x64, bf16 tensor cores",
                                    lambda: sweep(ppo_sweep_streamed(p, o, *data, block_perm, slab, hp16)),
                                    lambda: sweep(ppo_sweep_streamed_plain(p, o, *data, block_perm, slab, hp16)),
                                    3, None, None),
        "ppo_sweep_bf16": ("G=40 x M=24576, gathered, F=25 A=9 64x64, bf16 tensor cores",
                           lambda: sweep(ppo_sweep(p, o, *gathered, hp16)),
                           lambda: sweep(ppo_sweep_plain(p, o, zip(*gathered), hp16)), 3, None, None),
        "ddpg_sweep_bf16": ("G=24 x M=256, F=25 A=9 400-300, bf16 tensor cores", lambda: ddpg(ddpg_sweep(*d16)),
                            lambda: ddpg(ddpg_sweep_plain(*d16)), 3, None, None),
    }
    # K6's bf16 block-actor rows: the f32 kernel on the same days
    k6_f32 = {
        "gen_policy_multiday_bf16": lambda: (gen_policy_multiday(
            art_cfg, art_params, artifact, NEW_ROW_DAYS["gen_policy_multiday_bf16"], 12, BENCH_BATCH),),
        "gen_policy_multiday_block_bf16": lambda: (gen_policy_multiday(
            rbc_cfg, rbc_params, big, NEW_ROW_DAYS["gen_policy_multiday_block_bf16"], 12, BENCH_BATCH),),
        "gen_policy_multiday_ddpg_bf16": lambda: (gen_policy_multiday(
            art_cfg, art_params, ddpg_art, NEW_ROW_DAYS["gen_policy_multiday_ddpg_bf16"], 12, BENCH_BATCH,
            actor="ddpg"),),
    }
    # the tensor-core rows: parameter leaves, lr, G, the f32 kernel on the same inputs
    hp32, d32 = learner0._hypers(), ddpg_sweep_args[-1]
    f32_refs = {
        "ppo_sweep_streamed_bf16": (13, hp32.lr, block_perm.shape[0],
                                    lambda: sweep(ppo_sweep_streamed(p, o, *data, block_perm, slab, hp32))),
        "ppo_sweep_bf16": (13, hp32.lr, gathered[0].shape[0], lambda: sweep(ppo_sweep(p, o, *gathered, hp32))),
        "ddpg_sweep_bf16": (24, d32.lr, ddpg_sweep_args[6].shape[0], lambda: ddpg(ddpg_sweep(*ddpg_sweep_args))),
    }
    for name, (shape, kernel, plain, repeats, rtol, atol) in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        torch.cuda.synchronize()
        if name in f32_refs:  # tensor cores: a stated tolerance, not bit-equality
            n_params, lr, G, f32 = f32_refs[name]
            errors[name] = tensor_core_close(f"phase 24 {name} ({shape})", got, want, f32(), n_params, 4 * G * lr)
        elif name in k6_f32:  # K6's block actor in bf16, on the tensor cores
            f32 = k6_f32[name]()[0]
            errors[name] = k6_bf16_close(f"phase 24 {name} ({shape})", got[0], want[0], f32)
            check(not torch.equal(got[0], f32), f"{name}: the bf16 option gives the f32 kernel's stats")
            check(torch.equal(got[0], kernel()[0]), f"{name}: a rerun is not bit-identical")
        else:
            errors[name] = compare(f"phase 24 {name} ({shape})", got, want, rtol=rtol, atol=atol)
            if name == "gen_policy_multiday_block":
                check_equal(f"phase 24 {name}", got, want, ("stats",))
            elif name == "gen_policy_day_block":
                check_equal(f"phase 24 {name}", got, want, ("rewards", "actions", "soc_final", "batt_final"))
            elif name == "policy_day_rollout_block":
                check_equal(f"phase 24 {name}", got, want, ("rewards", "actions", "soc_final"))
        if name in ("ppo_sweep_streamed_bf16", "ddpg_sweep_bf16"):
            check(all(torch.equal(a, b) for a, b in zip(got, kernel())), f"{name}: a rerun is not bit-identical")
        times[name] = (shape, cuda_ms(kernel, repeats), start.elapsed_time(end))
        print(f"phase 24 {name} ({shape}): kernel {times[name][1]:.4f} ms, plain twin {times[name][2]:.4f} ms "
              f"on {card}")
    f32 = sweep(ppo_sweep_streamed(p, o, *data, block_perm, slab, learner0._hypers()))
    bf16 = sweep(ppo_sweep_streamed(p, o, *data, block_perm, slab, hp16))
    print(f"phase 24 K3 bf16 against K3 f32 after one update: params max |d| "
          f"{max(float((a - b).abs().max()) for a, b in zip(bf16[:13], f32[:13])):.3e}")


def big_evaluation_main_path(rbc_cfg, rbc_params, art_cfg, art_params, ddpg_art, big, u, pv, device, card):
    """Phase 25, the 256x256 actor and K6's bf16 option through the entry
    points a user calls, with the launch counts set to 0 before it and read
    after it: the bench row ``pallas_gen_policy_multiday_256x256_{f32,bf16}``
    (bench.py:403-414) through ``gen_policy_multiday`` at B=4096, the same
    actor on paired explicit days (K5) and from card reset states (K11b),
    the bench row ``pallas_gen_policy_multiday`` (the 64x64 actor, 2,500
    days, bench.py:394-401), the 64x64 bench actor and the DDPG artifact
    through K6 in bf16 and f32."""
    from smart_nanogrid_gym_torch.core import SmartNanogridTorch
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_day, gen_policy_multiday
    from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_day
    from smart_nanogrid_gym_torch.ops.policy_rollout import policy_day_rollout

    T = rbc_cfg.steps_per_day
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    rewards, actions, _, _ = gen_policy_day(rbc_cfg, rbc_params, big, u, pv)
    rbc_rewards, _ = gen_rbc_day(rbc_cfg, rbc_params, u, pv)
    check(bool(torch.isfinite(rewards).all() and torch.isfinite(actions).all()), "K5 256x256: non-finite output")
    low, high = (torch.as_tensor(b, device=device)[None, :, None] for b in rbc_cfg.action_bounds())
    check(bool(((actions >= low) & (actions <= high)).all()), "K5 256x256: actions outside the box")
    state, _ = SmartNanogridTorch(rbc_cfg).reset_batch(rbc_params, BENCH_BATCH, torch.Generator(device=device)
                                                       .manual_seed(25))
    k11b = policy_day_rollout(rbc_cfg, rbc_params, state, big)[0]
    check(bool(torch.isfinite(k11b).all()), "K11b 256x256: non-finite rewards")
    print(f"phase 25 256x256 actor (B={BENCH_BATCH}): paired explicit days {float(rewards.sum(0).mean()):.4f} "
          f"(rbc {float(rbc_rewards.sum(0).mean()):.4f}); from card reset states {float(k11b.sum(0).mean()):.4f}")

    # the bench row: a 10-day run sizes it (a row over ROW_SECONDS on its first run is cut)
    probe_days = 10
    t0 = time.perf_counter()
    gen_policy_multiday(rbc_cfg, rbc_params, big, probe_days, 0, BENCH_BATCH)
    torch.cuda.synchronize()
    per_day = (time.perf_counter() - t0) / probe_days
    days = min(BIG_ROW_DAYS, max(1, int(ROW_SECONDS / per_day)))
    if days < BIG_ROW_DAYS:
        print(f"phase 25 bench row cut to {days} of {BIG_ROW_DAYS} days ({per_day * 1e3:.3f} ms a day in f32)")
    else:
        print(f"phase 25 bench row at its full {BIG_ROW_DAYS} days ({per_day * 1e3:.3f} ms a day in f32 on the "
              f"{probe_days}-day probe, under ROW_SECONDS = {ROW_SECONDS})")
    rows = {}
    for tag, mm in (("f32", None), ("bf16", BF16)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = gen_policy_multiday(rbc_cfg, rbc_params, big, days, 1, BENCH_BATCH, mlp_dtype=mm)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rows[tag] = mean_std(stats, days * BENCH_BATCH)
        print(f"phase 25 bench row pallas_gen_policy_multiday_256x256_{tag}: B={BENCH_BATCH} x {days} days in "
              f"{seconds:.4f} s = {BENCH_BATCH * days * T / seconds:.4e} env-steps/s on {card}; mean day return "
              f"{rows[tag][0]:.4f}, std {rows[tag][1]:.4f}")
    rel = abs(rows["bf16"][0] - rows["f32"][0]) / abs(rows["f32"][0])
    print(f"phase 25 256x256 bf16 against f32: mean day return differs by {rel:.5f} (limit 0.005)")
    check(rel < 0.005, "bf16 moved the 256x256 mean day return by 0.5 % or more")

    small = shifted_bias_actor(rbc_cfg, (64, 64), 42, device)
    # the bench row pallas_gen_policy_multiday: the 64x64 actor, f32, 2,500 days
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = gen_policy_multiday(rbc_cfg, rbc_params, small, SMALL_ROW_DAYS, 4, BENCH_BATCH)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mean, std = mean_std(stats, SMALL_ROW_DAYS * BENCH_BATCH)
    check(math.isfinite(mean) and math.isfinite(std), "the 64x64 bench row: non-finite statistics")
    print(f"phase 25 bench row pallas_gen_policy_multiday (64x64, f32): B={BENCH_BATCH} x {SMALL_ROW_DAYS} days in "
          f"{seconds:.4f} s = {BENCH_BATCH * SMALL_ROW_DAYS * T / seconds:.4e} env-steps/s on {card}; mean day "
          f"return {mean:.4f}, std {std:.4f}")
    small_days = 400  # x 4096 envs, tests/test_tpu_kernels.py:195-217's check
    small_rows = {tag: mean_std(gen_policy_multiday(rbc_cfg, rbc_params, small, small_days, 2, BENCH_BATCH,
                                                    mlp_dtype=mm), small_days * BENCH_BATCH)
                  for tag, mm in (("f32", None), ("bf16", BF16))}
    (mf, sf), (mb, sb) = small_rows["f32"], small_rows["bf16"]
    print(f"phase 25 64x64 bench actor, {small_days} days x {BENCH_BATCH}: f32 mean {mf:.4f} std {sf:.4f}, bf16 "
          f"mean {mb:.4f} std {sb:.4f} (limits 0.5 %, 2 %)")
    check(abs(mb - mf) / abs(mf) < 0.005 and abs(sb - sf) / abs(sf) < 0.02,
          "bf16 moved the 64x64 day-return statistics")
    ddpg_rows = {tag: mean_std(gen_policy_multiday(art_cfg, art_params, ddpg_art, 4, 3, BENCH_BATCH, actor="ddpg",
                                                   mlp_dtype=mm), 4 * BENCH_BATCH)
                 for tag, mm in (("f32", None), ("bf16", BF16))}
    print(f"phase 25 DDPG artifact K6, 4 days x {BENCH_BATCH}: f32 mean {ddpg_rows['f32'][0]:.4f}, bf16 mean "
          f"{ddpg_rows['bf16'][0]:.4f}")
    check(all(math.isfinite(v) for r in ddpg_rows.values() for v in r), "K6 ddpg bf16: non-finite statistics")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"256x256 and K6 bf16 path launches: {launches}")
    for name in BIG_REPLACES:
        check(launches.get(name, 0) >= 1, f"kernel {name} was not launched on the 256x256 / K6 bf16 path")
    return launches


def bf16_training_main_path(cfg, params, device, card):
    """Phases 26-27, training with ``update_matmul_dtype=torch.bfloat16``
    through the entry points a user calls, each with the launch counts set
    to 0 before it and read after it: PPO (K2 + K3 bf16) for 50 updates at
    B=4096 and two ``env``-scheme updates (K4 bf16); DDPG (K9 + K10 bf16)
    for 30 updates at B=4096."""
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.solvers.ddpg import DDPGConfig, DDPGLearner
    from smart_nanogrid_gym_torch.solvers.ppo import PPOConfig, PPOLearner

    learner = PPOLearner(cfg, PPOConfig(collect_impl="kernel", sweep_impl="kernel", update_matmul_dtype=BF16),
                         device=device)
    state = learner.init(0, params, BENCH_BATCH)
    G = learner.ppo.num_epochs * learner.ppo.num_minibatches
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = learner.build_train_many(TRAIN_UPDATES)(state, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    returns = metrics.mean_return.double().cpu()
    first, last = float(returns[0]), float(returns[-5:].mean())
    print(f"phase 26 bf16 PPO train: {TRAIN_UPDATES} updates x B={BENCH_BATCH} (G={G}) in {seconds:.4f} s = "
          f"{seconds / TRAIN_UPDATES * 1e3:.3f} ms/update on {card}; launches {counts}; mean day return first "
          f"{first:.4f}, mean of the last 5 {last:.4f}")
    check(counts == {"ppo_collect_day_seeded": TRAIN_UPDATES, "ppo_sweep_streamed_bf16": TRAIN_UPDATES},
          f"launch counts {counts} are not 1 collection + 1 bf16 sweep launch per update")
    check(bool(torch.isfinite(returns).all()) and last > first, "bf16 training did not raise the mean day return")
    check(all(x.dtype == torch.float32 for x in state.params), "bf16 training left f32 master params")
    env_learner = PPOLearner(cfg, PPOConfig(sweep_impl="kernel", minibatch_scheme="env", update_matmul_dtype=BF16),
                             device=device)
    _, env_metrics = env_learner.build_train_many(2)(state._replace(update_step=0), params)
    check(bool(torch.isfinite(env_metrics.mean_return).all()), "bf16 env-scheme update: non-finite return")
    torch.cuda.synchronize()
    ppo_launches = dict(_build.launch_counts)
    print(f"bf16 PPO training path launches: {ppo_launches}")

    d_learner = DDPGLearner(cfg, DDPGConfig(collect_impl="kernel", sweep_impl="kernel", update_matmul_dtype=BF16),
                            device=device)
    d_state = d_learner.init(0, params, BENCH_BATCH)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    d_state, d_metrics = d_learner.build_train_many(BF16_TRAIN_UPDATES)(d_state, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ddpg_launches = dict(_build.launch_counts)
    Gd = d_learner.cfg.gradient_steps
    print(f"phase 27 bf16 DDPG train: {BF16_TRAIN_UPDATES} updates x B={BENCH_BATCH} (G={Gd}) in {seconds:.4f} s = "
          f"{seconds / BF16_TRAIN_UPDATES * 1e3:.3f} ms/update on {card}; launches {ddpg_launches}; critic loss "
          f"{float(d_metrics.critic_loss[-1]):.3f}, actor loss {float(d_metrics.actor_loss[-1]):.3f}")
    check(ddpg_launches == {"ddpg_collect_day_seeded": BF16_TRAIN_UPDATES, "ddpg_sweep_bf16": BF16_TRAIN_UPDATES},
          f"launch counts {ddpg_launches} are not 1 collection + 1 bf16 sweep launch per update")
    for name in d_metrics._fields:
        check(bool(torch.isfinite(getattr(d_metrics, name)).all()), f"bf16 DDPG {name}: non-finite")
    check(all(x.dtype == torch.float32 for x in d_state.actor + d_state.critic), "bf16 DDPG left f32 master params")
    for name in BF16_TRAIN_REPLACES:
        check(ppo_launches.get(name, 0) >= 1, f"kernel {name} was not launched on the bf16 training path")
    return ppo_launches, ddpg_launches


def bf16_device_times(rbc_cfg, rbc_params, art_cfg, art_params, artifact, ddpg_art, big, u, pv, u4, pv4, featlane,
                      gathered, state, learner, ddpg_sweep_args, card, timing_days):
    """Phase 28: by the profiler, the device time of each bf16 row beside its
    f32 counterpart's: K6 at 256x256 and with the DDPG artifact (B=4096, 2
    days), K3, K4 and K10 per update; and of the day kernels' rows at the
    shapes the kernels line reports: K7 on its ring block (8ch, 1 day), K6
    with the PPO artifact's 64x64 actor (f32, 20 days; bf16, 4 days), K5 with
    the PPO artifact, the DDPG artifact and the 256x256 actor (1 day).  Returns the device ms and the CUDA kernel
    instances the profiler saw, by row."""
    from smart_nanogrid_gym_torch.ops.ddpg_sweep import ddpg_sweep
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_day, gen_policy_multiday
    from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_day
    from smart_nanogrid_gym_torch.ops.ppo_sweep import ppo_sweep, ppo_sweep_streamed

    days = NEW_ROW_DAYS["gen_policy_multiday_block"]
    hp32 = learner._hypers()
    hp16 = hp32._replace(matmul_dtype=BF16)
    *data, block_perm, slab = featlane
    p, o = state.params, state.opt_state
    d16 = ddpg_sweep_args[:-1] + (ddpg_sweep_args[-1]._replace(matmul_dtype=BF16),)
    k3, k10 = "ppo_sweep_kernel", "ddpg_sweep_kernel"
    device_times, instances = {}, {}
    pairs = (
        ("gen_policy_multiday_block", lambda: gen_policy_multiday(rbc_cfg, rbc_params, big, days, 5, BENCH_BATCH),
         "gen_policy_multiday_block_kernel"),
        ("gen_policy_multiday_block_bf16",
         lambda: gen_policy_multiday(rbc_cfg, rbc_params, big, days, 5, BENCH_BATCH, mlp_dtype=BF16),
         "gen_policy_multiday_block_kernel"),
        ("gen_policy_multiday_ddpg",
         lambda: gen_policy_multiday(art_cfg, art_params, ddpg_art, days, 5, BENCH_BATCH, actor="ddpg"),
         "gen_policy_multiday_block_kernel"),
        ("gen_policy_multiday_ddpg_bf16",
         lambda: gen_policy_multiday(art_cfg, art_params, ddpg_art, days, 5, BENCH_BATCH, actor="ddpg",
                                     mlp_dtype=BF16), "gen_policy_multiday_block_kernel"),
        ("ppo_sweep_streamed", lambda: ppo_sweep_streamed(p, o, *data, block_perm, slab, hp32), k3),
        ("ppo_sweep_streamed_bf16", lambda: ppo_sweep_streamed(p, o, *data, block_perm, slab, hp16), k3),
        ("ppo_sweep", lambda: ppo_sweep(p, o, *gathered, hp32), k3),
        ("ppo_sweep_bf16", lambda: ppo_sweep(p, o, *gathered, hp16), k3),
        ("ddpg_sweep", lambda: ddpg_sweep(*ddpg_sweep_args), k10),
        ("ddpg_sweep_bf16", lambda: ddpg_sweep(*d16), k10),
    )
    for name, fn, kernel in pairs:
        device_times[name], instances[name] = profile_kernels(fn, kernel, 3)
        print(f"phase 28 {name}: {device_times[name]:.4f} ms of device time per call (profiler) on {card}")
    k6, k5 = "gen_policy_multiday_block_kernel", "gen_policy_day_block_kernel"
    rows = (
        ("gen_rbc_day", lambda: gen_rbc_day(rbc_cfg, rbc_params, u, pv), "gen_rbc_day_ring_kernel"),
        ("gen_policy_day", lambda: gen_policy_day(art_cfg, art_params, artifact, u4, pv4), k5),
        ("gen_policy_multiday", lambda: gen_policy_multiday(art_cfg, art_params, artifact, timing_days, 5,
                                                            BENCH_BATCH), k6),
        ("gen_policy_multiday_bf16", lambda: gen_policy_multiday(
            art_cfg, art_params, artifact, NEW_ROW_DAYS["gen_policy_multiday_bf16"], 5, BENCH_BATCH,
            mlp_dtype=BF16), k6),
        ("gen_policy_day_ddpg", lambda: gen_policy_day(art_cfg, art_params, ddpg_art, u4, pv4, actor="ddpg"), k5),
        ("gen_policy_day_block", lambda: gen_policy_day(rbc_cfg, rbc_params, big, u, pv), k5),
    )
    for name, fn, kernel in rows:
        device_times[name], instances[name] = profile_kernels(fn, kernel, 5)
        print(f"phase 28 {name}: {device_times[name]:.4f} ms of device time per call (profiler) on {card}")
    for a, b in (("gen_policy_multiday_block_bf16", "gen_policy_multiday_block"),
                 ("gen_policy_multiday_ddpg_bf16", "gen_policy_multiday_ddpg"),
                 ("ppo_sweep_streamed_bf16", "ppo_sweep_streamed"), ("ppo_sweep_bf16", "ppo_sweep"),
                 ("ddpg_sweep_bf16", "ddpg_sweep")):
        print(f"phase 28 {a} / {b}: device time ratio {device_times[a] / device_times[b]:.4f}")
    # K11b's 256x256 instance on tables already built, on a fresh and a
    # continued state: by the profiler through the wrapper (nan when it keeps
    # no record: not required) and by CUDA events around bare launches of the
    # packed block, so that a dropped record cannot leave the kernel untimed
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import actor_weights, policy_library
    from smart_nanogrid_gym_torch.ops.gen_rollout import kernel_traces
    from smart_nanogrid_gym_torch.ops.policy_rollout import launch_policy_day
    from smart_nanogrid_gym_torch.ops.rollout import state_tables

    device = next(iter(big.parameters())).device
    T, A, N, dt = rbc_cfg.steps_per_day, rbc_cfg.num_actions, rbc_cfg.num_chargers, rbc_cfg.time_interval
    traces, weights = kernel_traces(rbc_params, device), actor_weights(rbc_cfg, big, device)
    lib, block, label = policy_library(rbc_cfg, device, weights, BIG_HIDDEN, "ppo", traces, "policy_day_rollout")
    outs = [torch.empty(shape, device=device) for shape in ((T, BENCH_BATCH), (T, A, BENCH_BATCH), (N, BENCH_BATCH))]
    for kind, state in given_states(rbc_cfg, rbc_params, 28, device).items():
        st = state_tables(rbc_cfg, rbc_params, state).checked()
        profiled, seen = profile_kernels(lambda: launch_policy_day(rbc_cfg, traces, weights, st, BIG_HIDDEN),
                                         K11B_KERNEL, 3, required=False)
        events = cuda_ms(lambda: _build.launch(
            label, lib.ngk_policy_day_rollout, traces.price, traces.price_norm, traces.price_norm.numel(),
            traces.rad_norm, traces.rad_norm.numel(), traces.solar, *st, block, *outs, BENCH_BATCH, T, dt,
            device=device), 5)
        print(f"phase 28 policy_day_rollout_block ({kind} state): {profiled:.4f} ms of device time per call "
              f"(profiler), {events:.4f} ms per bare launch (CUDA events) on {card}")
        if kind == "continued":  # the state phase 24 checks and times
            device_times[label] = profiled if math.isfinite(profiled) else events
            instances[label] = seen or K11B_KERNEL
    return device_times, instances


def run_cli(main, argv):
    """``main(argv)`` of a CLI with its standard output captured (and echoed
    with a prefix); returns ``(result, output)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    for line in out.getvalue().splitlines():
        print(f"  | {line}")
    return result, out.getvalue()


def last_json(output: str) -> dict:
    """The last line of a CLI's output that is one JSON object."""
    return json.loads([line for line in output.splitlines() if line.startswith("{")][-1])


def cli_launches(label: str, fn):
    """``fn()`` with the launch counts set to 0 just before it and read just after."""
    from smart_nanogrid_gym_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"{label} launches: {counts}")
    return result, counts


def cli_train_ppo_path(root, card):
    """Phase 29, ``train_ppo`` through ``main(argv)`` on the bench config at
    B=4096 with ``--impl kernel --guard``, 3 epochs of CLI_UPDATES updates:
    K2 and K3 once per update, no recovery, a 2-epoch run resumed to 3 equal
    to the straight run (params, Adam moments, batteries), a progress.csv row
    per epoch, and the CLI's env-steps/s beside a run without the guard."""
    from smart_nanogrid_gym_torch.tools import train_ppo
    from smart_nanogrid_gym_torch.utils import guard as guard_module

    def argv(models, epochs, *extra):
        return ["--variant", "b-pv", "--num-chargers", "8", "--batch", str(BENCH_BATCH), "--epochs", str(epochs),
                "--episodes-per-epoch", str(CLI_UPDATES * BENCH_BATCH), "--impl", "kernel", "--device", "cuda",
                "--seed", "0", "--models-dir", os.path.join(root, models), *extra]

    guards = []

    class RecordedGuard(guard_module.TrainGuard):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            guards.append(self)

    original, guard_module.TrainGuard = guard_module.TrainGuard, RecordedGuard
    try:
        (straight, out), counts = cli_launches("phase 29 train_ppo (3 epochs)",
                                               lambda: run_cli(train_ppo.main, argv("runs", 3, "--guard")))
        updates = 3 * CLI_UPDATES
        check(counts == {"ppo_collect_day_seeded": updates, "ppo_sweep_streamed": updates},
              f"phase 29: launch counts {counts} are not 1 K2 + 1 K3 launch per update ({updates} updates)")
        check(len(guards) == 1 and guards[0].recoveries == 0, "phase 29: the NaN guard recovered")
        (_, _), first = cli_launches("phase 29 train_ppo (2 epochs)",
                                     lambda: run_cli(train_ppo.main, argv("resume", 2, "--guard")))
        (resumed, _), second = cli_launches("phase 29 train_ppo --resume (to 3 epochs)",
                                            lambda: run_cli(train_ppo.main, argv("resume", 3, "--guard", "--resume")))
    finally:
        guard_module.TrainGuard = original
    check(first.get("ppo_sweep_streamed", 0) + second.get("ppo_sweep_streamed", 0) == updates,
          "phase 29: the resumed run reran or skipped updates")
    pairs = list(zip(resumed.params + resumed.opt_state.mu + resumed.opt_state.nu + [resumed.batt_soc],
                     straight.params + straight.opt_state.mu + straight.opt_state.nu + [straight.batt_soc]))
    check(all(torch.equal(a, b) for a, b in pairs) and resumed.opt_state.count == straight.opt_state.count,
          "phase 29: the resumed run does not equal the straight run")
    print(f"phase 29 2 epochs + --resume to 3: params, Adam moments ({resumed.opt_state.count} steps) and batteries "
          f"torch.equal to the straight run at B={BENCH_BATCH} (--impl kernel)")
    run = os.path.join(root, "runs", "PPO-b-pv-bounded-sparse-8ch-1.0h")
    with open(os.path.join(run, "logs", "progress.csv")) as fp:
        rows = fp.read().splitlines()
    check(len(rows) == 1 + 3 and rows[0].startswith("step,"), f"phase 29: progress.csv has {len(rows)} lines")
    guarded = last_json(out)["steps_per_sec"]
    (_, plain_out), _ = cli_launches("phase 29 train_ppo without --guard (3 epochs)",
                                     lambda: run_cli(train_ppo.main, argv("unguarded", 3)))
    unguarded = last_json(plain_out)["steps_per_sec"]
    per_update = BENCH_BATCH * 24
    print(f"phase 29 train_ppo --impl kernel at B={BENCH_BATCH}, 3 epochs x {CLI_UPDATES} updates: CLI "
          f"{guarded:.1f} env-steps/s with --guard = {per_update / guarded * 1e3:.3f} ms per update, "
          f"{unguarded:.1f} without = {per_update / unguarded * 1e3:.3f} ms per update (epoch checkpoints "
          f"included) on {card}")
    return counts


def cli_train_ddpg_path(root, card):
    """Phase 30, ``train_ddpg --impl kernel`` at B=4096 on the bench config, 2
    epochs of 2 updates: K9 seeded and K10 once per update."""
    from smart_nanogrid_gym_torch.tools import train_ddpg

    argv = ["--variant", "b-pv", "--num-chargers", "8", "--batch", str(BENCH_BATCH), "--epochs", "2",
            "--episodes-per-epoch", str(2 * BENCH_BATCH), "--impl", "kernel", "--device", "cuda",
            "--models-dir", os.path.join(root, "runs")]
    (state, out), counts = cli_launches("phase 30 train_ddpg", lambda: run_cli(train_ddpg.main, argv))
    check(counts == {"ddpg_collect_day_seeded": 4, "ddpg_sweep": 4},
          f"phase 30: launch counts {counts} are not 1 K9 + 1 K10 launch per update (4 updates)")
    check(state.update_step == 4 and math.isfinite(last_json(out)["critic_loss"]), "phase 30: training state")
    rate = last_json(out)["steps_per_sec"]
    print(f"phase 30 train_ddpg --impl kernel at B={BENCH_BATCH}, 2 epochs x 2 updates: CLI {rate:.1f} env-steps/s "
          f"= {BENCH_BATCH * 24 / rate * 1e3:.3f} ms per update (epoch checkpoints included) on {card}")
    return counts


def cli_evaluate_path(root, art_cfg, art_params, artifact):
    """Phase 31, ``evaluate``: ``--models-root`` over phases 29-30's runs
    with ``--at-scale 20`` (K6 once per checkpoint, PPO and DDPG), then the
    committed PPO artifact, whose at-scale figure equals a direct
    ``evaluate_policy_at_scale`` call and whose same-day mean beats the RBC's."""
    from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policy_at_scale
    from smart_nanogrid_gym_torch.tools import evaluate

    argv = ["--variant", "b-pv", "--num-chargers", "8", "--days", "100", "--device", "cuda",
            "--models-root", os.path.join(root, "runs"), "--at-scale", "20"]
    (results, out), counts = cli_launches("phase 31 evaluate --models-root", lambda: run_cli(evaluate.main, argv))
    report = json.loads(out[out.index("{"):])
    scaled = [name for name in report if name.endswith("(at-scale)")]
    check(len(scaled) == 2 and counts == {"gen_policy_multiday": 1, "gen_policy_multiday_ddpg": 1},
          f"phase 31: at-scale rows {scaled} with launches {counts} are not one K6 per checkpoint")
    check(all(math.isfinite(report[n]["mean_day_return"]) for n in scaled) and len(results) == 4,
          "phase 31: evaluation of the trained runs")
    run = os.path.join(ROOT, "artifacts", "PPO-b-pv-bounded-sparse-4ch-1h")
    argv = ["--variant", "b-pv", "--num-chargers", "4", "--days", "256", "--device", "cuda", "--models-dir", run,
            "--at-scale", "20"]
    (results, out), art_counts = cli_launches("phase 31 evaluate (PPO artifact)", lambda: run_cli(evaluate.main, argv))
    report = json.loads(out[out.index("{"):])
    direct = evaluate_policy_at_scale(art_cfg, art_params, artifact, num_days=20, seed=0)
    got = report["PPO-b-pv-bounded-sparse-4ch-1h@108134400 (at-scale)"]
    check(got == direct, f"phase 31: the CLI's at-scale figure {got} is not evaluate_policy_at_scale's {direct}")
    ppo, rbc = (float(np.mean(results[n])) for n in ("PPO-b-pv-bounded-sparse-4ch-1h@108134400", "RBC"))
    print(f"phase 31 PPO artifact: at-scale (20 days x {BENCH_BATCH}) {got['mean_day_return']:.4f}, equal to "
          f"evaluate_policy_at_scale; same 256 days: PPO {ppo:.4f}, RBC {rbc:.4f}")
    check(ppo > rbc and art_counts == {"gen_policy_multiday": 1}, "phase 31: the artifact should beat the RBC")
    return {name: counts.get(name, 0) + art_counts.get(name, 0) for name in {*counts, *art_counts}}


def cli_predict_path(root):
    """Phase 32, ``predict`` with the PPO artifact and ``--with-rbc`` on the
    card (28-key JSON per policy), then ``visualize`` on its JSON.  The PNGs
    need matplotlib; where it is not installed the phase says so and renders
    visualize's HTML explorer alone."""
    import importlib.util

    from smart_nanogrid_gym_torch.tools import predict, visualize

    plots = importlib.util.find_spec("matplotlib") is not None
    out_dir = os.path.join(root, "predict")
    argv = ["--variant", "b-pv", "--num-chargers", "4", "--device", "cuda", "--out", out_dir, "--with-rbc",
            "--models-dir", os.path.join(ROOT, "artifacts", "PPO-b-pv-bounded-sparse-4ch-1h")]
    if plots:
        argv += ["--plot", os.path.join(root, "bars.png")]
    else:
        print("phase 32: matplotlib is not installed, so predict runs without --plot and "
              "visualize renders its HTML explorer only")
    (_, out), counts = cli_launches("phase 32 predict", lambda: run_cli(predict.main, argv))
    day_returns = last_json(out)["day_returns"]
    check(set(day_returns) == {"PPO-b-pv-bounded-sparse-4ch-1h@108134400", "RBC"}
          and all(math.isfinite(v) for v in day_returns.values()), f"phase 32: day returns {day_returns}")
    files = sorted(f for f in os.listdir(os.path.join(out_dir, "RL", "single_prediction_files"))
                   if f.endswith("-prediction_results.json"))
    check(len(files) == 2, f"phase 32: prediction files {files}")
    path = os.path.join(out_dir, "RL", "single_prediction_files", files[0])
    with open(path) as fp:
        results = json.load(fp)
    check(len(results) == 28, f"phase 32: {len(results)} keys in {files[0]}, not 28")
    html = os.path.join(root, "day.html")
    if plots:
        run_cli(visualize.main, ["--results", path, "--out", os.path.join(root, "day.png"), "--html", html])
    else:
        visualize.render_html(results, html)
    check(os.path.getsize(html) > 10_000 and len(visualize.build_panels(results)) >= 8, "phase 32: visualize")
    print(f"phase 32 predict on the card: {day_returns}; {files} with 28 keys; visualize wrote "
          f"{os.path.getsize(html)} bytes of HTML{' and the PNGs' if plots else ''}")
    return counts


def bounds(rbc_cfg, art_cfg, timing_days, ddpg_days, philox):
    """The least time of each kernel at the shape phase 7/12/19/24 times it;
    a Philox block takes ``philox`` lane instructions by pipe."""
    from smart_nanogrid_gym_torch.tools.profile_rbc import k7_uniform_floats

    B, T = BENCH_BATCH, rbc_cfg.steps_per_day
    out = {}
    N8, A8, F8 = rbc_cfg.num_chargers, rbc_cfg.num_actions, rbc_cfg.obs_dim
    N4, A4, F4 = art_cfg.num_chargers, art_cfg.num_actions, art_cfg.obs_dim
    actor8, critic8 = mlp_flops(F8, A8, 64, 64), mlp_flops(F8, 1, 64, 64)
    actor4 = mlp_flops(F4, A4, 64, 64)
    # K7: the explicit uniforms it reads (not the kinds the config never draws,
    # nor the departure while its window is shut), the battery and PV shift in;
    # rewards and final SoC out; the physics is not counted
    out["gen_rbc_day"] = bound(4 * (k7_uniform_floats(rbc_cfg, B) + 2 * B + T * B + N8 * B), 0)
    out["gen_rbc_multiday"] = bound(4 * 2 * B, 0, 0, philox_calls_per_day(rbc_cfg) * timing_days * B, philox)
    out["gen_policy_day"] = bound(4 * (T * 5 * N4 * B + 2 * B + T * B + T * A4 * B + N4 * B + B),
                                  actor4 * T * B)
    out["gen_policy_multiday"] = bound(4 * 3 * B, actor4 * T * timing_days * B, 0,
                                       philox_calls_per_day(art_cfg) * timing_days * B, philox)
    traj = 4 * (T * F8 * B + T * A8 * B + 3 * T * B + B)
    out["ppo_collect_day"] = bound(4 * (T * 5 * N8 * B + T * A8 * B + 2 * B) + traj, (actor8 + critic8) * T * B)
    normal_calls = 2 * ((A8 + 3) // 4) * T
    out["ppo_collect_day_seeded"] = bound(4 * B + traj, (actor8 + critic8) * T * B, 0,
                                          (philox_calls_per_day(rbc_cfg) + normal_calls + 1) * B, philox)
    # the sweep: forward of both torsos, and the backward's weight and input gradients
    bwd = lambda F, A: 2 * (64 * F + 2 * 64 * 64 + 2 * A * 64)  # noqa: E731
    per_sample = actor8 + critic8 + bwd(F8, A8) + bwd(F8, 1)
    P = 2 * (64 * F8 + 64 + 64 * 64 + 64) + A8 * 64 + A8 + 64 + 1 + A8
    G, M = 40, (B // 4) * T
    state_bytes = 4 * 3 * P * 2 + 4 * 4 * G
    out["ppo_sweep_streamed"] = bound(4 * T * B * (F8 + A8 + 3) + state_bytes, per_sample * G * M)
    out["ppo_sweep"] = bound(4 * G * M * (F8 + A8 + 3) + state_bytes, per_sample * G * M)

    # DDPG (400-300 ReLU torsos; the squash, OU and clip are not counted)
    H1, H2 = DDPG_HIDDEN
    ddpg4, ddpg8 = mlp_flops(F4, A4, H1, H2), mlp_flops(F8, A8, H1, H2)
    out["gen_policy_day_ddpg"] = bound(4 * (T * 5 * N4 * B + 2 * B + T * B + T * A4 * B + N4 * B + B), ddpg4 * T * B)
    out["gen_policy_multiday_ddpg"] = bound(4 * 3 * B, ddpg4 * T * ddpg_days * B, 0,
                                            philox_calls_per_day(art_cfg) * ddpg_days * B, philox)
    k9_out = 4 * (2 * T * F8 * B + T * A8 * B + T * B + B)
    out["ddpg_collect_day"] = bound(4 * (T * 5 * N8 * B + T * A8 * B + 2 * B) + k9_out, ddpg8 * T * B)
    out["ddpg_collect_day_seeded"] = bound(4 * (T * A8 * B + B) + k9_out, ddpg8 * T * B, 0,
                                           philox_calls_per_day(rbc_cfg) * B, philox)
    # the sweep: per sample and step, the forwards of the target actor, the target
    # critic, the critic, the actor and the critic on its action; the critic's
    # weight and input gradients; the input gradients back to the action; the
    # actor's weight and input gradients (multiply-adds, 2 operations each)
    FC = F8 + A8
    actor_fwd, critic_fwd = H1 * F8 + H2 * H1 + A8 * H2, H1 * FC + H2 * H1 + H2
    macs = (2 * actor_fwd + 3 * critic_fwd + critic_fwd + (H2 + H2 * H1) + (H2 + H2 * H1 + H1 * A8)
            + actor_fwd + (A8 * H2 + H2 * H1))
    Gd, Md = 24, 256
    P_actor, P_critic = actor_fwd + H1 + H2 + A8, critic_fwd + H1 + H2 + 1
    out["ddpg_sweep"] = bound(4 * Gd * Md * (2 * F8 + A8 + 2) + 4 * 2 * 4 * (P_actor + P_critic) + 4 * 2 * Gd,
                              2 * macs * Gd * Md)

    # K11a/K11b: the seven (T, N, B) tables, the carried column and mask, the
    # battery and PV shift in; rewards, (actions,) and the final column out
    def tables_in_bytes(N, A):
        return 4 * (7 * T * N * B + 2 * N * B + 2 * B + T * B + T * A * B + N * B)

    out["rbc_day_rollout"] = bound(tables_in_bytes(N8, 0), 0)
    out["policy_day_rollout"] = bound(tables_in_bytes(N4, A4), actor4 * T * B)

    # phase 24's rows: the 256x256 torso's products at the f32 rate, a bf16
    # row's products at the bf16 tensor-core rate, Philox on the SMs' pipes
    big8 = mlp_flops(F8, A8, *BIG_HIDDEN)
    days = NEW_ROW_DAYS
    philox8, philox4 = philox_calls_per_day(rbc_cfg) * B, philox_calls_per_day(art_cfg) * B
    d = days["gen_policy_multiday_bf16"]
    out["gen_policy_multiday_bf16"] = bound(4 * 3 * B, 0, actor4 * T * d * B, philox4 * d, philox)
    d = days["gen_policy_multiday_block"]
    out["gen_policy_multiday_block"] = bound(4 * 3 * B, big8 * T * B * d, 0, philox8 * d, philox)
    d = days["gen_policy_multiday_block_bf16"]
    out["gen_policy_multiday_block_bf16"] = bound(4 * 3 * B, 0, big8 * T * d * B, philox8 * d, philox)
    d = days["gen_policy_multiday_ddpg_bf16"]
    out["gen_policy_multiday_ddpg_bf16"] = bound(4 * 3 * B, 0, ddpg4 * T * d * B, philox4 * d, philox)
    out["gen_policy_day_block"] = bound(4 * (T * 5 * N8 * B + 2 * B + T * B + T * A8 * B + N8 * B + B),
                                        big8 * T * B)
    out["policy_day_rollout_block"] = bound(tables_in_bytes(N8, A8), big8 * T * B)
    out["ppo_sweep_streamed_bf16"] = bound(4 * T * B * (F8 + A8 + 3) + state_bytes, 0, per_sample * G * M)
    out["ppo_sweep_bf16"] = bound(4 * G * M * (F8 + A8 + 3) + state_bytes, 0, per_sample * G * M)
    out["ddpg_sweep_bf16"] = bound(4 * Gd * Md * (2 * F8 + A8 + 2) + 4 * 2 * 4 * (P_actor + P_critic) + 4 * 2 * Gd,
                                   0, 2 * macs * Gd * Md)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from smart_nanogrid_gym_torch.core import NanogridConfig, SmartNanogridTorch, make_params
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
        actor_weights, gen_policy_day, gen_policy_day_plain, gen_policy_multiday,
        gen_policy_multiday_plain)
    from smart_nanogrid_gym_torch.ops.gen_rollout import (
        gen_rbc_day, gen_rbc_day_plain, gen_rbc_multiday, gen_rbc_multiday_plain, kernel_traces)
    from smart_nanogrid_gym_torch.solvers.evaluator import evaluate_policy_at_scale
    from smart_nanogrid_gym_torch.solvers.networks import make_actor_policy_fn
    from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn
    from smart_nanogrid_gym_torch.utils.weights import load_actor_critic_npz, load_ddpg_actor_npz

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain engine's actor in full f32
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    rbc_cfg = NanogridConfig()  # the bench default: 8 chargers, PV + BESS, sparse, 1 h
    art_cfg = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True,
                             penalty_mode="sparse", time_interval=1.0)
    v2x_cfg = NanogridConfig(vehicle_to_everything=True)
    rbc_params = make_params(rbc_cfg, torch.float32, device)
    art_params = make_params(art_cfg, torch.float32, device)
    v2x_params = make_params(v2x_cfg, torch.float32, device)
    artifact = load_actor_critic_npz(ARTIFACT_NPZ).to(device)
    ddpg_art = load_ddpg_actor_npz(DDPG_ARTIFACT_NPZ, art_cfg).to(device)
    errors, times = {}, {}

    # ---- phase 1: build every kernel from the sources ----
    t0 = time.perf_counter()
    built = _build.build([_build.config_flags(c) for c in (rbc_cfg, art_cfg)]
                         + [_build.config_flags(rbc_cfg, BIG_HIDDEN)]
                         + [_build.sweep_flags(rbc_cfg.obs_dim, rbc_cfg.num_actions, 64, 64)]
                         + [_build.config_flags(c, DDPG_HIDDEN, "ddpg") for c in (rbc_cfg, art_cfg)]
                         + [_build.ddpg_sweep_flags(rbc_cfg.obs_dim, rbc_cfg.num_actions, *DDPG_HIDDEN)])
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s wall; "
          + ", ".join(f"{p.name} {s:.2f} s" for p, s in built))
    sweeps = (_build.sweep_library(rbc_cfg.obs_dim, rbc_cfg.num_actions, 64, 64, device),
              _build.ddpg_sweep_library(rbc_cfg.obs_dim, rbc_cfg.num_actions, *DDPG_HIDDEN, device))
    print(f"phase 1 cooperative grids: K3/K4 {sweeps[0].ngk_sweep_grid_blocks()} blocks, "
          f"K10 {sweeps[1].ngk_ddpg_grid_blocks()} blocks of 512 threads")
    philox, philox_opcodes = philox_pipes(built[0][0])
    print(f"phase 1 one Philox4x32-10 block in the SASS (cuobjdump -sass), lane instructions by pipe: {philox}; "
          f"opcodes {philox_opcodes}")
    rbc_lib, art_lib = _build.library(rbc_cfg, device), _build.library(art_cfg, device)
    design = {  # the library's own numbers (8ch b-pv)
        "gen_rbc_multiday": {"lanes_an_env": {B: rbc_lib.ngk_rbc_lanes(B) for B in (BENCH_BATCH, FULL_BATCH)},
                             "block_threads": rbc_lib.ngk_rbc_lane_threads()},
        "rbc_day_rollout": {"envs_a_block": rbc_lib.ngk_rbc_envs(), "ring_steps": rbc_lib.ngk_rbc_ring_depth()},
        "gen_rbc_day": {"envs_a_block": rbc_lib.ngk_rbc_envs(), "ring_steps": rbc_lib.ngk_gen_rbc_ring_depth(),
                        "ring_floats": rbc_lib.ngk_gen_rbc_ring_floats()},
        "gen_policy_day": {"envs_a_block": art_lib.ngk_collect_envs(), "smem_floats": art_lib.ngk_k6_smem_floats(0)},
    }
    # K5's and K11b's instances of the block actor (the artifact's 4ch 64x64, the bench's 256x256) and their libraries
    design_libraries = {"gen_policy_day": built[1][0], "policy_day_rollout": built[1][0],
                        "policy_day_rollout_block": built[2][0]}
    for name, lib in (("policy_day_rollout", art_lib),
                      ("policy_day_rollout_block", _build.library(rbc_cfg, device, BIG_HIDDEN))):
        design[name] = {"envs_a_block": lib.ngk_collect_envs(), "smem_floats": lib.ngk_k11b_smem_floats()}
    print(f"phase 1 K5/K7/K8/K11a/K11b layouts: {design}")
    for path, _ in built:
        with open(path.with_suffix(".log")) as fp:
            for line in fp:
                if "Compiling entry function" in line:
                    print("  ptxas:", line.split("'")[1] if "'" in line else line.strip())
                elif "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 2")
    # ---- phase 2: K7 against its twin, B=4096: the bench config (8 warps of
    # the ring block), and the main path's 4-charger config (its own 4-warp instance) ----
    u, pv = explicit_inputs(rbc_cfg, BENCH_BATCH, 0, device)
    batt = torch.full_like(pv, 0.5)
    traces = kernel_traces(rbc_params, device)
    u4, pv4 = explicit_inputs(art_cfg, BENCH_BATCH, 1, device)
    art_traces = kernel_traces(art_params, device)
    errors["gen_rbc_day"] = max(
        check_equal("phase 2 K7 gen_rbc_day (ring block, 8ch b-pv)", gen_rbc_day(rbc_cfg, rbc_params, u, pv),
                    gen_rbc_day_plain(rbc_cfg, traces, u, pv, batt), ("rewards", "soc_final")),
        check_equal("phase 2 K7 gen_rbc_day (ring block, 4ch b-pv, the main path's inputs)",
                    gen_rbc_day(art_cfg, art_params, u4, pv4),
                    gen_rbc_day_plain(art_cfg, art_traces, u4, pv4, torch.full_like(pv4, 0.5)),
                    ("rewards", "soc_final")))

    # ---- phase 3: K5 against its twin: the artifact, and a shifted 8-charger v2x actor ----
    k5_outputs = ("rewards", "actions", "soc_final", "batt_final")
    err_art = check_equal(
        "phase 3 K5 gen_policy_day (block actor, artifact 64x64, 4ch b-pv)",
        gen_policy_day(art_cfg, art_params, artifact, u4, pv4),
        gen_policy_day_plain(art_cfg, art_traces, actor_weights(art_cfg, artifact, device), u4, pv4,
                             torch.full_like(pv4, 0.5)), k5_outputs)
    v2x_actor = shifted_actor(v2x_cfg, 13, device)
    u8, pv8 = explicit_inputs(v2x_cfg, BENCH_BATCH, 2, device)
    v2x_got = gen_policy_day(v2x_cfg, v2x_params, v2x_actor, u8, pv8)
    err_v2x = check_equal(
        "phase 3 K5 gen_policy_day (block actor, shifted 64x64 actor, 8ch v2x-b-pv)", v2x_got,
        gen_policy_day_plain(v2x_cfg, kernel_traces(v2x_params, device),
                             actor_weights(v2x_cfg, v2x_actor, device), u8, pv8,
                             torch.full_like(pv8, 0.5)), k5_outputs)
    chargers = v2x_got[1][:, :v2x_cfg.num_chargers]
    check(bool((chargers > 0).any() and (chargers < 0).any()), "K5 v2x: not both charger branches ran")
    errors["gen_policy_day"] = max(err_art, err_v2x)

    # ---- phase 4: K8 and K6 element for element against their Philox twins ----
    k8_got = (gen_rbc_multiday(rbc_cfg, rbc_params, 3, 11, 1024),)
    k8_want = (gen_rbc_multiday_plain(rbc_cfg, traces, 3, 11, 1024),)
    errors["gen_rbc_multiday"] = compare("K8 gen_rbc_multiday (B=1024, 3 days)", k8_got, k8_want, rtol=1e-5,
                                         atol=1e-3)
    check_equal("K8 gen_rbc_multiday (B=1024, 3 days)", k8_got, k8_want, ("stats",))
    check_equal(f"K8 gen_rbc_multiday (B={FULL_BATCH}, 2 days)", (gen_rbc_multiday(rbc_cfg, rbc_params, 2, 13,
                                                                                    FULL_BATCH),),
                (gen_rbc_multiday_plain(rbc_cfg, traces, 2, 13, FULL_BATCH),), ("stats",))
    art_weights = actor_weights(art_cfg, artifact, device)
    k6_got = (gen_policy_multiday(art_cfg, art_params, artifact, 3, 12, 1024),)
    k6_want = (gen_policy_multiday_plain(art_cfg, art_traces, art_weights, 3, 12, 1024),)
    errors["gen_policy_multiday"] = compare("K6 gen_policy_multiday (B=1024, 3 days)", k6_got, k6_want,
                                            rtol=2e-4, atol=1e-2)
    check_equal("K6 gen_policy_multiday (64x64 on the block actor)", k6_got, k6_want, ("stats",))
    torch.cuda.synchronize()

    # ---- phases 8-10: the training kernels K1-K4 against their twins, and K2's draws ----
    from smart_nanogrid_gym_torch.solvers.ppo import PPOConfig, PPOLearner

    learner0 = PPOLearner(rbc_cfg, PPOConfig(collect_impl="kernel", sweep_impl="kernel"), device=device)
    state0 = learner0.init(7, rbc_params, BENCH_BATCH)
    normals, batt_k1 = collect_twin_checks(rbc_cfg, rbc_params, state0.params, u, pv, device, errors)
    k2_statistics(rbc_cfg, rbc_params, state0.params, device)
    featlane, gathered = update_inputs(learner0, rbc_cfg, rbc_params, state0)
    sweep_twin_checks(learner0, featlane, gathered, state0, errors)
    torch.cuda.synchronize()

    # ---- the evaluation path, through the entry points a user calls ----
    _build.reset_launch_counts()
    # paired evaluation of the RBC and the artifact on the same explicit days (K7, K5)
    rbc_rewards, _ = gen_rbc_day(art_cfg, art_params, u4, pv4)
    ppo_rewards, actions, _, _ = gen_policy_day(art_cfg, art_params, artifact, u4, pv4)
    # the bench's RBC multiday run (K8), at the bench batch and at a batch that fills the card
    scale = {}
    for batch, days in ((BENCH_BATCH, 2000), (131_072, 100)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = gen_rbc_multiday(rbc_cfg, rbc_params, days, 1000, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        scale[batch] = (stats, days, seconds)
        rate = batch * days * rbc_cfg.steps_per_day / seconds
        print(f"phase 5 K8 at scale: B={batch} x {days} days in {seconds:.4f} s "
              f"(first call, build excluded) = {rate:.4e} env-steps/s on {card}")
    # the artifact at scale through the evaluator (K6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at_scale = evaluate_policy_at_scale(art_cfg, art_params, artifact, num_days=256,
                                        batch=BENCH_BATCH, seed=0)
    seconds = time.perf_counter() - t0
    print(f"phase 6 evaluate_policy_at_scale: {at_scale} in {seconds:.4f} s "
          f"= {at_scale['total_days'] * 24 / seconds:.4e} env-steps/s on {card}")
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"main path launches: {launches}")
    for name in REPLACES:
        check(launches.get(name, 0) >= 1, f"kernel {name} was not launched on the main path")

    # ---- what came out is right ----
    for name, x in (("rbc rewards", rbc_rewards), ("ppo rewards", ppo_rewards), ("actions", actions)):
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite")
    check(rbc_rewards.shape == (24, BENCH_BATCH) and actions.shape == (24, 5, BENCH_BATCH),
          "paired day shapes")
    low, high = (torch.as_tensor(b, device=device)[None, :, None] for b in art_cfg.action_bounds())
    check(bool(((actions >= low) & (actions <= high)).all()), "actions outside the action box")
    paired_ppo, paired_rbc = float(ppo_rewards.sum(0).mean()), float(rbc_rewards.sum(0).mean())
    print(f"paired explicit days (B={BENCH_BATCH}): ppo {paired_ppo:.4f}, rbc {paired_rbc:.4f}")
    check(paired_ppo > paired_rbc, "the artifact should beat the RBC on paired days")

    env_rbc = SmartNanogridTorch(rbc_cfg)
    rbc_policy = make_rbc_policy_fn(rbc_cfg)
    oracle_days = 16

    def k8_draw(attempt):
        if attempt == 0:
            stats, days, _ = scale[BENCH_BATCH]
        else:
            days = 2000
            stats = gen_rbc_multiday(rbc_cfg, rbc_params, days, 1000 + attempt, BENCH_BATCH)
        return mean_std(stats, days * BENCH_BATCH)

    def rbc_oracle(attempt):
        gen = torch.Generator(device=device).manual_seed(77 + attempt)
        sums = torch.zeros((), dtype=torch.float64, device=device)
        sq = torch.zeros((), dtype=torch.float64, device=device)
        for _ in range(oracle_days):
            state, obs = env_rbc.reset_batch(rbc_params, BENCH_BATCH, gen)
            _, _, (_, rewards, _, _) = env_rbc.rollout_day(rbc_params, state, rbc_policy, obs, gen)
            ret = rewards.sum(0).double()
            sums, sq = sums + ret.sum(), sq + (ret * ret).sum()
        n = oracle_days * BENCH_BATCH
        mean = float(sums) / n
        return mean, math.sqrt(max(float(sq) / n - mean * mean, 0.0))

    stats_match("phase 5 K8 vs plain engine (RBC, 4096 x 16 fresh days)", k8_draw, rbc_oracle,
                2000 * BENCH_BATCH, oracle_days * BENCH_BATCH)

    art_env = SmartNanogridTorch(art_cfg)
    art_policy = make_actor_policy_fn(art_cfg, artifact)
    k6_days = 256

    def k6_draw(attempt):
        if attempt == 0:
            return at_scale["mean_day_return"], at_scale["std_day_return"]
        res = evaluate_policy_at_scale(art_cfg, art_params, artifact, k6_days, BENCH_BATCH, attempt)
        return res["mean_day_return"], res["std_day_return"]

    def k6_oracle(attempt):
        """Fresh days with the battery carried from one day to the next, as K6 does."""
        gen = torch.Generator(device=device).manual_seed(99 + attempt)
        batt = torch.full((BENCH_BATCH,), 0.5, device=device)
        sums = sq = 0.0
        for _ in range(k6_days):
            state, obs = art_env.reset_batch(art_params, BENCH_BATCH, gen, batt_soc=batt)
            final, _, (_, rewards, _, _) = art_env.rollout_day(art_params, state, art_policy, obs, gen)
            batt = final.batt_soc
            ret = rewards.sum(0).double()
            sums, sq = sums + ret.sum(), sq + (ret * ret).sum()
        n = k6_days * BENCH_BATCH
        mean = float(sums) / n
        return mean, math.sqrt(max(float(sq) / n - mean * mean, 0.0))

    stats_match("phase 6 K6 vs plain engine (artifact, 4096 x 256 days, battery carried)",
                k6_draw, k6_oracle, k6_days * BENCH_BATCH, k6_days * BENCH_BATCH)

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 11")
    # ---- phase 11: the training path ----
    learner, trained_state, train_launches = training_main_path(rbc_cfg, rbc_params, u, pv, device, card)

    # ---- phases 13-16: the DDPG kernels against their twins, K9's draws ----
    d_learner, d_leaves, d_ou, d_batt, k9_day = ddpg_twin_checks(art_cfg, art_params, ddpg_art, u4, pv4, rbc_cfg,
                                                                 rbc_params, u, pv, device, errors)
    k9_statistics(rbc_cfg, rbc_params, d_learner, d_leaves, device)
    sweep_args = ddpg_sweep_twin_check(rbc_cfg, rbc_params, d_learner, k9_day, device, errors)
    torch.cuda.synchronize()

    # ---- phases 17-18: the DDPG evaluation and training paths ----
    ddpg_eval_launches = ddpg_evaluation_main_path(art_cfg, art_params, ddpg_art, u4, pv4, device, card)
    ddpg_learner, ddpg_state, ddpg_train_launches, ddpg_ms = ddpg_training_main_path(
        rbc_cfg, rbc_params, art_cfg, art_params, u, pv, device, card)

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 20")
    # ---- phases 20-23: K11a/K11b against their twins, then the stateful-env path ----
    tables_in_checks(rbc_cfg, rbc_params, art_cfg, art_params, artifact, v2x_cfg, v2x_params, device, errors)
    torch.cuda.synchronize()
    tables_launches = stateful_env_main_path(rbc_cfg, rbc_params, art_cfg, art_params, artifact, device, card)

    # ---- phases 24-27: the bf16 variants and the 256x256 actor against their twins, then their paths ----
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 24")
    big = shifted_bias_actor(rbc_cfg, BIG_HIDDEN, 42, device)
    bf16_rows(rbc_cfg, rbc_params, art_cfg, art_params, artifact, ddpg_art, big, u, pv, featlane, gathered, state0,
              learner0, sweep_args, device, card, errors, times)
    torch.cuda.synchronize()
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 25")
    big_launches = big_evaluation_main_path(rbc_cfg, rbc_params, art_cfg, art_params, ddpg_art, big, u, pv, device,
                                            card)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 26")
    bf16_ppo_launches, bf16_ddpg_launches = bf16_training_main_path(rbc_cfg, rbc_params, device, card)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 7")

    # ---- phase 7: each kernel and its twin, timed on the card ----
    timing_days = 20
    cases = {
        "gen_rbc_day": (f"B={BENCH_BATCH}, 1 day, 8ch b-pv",
                        lambda: gen_rbc_day(rbc_cfg, rbc_params, u, pv),
                        lambda: gen_rbc_day_plain(rbc_cfg, traces, u, pv, batt), 20),
        "gen_rbc_multiday": (f"B={BENCH_BATCH}, {timing_days} days, 8ch b-pv",
                             lambda: gen_rbc_multiday(rbc_cfg, rbc_params, timing_days, 5, BENCH_BATCH),
                             lambda: gen_rbc_multiday_plain(rbc_cfg, traces, timing_days, 5, BENCH_BATCH),
                             5),
        "gen_policy_day": (f"B={BENCH_BATCH}, 1 day, artifact 4ch b-pv",
                           lambda: gen_policy_day(art_cfg, art_params, artifact, u4, pv4),
                           lambda: gen_policy_day_plain(art_cfg, art_traces, art_weights, u4, pv4,
                                                        torch.full_like(pv4, 0.5)), 20),
        "gen_policy_multiday": (f"B={BENCH_BATCH}, {timing_days} days, artifact 4ch b-pv",
                                lambda: gen_policy_multiday(art_cfg, art_params, artifact, timing_days,
                                                            5, BENCH_BATCH),
                                lambda: gen_policy_multiday_plain(art_cfg, art_traces, art_weights,
                                                                  timing_days, 5, BENCH_BATCH), 5),
    }
    plain_out = {}
    for name, (shape, kernel, plain, repeats) in cases.items():
        plain_ms, plain_out[name] = once_ms(plain)
        times[name] = (shape, cuda_ms(kernel, repeats), plain_ms)
        print(f"phase 7 {name} ({shape}): kernel {times[name][1]:.4f} ms, "
              f"plain twin {times[name][2]:.4f} ms on {card}")
    # K8 at the main path's batch bit-equal to its twin, and its device time
    kernel = cases["gen_rbc_multiday"][1]
    check_equal(f"phase 7 K8 gen_rbc_multiday (B={BENCH_BATCH}, {timing_days} days)", (kernel(),),
                (plain_out["gen_rbc_multiday"],), ("stats",))
    k8_device = profile_kernels(kernel, "gen_rbc_multiday_kernel", 5)
    print(f"phase 7 gen_rbc_multiday: {k8_device[0]:.4f} ms of device time per call (profiler) on {card}")
    # K6 at the main path's batch: the 64x64 block actor bit-equal to its twin
    check_equal(f"phase 7 K6 gen_policy_multiday (B={BENCH_BATCH}, {timing_days} days)",
                (cases["gen_policy_multiday"][1](),), (plain_out["gen_policy_multiday"],), ("stats",))
    tables_in_seen = tables_in_timings(rbc_cfg, rbc_params, art_cfg, art_params, artifact, device, card, times)

    training_timings(learner, rbc_cfg, rbc_params, trained_state, featlane, gathered, u, pv, normals,
                     batt_k1, card, times)
    ddpg_days = 4
    ddpg_timings(art_cfg, art_params, ddpg_art, u4, pv4, rbc_cfg, rbc_params, ddpg_learner, d_leaves, u, pv, d_ou,
                 d_batt, sweep_args, ddpg_state, card, times, ddpg_days)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 28")
    device_times, instances = bf16_device_times(rbc_cfg, rbc_params, art_cfg, art_params, artifact, ddpg_art, big, u, pv, u4,
                                     pv4, featlane, gathered, trained_state, learner, sweep_args, card, timing_days)
    for name, seen in (("gen_rbc_multiday", k8_device), *tables_in_seen.items()):
        device_times[name], instances[name] = seen

    library = {name: k10_products_ms(sweep_args, dtype) for name, dtype in
               (("ddpg_sweep", torch.float32), ("ddpg_sweep_bf16", BF16))}
    for name, ms in library.items():
        print(f"K10 yardstick {name}: the 28 products of each of 24 steps as torch.matmul (cuBLAS, products "
              f"only) {ms:.4f} ms per update, the kernel {times[name][1]:.4f} ms (whole update) on {card}")
    for dtype, names in ((torch.float32, ("ppo_sweep_streamed", "ppo_sweep")),
                         (BF16, ("ppo_sweep_streamed_bf16", "ppo_sweep_bf16"))):
        ms = ppo_products_ms(gathered, (64, 64), dtype)  # K3's and K4's updates have the same products
        for name in names:
            library[name] = ms
            print(f"K3/K4 yardstick {name}: the 16 products of each of 40 steps as torch.matmul (cuBLAS, products "
                  f"only) {ms:.4f} ms per update, the kernel {times[name][1]:.4f} ms (whole update) on {card}")
    for name, cfg, hidden, days, dtype in (
            ("gen_policy_multiday", art_cfg, artifact.hidden, timing_days, torch.float32),
            ("gen_policy_multiday_bf16", art_cfg, artifact.hidden, NEW_ROW_DAYS["gen_policy_multiday_bf16"], BF16),
            ("gen_policy_day", art_cfg, artifact.hidden, 1, torch.float32),
            ("gen_policy_day_ddpg", art_cfg, DDPG_HIDDEN, 1, torch.float32),
            ("gen_policy_day_block", rbc_cfg, BIG_HIDDEN, 1, torch.float32),
            ("gen_policy_multiday_ddpg", art_cfg, DDPG_HIDDEN, ddpg_days, torch.float32),
            ("gen_policy_multiday_ddpg_bf16", art_cfg, DDPG_HIDDEN, NEW_ROW_DAYS["gen_policy_multiday_ddpg_bf16"], BF16),
            ("gen_policy_multiday_block", rbc_cfg, BIG_HIDDEN, NEW_ROW_DAYS["gen_policy_multiday_block"],
             torch.float32),
            ("gen_policy_multiday_block_bf16", rbc_cfg, BIG_HIDDEN, NEW_ROW_DAYS["gen_policy_multiday_block_bf16"],
             BF16),
            ("policy_day_rollout", art_cfg, artifact.hidden, 1, torch.float32),
            ("policy_day_rollout_block", rbc_cfg, BIG_HIDDEN, 1, torch.float32)):
        library[name] = k6_products_ms(cfg, hidden, days, dtype)
        print(f"K5/K6/K11b yardstick {name}: the actor's 3 products of each of {days} x 24 steps as torch.matmul at "
              f"B={BENCH_BATCH} (cuBLAS {'bf16' if dtype == BF16 else 'f32'}, products only) {library[name]:.4f} "
              f"ms, the kernel's row {times[name][1]:.4f} ms ({times[name][0]}) on {card}")
    library["ppo_collect_day"] = collect_products_ms(rbc_cfg, (64, 64), True, device)
    library["ppo_collect_day_seeded"] = collect_products_ms(rbc_cfg, (64, 64), True, device)
    library["ddpg_collect_day_seeded"] = collect_products_ms(rbc_cfg, DDPG_HIDDEN, False, device)
    library["ddpg_collect_day"] = library["ddpg_collect_day_seeded"]  # K9's explicit day: the same products
    for name, label in (("ppo_collect_day", "K1: the actor-critic's 6"),
                        ("ppo_collect_day_seeded", "K2: the actor-critic's 6"),
                        ("ddpg_collect_day", "K9: the 400-300 actor's 3"),
                        ("ddpg_collect_day_seeded", "K9 seeded: the 400-300 actor's 3")):
        print(f"{label} products of each of 24 steps as torch.matmul at B={BENCH_BATCH} (cuBLAS f32, products "
              f"only) {library[name]:.4f} ms per day, the kernel {times[name][1]:.4f} ms (wrapper, whole day) "
              f"on {card}")

    # ---- phases 29-32: the CLIs through their main(argv) on the card ----
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 29")
    cli_root = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(cli_root, ignore_errors=True)
    ppo_cli = cli_train_ppo_path(cli_root, card)
    ddpg_cli = cli_train_ddpg_path(cli_root, card)
    eval_cli = cli_evaluate_path(cli_root, art_cfg, art_params, artifact)
    cli_predict_path(cli_root)
    cli_counts = {**ppo_cli, **ddpg_cli, **eval_cli}

    jax_modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
    check(not jax_modules, f"the port loaded JAX modules: {jax_modules[:5]}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    least = bounds(rbc_cfg, art_cfg, timing_days, ddpg_days, philox)
    T8, F8, A8 = rbc_cfg.steps_per_day, rbc_cfg.obs_dim, rbc_cfg.num_actions
    for name, ops in (("ppo_collect_day_seeded", (mlp_flops(F8, A8, 64, 64) + mlp_flops(F8, 1, 64, 64)) * T8),
                      ("ddpg_collect_day_seeded", mlp_flops(F8, A8, *DDPG_HIDDEN) * T8),
                      ("policy_day_rollout", mlp_flops(art_cfg.obs_dim, art_cfg.num_actions, 64, 64) * T8),
                      ("policy_day_rollout_block", mlp_flops(F8, A8, *BIG_HIDDEN) * T8)):
        # without FMA a multiply and an add are an instruction each, at half the FMA rate
        print(f"{name}: FMA-free floor of the products {ops * BENCH_BATCH / (F32_OPS_PER_S / 2) * 1e3:.4f} ms "
              f"(B={BENCH_BATCH}), bound {least[name][0]:.4f} ms ({least[name][1]}, FMA counted)")
    kernels = []
    # each kernel's launches in the run of the main path it belongs to
    paths = ((TRAIN_REPLACES, train_launches), (REPLACES, launches), (DDPG_REPLACES, ddpg_eval_launches),
             (DDPG_TRAIN_REPLACES, ddpg_train_launches), (TABLES_REPLACES, tables_launches),
             (BIG_REPLACES, big_launches), (BF16_TRAIN_REPLACES, bf16_ppo_launches),
             (BF16_DDPG_REPLACES, bf16_ddpg_launches))
    sources = {name: SWEEP_SOURCE for name in ("ppo_sweep_streamed", "ppo_sweep", *BF16_TRAIN_REPLACES)}
    sources.update({name: DDPG_SWEEP_SOURCE for name in ("ddpg_sweep", *BF16_DDPG_REPLACES)})
    for name, replaces, count in ((n, r, path_launches[n]) for table, path_launches in paths
                                  for n, r in table.items()):
        kernels.append({
            "name": name, "route": "cuda", "source": sources.get(name, DAY_SOURCE),
            "replaces": replaces, "launches": count, "max_abs_err": errors[name], "ms": times[name][1],
            "plain_ms": times[name][2], "bound_ms": least[name][0], "bound_by": least[name][1],
            "library_ms": library.get(name), "shape": times[name][0], "kernel": instances.get(name),
            "device_ms": device_times.get(name),
        })
        if name in cli_counts:  # the kernel's launches in phases 29-31, the CLIs' runs
            kernels[-1]["cli_launches"] = cli_counts[name]
        if name in design:
            kernels[-1]["design"] = design[name]
            kernels[-1]["ptxas"] = ptxas_line(design_libraries.get(name, built[0][0]), instances[name])
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
