"""Device time of the RBC day kernels K7, K8 and K11a, and of the other day kernels of their libraries, on one CUDA card.

Run from the root of a checkout (it builds the kernels first):

    python3 smart_nanogrid_gym_torch/tools/profile_rbc.py [--root DIR] [--check] [--ring] [--lanes] [--stage]

``--root`` imports ``smart_nanogrid_gym_torch`` from another checkout (for
example the parent commit unpacked under ``build/``), so that one call can time
two versions in turn on the same card (parent, change, change, parent); by
default the checkout that holds this file.  On the 8-charger bench config
(PV + BESS, sparse, 1 h) it times ``gen_rbc_multiday`` (K8) over 20 days at
B=4096 and over 100 days at B=131,072, and K11a on the day tables of a card
reset (``launch_rbc_day``, the tables built beforehand) at B=4096 and
131,072; then, at B=4096, the other kernels of the same libraries: K7
(``gen_rbc_day``, one explicit-uniform day), K5 with the committed PPO
artifact (4 chargers, 64x64), and K11b with the artifact and with the
bench's 256x256 torso (biases +0.05, bench.py:403-414), each on the tables
of a fresh (card reset) and of a continued state (a plain RBC day later).
Per row the device milliseconds per launch by ``torch.profiler`` (the
kernels whose name holds the row's kernel, so that a parent's design is
timed too: any of K7's holds ``gen_rbc_day``, K5's ``gen_policy_day`` and
K11b's ``policy_day_rollout``) over a few launches after a warm-up, and for
K8, K11a and K7 the rate they imply (env-steps/s; K11a's table bytes/s,
K7's of the uniforms it reads: :func:`k7_uniform_floats`); K7's, K5's and
K11b's rows also by CUDA events around bare launches (K11b's of the block
its wrapper packs).

``--check`` first holds K8, K11a, K7 and K5 against their plain twins with
``torch.equal`` at the main path's shapes (K8 at B=4096 x 20 days and
131,072 x 2 days; K11a on a fresh and a continued state at B=4096 and on a
card reset at 131,072; K7 on the bench config and on the artifact's 4-charger
one, and K5 with the PPO artifact, at B=4096) and prints
each one's max abs difference; it uses only the package's public functions,
so it runs on a parent checkout too.

``--ring`` (this checkout only) also times K11a at both batches on
libraries built from copies of the sources under ``build/rbc_variants/``
whose ring keeps a fixed number of steps in flight (2, 3, 4, 6 and 13; two
steps hold about what a one-step register prefetch would), and ``--lanes``
K8 at B=4096 to 131,072 on copies whose ``kernels.cu`` launches it with a
fixed number of lanes an env (1, and the full layout's 8), each beside the
package's and checked to give the same outputs; each ``--lanes`` reading
is taken twice, by the profiler (through the wrapper) and by CUDA events
around bare launches queued back to back (``torch.cuda.Event``).  ``--stage``
(this checkout only) times K11b's rows on copies of the sources whose
``store_tables`` stages the next step's table rows by ``cp.async`` (K11a's
4-byte asynchronous copies, waited for before the step's first barrier) in
place of loads through registers, beside the package's, in turns (package,
copy, copy, package), each checked to give the package's outputs.  ``--sass``
reads the 8-charger library's K7 and K11a instances by ``cuobjdump -sass``
(for the root's package, so a parent too): each one's instructions, and
those of its step loop (the longest backward branch) with the sum of their
stall counts from the scheduler's control bits, the cycles a warp waits
between issues whatever the data.  The last line is one JSON object with
the numbers, the card's name and power limit, and the root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

BATCH, FULL_BATCH = 4096, 131_072
DEPTH_ANCHOR = "  static constexpr int DEPTH = FIT < 2 ? 2 : (FIT > kRbcMaxDepth ? kRbcMaxDepth : FIT);"
LANES_ANCHOR = "inline int rbc_lanes(int B) { return B >= kRbcFillThreads ? 1 : kRbcFull; }"
RING_DEPTHS = (2, 3, 4, 6, 13)
LANES = {1: "1", 8: "kRbcFull"}  # lanes an env: what the patched rbc_lanes returns (8 chargers)
# K11b's staging of a step's table rows: loads through registers, and the --stage copy's cp.async
STAGE_ANCHOR = """  float v[ROUNDS];
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int r = r0 + q * WARPS;  // k * N + n
    v[q] = r < ROWS ? __ldg(src + (r / N) * plane + (r % N) * B) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int r = r0 + q * WARPS;
    if (r < ROWS) slot[r * E + e] = v[q];
  }
"""
STAGE_ASYNC = """#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int r = r0 + q * WARPS;
    if (r < ROWS) async_copy_f32(slot + r * E + e, src + (r / N) * plane + (r % N) * B, true);
  }
  async_commit();
  async_wait<0>();
"""
# batch: days, about 2e7 env-steps a launch
LANE_BATCHES = {4096: 200, 8192: 100, 12288: 70, 16384: 50, 20480: 40, 24576: 35, 32768: 25, 65536: 15,
                131072: 10}


def k7_uniform_floats(config, batch: int) -> int:
    """The uniforms K7 must read of its ``(T, 5, N, B)`` input: the arrival
    and SoC kinds every step, the capacity and the requested SoC where the
    config draws them, and the departure only in the steps whose window is
    open (``StepDraws::fill``, ``ops/gen_rollout.py::gen_rbc_step``)."""
    T, dt = config.steps_per_day, config.time_interval
    k4, k10, k1 = int(4 / dt), int(10 / dt), int(1 / dt)
    kinds = 2 + int(config.different_battery_capacities) + int(config.requested_state_of_charge)
    open_steps = sum(1 for t in range(T) if t + k4 < min(t + k10, T + k1))
    return (kinds * T + open_steps) * config.num_chargers * batch


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;\s*/\* 0x[0-9a-f]{16} \*/")


def sass_loop(text: str, kernel: str) -> dict[str, int]:
    """``kernel``'s instructions in a library's ``cuobjdump -sass`` listing,
    and those of its longest loop (the range of its longest backward branch)
    with their stall counts summed (bits 41-44 of an instruction's second word)."""
    body = text[text.index(f"Function : {kernel}"):]
    body = body[:body.find("Function : ", 1) if "Function : " in body[1:] else len(body)].splitlines()
    ins = []  # (address, instruction, stall cycles)
    for line, control in zip(body, body[1:]):
        m = SASS_LINE.search(line)
        if m:
            word = int(re.search(r"0x([0-9a-f]{16})", control).group(1), 16)
            ins.append((int(m.group(1), 16), m.group(2), (word >> 41) & 0xF))
    back = [(int(m.group(1), 16), a) for a, op, _ in ins if (m := re.search(r"BRA (?:`\(\S+\) )?0x([0-9a-f]+)", op))
            and int(m.group(1), 16) < a]
    head, tail = max(back, key=lambda r: r[1] - r[0])
    loop = [x for x in ins if head <= x[0] <= tail]
    return {"instructions": len(ins), "loop_instructions": len(loop), "loop_stall_cycles": sum(x[2] for x in loop)}


def device_ms(torch, fn, kernel: str, repeats: int) -> float:
    """Mean device milliseconds per launch of the kernels whose name holds
    ``kernel``, over the launches the profiler recorded in ``repeats`` calls
    (one launch each)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    us, launches = sum(e.self_device_time_total for e in events), sum(e.count for e in events)
    if us <= 0 or launches == 0:
        raise RuntimeError(f"the profiler recorded no device time for {kernel}")
    if launches != repeats:
        print(f"  (the profiler recorded {launches} launches of {kernel} in {repeats} calls)")
    return us / launches / 1e3


def event_ms(torch, fn, repeats: int) -> float:
    """Milliseconds per call of ``fn`` (one launch, no host sync) by CUDA
    events around ``repeats`` calls queued back to back, after a warm-up
    call: the device time per launch and the gaps between launches."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def variants(spec, kind: str) -> dict[int, ctypes.CDLL]:
    """The ring-depth (``kind`` "ring") or lane-count ("lanes") variants,
    built in parallel from copies of the sources under ``build/rbc_variants/``."""
    from concurrent.futures import ThreadPoolExecutor

    from smart_nanogrid_gym_torch.ops import _build

    if kind == "ring":
        jobs = {d: ("day_step.cuh", DEPTH_ANCHOR, f"  static constexpr int DEPTH = {d};") for d in RING_DEPTHS}
    else:
        jobs = {n: ("kernels.cu", LANES_ANCHOR, f"inline int rbc_lanes(int) {{ return {text}; }}")
                for n, text in LANES.items()}

    def build(key, source, anchor, text):
        return _build.patched_library(spec, _build.BUILD_DIR.parent / "rbc_variants" / f"{kind}{key}", {
            source: lambda code: _build.replace_once(code, anchor, text, source)})

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = {k: pool.submit(build, k, *job) for k, job in jobs.items()}
        return {k: f.result() for k, f in built.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--check", action="store_true", help="K8 and K11a against their twins, bit for bit")
    parser.add_argument("--ring", action="store_true", help="K11a with fixed ring depths (this checkout only)")
    parser.add_argument("--lanes", action="store_true", help="K8 with fixed lanes an env (this checkout only)")
    parser.add_argument("--stage", action="store_true", help="K11b staging by cp.async (this checkout only)")
    parser.add_argument("--sass", action="store_true", help="K7's and K11a's step loops by cuobjdump -sass")
    args = parser.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_rbc needs a CUDA device")
    from unittest import mock

    from smart_nanogrid_gym_torch.core import NanogridConfig, SmartNanogridTorch, fused_day_rollout, make_params
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import (
        actor_weights, gen_policy_day, gen_policy_day_plain, policy_library)
    from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_day, gen_rbc_multiday, kernel_traces
    from smart_nanogrid_gym_torch.ops.policy_rollout import launch_policy_day
    from smart_nanogrid_gym_torch.ops.rollout import launch_rbc_day, state_tables
    from smart_nanogrid_gym_torch.solvers.networks import ActorCritic
    from smart_nanogrid_gym_torch.solvers.rbc import make_rbc_policy_fn
    from smart_nanogrid_gym_torch.utils.weights import load_actor_critic_npz

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", torch.cuda.current_device())  # the index: _build.launch compares devices
    cfg = NanogridConfig()
    art_cfg = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True, penalty_mode="sparse",
                             time_interval=1.0)
    _build.build([_build.config_spec(cfg), _build.config_spec(art_cfg), _build.config_spec(cfg, (256, 256))])
    T, N = cfg.steps_per_day, cfg.num_chargers
    params, art_params = make_params(cfg, torch.float32, dev), make_params(art_cfg, torch.float32, dev)
    traces, art_traces = kernel_traces(params, dev), kernel_traces(art_params, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = {b: state_tables(cfg, params, SmartNanogridTorch(cfg).reset_batch(params, b, gen)[0])
              for b in (BATCH, FULL_BATCH)}

    def given(config, config_params):  # the tables of a card reset and of the same envs a plain RBC day later
        fresh, _ = SmartNanogridTorch(config).reset_batch(config_params, BATCH, gen)
        continued, _ = fused_day_rollout(config, config_params, fresh, make_rbc_policy_fn(config), generator=gen)
        return {kind: state_tables(config, config_params, state)
                for kind, state in (("fresh", fresh), ("continued", continued))}

    art_tables, big_tables = given(art_cfg, art_params), given(cfg, params)
    u = torch.rand((T, 5, N, BATCH), generator=gen, device=dev)
    pv = torch.floor(torch.rand(BATCH, generator=gen, device=dev) * 181) / 100
    u4 = torch.rand((T, 5, art_cfg.num_chargers, BATCH), generator=gen, device=dev)
    ppo = load_actor_critic_npz(str(Path(root) / "artifacts" / "PPO-b-pv-bounded-sparse-4ch-1h" / "108134400.npz"))
    ppo = ppo.to(dev)
    big = ActorCritic(cfg.obs_dim, cfg.num_actions, (256, 256), generator=torch.Generator().manual_seed(42))
    with torch.no_grad():
        for p in big.parameters():
            if p.dim() == 1:
                p.add_(0.05)
    big = big.to(dev)
    art_w, big_w = actor_weights(art_cfg, ppo, dev), actor_weights(cfg, big, dev)
    table_bytes = {b: 4 * 7 * T * N * b for b in (BATCH, FULL_BATCH)}
    uniform_bytes = 4 * k7_uniform_floats(cfg, BATCH)

    rows = {
        f"K8 gen_rbc_multiday B={BATCH} x 20 days": (
            lambda: gen_rbc_multiday(cfg, params, 20, 5, BATCH), "gen_rbc_multiday_kernel", 5, BATCH * 20 * T),
        f"K8 gen_rbc_multiday B={FULL_BATCH} x 100 days": (
            lambda: gen_rbc_multiday(cfg, params, 100, 5, FULL_BATCH), "gen_rbc_multiday_kernel", 3,
            FULL_BATCH * 100 * T),
        f"K11a rbc_day_rollout B={BATCH}": (
            lambda: launch_rbc_day(cfg, traces, tables[BATCH]), "rbc_day_rollout_kernel", 20, BATCH * T),
        f"K11a rbc_day_rollout B={FULL_BATCH}": (
            lambda: launch_rbc_day(cfg, traces, tables[FULL_BATCH]), "rbc_day_rollout_kernel", 10, FULL_BATCH * T),
        f"K7 gen_rbc_day B={BATCH}": (lambda: gen_rbc_day(cfg, params, u, pv), "gen_rbc_day", 20, BATCH * T),
        f"K5 gen_policy_day 64x64 B={BATCH}": (
            lambda: gen_policy_day(art_cfg, art_params, ppo, u4, pv), "gen_policy_day", 20, None),
    }
    # K11b: (config, traces, weights, hidden, tables by state) of each torso
    k11b = {"policy_day_rollout 64x64": (art_cfg, art_traces, art_w, ppo.hidden, art_tables),
            "policy_day_rollout_block 256x256": (cfg, traces, big_w, (256, 256), big_tables)}
    print(f"card: {card}; package from {root}")
    result = {}
    if args.check:
        from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_multiday_plain
        from smart_nanogrid_gym_torch.ops.rollout import rbc_day_rollout, rbc_day_rollout_plain

        fresh, _ = SmartNanogridTorch(cfg).reset_batch(params, BATCH, gen)
        continued, _ = fused_day_rollout(cfg, params, fresh, make_rbc_policy_fn(cfg), generator=gen)
        big_state, _ = SmartNanogridTorch(cfg).reset_batch(params, FULL_BATCH, gen)
        from smart_nanogrid_gym_torch.ops.gen_rollout import gen_rbc_day_plain

        batt = torch.full_like(pv, 0.5)
        checks = {f"K7 B={BATCH}": (lambda: gen_rbc_day(cfg, params, u, pv),
                                    lambda: gen_rbc_day_plain(cfg, traces, u, pv, batt)),
                  f"K7 4ch B={BATCH}": (lambda: gen_rbc_day(art_cfg, art_params, u4, pv),
                                        lambda: gen_rbc_day_plain(art_cfg, art_traces, u4, pv, batt)),
                  f"K5 64x64 B={BATCH}": (lambda: gen_policy_day(art_cfg, art_params, ppo, u4, pv),
                                          lambda: gen_policy_day_plain(art_cfg, art_traces, art_w, u4, pv, batt)),
                  f"K8 B={BATCH} x 20 days": (lambda: (gen_rbc_multiday(cfg, params, 20, 5, BATCH),),
                                              lambda: (gen_rbc_multiday_plain(cfg, traces, 20, 5, BATCH),)),
                  f"K8 B={FULL_BATCH} x 2 days": (lambda: (gen_rbc_multiday(cfg, params, 2, 13, FULL_BATCH),),
                                                  lambda: (gen_rbc_multiday_plain(cfg, traces, 2, 13, FULL_BATCH),))}
        for label, state in ((f"fresh B={BATCH}", fresh), (f"continued B={BATCH}", continued),
                             (f"card reset B={FULL_BATCH}", big_state)):
            checks[f"K11a {label}"] = (
                lambda st=state: rbc_day_rollout(cfg, params, st),
                lambda st=state: rbc_day_rollout_plain(cfg, traces, state_tables(cfg, params, st)))
        result["check"] = {}
        for label, (kernel, plain) in checks.items():
            got, want = kernel(), plain()
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            result["check"][label] = {"equal": equal, "max_abs_err": err}
            print(f"  {label}: {'bit-equal to' if equal else 'NOT bit-equal to'} the twin, max |d| {err:.3e}")
    for name, (call, kernel, repeats, steps) in rows.items():
        ms = device_ms(torch, call, kernel, repeats)
        result[name] = {"device_ms": ms}
        extra = ""
        if steps is not None:
            result[name]["env_steps_per_s"] = steps / ms * 1e3
            extra = f", {steps / ms * 1e3:.4e} env-steps/s"
        if "K11a" in name:
            b = BATCH if f"B={BATCH}" in name else FULL_BATCH
            result[name]["table_bytes_per_s"] = table_bytes[b] / ms * 1e3
            extra += f", tables read at {table_bytes[b] / ms * 1e-9:.3f} TB/s"
        if "K7" in name:
            result[name]["uniform_bytes_per_s"] = uniform_bytes / ms * 1e3
            extra += f", the uniforms it reads ({uniform_bytes / 1e6:.2f} MB) at {uniform_bytes / ms * 1e-9:.3f} TB/s"
        if name.startswith(("K7", "K5")):
            result[name]["event_ms"] = event_ms(torch, call, repeats)
            extra += f"; {result[name]['event_ms']:.4f} ms a call by CUDA events (wrapper included)"
        print(f"  {name}: {ms:.4f} device ms per launch{extra}")
    for label, (config, tr, w, hidden, by_state) in k11b.items():
        lib, block, count = policy_library(config, dev, w, hidden, "ppo", tr, "policy_day_rollout")
        T_, A_, N_ = config.steps_per_day, config.num_actions, config.num_chargers
        outs = [torch.empty(shape, device=dev) for shape in ((T_, BATCH), (T_, A_, BATCH), (N_, BATCH))]
        for kind, st in by_state.items():
            st = st.checked()

            def bare():  # the launch alone, the block packed once
                _build.launch(count, lib.ngk_policy_day_rollout, tr.price, tr.price_norm, tr.price_norm.numel(),
                              tr.rad_norm, tr.rad_norm.numel(), tr.solar, *st, block, *outs, BATCH, T_,
                              config.time_interval, device=dev)

            name = f"K11b {label} B={BATCH} {kind} state"
            result[name] = {
                "device_ms": device_ms(torch, lambda: launch_policy_day(config, tr, w, st, hidden),
                                       "policy_day_rollout", 10),
                "event_ms": event_ms(torch, bare, 10)}
            print(f"  {name}: {result[name]['device_ms']:.4f} device ms per launch (profiler), "
                  f"{result[name]['event_ms']:.4f} ms per bare launch (CUDA events)")

    package = _build.load(_build.config_spec(cfg), dev)

    def with_library(lib, fn):
        with mock.patch.object(_build, "load", lambda *a, **k: lib):
            return fn()

    if args.ring:
        result["ring"] = {}
        libs = variants(_build.config_spec(cfg), "ring")
        for b in (BATCH, FULL_BATCH):
            def k11a(lib):
                return with_library(lib, lambda: launch_rbc_day(cfg, traces, tables[b]))
            want = k11a(package)
            row = {"package": [device_ms(torch, lambda: k11a(package), "rbc_day_rollout_kernel", 10)]}
            for depth, lib in libs.items():
                same = all(torch.equal(x, y) for x, y in zip(k11a(lib), want))
                row[depth] = device_ms(torch, lambda: k11a(lib), "rbc_day_rollout_kernel", 10)
                print(f"  K11a B={b}: ring of {depth} steps {row[depth]:.4f} ms, outputs identical: {same}")
                if not same:
                    raise RuntimeError(f"K11a with a {depth}-step ring differs from the package's")
            row["package"].append(device_ms(torch, lambda: k11a(package), "rbc_day_rollout_kernel", 10))
            print(f"  K11a B={b}: the package's ring of {package.ngk_rbc_ring_depth()} steps "
                  f"{row['package'][0]:.4f} / {row['package'][1]:.4f} ms")
            result["ring"][str(b)] = row
    if args.lanes:
        result["lanes"] = {}
        libs = variants(_build.config_spec(cfg), "lanes")
        for b, days in LANE_BATCHES.items():
            def k8(lib):
                return with_library(lib, lambda: gen_rbc_multiday(cfg, params, days, 5, b))
            def launch_only(lib, out):  # the wrapper's launch without its checks (which read the params back)
                _build.launch("gen_rbc_multiday", lib.ngk_gen_rbc_multiday, traces.price, traces.rad_norm,
                              traces.rad_norm.numel(), traces.solar, 5, days, out, b, *_build.day_dims(cfg),
                              device=out.device)
            want = k8(package)
            row = {"package_lanes": package.ngk_rbc_lanes(b)}
            for tag, lib in (("package", package), *libs.items()):
                if not torch.equal(k8(lib), want):
                    raise RuntimeError(f"K8 with {tag} lanes an env differs from the package's")
                out = torch.empty_like(want)
                row[tag] = {"profiler_ms": device_ms(torch, lambda: k8(lib), "gen_rbc_multiday_kernel", 5),
                            "event_ms": event_ms(torch, lambda: launch_only(lib, out), 5)}
                if not torch.equal(out, want):
                    raise RuntimeError(f"K8 launched alone with {tag} lanes an env differs from the package's")
            steps = b * days * T
            print(f"  K8 B={b} x {days} days, env-steps/s by the profiler | by CUDA events: " + ", ".join(
                f"{k} lanes {steps / row[k]['profiler_ms'] * 1e3:.4e} | {steps / row[k]['event_ms'] * 1e3:.4e}"
                for k in LANES) + f"; the package ({row['package_lanes']} lanes) "
                f"{steps / row['package']['profiler_ms'] * 1e3:.4e} | {steps / row['package']['event_ms'] * 1e3:.4e}")
            result["lanes"][str(b)] = row
    if args.stage:
        result["stage"] = {}
        for label, (config, tr, w, hidden, by_state) in k11b.items():
            spec = _build.config_spec(config, hidden)
            copy = _build.patched_library(spec, _build.BUILD_DIR.parent / "rbc_variants" / f"stage{hidden[0]}", {
                "day_step.cuh": lambda code: _build.replace_once(code, STAGE_ANCHOR, STAGE_ASYNC, "day_step.cuh")})
            libs = {"package": _build.load(spec, dev), "cp.async": copy}
            for kind, st in by_state.items():
                def k11b_on(lib):
                    return with_library(lib, lambda: launch_policy_day(config, tr, w, st, hidden))
                want = k11b_on(libs["package"])
                if not all(torch.equal(x, y) for x, y in zip(k11b_on(copy), want)):
                    raise RuntimeError(f"K11b {label} staged by cp.async differs from the package's")
                row = {tag: [] for tag in libs}
                for tag in ("package", "cp.async", "cp.async", "package"):
                    row[tag].append(device_ms(torch, lambda: k11b_on(libs[tag]), "policy_day_rollout", 10))
                print(f"  K11b {label} {kind} state: loads {row['package']} ms, cp.async {row['cp.async']} ms "
                      f"(device, profiler); outputs identical")
                result["stage"][f"{label} {kind}"] = row
    if args.sass:
        result["sass"] = {}
        text = subprocess.run(["cuobjdump", "-sass", package._name], capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for label, name in (("K7", "gen_rbc_day"), ("K11a", "rbc_day_rollout_kernel")):
            mangled = next(k for k in re.findall(r"Function : (\S+)", text) if name in k)
            result["sass"][label] = sass_loop(text, mangled)
            print(f"  {label} {mangled}: {result['sass'][label]}")
    print(json.dumps({"card": card, "root": root, "kernels": result}))


if __name__ == "__main__":
    main()
