"""Device time of the block-actor rows of K6 and K5, and the parts of one of their steps, on one CUDA card.

Run from the root of a checkout (it builds the kernels first):

    python3 smart_nanogrid_gym_torch/tools/profile_k6.py [--root DIR] [--phases] [--tiles]

``--root`` imports ``smart_nanogrid_gym_torch`` from another checkout (for
example the parent commit unpacked under ``build/``), so that one call can time
two versions in turn on the same card; by default the checkout that holds this
file.  At the bench batch it times eight rows: ``gen_policy_multiday`` (K6)
with the committed DDPG artifact (4 chargers, 400-300) over 4 days in f32 and
2 days in bf16, with the bench's 256x256 PPO torso (8 chargers, biases +0.05,
bench.py:403-414) over 2 days in f32 and bf16, and with the committed PPO
artifact (4 chargers, 64x64) over 20 days in f32 and 4 days in bf16; and
``gen_policy_day`` (K5) on one explicit-uniform day with the DDPG artifact
and with the 256x256 torso.  Per row the device milliseconds per launch by
``torch.profiler`` (every kernel whose name holds ``gen_policy_multiday`` or
``gen_policy_day``, whichever design the checkout launches) over 5 launches
after a warm-up, and the wrapper's milliseconds per call by CUDA events.

``--phases`` (this checkout only) builds the same libraries with
``-DNGK_K6_CLOCK=1``, in which block 0 stamps ``%globaltimer`` at the borders
of each step's parts (``csrc/day_step.cuh::k6_stamp``; every stamp read
before a barrier, or right after a layer's): the env warp's step start and
its observation staged; product thread 0's arrival, each hidden layer done,
the head done and its time spent waiting for the weight ring's chunks.  For
each K6 row it prints the microseconds per step of each part (mean over the
first 48 steps, 64 for the longer rows, of launches 3-5): the env's window
(physics of step t and observation of t + 1), layer 1, layer 2, the head and
the ring waits, and whether the outputs are bit-identical to the package's
own kernel.

``--tiles`` (this checkout only) times the two 64x64 f32 rows (the artifact's
4 chargers over 20 days, and the bench's 8 chargers with its 64x64 actor,
biases +0.05, over 20 days) on the package's library and on a library built
from a copy of the sources under ``build/k6_tiles/`` whose ``choose_tiles``
lacks the 4 x 2 shape (so the 64-row layers take 4 x 4), in turns (package,
copy, copy, package), and checks that both give the same stats.  The last line is one JSON object with the numbers, the card's name
and power limit, and the root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

BATCH = 4096  # the bench batch
NARROW = "  const TileShape shapes[5] = {{4, 4}, {4, 8}, {8, 4}, {8, 8}, {4, 2}};\n  TileShape best = shapes[0];\n" \
         "  int best_cost = -1;\n  for (int i = 0; i < 5; ++i) {\n"
WIDE = "  const TileShape shapes[4] = {{4, 4}, {4, 8}, {8, 4}, {8, 8}};\n  TileShape best = shapes[0];\n" \
       "  int best_cost = -1;\n  for (int i = 0; i < 4; ++i) {\n"
REPEATS = 5   # launches under the profiler
SLOTS, STEPS = 8, 64  # kK6ClockSlots, kK6ClockSteps
ENV_START, ENV_STAGED, LAYER1, LAYER2, HEAD, RING_WAIT, ARRIVE = range(7)


def step_parts(record: np.ndarray, steps: int) -> dict[str, np.ndarray]:
    """Nanoseconds of each part of each of the first ``steps`` - 1 steps."""
    r = record.reshape(STEPS, SLOTS)[:steps].astype(np.int64)
    start = np.maximum(r[:, ENV_STAGED], r[:, ARRIVE])  # the later arrival at the first barrier
    return {
        "step": np.diff(r[:, ENV_START]),
        "env: physics of step t and observation of t + 1": r[1:, ENV_STAGED] - r[:-1, HEAD],
        "products: layer 1": (r[:, LAYER1] - start)[:-1],
        "products: layer 2": (r[:, LAYER2] - r[:, LAYER1])[:-1],
        "products: head": (r[:, HEAD] - r[:, LAYER2])[:-1],
        "products: waiting for weight chunks (in the layers)": np.diff(r[:, RING_WAIT]),
    }


def wide_tiles_library(spec) -> ctypes.CDLL:
    """The day-kernel library for ``spec`` built from a copy of the sources
    whose ``choose_tiles`` lacks the 4 x 2 shape."""
    from smart_nanogrid_gym_torch.ops import _build

    return _build.patched_library(spec, _build.BUILD_DIR.parent / "k6_tiles", {
        "day_step.cuh": lambda code: _build.replace_once(code, NARROW, WIDE, "day_step.cuh")})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--phases", action="store_true", help="block 0's step parts (this checkout only)")
    parser.add_argument("--tiles", action="store_true", help="the 64x64 rows with 4 x 2 and 4 x 4 tiles")
    args = parser.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k6 needs a CUDA device")
    from smart_nanogrid_gym_torch.core import NanogridConfig, make_params
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_day, gen_policy_multiday
    from smart_nanogrid_gym_torch.solvers.networks import ActorCritic
    from smart_nanogrid_gym_torch.utils.weights import load_actor_critic_npz, load_ddpg_actor_npz

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    art_cfg = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True, penalty_mode="sparse",
                             time_interval=1.0)
    bench_cfg = NanogridConfig()
    art_params, bench_params = make_params(art_cfg, torch.float32, dev), make_params(bench_cfg, torch.float32, dev)
    artifacts = Path(root) / "artifacts"
    ddpg = load_ddpg_actor_npz(str(artifacts / "DDPG-b-pv-bounded-sparse-4ch-1h" / "49152000.npz"), art_cfg).to(dev)
    ppo = load_actor_critic_npz(str(artifacts / "PPO-b-pv-bounded-sparse-4ch-1h" / "108134400.npz")).to(dev)

    def shifted(hidden, seed):
        net = ActorCritic(bench_cfg.obs_dim, bench_cfg.num_actions, hidden,
                          generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for p in net.parameters():
                if p.dim() == 1:
                    p.add_(0.05)
        return net.to(dev)

    big, small = shifted((256, 256), 42), shifted((64, 64), 42)

    def day_inputs(cfg, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        T, N = cfg.steps_per_day, cfg.num_chargers
        return (torch.rand((T, 5, N, BATCH), generator=gen, device=dev),
                torch.floor(torch.rand(BATCH, generator=gen, device=dev) * 181) / 100)

    u4, pv4 = day_inputs(art_cfg, 1)
    u8, pv8 = day_inputs(bench_cfg, 2)
    # name: (config, params, net, days (None: K5's one explicit day), actor, mlp_dtype)
    rows = {
        "K6 ddpg f32 (DDPG artifact 4ch, 4 days)": (art_cfg, art_params, ddpg, 4, "ddpg", None),
        "K6 ddpg bf16 (DDPG artifact 4ch, 2 days)": (art_cfg, art_params, ddpg, 2, "ddpg", bf16),
        "K6 256x256 f32 (bench 8ch, 2 days)": (bench_cfg, bench_params, big, 2, "ppo", None),
        "K6 256x256 bf16 (bench 8ch, 2 days)": (bench_cfg, bench_params, big, 2, "ppo", bf16),
        "K6 64x64 f32 (PPO artifact 4ch, 20 days)": (art_cfg, art_params, ppo, 20, "ppo", None),
        "K6 64x64 bf16 (PPO artifact 4ch, 4 days)": (art_cfg, art_params, ppo, 4, "ppo", bf16),
        "K5 ddpg (DDPG artifact 4ch, 1 day)": (art_cfg, art_params, ddpg, None, "ddpg", None),
        "K5 256x256 (bench 8ch, 1 day)": (bench_cfg, bench_params, big, None, "ppo", None),
    }

    def caller(cfg, params, net, days, actor, mm):
        if days is None:
            u, pv = (u4, pv4) if cfg is art_cfg else (u8, pv8)
            return lambda: gen_policy_day(cfg, params, net, u, pv, actor=actor)
        return lambda: gen_policy_multiday(cfg, params, net, days, 5, BATCH, actor=actor, mlp_dtype=mm)

    def device_ms(call, kernel):
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPEATS):
                call()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
        if device_us <= 0:
            raise RuntimeError(f"the profiler recorded no device time for {kernel}")
        return device_us / REPEATS / 1e3

    print(f"card: {card}; package from {root}")
    result = {"card": card, "root": root, "batch": BATCH, "rows": {}}
    for name, (cfg, params, net, days, actor, mm) in rows.items():
        call = caller(cfg, params, net, days, actor, mm)
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            call()
        end.record()
        torch.cuda.synchronize()
        kernel = "gen_policy_day" if days is None else "gen_policy_multiday"
        result["rows"][name] = {"device_ms": device_ms(call, kernel), "wrapper_ms": start.elapsed_time(end) / REPEATS}
        print(f"  {name} (B={BATCH}): {result['rows'][name]['device_ms']:.4f} device ms per launch, "
              f"{result['rows'][name]['wrapper_ms']:.4f} ms per call by CUDA events")

    if args.tiles:
        result["tiles"] = {}
        for name, (cfg, params, net) in {"K6 64x64 f32 (PPO artifact 4ch, 20 days)": (art_cfg, art_params, ppo),
                                         "K6 64x64 f32 (bench 8ch, 20 days)": (bench_cfg, bench_params, small)}.items():
            call = caller(cfg, params, net, 20, "ppo", None)
            wide = wide_tiles_library(_build.config_spec(cfg, net.hidden))
            own = call()
            times = {"4 x 2": [], "4 x 4": []}
            for tag in ("4 x 2", "4 x 4", "4 x 4", "4 x 2"):
                if tag == "4 x 4":
                    with mock.patch.object(_build, "load", return_value=wide):
                        times[tag].append(device_ms(call, "gen_policy_multiday"))
                        same = torch.equal(call(), own)
                    if not same:
                        raise RuntimeError(f"{name}: the 4 x 4 tiles give other stats than 4 x 2")
                else:
                    times[tag].append(device_ms(call, "gen_policy_multiday"))
            result["tiles"][name] = times
            print(f"{name}: device ms per launch, 4 x 2 tiles (the package) {times['4 x 2']}, 4 x 4 tiles "
                  f"{times['4 x 4']}; stats bit-identical")

    if args.phases:
        result["step_us"] = {}
        for name, (cfg, params, net, days, actor, mm) in rows.items():
            if days is None:
                continue
            spec = _build.config_spec(cfg, net.hidden, actor)
            lib = _build.load(spec._replace(flags={**spec.flags, "NGK_K6_CLOCK": 1}), dev)
            lib.ngk_k6_clock.argtypes = [ctypes.c_void_p]
            lib.ngk_k6_clock.restype = ctypes.c_int
            call = caller(cfg, params, net, days, actor, mm)
            own = call()
            record = np.zeros(STEPS * SLOTS, np.uint64)
            samples = []
            with mock.patch.object(_build, "load", return_value=lib):
                for rep in range(5):
                    out = call()
                    torch.cuda.synchronize()
                    if lib.ngk_k6_clock(record.ctypes.data) != 0:
                        raise RuntimeError("reading the step record failed")
                    if rep >= 2:
                        samples.append(step_parts(record, min(STEPS, days * cfg.steps_per_day)))
            parts = {k: float(np.mean([s[k] for s in samples])) / 1e3 for k in samples[0]}
            same = torch.equal(out, own)
            print(f"{name}: block 0's step parts (us per step); outputs "
                  f"{'bit-identical to' if same else 'DIFFER from'} the package's kernel")
            for k, us in parts.items():
                print(f"  {k}: {us:.3f}")
            result["step_us"][name] = {"identical": same, **parts}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
