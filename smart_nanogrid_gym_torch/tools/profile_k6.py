"""Device time of K6's block-actor rows, and the parts of one of its steps, on one CUDA card.

Run from the root of a checkout (it builds the kernels first):

    python3 smart_nanogrid_gym_torch/tools/profile_k6.py [--root DIR] [--phases]

``--root`` imports ``smart_nanogrid_gym_torch`` from another checkout (for
example the parent commit unpacked under ``build/``), so that one call can time
two versions in turn on the same card; by default the checkout that holds this
file.  At the bench batch it times ``gen_policy_multiday`` on the four rows of
K6's block actor: the committed DDPG artifact (4 chargers, 400-300) over 4
days in f32 and 2 days in bf16, and the bench's 256x256 PPO torso (8
chargers, biases +0.05, bench.py:403-414) over 2 days in f32 and bf16; per
row the device milliseconds per launch by ``torch.profiler`` over 5 launches
after a warm-up, and the wrapper's milliseconds per call by CUDA events.

``--phases`` (this checkout only) builds the same libraries with
``-DNGK_K6_CLOCK=1``, in which block 0 stamps ``%globaltimer`` at the borders
of each step's parts (``csrc/day_step.cuh::k6_stamp``; every stamp read
before a barrier, or right after a layer's): the env warp's step start and
its observation staged; product thread 0's arrival, each hidden layer done,
the head done and its time spent waiting for the weight ring's chunks.  It
prints the microseconds per step of each part (mean over the first 48
steps, 64 for the 4-day row, of launches 3-5): the env's window (physics of step t and observation of
t + 1), layer 1, layer 2, the head and the ring waits, and whether the
outputs are bit-identical to the package's own kernel.  The last line is one
JSON object with the numbers, the card's name and power limit, and the root.
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--phases", action="store_true", help="block 0's step parts (this checkout only)")
    args = parser.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k6 needs a CUDA device")
    from smart_nanogrid_gym_torch.core import NanogridConfig, make_params
    from smart_nanogrid_gym_torch.ops import _build
    from smart_nanogrid_gym_torch.ops.gen_policy_rollout import gen_policy_multiday
    from smart_nanogrid_gym_torch.solvers.networks import ActorCritic
    from smart_nanogrid_gym_torch.utils.weights import load_ddpg_actor_npz

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    art_cfg = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True, penalty_mode="sparse",
                             time_interval=1.0)
    bench_cfg = NanogridConfig()
    art_params, bench_params = make_params(art_cfg, torch.float32, dev), make_params(bench_cfg, torch.float32, dev)
    npz = Path(root) / "artifacts" / "DDPG-b-pv-bounded-sparse-4ch-1h" / "49152000.npz"
    ddpg = load_ddpg_actor_npz(str(npz), art_cfg).to(dev)
    big = ActorCritic(bench_cfg.obs_dim, bench_cfg.num_actions, (256, 256), generator=torch.Generator().manual_seed(42))
    with torch.no_grad():
        for p in big.parameters():
            if p.dim() == 1:
                p.add_(0.05)
    big = big.to(dev)
    rows = {
        "K6 ddpg f32 (DDPG artifact 4ch, 4 days)": (art_cfg, art_params, ddpg, 4, "ddpg", None),
        "K6 ddpg bf16 (DDPG artifact 4ch, 2 days)": (art_cfg, art_params, ddpg, 2, "ddpg", bf16),
        "K6 256x256 f32 (bench 8ch, 2 days)": (bench_cfg, bench_params, big, 2, "ppo", None),
        "K6 256x256 bf16 (bench 8ch, 2 days)": (bench_cfg, bench_params, big, 2, "ppo", bf16),
    }
    print(f"card: {card}; package from {root}")
    result = {"card": card, "root": root, "batch": BATCH, "rows": {}}
    for name, (cfg, params, net, days, actor, mm) in rows.items():
        def call():
            return gen_policy_multiday(cfg, params, net, days, 5, BATCH, actor=actor, mlp_dtype=mm)

        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            call()
        end.record()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPEATS):
                call()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if "gen_policy_multiday_block_kernel" in e.key)
        if device_us <= 0:
            raise RuntimeError("the profiler recorded no device time for gen_policy_multiday_block_kernel")
        result["rows"][name] = {"device_ms": device_us / REPEATS / 1e3,
                                "wrapper_ms": start.elapsed_time(end) / REPEATS}
        print(f"  {name} (B={BATCH}): {result['rows'][name]['device_ms']:.4f} device ms per launch, "
              f"{result['rows'][name]['wrapper_ms']:.4f} ms per call by CUDA events")

    if args.phases:
        result["step_us"] = {}
        for name, (cfg, params, net, days, actor, mm) in rows.items():
            flags = {**_build.config_flags(cfg, net.hidden, actor), "NGK_K6_CLOCK": 1}
            lib = _build._load(flags, dev)
            lib.ngk_k6_clock.argtypes = [ctypes.c_void_p]
            lib.ngk_k6_clock.restype = ctypes.c_int
            own = gen_policy_multiday(cfg, params, net, days, 5, BATCH, actor=actor, mlp_dtype=mm)
            record = np.zeros(STEPS * SLOTS, np.uint64)
            samples = []
            with mock.patch.object(_build, "library", return_value=lib):
                for rep in range(5):
                    out = gen_policy_multiday(cfg, params, net, days, 5, BATCH, actor=actor, mlp_dtype=mm)
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
