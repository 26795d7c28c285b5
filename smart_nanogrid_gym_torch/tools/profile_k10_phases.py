"""Time each phase of K10 (the DDPG update sweep) on the card.

Run from the root of the repository (it builds an instrumented K10 first):

    python3 -m smart_nanogrid_gym_torch.tools.profile_k10_phases [--bf16] [--updates 6]

K10 runs a whole update as one cooperative launch, so the profiler sees one
kernel.  This tool writes a copy of ``csrc/ddpg_sweep.cuh``,
``csrc/ddpg_sweep.cu`` and ``csrc/operand.cuh`` into ``build/k10_phases/``
in which block 0 records
``%globaltimer`` after every grid barrier and after every phase's table is
built (``instrument``), builds it with the package's nvcc flags, and runs
``ddpg_sweep`` on it at the bench shape (G=24, M=256, F=25, A=9, 400-300)
with seeded random networks and minibatches.  It prints, for each phase, the
microseconds per step (mean over the G steps of all but the first two
updates) and the part of it spent building the phase's table, the update's
device time by CUDA events, and a digest of the results: f32 results are
bit-identical to the uninstrumented kernel's, which ``ddpg_sweep`` (and so
its twin) can confirm.  The repository's own sources and libraries are not
touched.  The last line is one JSON object with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from ..ops import _build
from ..ops.ddpg_sweep import DDPGSweepHypers, ddpg_sweep
from ..ops.ppo_sweep import zeros_adam

PHASES = ("Fwd1", "Fwd2", "Heads", "Target1", "Target2", "TargetQ", "CriticBack3", "CriticBack2",
          "CriticBack1", "CriticAdam", "Pi1", "Pi2", "Pi3", "Pi4", "PiAction", "ActorBack3", "ActorBack2",
          "ActorBack1", "ActorAdam")  # ngd::PhaseId in order
SLOTS = 2048  # timer slots per record: the barrier times, then the table-built times
OUT_DIR = _build.BUILD_DIR.parent / "k10_phases"


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"csrc/ddpg_sweep.cuh has changed: {old!r} is not found exactly once")
    return text.replace(old, new)


def instrument(cuh: str, cu: str) -> tuple[str, str]:
    """The K10 sources with block 0's timer record and ``ngk_phase_clock``."""
    cuh = _sub(cuh, "// The whole update: G steps",
               f"__device__ unsigned long long ngd_clock[2 * {SLOTS}];\n"
               "__device__ __forceinline__ unsigned long long clock_ns() {\n"
               "  unsigned long long t;\n"
               "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
               "  return t;\n}\n\n// The whole update: G steps")
    cuh = _sub(cuh, "  for (int g = 0; g < s.G; ++g) {\n    for (int id = 0; id < kPhases; ++id) {",
               "  if (blockIdx.x == 0 && threadIdx.x == 0) ngd_clock[0] = clock_ns();\n"
               "  for (int g = 0; g < s.G; ++g) {\n    for (int id = 0; id < kPhases; ++id) {")
    cuh = _sub(cuh, "      grid.sync();\n",
               "      grid.sync();\n"
               "      if (blockIdx.x == 0 && threadIdx.x == 0) ngd_clock[1 + g * kPhases + id] = clock_ns();\n")
    cuh = _sub(cuh, "        __syncthreads();\n        int q = 0;",
               "        __syncthreads();\n"
               f"        if (blockIdx.x == 0 && threadIdx.x == 0) ngd_clock[{SLOTS} + g * kPhases + id] = clock_ns();\n"
               "        int q = 0;")
    cu = cu + ('\nextern "C" int ngk_phase_clock(unsigned long long* out) {\n'
               "  return static_cast<int>(cudaMemcpyFromSymbol(out, ngd::ngd_clock, sizeof(ngd::ngd_clock)));\n}\n")
    return cuh, cu


def build_instrumented(spec: _build.Spec) -> ctypes.CDLL:
    cuh, cu = instrument((_build.CSRC / "ddpg_sweep.cuh").read_text(), (_build.CSRC / "ddpg_sweep.cu").read_text())
    lib = _build.patched_library(spec, OUT_DIR, {"ddpg_sweep.cuh": lambda _: cuh, "ddpg_sweep.cu": lambda _: cu})
    lib.ngk_phase_clock.argtypes = [ctypes.c_void_p]
    lib.ngk_phase_clock.restype = ctypes.c_int
    return lib


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bf16", action="store_true", help="matmul_dtype=torch.bfloat16 (the tensor cores)")
    parser.add_argument("--updates", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_k10_phases needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    G, M, F, A, H1, H2 = 24, 256, 25, 9, 400, 300
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def net(fan_in, out):
        return [randn(H1, fan_in, scale=fan_in ** -0.5), randn(H1, scale=0.05), randn(H2, H1, scale=H1 ** -0.5),
                randn(H2, scale=0.05), randn(out, H2, scale=H2 ** -0.5), randn(out, scale=0.05)]

    actor, critic = net(F, A), net(F + A, 1)
    data = (randn(G, M, F), torch.rand(G, M, A, generator=gen, device=dev), randn(G, M), randn(G, M, F),
            (torch.rand(G, M, generator=gen, device=dev) < 0.05).float())
    box = (torch.zeros(A, device=dev), torch.ones(A, device=dev))
    hp = DDPGSweepHypers(lr=1e-3, gamma=0.99, tau=0.005, matmul_dtype=torch.bfloat16 if args.bf16 else None)
    lib = build_instrumented(_build.ddpg_sweep_spec(F, A, H1, H2))
    record = np.zeros(2 * SLOTS, np.uint64)
    steps, builds, events = [], [], []
    with mock.patch.object(_build, "load", return_value=lib):
        for rep in range(args.updates):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = ddpg_sweep(actor, critic, actor, critic, zeros_adam(actor), zeros_adam(critic), *data, *box, hp)
            end.record()
            torch.cuda.synchronize()
            if lib.ngk_phase_clock(record.ctypes.data) != 0:
                raise RuntimeError("reading the phase record failed")
            barrier = record[:1 + G * len(PHASES)].astype(np.int64)
            built = record[SLOTS:SLOTS + G * len(PHASES)].astype(np.int64)
            if rep >= 2:
                steps.append(np.diff(barrier).reshape(G, -1))
                builds.append(np.where(built > 0, built - barrier[:-1], 0).reshape(G, -1))
                events.append(start.elapsed_time(end))
    phase_ns, build_ns = np.mean(steps, axis=0).mean(axis=0), np.mean(builds, axis=0).mean(axis=0)
    leaves = [x for part in out[:4] for x in part] + out[4].mu + out[4].nu + out[5].mu + out[5].nu + [out[6]]
    digest = hashlib.sha256(torch.cat([x.reshape(-1) for x in leaves]).cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"card: {card}")
    print(f"K10 {'bf16' if args.bf16 else 'f32'}, G={G} x M={M}, 400-300: {phase_ns.sum() / 1e3:.3f} us per step "
          f"by block 0's clock, {np.mean(events):.4f} ms per update by CUDA events; digest {digest}")
    for name, ns, b in zip(PHASES, phase_ns, build_ns):
        print(f"  {name}: {ns / 1e3:.3f} us per step (table build {b / 1e3:.3f})")
    print(json.dumps({"card": card, "bf16": args.bf16, "step_us": phase_ns.sum() / 1e3,
                      "update_ms_events": float(np.mean(events)), "digest": digest,
                      "phase_us": {n: float(ns / 1e3) for n, ns in zip(PHASES, phase_ns)},
                      "build_us": {n: float(b / 1e3) for n, b in zip(PHASES, build_ns)}}))


if __name__ == "__main__":
    main()
