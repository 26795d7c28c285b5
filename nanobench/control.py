"""The readings a cell's limits are set from: the program's compared
numbers over many seeds (the lower readings) and the control's, the plain
reference in the next precision below the configuration's put in the
program's place (the upper readings), in one process.

    python3 -m nanobench.control --workload <cell> --seeds 12 --control-seeds 3 --seconds 2

Each seed sets the cell up, runs its units for ``--seconds`` (at least one),
and checks them as a run does; the first ``--control-seeds`` seeds also run
the control on the same calls (bf16 for the evaluation cells, TF32 for the
training cell) and, for the training cell, the reference with TF32 in its
gradient steps alone (``sweep_control``), the reference with half of each
minibatch left out (a planted fault), and the program on a lower-precision
path of its own, set up anew with the traffic overrides that the driver's
``PROGRAM_CONTROLS`` names (for the training cell, K3 in bf16).  One JSON line per reading, then the
largest program reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nanobench import common, harness


def readings(cell, seed: int, seconds: float, device, control_too: bool) -> dict:
    drv = cell.driver
    state = drv.setup(harness.Ctx(harness.ROOT, cell.config, cell.traffic, seed, device))
    start = time.perf_counter()
    units = 0
    while units == 0 or time.perf_counter() - start < seconds:
        drv.unit(state)
        units += 1
    outputs = drv.finish(state)
    del state
    out = {"seed": seed, "units": units,
           "program": {k: v for k, (v, _) in drv.check(cell.config, cell.traffic, seed, outputs, harness.ROOT,
                                                        device).items()}}
    if control_too:
        out["control"] = {k: v for k, (v, _) in drv.control(cell.config, cell.traffic, seed, outputs, harness.ROOT,
                                                            device, torch.bfloat16).items()}
        for side in ("sweep_control", "fault"):
            if hasattr(drv, side):
                out[side] = {k: v for k, (v, _) in getattr(drv, side)(cell.config, cell.traffic, seed, outputs,
                                                                       harness.ROOT, device).items()}
        del outputs
        for name, overrides in getattr(drv, "PROGRAM_CONTROLS", {}).items():
            variant = harness.load_cell(cell.name, harness.ROOT, overrides)
            out[name] = readings(variant, seed, seconds, device, False)["program"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("nanobench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    rows = []
    for i, seed in enumerate(common.seeds(args.first_seed, args.seeds, salt=9)):
        rows.append(readings(cell, seed, args.seconds, device, i < args.control_seeds))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload,
               "lower": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for side in sorted({k for r in rows for k in r} - {"seed", "units", "program"}):
        got = [r[side] for r in rows if side in r]
        if got:
            summary[side] = {k: min(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
