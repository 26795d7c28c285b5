"""Generate the port's benchmark table in README.md from BENCH_TABLE_torch.json.

The counterpart of the JAX package's ``tools/gen_bench_table.py``: the
table between the ``BENCH_TABLE_TORCH`` markers in README's PyTorch/CUDA
section is rendered from ``BENCH_TABLE_torch.json`` (written by ``python -m
smart_nanogrid_gym_torch.tools.bench --all`` on the card), and
tests/test_torch_tools.py::test_readme_torch_bench_table_current fails
whenever the two drift.  The JAX package's table and its markers are left
as they are.

Usage: ``python -m smart_nanogrid_gym_torch.tools.gen_bench_table`` rewrites
the marked region in place after a bench run.
"""

from __future__ import annotations

import json
import os

START_MARK = ("<!-- BENCH_TABLE_TORCH_START (generated by "
              "smart_nanogrid_gym_torch/tools/gen_bench_table.py) -->")
END_MARK = "<!-- BENCH_TABLE_TORCH_END -->"

REFERENCE_STEPS_PER_SEC = 1699.0  # tools/bench.py: the reference's Python env on a CPU

# (key, row label) in table order; rows absent from the JSON are skipped,
# and JSON keys missing from this list get a fallback row so a new bench
# entry can never silently drop out of the README.
ROW_LABELS = [
    ("pallas_gen_rbc_multiday",
     "env-steps/s incl. per-day schedule generation (4096 envs, 1 card), RBC multiday kernel K8 "
     "(`gen_rbc_multiday_kernel<C, L>`, `csrc/day_step.cuh`: Philox draws, generation, RBC and physics "
     "in one launch per 40,000 days; an env on 8 lanes of a warp)"),
    ("__vs_reference__",
     "vs the reference's Python env (1,699 steps/s, one env on a CPU)"),
    ("xla_gen_plus_fused_day",
     "same work, plain engine: generation + reset + fused day (`core/rollout.py`), RBC"),
    ("xla_gen_plus_pallas_rbc_day",
     "same work, plain generation + reset, the day by K11a (`rbc_day_rollout_kernel`, "
     "`ops/rollout.py`, batched params)"),
    ("xla_policy_in_loop",
     "policy-in-the-loop (PPO 64×64 actor, clipped mean), plain engine"),
    ("pallas_gen_policy_multiday",
     "policy-in-the-loop incl. per-day schedule generation, actor multiday kernel K6 "
     "(`gen_policy_multiday_block_kernel`, `csrc/day_step.cuh`: 32 envs a block, an env warp and "
     "register-tiled product warps), 64×64 actor"),
    ("pallas_gen_policy_multiday_256x256_f32",
     "K6 with a 256×256 actor torso, f32 products (a TMA weight ring)"),
    ("pallas_gen_policy_multiday_256x256_bf16",
     "K6, 256×256 torso, **bf16 products on the tensor cores** (`mma.sync`, f32 accumulation)"),
    ("ppo_train_update",
     "**PPO training** env-steps/s — full update (collection + GAE + 10-epoch × 4-minibatch "
     "sweep), plain engine and autograd, 25 updates a call (`solvers/ppo.py build_train_many`)"),
    ("ppo_train_update_kernel",
     "**PPO training on the kernels** — collection kernel K2 (`ppo_collect_day_kernel`: "
     "generation + stochastic actor + value head + physics, one launch) feeding the sweep kernel "
     "K3 (`ppo_sweep_kernel`, `csrc/ppo_sweep.cuh`: all 40 gradient steps with clip + Adam in one "
     "cooperative launch)"),
    ("ppo_train_update_unamortized",
     "PPO training, plain, one update a call"),
    ("ddpg_train_update_kernel",
     "**DDPG training on the kernels** — collection kernel K9 (`ddpg_collect_day_kernel`, seeded) "
     "+ sweep kernel K10 (`ddpg_sweep_kernel`, `csrc/ddpg_sweep.cuh`: both nets, targets and Adam "
     "in one cooperative launch, bf16 products on the tensor cores)"),
    ("ddpg_train_update",
     "**DDPG training** env-steps/s — collect a day + 24 gradient steps per update, plain engine "
     "and autograd, 25 updates a call (`solvers/ddpg.py build_train_many`)"),
    ("native_single_env",
     "native C++ engine, single env (host CPU, load-dependent)"),
    ("native_batched_1024",
     "native C++ **batched** engine (`NativeBatchEngine`, 1024 envs, OpenMP; bound by the host's "
     "cores)"),
]


def _humanize(v: float) -> str:
    for scale, suffix in ((1e9, "B"), (1e6, "M"), (1e3, "k")):
        if v >= scale:
            x = v / scale
            return f"{x:.2f}{suffix}" if x < 10 else (
                f"{x:.1f}{suffix}" if x < 100 else f"{x:.0f}{suffix}")
    return f"{v:.0f}"


def render(table: dict) -> str:
    """The markdown table (incl. markers) for a BENCH_TABLE_torch.json payload."""
    paths = dict(table["paths"])
    lines = [START_MARK, "",
             f"Measured on {table['card']} (`nvidia-smi` name, power limit), torch {table['torch']}, "
             f"{table['batch']} envs, {table['config']}:", "",
             "| Metric | Value |", "|---|---|"]
    known = set()
    for key, label in ROW_LABELS:
        known.add(key)
        if key == "__vs_reference__":
            head = paths.get("pallas_gen_rbc_multiday")
            if head:
                ratio = head / REFERENCE_STEPS_PER_SEC
                lines.append(f"| {label} | **~{_humanize(ratio)}×** |")
            continue
        if key not in paths:
            continue
        bold = key in ("pallas_gen_rbc_multiday", "pallas_gen_policy_multiday",
                       "ppo_train_update_kernel", "ddpg_train_update_kernel")
        val = _humanize(paths[key]) + " steps/s"
        lines.append(f"| {label} | {'**' + val + '**' if bold else val} |")
    for key in paths:  # never silently drop a new bench entry
        if key not in known:
            lines.append(f"| `{key}` (unlabelled — add to smart_nanogrid_gym_torch/tools/gen_bench_table.py) "
                         f"| {_humanize(paths[key])} steps/s |")
    lines += ["", END_MARK]
    return "\n".join(lines)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_table(root: str | None = None) -> dict:
    with open(os.path.join(root or _repo_root(), "BENCH_TABLE_torch.json")) as fp:
        return json.load(fp)


def update_readme(root: str | None = None) -> str:
    """Replace the marked region of README.md; returns the new region."""
    root = root or _repo_root()
    readme_path = os.path.join(root, "README.md")
    with open(readme_path) as fp:
        text = fp.read()
    start = text.index(START_MARK)
    end = text.index(END_MARK) + len(END_MARK)
    region = render(load_table(root))
    with open(readme_path, "w") as fp:
        fp.write(text[:start] + region + text[end:])
    return region


if __name__ == "__main__":
    print(update_readme())
