"""Generate docs/API_torch.md, the public API reference of the PyTorch port
(the counterpart of the JAX package's ``tools/gen_api_docs.py`` and
``docs/API.md``).

Introspects the port's public surface (the engine, the gym-compatible
adapter, the solvers, the env mesh and multi-process runtime, the kernels'
wrappers, the native serving path, the utils, the CLIs and the bench) and emits one
markdown file with the signature and the first docstring paragraph of every
public class and function.  Regenerate after API changes:

    python -m smart_nanogrid_gym_torch.tools.gen_api_docs [--out docs/API_torch.md]

tests/test_torch_tools.py pins that the committed file is current.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import io
import re

PACKAGE = "smart_nanogrid_gym_torch"

# (module, [public names]); None = every non-underscore function or class
# defined in the module, in source order.
SURFACE: list[tuple[str, list[str] | None]] = [
    (f"{PACKAGE}.core.config", ["NanogridConfig", "PenaltyMode"]),
    (f"{PACKAGE}.core.params", ["NanogridParams", "make_params", "broadcast_params"]),
    (f"{PACKAGE}.core.state", None),
    (f"{PACKAGE}.core.generate", None),
    (f"{PACKAGE}.core.transition", ["reset", "observe", "step", "step_plain"]),
    (f"{PACKAGE}.core.rollout", None),
    (f"{PACKAGE}.core.env", ["SmartNanogridTorch"]),
    (f"{PACKAGE}.compat.gym_adapter", ["SmartNanogridEnv"]),
    (f"{PACKAGE}.compat.vector_env", None),
    (f"{PACKAGE}.compat.sb3_loader", None),
    (f"{PACKAGE}.solvers.rbc", None),
    (f"{PACKAGE}.solvers.ppo", ["PPOConfig", "PPOLearner"]),
    (f"{PACKAGE}.solvers.ddpg", ["DDPGConfig", "DDPGLearner", "ou_step"]),
    (f"{PACKAGE}.solvers.evaluator", None),
    (f"{PACKAGE}.solvers.networks", None),
    (f"{PACKAGE}.parallel.mesh", None),
    (f"{PACKAGE}.parallel.distributed", None),
    (f"{PACKAGE}.ops.gen_rollout", ["gen_rbc_day", "gen_rbc_multiday"]),
    (f"{PACKAGE}.ops.gen_policy_rollout", ["gen_policy_day", "gen_policy_multiday"]),
    (f"{PACKAGE}.ops.ppo_sweep", ["SweepHypers", "ppo_sweep", "ppo_sweep_streamed"]),
    (f"{PACKAGE}.ops.ddpg_sweep", ["DDPGSweepHypers", "ddpg_sweep"]),
    (f"{PACKAGE}.ops.collect", ["ppo_collect_day", "ppo_collect_day_seeded"]),
    (f"{PACKAGE}.ops.ddpg_collect", ["ddpg_collect_day", "ddpg_collect_day_seeded"]),
    (f"{PACKAGE}.ops.rollout", ["rbc_day_rollout"]),
    (f"{PACKAGE}.ops.policy_rollout", ["policy_day_rollout"]),
    (f"{PACKAGE}.ops.param_guard", None),
    (f"{PACKAGE}.ops.engine_step", ["engine_step"]),
    (f"{PACKAGE}.ops.gae", ["gae"]),
    (f"{PACKAGE}.native", ["NativeEngine", "NativeBatchEngine", "generate_schedule_native"]),
    (f"{PACKAGE}.utils.checkpoint", None),
    (f"{PACKAGE}.utils.guard", None),
    (f"{PACKAGE}.utils.metrics", None),
    (f"{PACKAGE}.utils.profiling", None),
    (f"{PACKAGE}.tools.train_ppo", ["main"]),
    (f"{PACKAGE}.tools.train_ddpg", ["main"]),
    (f"{PACKAGE}.tools.train_multi", ["main"]),
    (f"{PACKAGE}.tools.evaluate", ["main"]),
    (f"{PACKAGE}.tools.predict", ["main"]),
    (f"{PACKAGE}.tools.visualize", ["main"]),
    (f"{PACKAGE}.tools.bench", ["bench_headline", "bench_all", "bench_scaling", "bench_train_profile",
                                "check_multiday_stats", "stats_bounds", "plain_day_return_stats", "main"]),
    (f"{PACKAGE}.tools.gen_bench_table", ["render", "load_table", "update_readme"]),
    (f"{PACKAGE}.parallel.multihost_demo", ["main"]),
]


def _clean(text: str) -> str:
    # reprs of module-level objects embed memory addresses
    return re.sub(r" at 0x[0-9a-f]+", " at 0x…", text)


def _first_paragraph(doc: str | None) -> str:
    if not doc:
        return ""
    return _clean(inspect.cleandoc(doc).split("\n\n", 1)[0].replace("\n", " "))


def _public_names(mod) -> list[str]:
    return [name for name, obj in vars(mod).items()
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and getattr(obj, "__module__", None) == mod.__name__]  # re-exports at their source


def _signature(obj) -> str:
    try:
        return _clean(str(inspect.signature(obj)))
    except (TypeError, ValueError):
        return "(...)"


def _emit_object(out: io.StringIO, name: str, obj) -> None:
    out.write(f"### `{name}{_signature(obj)}`\n\n")
    p = _first_paragraph(obj.__doc__)
    if p:
        out.write(p + "\n\n")
    if not inspect.isclass(obj):
        return
    # the port's own classes in the MRO (an optional library base, such as
    # gymnasium's for the adapter, would make the file depend on the install)
    seen = set()
    for klass in inspect.getmro(obj):
        if not getattr(klass, "__module__", "").startswith(PACKAGE):
            continue
        for mname, meth in vars(klass).items():
            if mname.startswith("_") or mname in seen:
                continue
            if isinstance(meth, property):
                seen.add(mname)
                out.write(f"- `.{mname}` (property) — {_first_paragraph(meth.__doc__) or '…'}\n")
                continue
            if not callable(meth):
                continue
            seen.add(mname)
            fn = inspect.unwrap(getattr(obj, mname))
            out.write(f"- `.{mname}{_signature(fn)}` — {_first_paragraph(getattr(fn, '__doc__', '')) or '…'}\n")
    out.write("\n")


def render() -> str:
    out = io.StringIO()
    out.write(
        "# API reference: smart_nanogrid_gym_torch\n\n"
        f"Public surface of `{PACKAGE}`, the PyTorch/CUDA port, grouped by module.  "
        f"Generated by `python -m {PACKAGE}.tools.gen_api_docs`; do not edit by hand.  "
        "The JAX package's surface is in `docs/API.md`.\n\n"
    )
    for mod_name, names in SURFACE:
        mod = importlib.import_module(mod_name)
        pub = names if names is not None else _public_names(mod)
        if not pub:
            continue
        out.write(f"## `{mod_name}`\n\n")
        p = _first_paragraph(mod.__doc__)
        if p:
            out.write(p + "\n\n")
        for name in pub:
            _emit_object(out, name, getattr(mod, name))
    return out.getvalue()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="docs/API_torch.md")
    p.add_argument("--check", action="store_true", help="exit 1 if the file on disk is stale")
    args = p.parse_args(argv)
    text = render()
    if args.check:
        with open(args.out) as fp:
            if fp.read() != text:
                raise SystemExit(f"{args.out} is stale; regenerate with python -m {PACKAGE}.tools.gen_api_docs")
        print(f"{args.out} is current")
        return 0
    with open(args.out, "w") as fp:
        fp.write(text)
    print(f"wrote {args.out} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    main()
