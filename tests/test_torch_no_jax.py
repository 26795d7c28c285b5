"""The port runs without JAX or the JAX package: importing it, rolling a
day, running one PPO and one DDPG training update (and a bf16 one of each
learner path), a DDPG at-scale evaluation, K6's bf16 twin, the tables-in
day twins, the gym adapter, the vector env, ``train_ppo --guard`` and
``evaluate --models-root`` (with the utils and the SB3 loader imported), a
seed-replayed day from the native runtime and K8's twin through
``sharded_multiday_kernel_fn`` (with ``parallel``, ``multihost_demo``,
``gen_api_docs``, the bench and ``gen_bench_table`` imported) on the CPU leave ``jax`` and
``smart_nanogrid_gym_tpu`` out of ``sys.modules``, and no file of the port
imports them.  The port's copies of the JAX-free tables equal the JAX
package's."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import tempfile
import numpy as np
import torch
import smart_nanogrid_gym_torch
import smart_nanogrid_gym_torch.envs
from smart_nanogrid_gym_torch.compat import SmartNanogridEnv, VectorSmartNanogridEnv
from smart_nanogrid_gym_torch.core import NanogridConfig, SmartNanogridTorch
from smart_nanogrid_gym_torch.ops import (
    gen_policy_multiday, gen_rbc_day, gen_rbc_multiday, policy_day_rollout, rbc_day_rollout)
from smart_nanogrid_gym_torch.solvers import (
    ActorCritic, DDPGActor, DDPGConfig, DDPGLearner, PPOConfig, PPOLearner, evaluate_policies_same_days,
    evaluate_policy_at_scale, make_rbc_policy_fn, predict_single_day)
from smart_nanogrid_gym_torch.utils import load_actor_critic_npz, load_ddpg_actor_npz

config = NanogridConfig(num_chargers=4)
env = SmartNanogridTorch(config)
params = env.default_params(torch.float32, "cpu")
gen = torch.Generator().manual_seed(0)
state, obs = env.reset_batch(params, 8, gen)
_, _, (_, rewards, _, _) = env.rollout_day(params, state, make_rbc_policy_fn(config), obs, gen)
assert rewards.shape == (24, 8) and bool(torch.isfinite(rewards).all())
gen_rbc_multiday(config, params, 1, 0, 8)
net = ActorCritic(config.obs_dim, config.num_actions)
assert rbc_day_rollout(config, params, state)[0].shape == (24, 8)
assert policy_day_rollout(config, params, state, net)[1].shape == (24, config.num_actions, 8)
rewards, info = predict_single_day(config, params, make_rbc_policy_fn(config), gen)
assert rewards.shape == (24,) and info.charger_actions.shape == (24, 4)
adapter = SmartNanogridEnv(number_of_chargers=4, output_directory=tempfile.mkdtemp(), device="cpu")
adapter.reset(seed=1)
for _ in range(24):
    out = adapter.step(np.full(5, 0.2))
assert out[2]
venv = VectorSmartNanogridEnv(num_envs=8, device="cpu", number_of_chargers=4)
venv.reset()
assert venv.step(np.zeros((8, 5)))[1].shape == (8,)
assert evaluate_policy_at_scale(config, params, net, 1, 8)["total_days"] == 8
learner = PPOLearner(config, PPOConfig(num_epochs=1, num_minibatches=2, collect_impl="kernel",
                                       sweep_impl="kernel"), device="cpu")
state, metrics = learner.build_train_step()(learner.init(0, params, 128), params)
assert state.update_step == 1 and bool(torch.isfinite(metrics.mean_return))
ddpg = DDPGLearner(config, DDPGConfig(buffer_days=1, gradient_steps=1, batch_size=16, collect_impl="kernel",
                                      sweep_impl="kernel"), device="cpu")
state, metrics = ddpg.build_train_step()(ddpg.init(0, params, 8), params)
assert state.update_step == 1 and bool(torch.isfinite(metrics.critic_loss))
low, high = config.action_bounds()
actor = DDPGActor(config.obs_dim, config.num_actions, low, high)
assert evaluate_policy_at_scale(config, params, actor, 1, 8, algorithm="ddpg")["total_days"] == 8
# the bf16 options: K6's mlp_dtype for both actors, a bf16 update of each learner path
for n, kind in ((net, "ppo"), (actor, "ddpg")):
    assert gen_policy_multiday(config, params, n, 1, 0, 8, actor=kind, mlp_dtype=torch.bfloat16).shape == (3, 8)
for impl in ("plain", "kernel"):
    learner = PPOLearner(config, PPOConfig(num_epochs=1, num_minibatches=2, collect_impl=impl, sweep_impl=impl,
                                           update_matmul_dtype=torch.bfloat16), device="cpu")
    state, metrics = learner.build_train_step()(learner.init(0, params, 128 if impl == "kernel" else 8), params)
    assert bool(torch.isfinite(metrics.policy_loss)) and state.params[0].dtype == torch.float32
    ddpg = DDPGLearner(config, DDPGConfig(buffer_days=1, gradient_steps=1, batch_size=16, collect_impl=impl,
                                          sweep_impl=impl, update_matmul_dtype=torch.bfloat16), device="cpu")
    state, metrics = ddpg.build_train_step()(ddpg.init(0, params, 8), params)
    assert bool(torch.isfinite(metrics.critic_loss)) and state.actor[0].dtype == torch.float32
# the entry points: utils, the SB3 loader and the CLIs, two of them run
from smart_nanogrid_gym_torch.compat import sb3_loader
from smart_nanogrid_gym_torch.tools import evaluate, predict, train_ddpg, train_multi, train_ppo, visualize
from smart_nanogrid_gym_torch.utils import checkpoint, guard, metrics as metrics_module, profiling
models = tempfile.mkdtemp()
train_ppo.main(["--variant", "basic", "--num-chargers", "4", "--batch", "8", "--epochs", "1",
                "--episodes-per-epoch", "8", "--models-dir", models, "--device", "cpu", "--guard"])
assert len(evaluate.main(["--variant", "basic", "--num-chargers", "4", "--days", "4", "--models-root", models,
                          "--device", "cpu"])) == 3
# the last modules: the native runtime and its seed replay, the env mesh and the multi-process runtime
from smart_nanogrid_gym_torch import native
from smart_nanogrid_gym_torch.core import schedule_from_reference_seed
from smart_nanogrid_gym_torch.parallel import distributed, make_mesh, multihost_demo
from smart_nanogrid_gym_torch.tools import bench, gen_api_docs, gen_bench_table
day = schedule_from_reference_seed(0, config, device="cpu")
assert day.occupancy.shape == (4, config.table_len) and day.occupancy.dtype == torch.float64
assert native.NativeEngine(config).obs_dim == config.obs_dim
assert distributed.sharded_multiday_kernel_fn(config, make_mesh("cpu"), 1, 8)(params, 0).shape == (2, 8)
assert "smart_nanogrid_gym_torch.native" in gen_api_docs.render()
# the bench and its table generator: the statistical gate, the README table
assert bench.stats_bounds(-350.0, 70.0, 1024, 1024)[0] > 0
assert gen_bench_table.render({"batch": 8, "config": "c", "card": "cpu", "torch": "t", "paths": {"x": 1.0}})
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "smart_nanogrid_gym_tpu")]
assert not loaded, loaded
print("ok")
"""


def test_port_runs_without_jax():
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


IMPORT = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|smart_nanogrid_gym_tpu)\b", re.M)


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(Path(REPO, "smart_nanogrid_gym_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    offenders = [str(f.relative_to(REPO)) for f in files if IMPORT.search(f.read_text())]
    assert not offenders, offenders


def _port_import_graph() -> dict[str, set[str]]:
    """Each module of the port (package ``__init__``s left out) with the
    modules of the port it imports anywhere in its body, function-level and
    type-checking imports included; an import of a package (its
    ``__init__``) adds no edge."""
    pkg = Path(REPO, "smart_nanogrid_gym_torch")
    paths = {".".join(f.relative_to(REPO).with_suffix("").parts): f for f in pkg.rglob("*.py")
             if f.name != "__init__.py"}
    graph = {}
    for name, path in paths.items():
        package = name.split(".")[:-1]
        deps = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                targets = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    base = ".".join(package[:len(package) - node.level + 1] + ([base] if base else []))
                targets = [base] + [f"{base}.{alias.name}" for alias in node.names]
            else:
                continue
            deps.update(t for t in targets if t in paths and t != name)
        graph[name] = deps
    return graph


def test_the_port_has_no_import_cycle():
    graph = _port_import_graph()
    done, stack = set(), []

    def visit(module):
        if module in stack:
            raise AssertionError("import cycle: " + " -> ".join(stack[stack.index(module):] + [module]))
        if module in done:
            return
        stack.append(module)
        for dep in sorted(graph[module]):
            visit(dep)
        stack.pop()
        done.add(module)

    for module in sorted(graph):
        visit(module)


@pytest.mark.parametrize("price_model", [0, 1, 2])
def test_port_tables_equal_the_jax_package_tables(price_model):
    from smart_nanogrid_gym_tpu.core import config as jax_config, prices as jax_prices, solar as jax_solar
    from smart_nanogrid_gym_torch.core import config, prices, solar

    np.testing.assert_array_equal(prices.build_price_table(price_model, 48)[0],
                                  jax_prices.build_price_table(price_model, 48)[0])
    assert prices.build_price_table(price_model, 48)[1] == jax_prices.build_price_table(price_model, 48)[1]
    for dt in (1.0, 0.5, 2.0):
        steps = int(24 / dt)
        for got, want in zip(solar.build_solar_tables(dt, steps), jax_solar.build_solar_tables(dt, steps)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for kw in ({}, {"num_chargers": 4, "pv_system": False}, {"vehicle_to_everything": True}):
        a, b = config.NanogridConfig(**kw), jax_config.NanogridConfig(**kw)
        assert (a.obs_dim, a.num_actions, a.steps_per_day, a.table_len) == \
            (b.obs_dim, b.num_actions, b.steps_per_day, b.table_len)
        np.testing.assert_array_equal(np.asarray(a.action_bounds()), np.asarray(b.action_bounds()))
    assert Path(solar.__file__).parent.parent == Path(REPO, "smart_nanogrid_gym_torch")
