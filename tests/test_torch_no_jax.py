"""The port runs without JAX: importing it and rolling a day on the CPU
leaves ``jax`` out of ``sys.modules``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import torch
import smart_nanogrid_gym_torch
from smart_nanogrid_gym_torch.core import NanogridConfig, SmartNanogridTorch
from smart_nanogrid_gym_torch.ops import gen_policy_multiday, gen_rbc_day, gen_rbc_multiday
from smart_nanogrid_gym_torch.solvers import (
    ActorCritic, evaluate_policies_same_days, evaluate_policy_at_scale, make_rbc_policy_fn)
from smart_nanogrid_gym_torch.utils import load_actor_critic_npz

config = NanogridConfig(num_chargers=4)
env = SmartNanogridTorch(config)
params = env.default_params(torch.float32, "cpu")
gen = torch.Generator().manual_seed(0)
state, obs = env.reset_batch(params, 8, gen)
_, _, (_, rewards, _, _) = env.rollout_day(params, state, make_rbc_policy_fn(config), obs, gen)
assert rewards.shape == (24, 8) and bool(torch.isfinite(rewards).all())
gen_rbc_multiday(config, params, 1, 0, 8)
net = ActorCritic(config.obs_dim, config.num_actions)
assert evaluate_policy_at_scale(config, params, net, 1, 8)["total_days"] == 8
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")]
assert not loaded, loaded
print("ok")
"""


def test_port_runs_without_jax():
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
