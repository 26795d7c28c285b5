"""The port's ``ng.`` spans (``utils/profiling.py::span``) on the CPU.

- With no profiler running, ``span`` returns one shared null context and
  records nothing.
- Under ``torch.profiler`` each path records its spans at its layer
  boundaries, nested as the calls nest: a kernel-path PPO update and a
  kernel-path DDPG update through the twins, ``evaluate_policy_at_scale``, ``gen_rbc_multiday`` and a 16-env
  vector env stepped through a day end.
- A span leaves every output bit-equal to a run with no profiler.
- A function under ``spanned`` keeps its name, docstring and signature,
  and its errors pass through the span unchanged.
"""

import contextlib
import inspect

import numpy as np
import pytest
import torch

from smart_nanogrid_gym_torch.compat import VectorSmartNanogridEnv
from smart_nanogrid_gym_torch.core import NanogridConfig, make_params
from smart_nanogrid_gym_torch.compat.vector_env import VectorSmartNanogridEnv as VectorEnv
from smart_nanogrid_gym_torch.core.env import SmartNanogridTorch
from smart_nanogrid_gym_torch.ops import gen_policy_multiday, gen_rbc_multiday, ppo_collect_day_seeded, ppo_sweep_streamed
from smart_nanogrid_gym_torch.ops.ddpg_collect import ddpg_collect_day_seeded
from smart_nanogrid_gym_torch.ops.ddpg_sweep import ddpg_sweep
from smart_nanogrid_gym_torch.ops.param_guard import check_baked_params
from smart_nanogrid_gym_torch.solvers import DDPGConfig, DDPGLearner, PPOConfig, PPOLearner, evaluate_policy_at_scale
from smart_nanogrid_gym_torch.solvers.networks import ActorCritic
from smart_nanogrid_gym_torch.utils import profiling

CONFIG = NanogridConfig(num_chargers=4, pv_system=True, battery_system=True)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ppo_update():
    params = make_params(CONFIG, torch.float32, "cpu")
    learner = PPOLearner(CONFIG, PPOConfig(num_epochs=2, collect_impl="kernel", sweep_impl="kernel"), device="cpu")
    state, metrics = learner.build_train_step()(learner.init(0, params, 32), params)
    return state.params + state.opt_state.mu + state.opt_state.nu + [state.batt_soc] + list(metrics)


def ddpg_update():
    params = make_params(CONFIG, torch.float32, "cpu")
    learner = DDPGLearner(CONFIG, DDPGConfig(buffer_days=2, batch_size=16, gradient_steps=2, collect_impl="kernel",
                                             sweep_impl="kernel"), device="cpu")
    state, metrics = learner.build_train_step()(learner.init(0, params, 8), params)
    return (state.actor + state.critic + state.target_actor + state.target_critic + state.actor_opt.mu
            + state.critic_opt.mu + list(state.buffer[:5]) + [state.batt_soc] + list(metrics))


def evaluate():
    torch.manual_seed(4)
    net = ActorCritic(CONFIG.obs_dim, CONFIG.num_actions)
    got = evaluate_policy_at_scale(CONFIG, make_params(CONFIG, torch.float32, "cpu"), net, 2, 8, seed=9)
    return [torch.tensor([got["mean_day_return"], got["std_day_return"], got["total_days"]], dtype=torch.float64)]


def rbc_days():
    return [gen_rbc_multiday(CONFIG, make_params(CONFIG, torch.float32, "cpu"), 2, 9, 8)]


def vector_env():
    env = VectorSmartNanogridEnv(num_envs=16, seed=3, device="cpu", number_of_chargers=4)
    obs, _ = env.reset()
    out = [obs]
    actions = np.linspace(-0.5, 1.0, 16 * CONFIG.num_actions, dtype=np.float32).reshape(16, -1)
    for _ in range(env.config.steps_per_day + 1):   # through the day end and its autoreset
        obs, rewards, dones, _, _ = env.step(actions)
        out += [obs, rewards, dones]
    return [torch.as_tensor(x) for x in out]


# each path: the spans it must record, as (a span, the spans directly inside it in order)
PATHS = {
    "ppo_update": (ppo_update, [("ng.ppo.update", ["ng.ppo.draw", "ng.collect", "ng.ppo.gae", "ng.sweep"])]),
    "ddpg_update": (ddpg_update, [("ng.ddpg.update", ["ng.ddpg.draw", "ng.ddpg.ou", "ng.collect", "ng.ddpg.replay",
                                                      "ng.ddpg.replay", "ng.sweep"])]),
    "evaluate": (evaluate, [("ng.evaluate", ["ng.guard", "ng.policy_days"])]),
    "rbc_days": (rbc_days, [("ng.rbc_days", ["ng.guard"])]),
    "vector_env": (vector_env, [("ng.vecenv.reset", ["ng.generate"])]),
}


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events() if e.name().startswith(profiling.SPAN_PREFIX))
    return out, spans


def within(s, o):
    return o[0] <= s[0] and s[1] <= o[1]


@pytest.mark.parametrize("a, b", [("ppo.update", "launch"), ("guard", "guard")])
def test_span_is_one_null_context_without_a_profiler(a, b):
    null = profiling.span(a)
    assert null is profiling.span(b) and isinstance(null, contextlib.nullcontext)
    with profiling.span(a):
        assert not torch._C._autograd._profiler_enabled()


@pytest.mark.parametrize("path", list(PATHS))
def test_path_records_its_spans_nested(path):
    fn, nesting = PATHS[path]
    _, spans = profiled(fn)
    for outer, inner in nesting:
        parents = [s for s in spans if s[2] == outer]
        assert parents, (outer, spans)
        for parent in parents:
            inside = [s for s in spans if s != parent and within(s, parent)]
            direct = [s for s in inside if not any(o != s and within(s, o) for o in inside)]
            assert [s[2] for s in direct] == inner, (outer, direct)
            assert all(a[1] <= b[0] for a, b in zip(direct, direct[1:]))   # in turn, not overlapping
    if path == "vector_env":
        names = [s[2] for s in spans]
        steps = CONFIG.steps_per_day + 1
        assert names.count("ng.engine.step") == steps and names.count("ng.to_host") == steps
        assert names.count("ng.vecenv.reset") == 2   # the first reset and the day end's


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_leave_outputs_bit_equal(path):
    fn = PATHS[path][0]
    plain = fn()
    traced, spans = profiled(fn)
    assert spans
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


SPANNED = {
    "ng.ppo.update": PPOLearner._kernel_step,
    "ng.collect": ppo_collect_day_seeded,
    "ng.sweep": ppo_sweep_streamed,
    "ng.ddpg.update": DDPGLearner._train_body,
    "ng.collect (DDPG)": ddpg_collect_day_seeded,
    "ng.sweep (DDPG)": ddpg_sweep,
    "ng.guard": check_baked_params,
    "ng.evaluate": evaluate_policy_at_scale,
    "ng.rbc_days": gen_rbc_multiday,
    "ng.policy_days": gen_policy_multiday,
    "ng.engine.step": SmartNanogridTorch.step_batch,
    "ng.vecenv.reset": VectorEnv.reset,
}


@pytest.mark.parametrize("name", list(SPANNED))
def test_spanned_function_keeps_its_name_and_signature(name):
    fn = SPANNED[name]
    inner = fn.__wrapped__
    assert (fn.__name__, fn.__qualname__, fn.__doc__) == (inner.__name__, inner.__qualname__, inner.__doc__)
    assert inspect.signature(fn) == inspect.signature(inner)


def test_spanned_passes_an_error_through():
    params = make_params(CONFIG, torch.float32, "cpu")._replace(charger_max_power=torch.tensor(11.0))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="charger_max_power=22.0"):
            check_baked_params(CONFIG, params, "k")
    assert [e.name() for e in prof.profiler.kineto_results.events() if e.name().startswith("ng.")] == ["ng.guard"]
