"""Each cell's run on the CPU at a small size, the program's plain twins in
the kernels' place and the look for a card skipped: sound, it comes out
correct; with its timed path broken underneath, in each way the cell can
be broken, it comes out not correct."""

import time

import pytest
import torch

from nanobench import harness

SMALL = {
    "rbc8-eval-10kdays": dict(batch=8, days=3, check_calls=2, check_envs=8),
    "ppo64-eval-10kdays": dict(batch=8, days=3, check_calls=2, check_envs=8),
    "ppo64-train-kernel": dict(batch=64),
    "ppo64-vecenv-1024": dict(num_envs=16, check_envs=16),
}


def run(cell):
    c = harness.load_cell(cell, overrides=SMALL[cell])
    torch.manual_seed(0)
    return harness.run_cell(c, 2 ** 31 + 77, 0.05, False, torch.device("cpu"), time.perf_counter())


# ---- the evaluation kernels: their stats (Σ, Σ², ...) per env ------------------

def eval_faults(fn):
    def unchanged(*args, **kwargs):      # the state left as it was: the output never written
        return torch.zeros_like(fn(*args, **kwargs))

    def half(*args, **kwargs):           # half of the envs left out, their stats the mean of the rest
        st = fn(*args, **kwargs).clone()
        B = st.shape[1]
        st[:, B // 2:] = st[:, :B // 2].mean(dim=1, keepdim=True)
        return st

    def altered(*args, **kwargs):        # an answer altered where it is produced: one env's by 1 %
        st = fn(*args, **kwargs).clone()
        st[:2, 0] *= 1.01
        return st

    return {"unchanged": unchanged, "half": half, "altered": altered}


def patch_rbc(monkeypatch, fault):
    from smart_nanogrid_gym_torch.ops import gen_rollout

    monkeypatch.setattr(gen_rollout, "gen_rbc_multiday", eval_faults(gen_rollout.gen_rbc_multiday)[fault])


def patch_policy(monkeypatch, fault):
    from smart_nanogrid_gym_torch.solvers import evaluator

    monkeypatch.setattr(evaluator, "gen_policy_multiday", eval_faults(evaluator.gen_policy_multiday)[fault])


# ---- the learner: K2, K3 -------------------------------------------------------

def patch_train(monkeypatch, fault):
    from smart_nanogrid_gym_torch.solvers import ppo

    sweep, collect = ppo.ppo_sweep_streamed, ppo.ppo_collect_day_seeded

    def unchanged(params, adam, obs, act, logp, adv, ret, block_perm, *args, **kwargs):
        _, _, metrics = sweep(params, adam, obs, act, logp, adv, ret, block_perm, *args, **kwargs)
        return params, adam, metrics

    def half(params, adam, obs, act, logp, adv, ret, block_perm, *args, **kwargs):
        return sweep(params, adam, obs, act, logp, adv, ret, block_perm[:, :block_perm.shape[1] // 2], *args,
                     **kwargs)

    def altered(*args, **kwargs):
        out = list(collect(*args, **kwargs))
        out[4] = out[4] + 0.1   # the rewards
        return tuple(out)

    if fault == "altered":
        monkeypatch.setattr(ppo, "ppo_collect_day_seeded", altered)
    else:
        monkeypatch.setattr(ppo, "ppo_sweep_streamed", {"unchanged": unchanged, "half": half}[fault])


# ---- the vector env ----------------------------------------------------------------

def patch_vecenv(monkeypatch, fault):
    from smart_nanogrid_gym_torch.compat.vector_env import VectorSmartNanogridEnv

    step = VectorSmartNanogridEnv.step

    def unchanged(self, actions):
        before = self._states
        obs, r, d, tr, info = step(self, actions)
        if not d.all():
            self._states = before       # the step returns its state unchanged
            obs = self.engine.step_batch(self.params, before, torch.as_tensor(actions), self._generator).obs
            obs = obs.cpu().numpy()
        return obs, r, d, tr, info

    def half(self, actions):
        obs, r, d, tr, info = step(self, actions)
        r = r.copy()
        r[len(r) // 2:] = r[:len(r) // 2].mean()
        return obs, r, d, tr, info

    def altered(self, actions):
        obs, r, d, tr, info = step(self, actions)
        return obs, r + 0.01, d, tr, info

    monkeypatch.setattr(VectorSmartNanogridEnv, "step", {"unchanged": unchanged, "half": half,
                                                         "altered": altered}[fault])


PATCH = {"rbc8-eval-10kdays": patch_rbc, "ppo64-eval-10kdays": patch_policy, "ppo64-train-kernel": patch_train,
         "ppo64-vecenv-1024": patch_vecenv}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    PATCH[cell](monkeypatch, fault)
    r = run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "nonfinite"])
def test_training_window_fault_is_not_correct(fault, monkeypatch):
    """The learner broken only from the window's first update on, after the
    updates the reference follows: the check of the window's final state
    still finds it."""
    from smart_nanogrid_gym_torch.solvers import ppo

    sweep, calls = ppo.ppo_sweep_streamed, []
    first = harness.load_cell("ppo64-train-kernel", overrides=SMALL["ppo64-train-kernel"]).traffic["check_updates"]

    def late(params, adam, *args, **kwargs):
        calls.append(1)
        new_params, new_adam, metrics = sweep(params, adam, *args, **kwargs)
        if len(calls) <= first:
            return new_params, new_adam, metrics
        if fault == "unchanged":
            return params, adam, metrics
        return [x * float("nan") for x in new_params], new_adam, metrics

    monkeypatch.setattr(ppo, "ppo_sweep_streamed", late)
    r = run("ppo64-train-kernel")
    assert len(calls) > first
    assert not r["correct"], r["checks"]
