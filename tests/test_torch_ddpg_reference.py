"""The port's DDPG learner on its kernel path, run on CPU tensors (K9's and
K10's plain twins), against the benchmark's plain reference
(``nanobench/reference/ddpg.py``, autograd in f32) on seeded random weights
at SB3's 400-300 widths: 16 envs of the benchmark's 8-charger grid, 2
updates of 2 gradient steps of 32 samples from a 2-day replay.

Compared, each with the tolerance and its reason:

- the replay after both days (observations, actions, rewards, next
  observations, dones): ``rtol = atol = 1e-4``.  The twin sums the actor's
  products in index order, the reference through ``torch.matmul``: an
  action moves by about 1e-6 of its size, and the SoC columns carry that
  through the day's 24 steps (about 2e-5 in these runs); the dones are set
  alike, exactly;
- each update's critic loss, actor loss and mean return: ``rtol = 1e-4``.
  The twin's loss sums run in sample order, the reference's in its own
  (about 3e-6 apart here);
- the actor, critic and both targets after 2 updates: ``atol = 1e-4``, a
  tenth of the learning rate.  Each parameter moved by up to 4 Adam steps
  of about the learning rate; rounding of the gradients moves a step far
  less (under 2e-5 here), where an error in the mathematics moves it by
  a whole step;
- the Adam moments: ``rtol = 1e-4``, ``atol = 1e-6``: the gradients' own
  rounding, relative.

With ``update_matmul_dtype=bfloat16`` K10's twin rounds both operands of
every product to bf16, a lower precision than the configuration's f32: the
same comparison breaks at least one of these tolerances.
"""

import json
from pathlib import Path

import pytest
import torch

from nanobench import common
from nanobench.reference import ddpg as ref
from nanobench.reference.tables import grid_tables
from smart_nanogrid_gym_torch.core.params import make_params
from smart_nanogrid_gym_torch.ops.ppo_sweep import zeros_adam
from smart_nanogrid_gym_torch.solvers.ddpg import DDPGConfig, DDPGLearner

ROOT = Path(__file__).resolve().parent.parent
GRID = json.loads((ROOT / "nanobench/configs/nanogrid8-bpv-ddpg400.json").read_text())["grid"]
B, G, M, UPDATES, DAYS = 16, 2, 32, 2, 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def torso(fan_in, out, gen):
    sizes, leaves = [fan_in, 400, 300, out], []
    for rows, cols in zip(sizes[1:], sizes[:-1]):
        leaves += [torch.randn((rows, cols), generator=gen) / cols ** 0.5, 0.01 * torch.randn(rows, generator=gen)]
    return leaves


def both(dtype):
    """The learner's state and metrics after ``UPDATES`` updates, and the
    reference's updates, from the same weights and generator seed."""
    cfg = common.program_config(GRID)
    F, A = cfg.obs_dim, cfg.num_actions
    gen = torch.Generator().manual_seed(11)
    actor, critic = torso(F, A, gen), torso(F + A, 1, gen)
    learner = DDPGLearner(cfg, DDPGConfig(batch_size=M, gradient_steps=G, buffer_days=DAYS, collect_impl="kernel",
                                          sweep_impl="kernel", update_matmul_dtype=dtype), device="cpu")
    params = make_params(cfg, torch.float32, "cpu")
    batt = torch.full((B,), float(GRID["battery_initial_soc"]))
    state = learner.state_from(actor, critic, actor, critic, zeros_adam(actor), zeros_adam(critic), batt,
                               torch.Generator().manual_seed(5), params)
    step, metrics = learner.build_train_step(), []
    for _ in range(UPDATES):
        state, m = step(state, params)
        metrics.append(m)

    hp = ref.Hypers(minibatch=M, gradient_steps=G, buffer_days=DAYS)
    nets = ref.Nets(actor, critic, actor, critic)
    a_opt, c_opt = (ref.Adam(0, [torch.zeros_like(x) for x in net], [torch.zeros_like(x) for x in net])
                    for net in (actor, critic))
    replay = ref.empty_replay(DAYS, cfg.steps_per_day, B, F, A, "cpu")
    low, high = (torch.as_tensor(x) for x in cfg.action_bounds())
    tab, ref_gen, ups = grid_tables(GRID, ROOT, "cpu"), torch.Generator().manual_seed(5), []
    for _ in range(UPDATES):
        up = ref.update(GRID, tab, nets, a_opt, c_opt, replay, batt, ref_gen, low, high, hp)
        nets, a_opt, c_opt, replay, batt = up.nets, up.actor_opt, up.critic_opt, up.replay, up.batt
        ups.append(up)
    return state, metrics, ups


def close(got, want, **tol) -> bool:
    return all(torch.allclose(g.double(), w.double(), **tol) for g, w in zip(got, want))


def agreement(state, metrics, ups) -> dict:
    last = ups[-1]
    losses = [(float(m.critic_loss), u.critic_loss) for m, u in zip(metrics, ups)]
    losses += [(float(m.actor_loss), u.actor_loss) for m, u in zip(metrics, ups)]
    losses += [(float(m.mean_return), u.mean_return) for m, u in zip(metrics, ups)]
    buffer = state.buffer
    return {
        "replay": close(buffer[:4], last.replay[:4], rtol=1e-4, atol=1e-4)
        and torch.equal(buffer.dones.float(), last.replay.done) and buffer.filled == last.replay.filled,
        "losses": all(abs(p - r) <= 1e-4 * abs(r) for p, r in losses),
        "networks": close(state.actor + state.critic + state.target_actor + state.target_critic,
                          last.nets.actor + last.nets.critic + last.nets.t_actor + last.nets.t_critic,
                          rtol=0.0, atol=1e-4),
        "moments": close(state.actor_opt.mu + state.actor_opt.nu + state.critic_opt.mu + state.critic_opt.nu,
                         last.actor_opt.mu + last.actor_opt.nu + last.critic_opt.mu + last.critic_opt.nu,
                         rtol=1e-4, atol=1e-6)
        and state.actor_opt.count == last.actor_opt.count == state.critic_opt.count == UPDATES * G,
    }


def test_kernel_learner_matches_the_reference():
    got = agreement(*both(torch.float32))
    assert all(got.values()), got


def test_bf16_sweep_breaks_a_tolerance():
    got = agreement(*both(torch.bfloat16))
    assert not all(got.values()), got
