"""On-device DDPG (port of ``solvers/ddpg.py``).

SB3's DDPG with Ornstein-Uhlenbeck exploration noise (σ 0.5, θ 0.15, dt
1e-2): each update collects ``steps_per_update`` env steps per env (a fresh
generated day, the battery carried, the OU state restarted at zero), writes
them into a circular replay buffer on the device, and runs
``gradient_steps`` critic + actor steps on minibatches sampled from it,
each followed by polyak averaging of the target networks.  Networks and
hyperparameters default to SB3's DDPG (400-300 ReLU, lr 1e-3, γ 0.99, τ
5e-3, batch 256), as in the JAX package.

Two implementations, chosen per phase (``"plain"`` is the counterpart of the
JAX ``"xla"``, ``"kernel"`` of ``"pallas"``):

- ``collect_impl="plain"``: the plain engine (``generate_schedule`` +
  ``reset`` + ``fused_day_rollout`` with the OU sequence fed through
  ``policy_xs``; a collect window shorter than a day steps the env one step
  at a time); ``collect_impl="kernel"``: one launch of K9 seeded
  (``ops/ddpg_collect.py``) per update, whole days only;
- ``sweep_impl="plain"``: autograd and ``optax.adam`` written out;
  ``sweep_impl="kernel"``: K10 (``ops/ddpg_sweep.py``) on the minibatches
  gathered up front.

Every random draw (the day, the OU gaussians, the K9 seed, the minibatch
indices) comes from the state's host ``torch.Generator``, so an update never
waits on the card; a test passes JAX's own draws through :class:`DDPGDraws`
instead.  The kernel path's OU gaussians have the shape ``(T, A, B)``, the
plain path's ``(T, B, A)``, as in the JAX learner (ddpg.py:210-220): the two
streams are not comparable across implementations.  The replay buffer is
updated in place (at B = 4096 it holds 1.2 GB).  The learner runs on the card
unless it is given ``device="cpu"``.

With ``mesh=`` an :class:`..parallel.mesh.EnvMesh` the learner is one rank of
a data-parallel run, with the JAX learner's mesh semantics (ddpg.py:335-402):
the networks, targets and Adam states are replicated (broadcast from rank 0
at init), the batteries and the replay buffer stay on their rank, and the
critic's and the actor's gradients of each step are averaged across ranks
(one flat all-reduce each), as are the metrics.  The collection and sampling
draws differ between ranks (JAX's ``fold_in(k, shard)``): each rank draws the
days and OU gaussians of the global batch and keeps its envs' slice, and
draws every rank's minibatch indices and keeps its own, so each rank's host
draws cost O(W·B) for its B envs.  At world size 1 a
mesh changes nothing; the kernel paths apply Adam locally and raise
``ValueError`` at world size > 1, as in the JAX package.

``update_matmul_dtype=torch.bfloat16`` follows the JAX learner per path:
``sweep_impl="kernel"`` hands it to K10 and its twin (both operands of every
product rounded to bf16, f32 accumulation, ``ops/ddpg_sweep.py``);
``sweep_impl="plain"`` ignores it, as the JAX XLA scan does
(``_train_body``, ddpg.py:349-389, never reads it), and trains in f32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.config import NanogridConfig
from ..core.generate import draw_uniforms, generate_schedule
from ..core.params import NanogridParams
from ..core.rollout import fused_day_rollout
from ..core.transition import draw_pv_shift, reset, step
from ..ops.ddpg_collect import ddpg_collect_day_seeded
from ..ops.ddpg_sweep import DDPGSweepHypers, ddpg_sweep
from ..ops._build import bf16_operands
from ..ops.param_guard import check_baked_params
from ..ops.ppo_sweep import AdamState, zeros_adam
from ..parallel.mesh import EnvMesh, replicate
from ..utils.profiling import span, spanned
from .networks import DDPG_HIDDEN, DDPGActor, DDPGCritic, ddpg_leaves
from .ppo import check_mesh, mean_over_ranks, optax_adam_step

F32 = torch.float32
IMPLS = ("plain", "kernel")


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    learning_rate: float = 1e-3
    gamma: float = 0.99
    tau: float = 5e-3
    batch_size: int = 256
    buffer_days: int = 50          # replay capacity in days of the env batch
    ou_sigma: float = 0.5          # reference ddpg_train.py:111
    ou_theta: float = 0.15
    ou_dt: float = 1e-2            # SB3 OrnsteinUhlenbeckActionNoise default
    steps_per_update: int = 24     # env steps collected per update (one day)
    gradient_steps: int = 24
    sweep_impl: str = "plain"
    collect_impl: str = "plain"
    # operand dtype of K10's products: None / torch.float32, or torch.bfloat16;
    # the plain sweep ignores it, as the JAX XLA scan does
    update_matmul_dtype: object | None = None


class ReplayBuffer(NamedTuple):
    obs: torch.Tensor        # (C, B, F)
    actions: torch.Tensor    # (C, B, A)
    rewards: torch.Tensor    # (C, B)
    next_obs: torch.Tensor   # (C, B, F)
    dones: torch.Tensor      # (C, B) bool
    insert_pos: int
    filled: int


class DDPGTrainState(NamedTuple):
    actor: list               # the 6 leaves of networks.ddpg_leaves
    critic: list
    target_actor: list
    target_critic: list
    actor_opt: AdamState
    critic_opt: AdamState
    buffer: ReplayBuffer
    batt_soc: torch.Tensor    # (B,) the BESS state carried from day to day
    last_obs: torch.Tensor    # (B, F) the last collected step's next observation
    ou_state: torch.Tensor    # (B, A) the OU noise at the end of the last collect
    generator: torch.Generator  # host generator of every draw
    update_step: int


class DDPGMetrics(NamedTuple):
    critic_loss: torch.Tensor
    actor_loss: torch.Tensor
    mean_return: torch.Tensor  # mean per-env return of the collected steps


class DDPGDraws(NamedTuple):
    """The draws of one update: the OU gaussians (``(T, B, A)`` for the plain
    collection, ``(T, A, B)`` for the kernel's), the minibatch indices
    ``t_idx``/``b_idx (G, M)``, and the day: ``uniforms (B, T, 5, N)`` and
    ``pv_shift (B,)`` for the plain collection, ``seed`` for K9."""

    gaussians: torch.Tensor
    t_idx: torch.Tensor
    b_idx: torch.Tensor
    uniforms: torch.Tensor | None = None
    pv_shift: torch.Tensor | None = None
    seed: int | None = None


def ou_step(ou, gaussian, theta, sigma, dt, mu=0.0):
    """One Ornstein-Uhlenbeck step, SB3's ``OrnsteinUhlenbeckActionNoise``:
    ``x' = x + θ(μ − x)·dt + σ·√dt·N``, with ``√dt`` taken in ``ou``'s dtype."""
    return ou + theta * (mu - ou) * dt + sigma * torch.sqrt(torch.tensor(dt, dtype=ou.dtype)) * gaussian


def actor_apply(leaves, obs, low, high):
    """The flax ``DDPGActor.apply`` on 6 leaves: ReLU torso, squashed into the box."""
    w1, b1, w2, b2, w3, b3 = leaves
    lin = torch.nn.functional.linear
    x = lin(torch.relu(lin(torch.relu(lin(obs, w1, b1)), w2, b2)), w3, b3)
    return low + (torch.tanh(x) + 1.0) * 0.5 * (high - low)


def critic_apply(leaves, obs, action):
    """The flax ``DDPGCritic.apply`` on 6 leaves: Q of ``cat([obs, action])``."""
    w1, b1, w2, b2, w3, b3 = leaves
    lin = torch.nn.functional.linear
    x = torch.cat([obs, action], dim=-1)
    return lin(torch.relu(lin(torch.relu(lin(x, w1, b1)), w2, b2)), w3, b3)[..., 0]


class DDPGLearner:
    """The DDPG learner for one env config on one device (one rank of ``mesh``).
    Under a ``torch.profiler`` an update records the span ``ng.ddpg.update``
    around ``ng.ddpg.draw`` (the host draws), ``ng.ddpg.ou`` (the OU
    sequence), ``ng.collect`` (the collection day), ``ng.ddpg.replay`` (the
    day's insert, then the minibatches' gather) and ``ng.sweep``."""

    def __init__(self, env_config: NanogridConfig, ddpg_config: DDPGConfig | None = None,
                 mesh: EnvMesh | None = None, device: torch.device | str = "cuda"):
        self.env_config = env_config
        self.cfg = ddpg_config or DDPGConfig()
        self._bf16 = bf16_operands(self.cfg.update_matmul_dtype)
        for field in ("collect_impl", "sweep_impl"):
            if getattr(self.cfg, field) not in IMPLS:
                raise ValueError(f"DDPGConfig.{field} must be one of {IMPLS}, got "
                                 f"{getattr(self.cfg, field)!r}")
        self.mesh = check_mesh(mesh, self.cfg.collect_impl, self.cfg.sweep_impl)
        self.device = torch.device(mesh.device if mesh is not None else device)
        self.hidden = DDPG_HIDDEN
        low, high = env_config.action_bounds()
        self._low_high = (low, high)
        self._action_low = torch.as_tensor(low, dtype=F32, device=self.device)
        self._action_high = torch.as_tensor(high, dtype=F32, device=self.device)
        self.nanogrid_params = None
        # route whole-day plain collects through the sequential fallback (tests)
        self._force_sequential_collect = False

    # ------------------------------------------------------------------ init --

    def init(self, seed: int, nanogrid_params: NanogridParams, batch_size: int) -> DDPGTrainState:
        """Fresh networks with the flax initialisation (targets equal to
        them), zero Adam states, an empty buffer and the battery at its
        initial SoC for ``batch_size`` envs; every later draw comes from a
        host generator seeded with ``seed`` (this rank's envs and the
        networks of rank 0, with a mesh)."""
        generator = torch.Generator().manual_seed(seed)
        cfg = self.env_config
        low, high = self._low_high
        actor = DDPGActor(cfg.obs_dim, cfg.num_actions, low, high, self.hidden, generator)
        critic = DDPGCritic(cfg.obs_dim, cfg.num_actions, self.hidden, generator)
        a, c = ([x.detach().to(self.device) for x in ddpg_leaves(net)] for net in (actor, critic))
        if self.mesh is not None:
            a, c = replicate([a, c], self.mesh)
        batt = nanogrid_params.batt_init_soc.reshape(-1)[0].to(device=self.device, dtype=F32)
        return self.state_from(a, c, a, c, zeros_adam(a), zeros_adam(c), batt.expand(batch_size).clone(),
                               generator, nanogrid_params)

    def empty_buffer(self, batch_size: int) -> ReplayBuffer:
        C = self.cfg.buffer_days * self.env_config.steps_per_day
        F, A = self.env_config.obs_dim, self.env_config.num_actions
        z = dict(dtype=F32, device=self.device)
        return ReplayBuffer(torch.zeros((C, batch_size, F), **z), torch.zeros((C, batch_size, A), **z),
                            torch.zeros((C, batch_size), **z), torch.zeros((C, batch_size, F), **z),
                            torch.zeros((C, batch_size), dtype=torch.bool, device=self.device), 0, 0)

    def state_from(self, actor, critic, target_actor, target_critic, actor_opt: AdamState,
                   critic_opt: AdamState, batt_soc: torch.Tensor, generator: torch.Generator,
                   nanogrid_params: NanogridParams, buffer: ReplayBuffer | None = None) -> DDPGTrainState:
        """A train state from given networks, Adam states and batteries (for
        example :func:`..utils.weights.ddpg_state_from_jax`'s); an empty
        buffer unless one is given."""
        self.nanogrid_params = nanogrid_params
        to = dict(device=self.device, dtype=F32)

        def leaves(xs):
            return [x.detach().to(**to).clone() for x in xs]

        def adam(o):
            return AdamState(int(o.count), leaves(o.mu), leaves(o.nu))

        B = batt_soc.shape[0]
        F, A = self.env_config.obs_dim, self.env_config.num_actions
        return DDPGTrainState(
            leaves(actor), leaves(critic), leaves(target_actor), leaves(target_critic), adam(actor_opt),
            adam(critic_opt), buffer if buffer is not None else self.empty_buffer(B), batt_soc.to(**to),
            torch.zeros((B, F), **to), torch.zeros((B, A), **to), generator, 0)

    # ------------------------------------------------------------- pieces --

    def _hypers(self) -> DDPGSweepHypers:
        return DDPGSweepHypers(lr=self.cfg.learning_rate, gamma=self.cfg.gamma, tau=self.cfg.tau,
                               matmul_dtype=torch.bfloat16 if self._bf16 else None)

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """A host tensor on the learner's device without waiting for the card."""
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def _indices(self, generator: torch.Generator, batch: int, filled: int, world: int = 1, rank: int = 0):
        shape = (world, self.cfg.gradient_steps, self.cfg.batch_size)
        t_idx = torch.randint(0, max(filled, 1), shape, generator=generator)
        return t_idx[rank], torch.randint(0, batch, shape, generator=generator)[rank]

    def draw(self, generator: torch.Generator, batch: int, filled: int) -> DDPGDraws:
        """One update's draws from ``generator`` (host) for ``batch`` envs;
        ``filled`` is the buffer's fill after the update's collect (``_sample``
        draws ``t_idx < max(filled, 1)``, ddpg.py:320-331).  With a mesh, the
        day and the gaussians of the global batch, of which this rank keeps
        its envs', and this rank's own minibatch indices."""
        T, A = self.cfg.steps_per_update, self.env_config.num_actions
        world, rank = (self.mesh.world_size, self.mesh.rank) if self.mesh is not None else (1, 0)
        lo, hi = rank * batch, (rank + 1) * batch
        if self.cfg.collect_impl == "kernel":
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
            gaussians = torch.randn((T, A, batch), generator=generator)
            return DDPGDraws(gaussians, *self._indices(generator, batch, filled), seed=seed)
        uniforms = draw_uniforms(self.env_config, batch * world, generator, F32, "cpu")[lo:hi]
        pv_shift = draw_pv_shift(batch * world, generator, F32, "cpu")[lo:hi]
        gaussians = torch.randn((T, batch * world, A), generator=generator)[:, lo:hi].contiguous()
        return DDPGDraws(gaussians, *self._indices(generator, batch, filled, world, rank), uniforms, pv_shift)

    def _ou_sequence(self, gaussians: torch.Tensor) -> torch.Tensor:
        """The OU states of one collect from zero (each collect is a fresh
        episode, where SB3 resets the noise)."""
        ou = torch.zeros_like(gaussians[0])
        seq = []
        for g in gaussians:
            ou = ou_step(ou, g, self.cfg.ou_theta, self.cfg.ou_sigma, self.cfg.ou_dt)
            seq.append(ou)
        return torch.stack(seq)

    @staticmethod
    def _insert_day(buffer: ReplayBuffer, t_obs, t_act, rewards, next_obs, dones) -> ReplayBuffer:
        """Write a whole ``(T, B, ...)`` block at ``insert_pos`` in place.  The
        capacity must be a multiple of the block, so that whole-block inserts
        never wrap mid-block (ddpg.py:292-318)."""
        T = t_obs.shape[0]
        C = buffer.obs.shape[0]
        if C % T != 0:
            raise ValueError(f"replay capacity {C} must be a multiple of the day block {T}: "
                             "whole-day inserts assume a block-aligned insert_pos (no mid-block wrap)")
        pos = buffer.insert_pos
        for dst, src in zip(buffer[:5], (t_obs, t_act, rewards, next_obs, dones)):
            dst[pos:pos + T] = src
        return buffer._replace(insert_pos=(pos + T) % C, filled=min(buffer.filled + T, C))

    @staticmethod
    def _sample(buffer: ReplayBuffer, t_idx: torch.Tensor, b_idx: torch.Tensor):
        """The transitions at ``(t_idx, b_idx)``: obs, actions, rewards,
        next_obs and dones (as floats), each leading with the indices' shape."""
        return (buffer.obs[t_idx, b_idx], buffer.actions[t_idx, b_idx], buffer.rewards[t_idx, b_idx],
                buffer.next_obs[t_idx, b_idx], buffer.dones[t_idx, b_idx].to(F32))

    # ------------------------------------------------------------- collect --

    def _collect(self, state: DDPGTrainState, env_params, draws: DDPGDraws):
        """``steps_per_update`` steps per env with OU exploration, written
        into the buffer; returns ``(batt_soc, obs, ou_final, buffer, rewards
        (T, B))``."""
        T = self.cfg.steps_per_update
        B = state.batt_soc.shape[0]
        low, high = self._action_low, self._action_high
        with span("ddpg.ou"):
            ou_seq = self._ou_sequence(self._to_device(draws.gaussians))
        if self.cfg.collect_impl == "kernel" and not self._force_sequential_collect:
            obs, act, rew, nxt, batt = ddpg_collect_day_seeded(
                self.env_config, env_params, state.actor, draws.seed, ou_seq, state.batt_soc, B,
                check_params=False)
            with span("ddpg.replay"):
                dones = torch.zeros((T, B), dtype=torch.bool, device=rew.device)
                dones[-1] = True
                t_next = nxt.permute(0, 2, 1)
                buffer = self._insert_day(state.buffer, obs.permute(0, 2, 1), act.permute(0, 2, 1), rew,
                                          t_next, dones)
            return batt, t_next[-1], ou_seq[-1].T, buffer, rew

        schedule = generate_schedule(self.env_config, env_params, self._to_device(draws.uniforms))
        st, obs = reset(self.env_config, env_params, schedule, batt_soc=state.batt_soc,
                        pv_shift=self._to_device(draws.pv_shift))

        def explore(ob, ou_t):
            return torch.clamp(actor_apply(state.actor, ob, low, high) + ou_t, low, high)

        if T == self.env_config.steps_per_day and not self._force_sequential_collect:
            def policy_step(ob, ou_t):
                a = explore(ob, ou_t)
                return a, (ob, a)

            final, (obs_traj, rewards, dones, (t_obs, t_act)) = fused_day_rollout(
                self.env_config, env_params, st, policy_step, next_pv_shift=st.pv_shift, policy_aux=True,
                policy_xs=ou_seq)
            with span("ddpg.replay"):
                buffer = self._insert_day(state.buffer, t_obs, t_act, rewards, obs_traj, dones)
            return final.batt_soc, obs_traj[-1], ou_seq[-1], buffer, rewards

        # a partial-day window steps the env one step at a time, one buffer row each
        buffer, rewards = state.buffer, []
        C = buffer.obs.shape[0]
        for t in range(T):
            action = explore(obs, ou_seq[t])
            res = step(self.env_config, env_params, st, action, next_pv_shift=st.pv_shift)
            pos = buffer.insert_pos
            for dst, src in zip(buffer[:5], (obs, action, res.reward, res.obs, res.done)):
                dst[pos] = src
            buffer = buffer._replace(insert_pos=(pos + 1) % C, filled=min(buffer.filled + 1, C))
            st, obs = res.state, res.obs
            rewards.append(res.reward)
        return st.batt_soc, obs, ou_seq[-1], buffer, torch.stack(rewards)

    # --------------------------------------------------------------- sweep --

    def _plain_sweep(self, state: DDPGTrainState, batches):
        """The gradient steps through autograd with ``optax.adam`` written
        out, as the JAX learner's ``gradient_step`` (ddpg.py:349-381)."""
        low, high = self._action_low, self._action_high
        gamma, tau, lr = self.cfg.gamma, self.cfg.tau, self.cfg.learning_rate
        actor, critic = state.actor, state.critic
        t_actor, t_critic = state.target_actor, state.target_critic
        a_opt, c_opt = state.actor_opt, state.critic_opt
        rows = []
        for obs, act, rew, nxt, done in zip(*batches):
            with torch.no_grad():
                target_q = rew + gamma * (1.0 - done) * critic_apply(t_critic, nxt, actor_apply(t_actor, nxt, low,
                                                                                                 high))
            leaves = [p.detach().clone().requires_grad_(True) for p in critic]
            c_loss = ((critic_apply(leaves, obs, act) - target_q) ** 2).mean()
            c_grads = mean_over_ranks(self.mesh, torch.autograd.grad(c_loss, leaves))
            critic, c_opt = optax_adam_step(critic, c_opt, c_grads, lr)
            critic = [p.detach() for p in critic]
            leaves = [p.detach().clone().requires_grad_(True) for p in actor]
            a_loss = -critic_apply(critic, obs, actor_apply(leaves, obs, low, high)).mean()
            a_grads = mean_over_ranks(self.mesh, torch.autograd.grad(a_loss, leaves))
            actor, a_opt = optax_adam_step(actor, a_opt, a_grads, lr)
            actor = [p.detach() for p in actor]
            t_actor = [(1 - tau) * t + tau * p for t, p in zip(t_actor, actor)]
            t_critic = [(1 - tau) * t + tau * p for t, p in zip(t_critic, critic)]
            rows.append(torch.stack([c_loss.detach(), a_loss.detach()]))
        return actor, critic, t_actor, t_critic, a_opt, c_opt, torch.stack(rows)

    @spanned("ddpg.update")
    def _train_body(self, state: DDPGTrainState, env_params, draws: DDPGDraws | None = None):
        """One update: collect, insert, sample, sweep (ddpg.py:333-403)."""
        B = state.batt_soc.shape[0]
        C = state.buffer.obs.shape[0]
        filled = min(state.buffer.filled + self.cfg.steps_per_update, C)
        if draws is None:
            with span("ddpg.draw"):
                draws = self.draw(state.generator, B, filled)
        batt, obs, ou, buffer, rewards = self._collect(state, env_params, draws)
        with span("ddpg.replay"):
            batches = self._sample(buffer, self._to_device(draws.t_idx), self._to_device(draws.b_idx))
        if self.cfg.sweep_impl == "kernel":
            out = ddpg_sweep(state.actor, state.critic, state.target_actor, state.target_critic,
                             state.actor_opt, state.critic_opt, *batches, self._action_low, self._action_high,
                             self._hypers())
        else:
            out = self._plain_sweep(state, batches)
        actor, critic, t_actor, t_critic, a_opt, c_opt, metrics_g = out
        metrics = DDPGMetrics(*mean_over_ranks(self.mesh, [metrics_g[:, 0].mean(), metrics_g[:, 1].mean(),
                                                            rewards.sum(dim=0).mean()]))
        new = DDPGTrainState(actor, critic, t_actor, t_critic, a_opt, c_opt, buffer, batt, obs, ou,
                             state.generator, state.update_step + 1)
        return new, metrics

    # --------------------------------------------------------- entry points --

    def _check(self, env_params) -> None:
        T = self.cfg.steps_per_update
        if T > self.env_config.steps_per_day:
            raise ValueError(f"steps_per_update {T} exceeds the day of {self.env_config.steps_per_day} steps")
        if self.cfg.collect_impl == "kernel":
            if T != self.env_config.steps_per_day:
                raise ValueError("collect_impl='kernel' collects whole days (steps_per_update == steps_per_day)")
            check_baked_params(self.env_config, env_params, "DDPGConfig.collect_impl='kernel'",
                               generation=True)
            if self.env_config.lookahead != 3:
                raise ValueError("collect_impl='kernel' bakes the reference 3-step observation lookahead")

    def build_train_step(self):
        """``train_step(state, env_params, draws=None) -> (state, metrics)``,
        after the param guard of the kernel path; ``draws`` replaces the
        generator's draws."""
        checked = []

        def train_step(state: DDPGTrainState, env_params, draws: DDPGDraws | None = None):
            if not checked:
                self._check(env_params)
                checked.append(True)
            return self._train_body(state, env_params, draws)

        return train_step

    def build_train_many(self, updates_per_call: int):
        """``train_many(state, env_params) -> (state, metrics)`` running
        ``updates_per_call`` updates, metrics stacked over them.  The param
        guard runs here too (the JAX package skips it)."""
        step_fn = self.build_train_step()

        def train_many(state: DDPGTrainState, env_params):
            history = []
            for _ in range(updates_per_call):
                state, metrics = step_fn(state, env_params)
                history.append(metrics)
            return state, DDPGMetrics(*(torch.stack(x) for x in zip(*history)))

        return train_many

    def train(self, state: DDPGTrainState, num_updates: int, log_every: int = 0):
        """Run ``num_updates`` updates; returns the final state and the metric
        history (floats) at every ``log_every``-th update and the last."""
        step_fn = self.build_train_step()
        history = []
        for i in range(num_updates):
            state, metrics = step_fn(state, self.nanogrid_params)
            if log_every and (i % log_every == 0 or i == num_updates - 1):
                history.append(DDPGMetrics(*(float(x) for x in metrics)))
        return state, history

    def policy_fn(self, actor_leaves):
        """Deterministic policy ``obs -> actions`` (``DDPGLearner.policy_fn``)."""
        low, high = self._action_low, self._action_high

        def policy(obs, generator=None):
            with torch.no_grad():
                return actor_apply(actor_leaves, obs, low, high)

        return policy
