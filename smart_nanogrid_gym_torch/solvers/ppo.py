"""On-device PPO (port of ``solvers/ppo.py``).

Each update collects one fresh generated day per env with the current
stochastic policy (the battery carried from the previous update), computes
GAE, and runs ``num_epochs × num_minibatches`` clipped-PPO gradient steps with
optax's ``chain(clip_by_global_norm, adam)`` written out.  Hyperparameters
default to SB3's PPO defaults, as in the JAX package.

Two implementations, chosen per phase as the JAX ``PPOConfig`` chooses them
(``"plain"`` is the counterpart of ``"xla"``, ``"kernel"`` of ``"pallas"``):

- ``collect_impl="plain"``: the plain engine (``generate_schedule`` + ``reset``
  + ``fused_day_rollout``) with the actor-critic as ``torch`` matrix products;
  ``collect_impl="kernel"``: one launch of K2 (``ops/collect.py``) per update,
  which requires ``sweep_impl="kernel"`` and ``rollout_days=1`` and feeds K3
  the ``(T, feat, B)`` trajectory as it is;
- ``sweep_impl="plain"``: ``_loss`` through autograd and the optimizer written
  out; ``sweep_impl="kernel"``: K3 (``"block"`` scheme) or K4 (``"env"``
  scheme) of ``ops/ppo_sweep.py``.

``update_matmul_dtype=torch.bfloat16`` keeps each path's JAX semantics, and
the two differ:

- ``sweep_impl="plain"`` (the XLA ``_loss``, ppo.py:316-327): the params and
  the observations are cast to bf16 and the whole actor-critic apply runs in
  bf16 as flax runs it: each ``Dense`` rounds its product to bf16, then adds
  the bf16 bias in bf16; tanh runs on bf16 values; ``log_std`` is the
  bf16-rounded parameter; the outputs are cast back to f32, and autograd
  carries the gradients back through the casts into the f32 master params;
- ``sweep_impl="kernel"``: K3/K4's operand-only rounding
  (``SweepHypers.matmul_dtype``, ``ops/ppo_sweep.py``): both operands of
  every product rounded, the products accumulated in f32, everything else
  f32.

The collection and GAE run in f32 either way.

Every random draw (the days, the action noise, the Philox seeds, the
minibatch permutations) comes from the state's host ``torch.Generator``, so an
update never waits on the card; a test passes JAX's own draws through
:class:`PlainDraws` instead.  The learner runs on the card unless it is given
``device="cpu"``.

With ``mesh=`` an :class:`..parallel.mesh.EnvMesh` the learner is one rank of
a data-parallel run, with the JAX learner's mesh semantics (ppo.py:217-250,
514-536): the params and Adam state are replicated (broadcast from rank 0 at
init), the batteries, days and trajectories stay on their rank, each
gradient step takes the mean of the ranks' gradients (one flat all-reduce
per step) before the clip and Adam, and the metrics are averaged across
ranks.  Every rank shares the generator seed: each draws the days and the
action noise of the **global** batch and keeps its own envs' slice, and all
draw the same minibatch permutations over their local samples.  So each
rank's host draws cost O(W·B) for its B envs, and grow with the world size
W; ``chip_smoke.py`` phase 35 times them beside the update.  At world
size 1 a mesh changes nothing.  The kernel path applies Adam inside K3, so
at world size > 1 it raises ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.config import NanogridConfig
from ..core.generate import draw_uniforms, generate_schedule
from ..core.params import NanogridParams
from ..core.rollout import fused_day_rollout
from ..core.transition import draw_pv_shift, reset
from ..ops.collect import ppo_collect_day_seeded
from ..ops._build import bf16_operands
from ..ops.gae import gae
from ..ops.param_guard import check_baked_params
from ..ops.ppo_sweep import (
    AdamState,
    SweepHypers,
    normalise_centred,
    pick_chunk,
    ppo_sweep,
    ppo_sweep_streamed,
    zeros_adam,
)
from ..parallel.mesh import EnvMesh, replicate
from ..utils.profiling import span, spanned
from .networks import ActorCritic, actor_critic_leaves

F32 = torch.float32
LOG_2PI = math.log(2.0 * math.pi)
ENTROPY_CONST = 0.5 * math.log(2.0 * math.pi * math.e)
IMPLS = ("plain", "kernel")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_epochs: int = 10
    num_minibatches: int = 4
    rollout_days: int = 1
    # operand dtype of the update sweep: None / torch.float32, or
    # torch.bfloat16 (each sweep_impl with its JAX semantics, module docstring)
    update_matmul_dtype: object | None = None
    sweep_impl: str = "plain"
    # "env" (per-epoch permutation of envs), "block" (of sample blocks of
    # pick_chunk's granule), "auto": "block" for sweep_impl="kernel", else "env"
    minibatch_scheme: str = "auto"
    collect_impl: str = "plain"


class PPOTrainState(NamedTuple):
    params: list              # the 13 leaves of networks.actor_critic_leaves
    opt_state: AdamState
    batt_soc: torch.Tensor    # (B,) the BESS state carried from day to day
    generator: torch.Generator  # host generator of every draw
    update_step: int


class PPOMetrics(NamedTuple):
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    mean_return: torch.Tensor  # mean per-day return across the rollout batch


class PlainDraws(NamedTuple):
    """The draws of one plain-path update: per rollout day ``(uniforms (B, T,
    5, N), pv_shift (B,), normals (T, B, A))``, and the epochs' permutations
    ``(E, n)`` (of envs for the ``env`` scheme, of sample blocks for
    ``block``; None draws them from the generator)."""

    days: list
    perms: torch.Tensor | None = None


def _gaussian_logp(mean, log_std, action):
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * ((action - mean) ** 2 / var + 2 * log_std + LOG_2PI), dim=-1)


def optax_adam_step(params, opt: AdamState, grads, lr: float, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8):
    """One step of ``optax.adam(lr)`` on lists of leaves, written out: bias
    correction ``1 − bᵗ``, eps outside the sqrt.  Returns ``(params,
    AdamState)``."""
    count = opt.count + 1
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, opt.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, opt.nu)]
    bc1 = torch.tensor(1 - b1 ** count, dtype=F32)
    bc2 = torch.tensor(1 - b2 ** count, dtype=F32)
    new = [p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + eps)) for p, m, v in zip(params, mu, nu)]
    return new, AdamState(count, mu, nu)


def apply_actor_critic(leaves, obs):
    """``(mean, log_std, value)`` of the actor-critic given as leaves, for
    ``obs (..., F)``: the flax module's ``apply``."""
    pW1, pb1, pW2, pb2, pW3, pb3, vW1, vb1, vW2, vb2, vW3, vb3, log_std = leaves
    lin = torch.nn.functional.linear
    mean = lin(torch.tanh(lin(torch.tanh(lin(obs, pW1, pb1)), pW2, pb2)), pW3, pb3)
    value = lin(torch.tanh(lin(torch.tanh(lin(obs, vW1, vb1)), vW2, vb2)), vW3, vb3)
    return mean, log_std, value[..., 0]


def apply_actor_critic_bf16(leaves, obs):
    """``apply_actor_critic`` as the JAX ``_loss`` runs it under a bf16
    ``update_matmul_dtype``: params and obs cast to bf16, each layer a bf16
    product (rounded once) followed by a separate bf16 bias add (rounded
    again) as flax's ``Dense`` computes it, tanh on bf16 values; the outputs
    cast back to f32.  Gradients reach the f32 leaves through the casts."""
    pW1, pb1, pW2, pb2, pW3, pb3, vW1, vb1, vW2, vb2, vW3, vb3, log_std = (x.to(torch.bfloat16) for x in leaves)
    x = obs.to(torch.bfloat16)

    def dense(h, w, b):
        return torch.matmul(h, w.T) + b

    mean = dense(torch.tanh(dense(torch.tanh(dense(x, pW1, pb1)), pW2, pb2)), pW3, pb3)
    value = dense(torch.tanh(dense(torch.tanh(dense(x, vW1, vb1)), vW2, vb2)), vW3, vb3)
    return mean.to(F32), log_std.to(F32), value[..., 0].to(F32)


def check_mesh(mesh, collect_impl: str, sweep_impl: str) -> EnvMesh | None:
    """``mesh`` when it is None or an ``EnvMesh`` the implementations can run
    on: the kernel sweeps apply Adam locally, so they take world size 1 only."""
    if mesh is None:
        return None
    if not isinstance(mesh, EnvMesh):
        raise TypeError(f"mesh must be a parallel.mesh.EnvMesh, got {type(mesh).__name__}")
    if mesh.world_size > 1:
        if sweep_impl == "kernel":
            raise ValueError("sweep_impl='kernel' supports world size 1 only (the kernel applies Adam "
                             "locally; a mesh of more than one rank needs the per-step gradient mean of the "
                             "plain sweep)")
        if collect_impl == "kernel":
            raise ValueError("collect_impl='kernel' supports world size 1 only (see sweep_impl)")
    return mesh


def mean_over_ranks(mesh: EnvMesh | None, tensors):
    """The ranks' mean of each tensor of ``tensors``, through one flat
    all-reduce; the tensors themselves without a mesh or at world size 1."""
    if mesh is None or mesh.world_size == 1:
        return list(tensors)
    flat = mesh.all_reduce_mean(torch.cat([x.reshape(-1) for x in tensors]))
    return [y.view_as(x) for x, y in zip(tensors, torch.split(flat, [x.numel() for x in tensors]))]


class PPOLearner:
    """The PPO learner for one env config on one device (one rank of ``mesh``)."""

    def __init__(self, env_config: NanogridConfig, ppo_config: PPOConfig | None = None,
                 mesh: EnvMesh | None = None, device: torch.device | str = "cuda"):
        self.env_config = env_config
        self.ppo = ppo_config or PPOConfig()
        self._bf16 = bf16_operands(self.ppo.update_matmul_dtype)
        for field in ("collect_impl", "sweep_impl"):
            if getattr(self.ppo, field) not in IMPLS:
                raise ValueError(f"PPOConfig.{field} must be one of {IMPLS}, got "
                                 f"{getattr(self.ppo, field)!r}")
        self.mesh = check_mesh(mesh, self.ppo.collect_impl, self.ppo.sweep_impl)
        self.device = torch.device(mesh.device if mesh is not None else device)
        self.hidden = (64, 64)
        low, high = env_config.action_bounds()
        self._action_low = torch.as_tensor(low, dtype=F32, device=self.device)
        self._action_high = torch.as_tensor(high, dtype=F32, device=self.device)
        self.nanogrid_params = None
        self._day_ends: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    # ------------------------------------------------------------------ init --

    def init(self, seed: int, nanogrid_params: NanogridParams, batch_size: int) -> PPOTrainState:
        """A fresh network with the flax initialisation, zero Adam state and
        the battery at its initial SoC for ``batch_size`` envs (this rank's,
        with a mesh); every later draw comes from a host generator seeded with
        ``seed``.  With a mesh the network is rank 0's on every rank."""
        generator, leaves = self._network(seed)
        batt = nanogrid_params.batt_init_soc.reshape(-1)[0].to(device=self.device, dtype=F32)
        return self.state_from(leaves, zeros_adam(leaves), batt.expand(batch_size).clone(),
                               generator, nanogrid_params)

    def _network(self, seed: int):
        generator = torch.Generator().manual_seed(seed)
        net = ActorCritic(self.env_config.obs_dim, self.env_config.num_actions, self.hidden,
                          generator=generator)
        leaves = [x.detach().to(self.device) for x in actor_critic_leaves(net)]
        if self.mesh is not None:
            leaves = replicate(leaves, self.mesh)
        return generator, leaves

    def init_distributed(self, seed: int, nanogrid_params: NanogridParams, global_batch: int,
                         env_seed: int = 0) -> PPOTrainState:
        """Multi-process init (ppo.py:217-250): the network from the shared
        ``seed`` (replicated from rank 0), and this rank's envs from
        :func:`..parallel.distributed.distributed_reset` of the global batch
        (days keyed by global env index, so the envs do not depend on the
        number of processes).  At world size 1 it equals :meth:`init`."""
        if self.mesh is None:
            raise ValueError("init_distributed requires a mesh")
        from ..parallel.distributed import distributed_reset

        generator, leaves = self._network(seed)
        _, env_states, _ = distributed_reset(self.env_config, nanogrid_params, self.mesh, global_batch,
                                             seed=env_seed)
        return self.state_from(leaves, zeros_adam(leaves), env_states.batt_soc, generator, nanogrid_params)

    def state_from(self, params, opt_state: AdamState, batt_soc: torch.Tensor,
                   generator: torch.Generator, nanogrid_params: NanogridParams) -> PPOTrainState:
        """A train state from given parameters, Adam state and batteries (for
        example :func:`..utils.weights.ppo_state_from_jax`'s)."""
        self.nanogrid_params = nanogrid_params
        to = dict(device=self.device, dtype=F32)
        return PPOTrainState(
            params=[x.to(**to) for x in params],
            opt_state=AdamState(int(opt_state.count), [x.to(**to) for x in opt_state.mu],
                                [x.to(**to) for x in opt_state.nu]),
            batt_soc=batt_soc.to(**to), generator=generator, update_step=0)

    # ------------------------------------------------------------- pieces --

    def _hypers(self) -> SweepHypers:
        return SweepHypers(lr=self.ppo.learning_rate, clip_eps=self.ppo.clip_eps,
                           vf_coef=self.ppo.vf_coef, ent_coef=self.ppo.entropy_coef,
                           max_grad_norm=self.ppo.max_grad_norm,
                           matmul_dtype=torch.bfloat16 if self._bf16 else None)

    def _resolved_scheme(self) -> str:
        s = self.ppo.minibatch_scheme
        if s == "auto":
            return "block" if self.ppo.sweep_impl == "kernel" else "env"
        if s not in ("env", "block"):
            raise ValueError(f"unknown minibatch_scheme {s!r}")
        return s

    def _granule(self, M: int) -> int:
        return pick_chunk(M, self.env_config.obs_dim, self.env_config.num_actions, *self.hidden)

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """A host tensor on the learner's device without waiting for the card."""
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def _gae(self, rewards, values, dones, last_value):
        """Generalised advantage estimation over the ``(T, B)`` rollout: one
        launch of ``ops/gae.py``'s kernel on the card, its twin on the CPU."""
        return gae(rewards, values, dones, last_value, self.ppo.gamma, self.ppo.gae_lambda)

    def _day_end(self, T: int, B: int, device: torch.device):
        """The kernel path's dones, the day ending at t = T-1, and its zero
        bootstrap values: built once per shape and device, read only."""
        key = (T, B, device)
        if key not in self._day_ends:
            dones = torch.zeros((T, B), dtype=torch.bool, device=device)
            dones[-1] = True
            self._day_ends[key] = dones, torch.zeros(B, device=device)
        return self._day_ends[key]

    def _loss(self, params, obs, actions, old_logp, old_values, advantages, returns):
        apply = apply_actor_critic_bf16 if self._bf16 else apply_actor_critic
        mean, log_std, values = apply(params, obs)
        logp = _gaussian_logp(mean, log_std, actions)
        ratio = torch.exp(logp - old_logp)
        norm_adv = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
        lo = torch.tensor(1 - self.ppo.clip_eps, dtype=F32, device=ratio.device)
        hi = torch.tensor(1 + self.ppo.clip_eps, dtype=F32, device=ratio.device)
        pg1 = ratio * norm_adv
        # jnp.clip's derivative conventions: maximum then minimum
        pg2 = torch.minimum(torch.maximum(ratio, lo), hi) * norm_adv
        policy_loss = -torch.minimum(pg1, pg2).mean()
        value_loss = 0.5 * ((values - returns) ** 2).mean()
        entropy = torch.sum(log_std + ENTROPY_CONST)
        total = policy_loss + self.ppo.vf_coef * value_loss - self.ppo.entropy_coef * entropy
        approx_kl = ((ratio - 1) - torch.log(ratio)).mean()
        return total, (policy_loss, value_loss, entropy, approx_kl)

    def _optax_step(self, params, opt: AdamState, grads):
        """``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` written out:
        scale by ``max_norm / norm`` only when ``norm >= max_norm``."""
        max_norm = torch.tensor(self.ppo.max_grad_norm, dtype=F32, device=grads[0].device)
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        grads = [torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm) for g in grads]
        return optax_adam_step(params, opt, grads, self.ppo.learning_rate)

    # -------------------------------------------------------- plain collect --

    def draw_plain(self, generator: torch.Generator, batch: int) -> PlainDraws:
        """One update's days and action noise drawn from ``generator`` (host)
        for ``batch`` envs; with a mesh the draws of the global batch, of
        which this rank keeps its own envs'."""
        T, A = self.env_config.steps_per_day, self.env_config.num_actions
        world, rank = (self.mesh.world_size, self.mesh.rank) if self.mesh is not None else (1, 0)
        lo, hi = rank * batch, (rank + 1) * batch
        days = []
        for _ in range(self.ppo.rollout_days):
            u = draw_uniforms(self.env_config, batch * world, generator, F32, "cpu")[lo:hi]
            pv = draw_pv_shift(batch * world, generator, F32, "cpu")[lo:hi]
            normals = torch.randn((T, batch * world, A), generator=generator)[:, lo:hi]
            days.append(tuple(self._to_device(x.contiguous()) for x in (u, pv, normals)))
        return PlainDraws(days)

    def _rollout(self, params, env_params, batt_soc, draws: PlainDraws):
        """``rollout_days`` fresh days with the battery carried: every day's
        schedule is generated anew (the reference resets at each episode end)."""

        def policy_step(ob, normal):
            mean, log_std, value = apply_actor_critic(params, ob)
            action = mean + torch.exp(log_std) * normal
            logp = _gaussian_logp(mean, log_std, action)
            clipped = torch.clamp(action, self._action_low, self._action_high)
            return clipped, (ob, action, logp, value)

        pieces, obs = [], None
        for uniforms, pv_shift, normals in draws.days:
            schedule = generate_schedule(self.env_config, env_params, uniforms)
            state, _ = reset(self.env_config, env_params, schedule, batt_soc=batt_soc, pv_shift=pv_shift)
            state, (obs_traj, rewards, dones, aux) = fused_day_rollout(
                self.env_config, env_params, state, policy_step, next_pv_shift=pv_shift,
                policy_aux=True, policy_xs=normals)
            batt_soc = state.batt_soc
            obs = obs_traj[-1]
            pieces.append(tuple(aux) + (rewards, dones))
        traj = tuple(torch.cat(xs, dim=0) for xs in zip(*pieces))
        return batt_soc, obs, traj

    def _plain_step(self, state: PPOTrainState, env_params, draws: PlainDraws | None):
        with torch.no_grad():
            B = state.batt_soc.shape[0]
            draws = draws or self.draw_plain(state.generator, B)
            batt, last_obs, traj = self._rollout(state.params, env_params, state.batt_soc, draws)
            t_obs, t_act, t_logp, t_val, t_rew, t_done = traj
            _, _, last_value = apply_actor_critic(state.params, last_obs)
            advantages, returns = self._gae(t_rew, t_val, t_done, last_value)
        batch = tuple(x.transpose(0, 1) for x in (t_obs, t_act, t_logp, t_val, advantages, returns))
        n_envs = batch[0].shape[0]
        num_mb = min(self.ppo.num_minibatches, n_envs)
        mb_envs = n_envs // num_mb
        params, opt, metrics_g = self._sweep(state, batch, num_mb, mb_envs, draws.perms)
        T = self.env_config.steps_per_day
        day_returns = t_rew.reshape(self.ppo.rollout_days, T, -1).sum(dim=1)
        metrics = PPOMetrics(*mean_over_ranks(self.mesh, [metrics_g[:, i].mean() for i in range(4)]
                                              + [day_returns.mean()]))
        return state._replace(params=params, opt_state=opt, batt_soc=batt,
                              update_step=state.update_step + 1), metrics

    # -------------------------------------------------------------- sweeps --

    def _perms(self, generator, perms, E, n, keep):
        if perms is None:
            perms = torch.stack([torch.randperm(n, generator=generator) for _ in range(E)])
        return perms[:, :keep]

    def _sweep(self, state, batch, num_mb, mb_envs, perms):
        """The epoch×minibatch sweep over env-major ``(B, T, ...)`` arrays."""
        E = self.ppo.num_epochs
        T = batch[0].shape[1]
        M = mb_envs * T
        n_used = mb_envs * num_mb
        scheme = self._resolved_scheme()
        if scheme == "block":
            granule = self._granule(M)
            n_bl = (n_used * T) // granule
            perms = self._perms(state.generator, perms, E, n_bl, n_bl)
        else:
            perms = self._perms(state.generator, perms, E, batch[0].shape[0], n_used)
        if self.ppo.sweep_impl == "kernel":
            return self._kernel_sweep(state, batch, num_mb, mb_envs, perms, scheme)

        # the block scheme permutes sample blocks, the env scheme envs
        rows = (tuple(x[:n_used].reshape((n_bl, granule) + x.shape[2:]) for x in batch)
                if scheme == "block" else batch)
        params, opt = [p.detach() for p in state.params], state.opt_state
        auxs = []
        for e in range(E):
            idx = perms[e].to(batch[0].device)
            mbs = tuple(x[idx].reshape((num_mb, M) + x.shape[2:]) for x in rows)
            for i in range(num_mb):
                leaves = [p.clone().requires_grad_(True) for p in params]
                _, aux = self._loss(leaves, *(x[i] for x in mbs))
                grads = mean_over_ranks(self.mesh, torch.autograd.grad(_, leaves))
                params, opt = self._optax_step(params, opt, grads)
                auxs.append(torch.stack([a.detach() for a in aux]))
        return params, opt, torch.stack(auxs)

    def _kernel_sweep(self, state, batch, num_mb, mb_envs, perms, scheme):
        """K3 (``block``, sample layout) or K4 (``env``) after a plain collection."""
        t_obs, t_act, t_logp, _, advantages, returns = batch
        T = t_obs.shape[1]
        E = self.ppo.num_epochs
        G, M = E * num_mb, mb_envs * T
        n_used = mb_envs * num_mb
        if scheme == "block":
            granule = self._granule(M)
            K = M // granule
            flats = [x[:n_used].reshape((n_used * T,) + x.shape[2:]).contiguous()
                     for x in (t_obs, t_act, t_logp, advantages, returns)]
            block_perm = perms.reshape(E, num_mb, K).reshape(G, K)
            return ppo_sweep_streamed(state.params, state.opt_state, *flats, block_perm, granule,
                                      self._hypers(), data_layout="sample")
        idx = perms.to(t_obs.device)

        def gather(x):  # (B, T, ...) -> (G, M, ...)
            return x[idx].reshape((G, M) + x.shape[2:]).contiguous()

        adv_g = gather(advantages)
        mean, std = normalise_centred(adv_g)
        nadv_g = (adv_g - mean[:, None]) / (std[:, None] + 1e-8)
        return ppo_sweep(state.params, state.opt_state, gather(t_obs), gather(t_act), gather(t_logp),
                         nadv_g, gather(returns), self._hypers())

    # ---------------------------------------------------- the kernel path --

    def kernel_layout(self, batch: int) -> tuple[int, int, int]:
        """``(num_mb, slab, n_bl)`` of the kernel path's featlane sweep
        (ppo.py:381-396): ``slab`` is the largest divisor of the batch up to
        :func:`pick_chunk`'s granule; raises when the ``T × (B / slab)``
        blocks do not divide into minibatches."""
        T = self.env_config.steps_per_day
        num_mb = min(self.ppo.num_minibatches, batch)
        chunk = self._granule((batch // num_mb) * T)
        slab = next(c for c in range(min(chunk, batch), 0, -1) if batch % c == 0)
        n_bl = T * (batch // slab)
        if n_bl % num_mb:
            raise ValueError(f"featlane blocks {n_bl} not divisible into {num_mb} minibatches "
                             "— pick num_minibatches dividing steps_per_day")
        return num_mb, slab, n_bl

    def draw_kernel(self, generator: torch.Generator, n_bl: int) -> tuple[int, torch.Tensor]:
        """One kernel-path update's draws: the collection seed (a fresh int32)
        and the epochs' block permutations ``(E, n_bl)``."""
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))
        perms = torch.stack([torch.randperm(n_bl, generator=generator)
                             for _ in range(self.ppo.num_epochs)])
        return seed, perms

    @spanned("ppo.update")
    def _kernel_step(self, state: PPOTrainState, env_params):
        """K2 → GAE → K3 featlane (``_kernel_train_step``, ppo.py:340-430)."""
        B = state.batt_soc.shape[0]
        T = self.env_config.steps_per_day
        num_mb, slab, n_bl = self.kernel_layout(B)
        with span("ppo.draw"):
            seed, perms = self.draw_kernel(state.generator, n_bl)
        obs_tfb, act_tab, logp_tb, val_tb, rew_tb, batt_fin = ppo_collect_day_seeded(
            self.env_config, env_params, state.params, seed, state.batt_soc, B, check_params=False)
        with span("ppo.gae"):
            # the day ends at t = T-1: GAE's bootstrap is multiplied by 0 there
            advantages, returns = self._gae(rew_tb, val_tb, *self._day_end(T, B, rew_tb.device))
        E, K = self.ppo.num_epochs, n_bl // num_mb
        block_perm = perms.reshape(E * num_mb, K)
        params, opt, metrics_g = ppo_sweep_streamed(
            state.params, state.opt_state, obs_tfb, act_tab, logp_tb, advantages, returns,
            block_perm, slab, self._hypers(), data_layout="featlane")
        metrics = PPOMetrics(*(metrics_g[:, i].mean() for i in range(4)), rew_tb.sum(dim=0).mean())
        return state._replace(params=params, opt_state=opt, batt_soc=batt_fin,
                              update_step=state.update_step + 1), metrics

    # --------------------------------------------------------- entry points --

    def _check(self, env_params) -> None:
        if self.ppo.collect_impl == "kernel":
            if self.ppo.rollout_days != 1:
                raise ValueError("collect_impl='kernel' collects exactly one day per update (rollout_days=1)")
            if self.ppo.sweep_impl != "kernel":
                raise ValueError("collect_impl='kernel' requires sweep_impl='kernel' (featlane trajectories)")
            check_baked_params(self.env_config, env_params, "PPOConfig.collect_impl='kernel'",
                               generation=True)
            if self.env_config.lookahead != 3:
                raise ValueError("collect_impl='kernel' bakes the reference 3-step observation lookahead")

    def build_train_step(self):
        """``train_step(state, env_params, draws=None) -> (state, metrics)``,
        after the param guard of the kernel path; ``draws`` (plain collection
        only) replaces the generator's draws."""
        checked = []

        def train_step(state: PPOTrainState, env_params, draws: PlainDraws | None = None):
            if not checked:
                self._check(env_params)
                checked.append(True)
            if self.ppo.collect_impl == "kernel":
                if draws is not None:
                    raise ValueError("the kernel path draws in the kernel; draws= is for the plain path")
                return self._kernel_step(state, env_params)
            return self._plain_step(state, env_params, draws)

        return train_step

    def build_train_many(self, updates_per_call: int):
        """``train_many(state, env_params) -> (state, metrics)`` running
        ``updates_per_call`` updates, metrics stacked over them.  The param
        guard runs here too (the JAX package skips it, ppo.py:681)."""
        step = self.build_train_step()

        def train_many(state: PPOTrainState, env_params):
            history = []
            for _ in range(updates_per_call):
                state, metrics = step(state, env_params)
                history.append(metrics)
            return state, PPOMetrics(*(torch.stack(x) for x in zip(*history)))

        return train_many

    def train(self, state: PPOTrainState, num_updates: int, log_every: int = 0):
        """Run ``num_updates`` updates; returns the final state and the metric
        history (floats) at every ``log_every``-th update and the last."""
        step_fn = self.build_train_step()
        history = []
        for i in range(num_updates):
            state, metrics = step_fn(state, self.nanogrid_params)
            if log_every and (i % log_every == 0 or i == num_updates - 1):
                history.append(PPOMetrics(*(float(x) for x in metrics)))
        return state, history

    def policy_fn(self, params, deterministic: bool = True):
        """Policy ``(obs, generator=None) -> clipped actions`` for evaluation."""

        def policy(obs, generator=None):
            with torch.no_grad():
                mean, log_std, _ = apply_actor_critic(params, obs)
                action = mean
                if not deterministic and generator is not None:
                    noise = torch.randn(mean.shape, generator=generator, device=mean.device)
                    action = mean + torch.exp(log_std) * noise
                return torch.clamp(action, self._action_low, self._action_high)

        return policy
