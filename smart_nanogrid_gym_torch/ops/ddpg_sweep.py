"""The DDPG update sweep: kernel K10 with its plain twin.

Replaces ``smart_nanogrid_gym_tpu/ops/pallas_ddpg_sweep.py``
(``ddpg_sweep_pallas``): all ``G`` gradient steps of one DDPG
update over pre-gathered replay minibatches ``(G, M, feat)``.  Each step,
in the JAX kernel's order (:24-32, :138-232):

1. the target bootstrap ``y = r + γ(1 − d)·Q′(s′, μ′(s′))`` with the
   sweep's squash ``low + (tanh(u) + 1)·half_span``, ``half_span = 0.5·(high
   − low)``;
2. the critic's MSE step with bare Adam (no clipping);
3. the actor's step through the *updated* critic: the gradient of
   ``−mean Q(s, μ(s))`` reaches the actor through the critic's action
   columns, times ``half_span·(1 − tanh²)``;
4. polyak ``(1 − τ)·t + τ·p`` on both targets.

ReLU's derivative is the post-activation test ``y > 0`` (0 at 0).  Adam's
bias correction is ``1 − exp(t·log b)``, the kernel's, not optax's ``1 −
bᵗ``.  Each network travels as its 6 leaves
(:func:`..solvers.networks.ddpg_leaves`); the kernels see them packed flat.

``DDPGSweepHypers.matmul_dtype=torch.bfloat16`` is the JAX kernel's bf16
operand option (pallas_ddpg_sweep.py:105-135, 153-154): both operands of
every product of the step are rounded to bf16 (the target bootstrap, the
critic's forward and backward, the actor's forward, the critic's input
gradient and the actor's backward) and the products accumulate in f32.  The
ReLU masks ``y > 0`` read f32 values; the squash, ``tanh_u``, the TD error,
the bias column sums, Adam and polyak stay f32.

On CUDA tensors :func:`ddpg_sweep` launches ``csrc/ddpg_sweep.cuh``'s
persistent cooperative kernel once per update (one ``ngk_ddpg_sweep`` call
for all ``G`` steps, one count of ``ddpg_sweep``, or ``ddpg_sweep_bf16``);
on CPU tensors it runs :func:`ddpg_sweep_plain`, which writes every product
and sum in the f32 kernel's order: products summed over their reduction
index in index order from the first product, bias gradients and the loss
sums in sample order.  With bf16 the kernel's products run on the tensor
cores, whose accumulation order is their own: the twin then matches the
kernel to a stated tolerance (``tests/test_torch_cuda.py``), not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils.profiling import spanned
from . import _build
from .gen_policy_rollout import relu
from ._build import bf16_operands, kernel_device, round_bf16
from .ppo_sweep import AdamState, adam_update_plain

F32 = torch.float32
N_LEAVES = 6
N_POINTERS = 20  # ngd::Sweep's device pointers


class DDPGSweepHypers(NamedTuple):
    """Hyperparameters of one sweep (``DDPGSweepHypers``, pallas_ddpg_sweep.py:49-60)."""

    lr: float
    gamma: float
    tau: float
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # operand dtype of the products: None / torch.float32 exact, torch.bfloat16
    # rounds both operands (f32 accumulation)
    matmul_dtype: object = None


def flat(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 6 leaves as one new contiguous f32 vector, in leaf order."""
    if len(leaves) != N_LEAVES:
        raise ValueError(f"a DDPG network has {N_LEAVES} leaves, got {len(leaves)}")
    return torch.cat([x.detach().reshape(-1).to(F32) for x in leaves])


def unflat(vec: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    sizes = [x.numel() for x in like]
    return [v.view(x.shape) for v, x in zip(vec.split(sizes), like)]


def _f32(x: float) -> float:
    return float(np.float32(x))


# ------------------------------------------------------------- the twin ---

def _mm(a: torch.Tensor, b: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` with each output summed over ``k`` in index
    order, from the first product (a tile of the f32 kernel); with ``bf16``
    both operands are rounded to bf16 first."""
    if bf16:
        a, b = round_bf16(a), round_bf16(b)
    acc = a[:, 0:1] * b[0:1]
    for k in range(1, a.shape[1]):
        acc = acc + a[:, k:k + 1] * b[k:k + 1]
    return acc


def _colsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (sample) axis in sample order (the kernel's ones-row product)."""
    acc = x[0]
    for m in range(1, x.shape[0]):
        acc = acc + x[m]
    return acc


def _mask(y: torch.Tensor) -> torch.Tensor:
    return (y > 0).to(y.dtype)


def _hidden(leaves, x, bf16):
    w1, b1, w2, b2 = leaves[:4]
    h1 = relu(_mm(x, w1.T, bf16) + b1)
    return h1, relu(_mm(h1, w2.T, bf16) + b2)


def _squash(u, low, high):
    th = torch.tanh(u)
    return low + (th + 1.0) * (0.5 * (high - low)), th


def _layer_grads(g, x, bf16):
    """Weight and bias gradients of a layer from its output gradient ``g (M,
    out)`` and input ``x (M, in)``."""
    return _mm(g.T, x, bf16), _colsum(g)


def ddpg_sweep_plain(actor, critic, t_actor, t_critic, a_adam: AdamState, c_adam: AdamState,
                     b_obs, b_act, b_rew, b_next, b_done, low, high, hp: DDPGSweepHypers):
    """Plain twin of K10 (same arguments and results as :func:`ddpg_sweep`)."""
    like_a, like_c = list(actor), list(critic)
    pa, pc, ta, tc = flat(actor), flat(critic), flat(t_actor), flat(t_critic)
    am, an, cm, cn = flat(a_adam.mu), flat(a_adam.nu), flat(c_adam.mu), flat(c_adam.nu)
    G, M = b_rew.shape
    F = b_obs.shape[2]
    low, high = low.to(F32), high.to(F32)
    inv_m = _f32(1.0 / M)
    two_inv_m = _f32(np.float32(2.0) * np.float32(1.0 / M))
    one_minus_tau = _f32(np.float32(1.0) - np.float32(hp.tau))
    neg_inv = torch.full((M, 1), -inv_m, dtype=F32, device=b_obs.device)
    bf16 = bf16_operands(hp.matmul_dtype)
    rows = []
    for g in range(G):
        obs, act, rew, nxt, done = (x[g].to(F32) for x in (b_obs, b_act, b_rew, b_next, b_done))
        A_, C_, TA, TC = (unflat(v, like) for v, like in ((pa, like_a), (pc, like_c), (ta, like_a), (tc, like_c)))
        # ---- target bootstrap ----
        _, ta2 = _hidden(TA, nxt, bf16)
        next_action, _ = _squash(_mm(ta2, TA[4].T, bf16) + TA[5], low, high)
        _, tq2 = _hidden(TC, torch.cat([nxt, next_action], dim=1), bf16)
        y = rew + (hp.gamma * (1.0 - done)) * (_mm(tq2, TC[4].T, bf16) + TC[5])[:, 0]
        # ---- critic step ----
        xa = torch.cat([obs, act], dim=1)
        q1, q2 = _hidden(C_, xa, bf16)
        cerr = (_mm(q2, C_[4].T, bf16) + C_[5])[:, 0] - y
        gq = (two_inv_m * cerr)[:, None]
        gw3, gb3 = _layer_grads(gq, q2, bf16)
        g2 = _mm(gq, C_[4], bf16) * _mask(q2)
        gw2, gb2 = _layer_grads(g2, q1, bf16)
        g1 = _mm(g2, C_[2], bf16) * _mask(q1)
        gw1, gb1 = _layer_grads(g1, xa, bf16)
        grads = torch.cat([x.reshape(-1) for x in (gw1, gb1, gw2, gb2, gw3, gb3)])
        pc, cm, cn = adam_update_plain(pc, cm, cn, grads, c_adam.count + g + 1, hp)
        # ---- actor step through the updated critic ----
        C_ = unflat(pc, like_c)
        a1, a2 = _hidden(A_, obs, bf16)
        a_pi, th = _squash(_mm(a2, A_[4].T, bf16) + A_[5], low, high)
        xa_pi = torch.cat([obs, a_pi], dim=1)
        p1, p2 = _hidden(C_, xa_pi, bf16)
        q_pi = (_mm(p2, C_[4].T, bf16) + C_[5])[:, 0]
        h2g = _mm(neg_inv, C_[4], bf16) * _mask(p2)
        h1g = _mm(h2g, C_[2], bf16) * _mask(p1)
        g_u = (_mm(h1g, C_[0][:, F:], bf16) * (0.5 * (high - low))) * (1.0 - th * th)
        gw3, gb3 = _layer_grads(g_u, a2, bf16)
        g2 = _mm(g_u, A_[4], bf16) * _mask(a2)
        gw2, gb2 = _layer_grads(g2, a1, bf16)
        g1 = _mm(g2, A_[2], bf16) * _mask(a1)
        gw1, gb1 = _layer_grads(g1, obs, bf16)
        grads = torch.cat([x.reshape(-1) for x in (gw1, gb1, gw2, gb2, gw3, gb3)])
        pa, am, an = adam_update_plain(pa, am, an, grads, a_adam.count + g + 1, hp)
        # ---- polyak, metrics ----
        ta = one_minus_tau * ta + hp.tau * pa
        tc = one_minus_tau * tc + hp.tau * pc
        rows.append(torch.stack([_colsum(cerr * cerr) * inv_m, -_colsum(q_pi) * inv_m]))
    return (unflat(pa, like_a), unflat(pc, like_c), unflat(ta, like_a), unflat(tc, like_c),
            AdamState(a_adam.count + G, unflat(am, like_a), unflat(an, like_a)),
            AdamState(c_adam.count + G, unflat(cm, like_c), unflat(cn, like_c)), torch.stack(rows))


# ------------------------------------------------------------------ K10 ---

def _check(actor, critic, b_obs, b_act, b_rew, b_next, b_done):
    G, M = b_rew.shape
    F, A = b_obs.shape[-1], b_act.shape[-1]
    for name, x, shape in (("b_obs", b_obs, (G, M, F)), ("b_act", b_act, (G, M, A)),
                           ("b_next", b_next, (G, M, F)), ("b_done", b_done, (G, M))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if actor[0].shape[1] != F or actor[4].shape[0] != A or critic[0].shape[1] != F + A:
        raise ValueError(f"networks take actor {actor[0].shape[1]}->{actor[4].shape[0]}, critic "
                         f"{critic[0].shape[1]}; the data has F={F}, A={A}")


@spanned("sweep")
def ddpg_sweep(actor, critic, t_actor, t_critic, a_adam: AdamState, c_adam: AdamState,
               b_obs: torch.Tensor, b_act: torch.Tensor, b_rew: torch.Tensor, b_next: torch.Tensor,
               b_done: torch.Tensor, low: torch.Tensor, high: torch.Tensor, hp: DDPGSweepHypers):
    """All ``G`` gradient steps of one DDPG update (K10).

    ``actor``/``critic``/``t_actor``/``t_critic``: 6 leaves each; ``a_adam``
    and ``c_adam``: their Adam states; ``b_obs (G, M, F)``, ``b_act (G, M,
    A)``, ``b_rew (G, M)``, ``b_next (G, M, F)``, ``b_done (G, M)``: the
    gathered minibatches; ``low``/``high (A,)``: the action box.  Returns
    ``(actor, critic, t_actor, t_critic, a_adam, c_adam, metrics (G, 2))``,
    a metric row being the critic and actor loss; the inputs are not modified.
    """
    _check(actor, critic, b_obs, b_act, b_rew, b_next, b_done)
    if not kernel_device(b_obs):
        return ddpg_sweep_plain(actor, critic, t_actor, t_critic, a_adam, c_adam, b_obs, b_act, b_rew,
                                b_next, b_done, low, high, hp)
    device = b_obs.device
    G, M = b_rew.shape
    F, A = b_obs.shape[2], b_act.shape[2]
    H1, H2 = actor[0].shape[0], actor[2].shape[0]
    if tuple(critic[0].shape) != (H1, F + A) or critic[2].shape[0] != H2:
        raise ValueError("the kernel takes actor and critic torsos of the same hidden sizes")
    lib = _build.load(_build.ddpg_sweep_spec(F, A, H1, H2), device)
    nets = [flat(x).to(device) for x in (actor, critic, t_actor, t_critic)]
    moments = [flat(x).to(device) for x in (a_adam.mu, a_adam.nu, c_adam.mu, c_adam.nu)]
    sizes = (lib.ngk_ddpg_actor_size(), lib.ngk_ddpg_critic_size())
    if (nets[0].numel(), nets[1].numel()) != sizes:
        raise ValueError(f"networks of {nets[0].numel()}/{nets[1].numel()} parameters, the sweep "
                         f"library expects {sizes}")
    f32 = dict(dtype=F32, device=device)
    obs, act, nxt = (_build.check_f32(x.to(F32).contiguous(), n)
                     for x, n in ((b_obs, "b_obs"), (b_act, "b_act"), (b_next, "b_next")))
    xa = torch.cat([obs, act], dim=2).contiguous()
    xa_next = torch.cat([nxt, torch.zeros((G, M, A), **f32)], dim=2).contiguous()
    xa_pi = torch.cat([obs, torch.zeros((G, M, A), **f32)], dim=2).contiguous()
    rew, done = (x.to(**f32).contiguous() for x in (b_rew, b_done))
    inv_m = _f32(1.0 / M)
    neg_inv = torch.full((M,), -inv_m, **f32)
    box = [x.to(**f32).contiguous() for x in (low, high)]
    grads = [torch.empty(n, **f32) for n in sizes]
    scratch = torch.empty(lib.ngk_ddpg_scratch_floats(M), **f32)
    metrics = torch.empty((G, 2), **f32)
    floats = (ctypes.c_float * 13)(
        hp.gamma, _f32(np.float32(2.0) * np.float32(1.0 / M)), inv_m, hp.tau,
        _f32(np.float32(1.0) - np.float32(hp.tau)), hp.lr, hp.adam_b1, 1.0 - hp.adam_b1,
        _f32(np.log(hp.adam_b1)), hp.adam_b2, 1.0 - hp.adam_b2, _f32(np.log(hp.adam_b2)), hp.adam_eps)
    bf16 = bf16_operands(hp.matmul_dtype)
    tensors = (*nets, *moments, *grads, xa, rew, done, xa_next, xa_pi, neg_inv, *box, scratch, metrics)
    ptrs = (ctypes.c_void_p * N_POINTERS)(*(t.data_ptr() for t in tensors))
    ints = (ctypes.c_int * 5)(G, M, a_adam.count, c_adam.count, int(bf16))
    _build.launch("ddpg_sweep_bf16" if bf16 else "ddpg_sweep", lib.ngk_ddpg_sweep, ptrs, ints, floats,
                  device=device)
    la, lc = list(actor), list(critic)
    am, an, cm, cn = moments
    return (unflat(nets[0], la), unflat(nets[1], lc), unflat(nets[2], la), unflat(nets[3], lc),
            AdamState(a_adam.count + G, unflat(am, la), unflat(an, la)),
            AdamState(c_adam.count + G, unflat(cm, lc), unflat(cn, lc)), metrics)
