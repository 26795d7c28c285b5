"""The PPO update sweep: kernels K3 and K4 with their plain twin.

Replaces ``smart_nanogrid_gym_tpu/ops/pallas_ppo_sweep.py``: every gradient
step of one PPO update (``G = num_epochs × num_minibatches`` steps) on the
SB3-default actor-critic (separate 64-64 tanh torsos, state-independent
``log_std``), each step the clipped-surrogate + ``vf_coef``·0.5·MSE −
``ent_coef``·entropy loss, its hand-written backward, optax's
``clip_by_global_norm`` and Adam.

- :func:`ppo_sweep_streamed` (K3, ``ppo_sweep_pallas_streamed``): the
  minibatches are sample blocks of the trajectory named by ``block_perm
  (G, K)``; ``data_layout="featlane"`` reads the collection kernel's
  ``(T, feat, B)`` layout (block id ``t·(B // granule) + slab``),
  ``"sample"`` flat env-major ``(S, feat)`` arrays.  Advantages are
  normalised per minibatch with a *centred* mean and std (two passes, ddof
  0, as ``PPOLearner._loss`` computes them), taken here before the sweep; the
  JAX kernel's ``E[x²] − mean²`` from block sums loses precision when
  ``|mean| ≫ std``.
- :func:`ppo_sweep` (K4, ``ppo_sweep_pallas``): pre-gathered minibatches
  ``(G, M, feat)`` with pre-normalised advantages.

On CUDA tensors both launch ``csrc/ppo_sweep.cuh``'s persistent cooperative
kernel once per update (one count under the wrapper's name, ``_bf16``
appended for bf16 operands): for each gradient step, every block first
computes the partial gradient of a fixed range of the minibatch's samples,
then the partials are summed in range order slice by slice, and every block
takes the global norm from the slices' sums of squares and applies the
clip and Adam to its part.  On CPU tensors they run :func:`ppo_sweep_plain`,
which computes the same hand-written backward with matrix products in the
kernel's summation order (:func:`_kernel_order_sum`,
:func:`_adam_block_norm`, from the partition constants below).  Both keep
the JAX kernel's two derivative conventions: ``jnp.minimum``'s balanced tie
(0.5/0.5 at ``pg1 == pg2``) and the strict clip-region indicator ``lo <
ratio < hi``.

``SweepHypers.matmul_dtype=torch.bfloat16`` is the JAX kernel's bf16
operand option (pallas_ppo_sweep.py:191-206): both operands of every
network product are rounded to bf16 and the products accumulate in f32 —
the forward of both torsos and every backward product (the weight
gradients, the input gradients through W3 and W2, and gW1).  Everything
else stays f32: the tanh derivative ``1 − y²`` reads the f32 activations,
and the log-prob, ratio, clip, metric sums, bias gradients, global-norm clip
and Adam run in f32, so the master parameters stay f32.  These are
operand-only semantics, the kernel path's; the learner's plain sweep casts
the whole flax apply instead (``solvers/ppo.py``).  On the card the large
products run on the bf16 tensor cores, which sum in their own order: there
the twin matches the kernel to a stated tolerance (``tests/test_torch_cuda.py``),
not bit for bit; in f32 it matches bit for bit.

Parameters travel as the 13 leaves of
:func:`..solvers.networks.actor_critic_leaves`; the kernels see them packed
into one flat f32 vector (:func:`flatten_leaves`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

from ..utils.profiling import spanned
from . import _build
from ._build import bf16_operands, kernel_device, round_bf16

F32 = torch.float32
N_PARAMS = 13
LOG_2PI = float(np.float32(np.log(2.0 * np.pi)))
ENTROPY_CONST = float(np.float32(0.5 * np.log(2.0 * np.pi * np.e)))
LAYOUTS = {"featlane": 0, "sample": 1, "gathered": 2}
# The sweep kernel's partition (kTile, kMaxRanges, kSlices in csrc/ppo_sweep.cuh).
# Constants, not the card's occupancy: the twin writes the same summation order.
GRAD_TILE = 64         # samples per tile of a range's partial gradient
MAX_GRAD_BLOCKS = 128  # sample ranges (partial gradients) per step at most
NORM_SLICES = 128      # slices of the reduction over ranges and of the global norm


class SweepHypers(NamedTuple):
    """Hyperparameters of one sweep (``pallas_ppo_sweep.py:67-83``)."""

    lr: float
    clip_eps: float
    vf_coef: float
    ent_coef: float
    max_grad_norm: float
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # operand dtype of the network products: None / torch.float32 exact,
    # torch.bfloat16 rounds both operands (f32 accumulation)
    matmul_dtype: object = None


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: the step count and the moments as 13 leaves."""

    count: int
    mu: list
    nu: list


def zeros_adam(leaves: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(0, [torch.zeros_like(x) for x in leaves], [torch.zeros_like(x) for x in leaves])


def flatten_leaves(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 13 leaves as one new contiguous f32 vector, in leaf order
    (``_flatten_actor_critic``, pallas_ppo_sweep.py:335-353)."""
    if len(leaves) != N_PARAMS:
        raise ValueError(f"the sweep takes {N_PARAMS} leaves, got {len(leaves)}")
    return torch.cat([x.detach().reshape(-1).to(F32) for x in leaves])


def unflatten_leaves(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Views of ``flat`` shaped like ``like`` (``_unflatten_actor_critic``)."""
    sizes = [x.numel() for x in like]
    return [v.view(x.shape) for v, x in zip(flat.split(sizes), like)]


def torso_dims(leaves: Sequence[torch.Tensor]) -> tuple[int, int, int, int]:
    """``(F, A, H1, H2)`` of an actor-critic given as leaves."""
    return leaves[0].shape[1], leaves[4].shape[0], leaves[0].shape[0], leaves[2].shape[0]


def pick_chunk(M: int, F: int, A: int, H1: int, H2: int, budget_bytes: int = 9 * 2 ** 20) -> int:
    """The ``block`` scheme's sample granule: ``_pick_chunk``
    (pallas_ppo_sweep.py:93-111) verbatim.  On the TPU it was a VMEM budget;
    here it is the partition rule that says which samples form a minibatch,
    kept so that both packages cut the same minibatches."""
    padlane = lambda n: -(-n // 128) * 128  # noqa: E731
    per_sample = 4 * (
        2 * (padlane(F) + padlane(A))
        + 6 * 8
        + 2 * (H1 + H2)
        + 3 * 16 + (H1 + H2)
    )
    target = max(1, budget_bytes // per_sample)
    for c in range(min(M, target), 0, -1):
        if M % c == 0:
            return c
    return M


# ------------------------------------------------------------- the twin ---

def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=F32, device=like.device)


def _dot_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w @ x`` for ``x (K, M)`` as products summed over K in index order
    (``feat_by_sample`` of csrc/ppo_sweep.cuh)."""
    acc = w[:, 0:1] * x[0:1]
    for k in range(1, w.shape[1]):
        acc = acc + w[:, k:k + 1] * x[k:k + 1]
    return acc


def _kernel_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (the minibatch's ``M`` samples) in the sweep
    kernel's order: within each tile of ``GRAD_TILE`` samples, then the
    tiles of a range, then the ranges (:func:`grad_blocks`)."""
    M = x.shape[-1]
    nb = grad_blocks(M)
    spb = math.ceil(M / nb)
    tiles = math.ceil(spb / GRAD_TILE)
    lead = x.shape[:-1]
    x = torch.nn.functional.pad(x, (0, nb * spb - M)).reshape(*lead, nb, spb)
    x = torch.nn.functional.pad(x, (0, tiles * GRAD_TILE - spb)).reshape(*lead, nb, tiles, GRAD_TILE)
    for _ in range(3):  # the samples of a tile, the tiles of a range, the ranges
        acc = x[..., 0]
        for i in range(1, x.shape[-1]):
            acc = acc + x[..., i]
        x = acc
    return x


def grad_step_plain(leaves, obs, act, old_logp, nadv, ret, hp: SweepHypers):
    """Gradient of one minibatch (``M`` samples, sample-major) by the
    hand-written backward of ``_sweep_kernel`` (pallas_ppo_sweep.py:229-295),
    every product and sum in the sweep kernel's order.  Returns the
    13 gradient leaves (without the entropy term) and the sums ``(policy
    loss, value loss, approx KL)`` times ``M``.  With bf16 ``matmul_dtype``
    every product operand (``op`` below) is rounded to bf16."""
    pW1, pb1, pW2, pb2, pW3, pb3, vW1, vb1, vW2, vb2, vW3, vb3, log_std = leaves
    M = obs.shape[0]
    inv_m = _scalar(1.0 / M, obs)
    x, act = obs.T, act.T  # feature-major, as the kernel's tiles
    op = round_bf16 if bf16_operands(hp.matmul_dtype) else (lambda t: t)

    def col(b):
        return b[:, None]

    def dot(w, v):
        return _dot_rows(op(w), op(v))

    y1p = torch.tanh(dot(pW1, x) + col(pb1))
    y2p = torch.tanh(dot(pW2, y1p) + col(pb2))
    mean = dot(pW3, y2p) + col(pb3)
    y1v = torch.tanh(dot(vW1, x) + col(vb1))
    y2v = torch.tanh(dot(vW2, y1v) + col(vb2))
    value = (dot(vW3, y2v) + col(vb3))[0]

    var = col(torch.exp(2.0 * log_std))
    diff = act - mean
    terms = -0.5 * (diff * diff / var + 2.0 * col(log_std) + LOG_2PI)
    logp = terms[0]
    for a in range(1, terms.shape[0]):
        logp = logp + terms[a]
    ratio = torch.exp(logp - old_logp)
    lo, hi = float(np.float32(1.0 - hp.clip_eps)), float(np.float32(1.0 + hp.clip_eps))
    pg1 = ratio * nadv
    pg2 = torch.clamp(ratio, lo, hi) * nadv
    min_pg = torch.minimum(pg1, pg2)
    verr = value - ret

    in_region = ((ratio > lo) & (ratio < hi)).to(F32)
    d_pg1 = nadv
    d_pg2 = nadv * in_region
    tie = 0.5 * (d_pg1 + d_pg2)
    d_ratio = torch.where(pg1 < pg2, d_pg1, torch.where(pg1 > pg2, d_pg2, tie))
    dl_dlogp = (-inv_m) * d_ratio * ratio

    g_mean = dl_dlogp * (diff / var)
    g_value = ((hp.vf_coef * inv_m) * verr)[None]

    def weight_grad(g, y):  # (out, M), (in, M) -> (out, in)
        return _kernel_order_sum(op(g)[:, None, :] * op(y)[None, :, :])

    g2p = dot(pW3.T, g_mean) * (1.0 - y2p * y2p)
    g1p = dot(pW2.T, g2p) * (1.0 - y1p * y1p)
    g2v = (op(vW3.T) * op(g_value)) * (1.0 - y2v * y2v)
    g1v = dot(vW2.T, g2v) * (1.0 - y1v * y1v)
    grads = []
    for g1, g2, g3, y1, y2 in ((g1p, g2p, g_mean, y1p, y2p), (g1v, g2v, g_value, y1v, y2v)):
        grads += [weight_grad(g1, x), _kernel_order_sum(g1), weight_grad(g2, y1), _kernel_order_sum(g2),
                  weight_grad(g3, y2), _kernel_order_sum(g3)]
    grads.append(_kernel_order_sum(dl_dlogp * (diff * diff / var - 1.0)))
    sums = torch.stack([_kernel_order_sum(-min_pg), 0.5 * _kernel_order_sum(verr * verr),
                        _kernel_order_sum((ratio - 1.0) - torch.log(ratio))])
    return grads, sums


def _adam_block_norm(grads: torch.Tensor) -> torch.Tensor:
    """The global norm in the sweep kernel's order: the ``P`` gradient
    elements are cut into slices of ``ceil(P / NORM_SLICES)``; each slice sums
    its squares in element order, then the slices' sums are added in slice
    order."""
    n = grads.numel()
    size = math.ceil(n / NORM_SLICES)
    slices = math.ceil(n / size)
    g = torch.nn.functional.pad(grads, (0, slices * size - n)).reshape(slices, size)
    sq = g[:, 0] * g[:, 0]
    for k in range(1, size):
        sq = sq + g[:, k] * g[:, k]
    total = sq[0]
    for i in range(1, slices):
        total = total + sq[i]
    return torch.sqrt(total)


def adam_step_plain(params, mu, nu, grads, t: int, hp: SweepHypers):
    """Clip by global norm and one Adam step on flat vectors, as the JAX
    kernel's last chunk does it (pallas_ppo_sweep.py:297-324): the norm trigger is
    ``norm < max_norm``, the bias correction ``1 − exp(t·log b)``, eps outside
    the sqrt.  ``grads`` already carries the entropy term."""
    g_norm = _adam_block_norm(grads)
    max_norm = _scalar(hp.max_grad_norm, grads)
    grads = torch.where(g_norm < max_norm, grads, (grads / g_norm) * max_norm)
    return adam_update_plain(params, mu, nu, grads, t, hp)


def adam_update_plain(params, mu, nu, grads, t: int, hp):
    """One bare Adam step on flat vectors as the sweep kernels take it:
    bias correction ``1 − exp(t·log b)``, eps outside the sqrt; ``hp`` has
    ``lr``, ``adam_b1``, ``adam_b2`` and ``adam_eps``.  Returns ``(params,
    mu, nu)``."""
    tf = _scalar(float(t), grads)
    bc1 = 1.0 - torch.exp(tf * float(np.float32(np.log(hp.adam_b1))))
    bc2 = 1.0 - torch.exp(tf * float(np.float32(np.log(hp.adam_b2))))
    m = hp.adam_b1 * mu + (1.0 - hp.adam_b1) * grads
    v = hp.adam_b2 * nu + (1.0 - hp.adam_b2) * grads * grads
    upd = (m / bc1) / (torch.sqrt(v / bc2) + hp.adam_eps)
    return params - hp.lr * upd, m, v


def ppo_sweep_plain(params, adam: AdamState, minibatches: Iterable, hypers: SweepHypers):
    """Plain twin of K3/K4: one gradient step per minibatch ``(obs (M, F),
    act (M, A), old_logp (M,), nadv (M,), ret (M,))`` with normalised
    advantages.  Returns ``(params, AdamState, metrics (G, 4))``; a metric row
    is policy loss, value loss, entropy, approx KL."""
    like = list(params)
    p, m, v = flatten_leaves(params), flatten_leaves(adam.mu), flatten_leaves(adam.nu)
    n_log_std = like[12].numel()
    rows = []
    g = 0
    for g, mb in enumerate(minibatches):
        leaves = unflatten_leaves(p, like)
        grads, sums = grad_step_plain(leaves, *mb, hypers)
        flat = torch.cat([x.reshape(-1) for x in grads])
        flat[-n_log_std:] += -hypers.ent_coef
        per_dim = leaves[12] + ENTROPY_CONST
        entropy = per_dim[0]
        for a in range(1, per_dim.numel()):
            entropy = entropy + per_dim[a]
        inv_m = _scalar(1.0 / mb[0].shape[0], flat)
        rows.append(torch.stack([sums[0] * inv_m, sums[1] * inv_m, entropy, sums[2] * inv_m]))
        p, m, v = adam_step_plain(p, m, v, flat, adam.count + g + 1, hypers)
    G = len(rows)
    return (unflatten_leaves(p, like), AdamState(adam.count + G, unflatten_leaves(m, like),
                                                 unflatten_leaves(v, like)), torch.stack(rows))


# ------------------------------------------------------- data and stats ---

def sample_blocks(x: torch.Tensor, granule: int, data_layout: str) -> torch.Tensor:
    """A trajectory array as ``(n_bl, granule[, feat])`` sample-major blocks in
    block-id order.  featlane: ``(T, feat, B)`` or ``(T, B)``, block id
    ``t·(B // granule) + slab``; sample: ``(S, feat)`` or ``(S,)``."""
    if data_layout == "featlane":
        if x.dim() == 2:
            T, B = x.shape
            return x.reshape(T * (B // granule), granule)
        T, feat, B = x.shape
        return x.reshape(T, feat, B // granule, granule).permute(0, 2, 3, 1).reshape(-1, granule, feat)
    if data_layout == "sample":
        return x.reshape((x.shape[0] // granule, granule) + tuple(x.shape[1:]))
    raise ValueError(f"unknown data_layout {data_layout!r}")


def normalise_centred(adv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row mean and std of ``adv (G, M)``, centred (two passes, ddof 0)."""
    mean = adv.mean(dim=1, keepdim=True)
    centred = adv - mean
    std = torch.sqrt((centred * centred).mean(dim=1))
    return mean[:, 0], std


def minibatch_stats(adv: torch.Tensor, block_perm: torch.Tensor, granule: int,
                    data_layout: str) -> torch.Tensor:
    """``(2, G)``: each minibatch's advantage mean and centred std."""
    blocks = sample_blocks(adv, granule, data_layout)
    G, K = block_perm.shape
    mean, std = normalise_centred(blocks[block_perm.long()].reshape(G, K * granule))
    return torch.stack([mean, std]).contiguous()


def _check_streamed(obs, granule, data_layout):
    if data_layout == "featlane":
        B = obs.shape[2]
        if B % granule:
            raise ValueError(f"lane count {B} not divisible by slab granule {granule}")
        return obs.shape[0] * (B // granule)
    if data_layout == "sample":
        S = obs.shape[0]
        if S % granule:
            raise ValueError(f"flat sample count {S} not divisible by granule {granule}")
        return S // granule
    raise ValueError(f"unknown data_layout {data_layout!r}")


# ------------------------------------------------------------------- K3 ---

def ppo_sweep_streamed_plain(params, adam: AdamState, obs, act, logp, adv, ret, block_perm, granule: int,
                             hypers: SweepHypers, data_layout: str = "featlane"):
    """Plain twin of K3: gathers each step's blocks and normalises its
    advantages with the centred stats, on the inputs' device."""
    G, K = block_perm.shape
    M = K * granule
    block_perm = block_perm.to(obs.device)
    stats = minibatch_stats(adv.to(F32), block_perm, granule, data_layout)
    blocks = [sample_blocks(x.to(F32), granule, data_layout) for x in (obs, act, logp, adv, ret)]

    def minibatches():
        for g in range(G):
            idx = block_perm[g].long()
            o, a, lp, ad, r = (b[idx].reshape((M,) + tuple(b.shape[2:])) for b in blocks)
            yield o, a, lp, (ad - stats[0, g]) / (stats[1, g] + 1e-8), r

    return ppo_sweep_plain(params, adam, minibatches(), hypers)


@spanned("sweep")
def ppo_sweep_streamed(params, adam: AdamState, obs, act, logp, adv, ret, block_perm: torch.Tensor,
                       granule: int, hypers: SweepHypers, data_layout: str = "featlane"):
    """All ``G`` gradient steps of one update over the sample blocks that
    ``block_perm (G, K)`` names (K3).  Returns ``(params, AdamState, metrics
    (G, 4))``; the inputs are not modified.  ``block_perm`` is checked on the
    host (a CUDA ``block_perm`` costs a device sync)."""
    n_bl = _check_streamed(obs, granule, data_layout)
    host_perm = block_perm.cpu()
    if host_perm.dim() != 2 or host_perm.numel() == 0:
        raise ValueError(f"block_perm must be (G, K), got {tuple(host_perm.shape)}")
    if int(host_perm.min()) < 0 or int(host_perm.max()) >= n_bl:
        raise ValueError(f"block_perm indexes outside the {n_bl} sample blocks")
    G, K = host_perm.shape
    M = K * granule
    block_perm = host_perm.to(torch.int32)
    if obs.device.type == "cuda":
        block_perm = block_perm.pin_memory().to(obs.device, non_blocking=True)
    if not kernel_device(obs):
        return ppo_sweep_streamed_plain(params, adam, obs, act, logp, adv, ret, block_perm, granule,
                                        hypers, data_layout)
    stats = minibatch_stats(adv.to(F32), block_perm, granule, data_layout)
    return _launch_sweep("ppo_sweep_streamed", params, adam, hypers, LAYOUTS[data_layout],
                         (obs, act, logp, adv, ret), block_perm, stats, G=G, K=K, granule=granule, M=M)


# ------------------------------------------------------------------- K4 ---

def ppo_sweep(params, adam: AdamState, obs_g, act_g, logp_g, nadv_g, ret_g, hypers: SweepHypers):
    """All ``G`` gradient steps on pre-gathered minibatches ``obs_g (G, M, F)``,
    ``act_g (G, M, A)``, ``logp_g``/``nadv_g``/``ret_g (G, M)`` with
    normalised advantages (K4).  Returns ``(params, AdamState, metrics (G, 4))``."""
    G, M = logp_g.shape
    if obs_g.shape[:2] != (G, M) or act_g.shape[:2] != (G, M):
        raise ValueError(f"obs_g/act_g must lead with ({G}, {M}), got {tuple(obs_g.shape)}, "
                         f"{tuple(act_g.shape)}")
    if not kernel_device(obs_g):
        mbs = zip(*(x.to(F32) for x in (obs_g, act_g, logp_g, nadv_g, ret_g)))
        return ppo_sweep_plain(params, adam, mbs, hypers)
    return _launch_sweep("ppo_sweep", params, adam, hypers, LAYOUTS["gathered"],
                         (obs_g, act_g, logp_g, nadv_g, ret_g), None, None,
                         G=G, K=1, granule=M, M=M)


# ------------------------------------------------------ the CUDA launch ---

def grad_blocks(M: int) -> int:
    """Sample ranges (partial gradients) per gradient step: one per
    ``GRAD_TILE`` samples, at most ``MAX_GRAD_BLOCKS``; the partition is a
    function of ``M`` alone, so reruns sum in the same order."""
    return max(1, min(MAX_GRAD_BLOCKS, math.ceil(M / GRAD_TILE)))


def _launch_sweep(name, params, adam, hp, layout, data, block_perm, stats, *, G, K, granule, M):
    obs, act, logp, adv, ret = (_build.check_f32(x.contiguous(), n) for x, n in
                                zip(data, ("obs", "act", "logp", "adv", "ret")))
    device = obs.device
    F, A, H1, H2 = torso_dims(params)
    feat_axis = 1 if layout == LAYOUTS["featlane"] else -1
    # the lane stride of the featlane layout; the sample count otherwise
    lanes = {LAYOUTS["featlane"]: obs.shape[-1], LAYOUTS["sample"]: obs.shape[0]}.get(layout, M)
    if obs.shape[feat_axis] != F or act.shape[feat_axis] != A:
        raise ValueError(f"data has obs {tuple(obs.shape)} and act {tuple(act.shape)}, "
                         f"the network takes F={F}, A={A}")
    lib = _build.load(_build.sweep_spec(F, A, H1, H2), device)
    n_params = lib.ngk_sweep_params_size()
    p = flatten_leaves(params).to(device)
    if p.numel() != n_params:
        raise ValueError(f"{p.numel()} parameters, the sweep library expects {n_params}")
    mu, nu = flatten_leaves(adam.mu).to(device), flatten_leaves(adam.nu).to(device)
    nb = grad_blocks(M)
    f32 = dict(dtype=F32, device=device)
    partials = torch.empty((nb, n_params + 3), **f32)
    grad = torch.empty(n_params, **f32)
    slice_sq = torch.empty(lib.ngk_sweep_slices(), **f32)
    metrics = torch.empty((G, 4), **f32)
    null = torch.empty(0, device=device)
    perm = block_perm if block_perm is not None else null
    st = stats if stats is not None else null
    bf16 = bf16_operands(hp.matmul_dtype)
    tensors = (p, mu, nu, obs, act, logp, adv, ret, perm, st, partials, grad, slice_sq, metrics)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    ints = (ctypes.c_int * 10)(layout, G, K, granule, M, lanes, nb, math.ceil(M / nb), adam.count, int(bf16))
    floats = (ctypes.c_float * 14)(
        float(np.float32(1.0 - hp.clip_eps)), float(np.float32(1.0 + hp.clip_eps)), hp.vf_coef, 1.0 / M, hp.lr,
        hp.max_grad_norm, -hp.ent_coef, hp.adam_b1, 1.0 - hp.adam_b1, float(np.float32(np.log(hp.adam_b1))),
        hp.adam_b2, 1.0 - hp.adam_b2, float(np.float32(np.log(hp.adam_b2))), hp.adam_eps)
    _build.launch(name + ("_bf16" if bf16 else ""), lib.ngk_ppo_sweep, ptrs, ints, floats, device=device)
    like = list(params)
    return (unflatten_leaves(p, like),
            AdamState(adam.count + G, unflatten_leaves(mu, like), unflatten_leaves(nu, like)),
            metrics)
