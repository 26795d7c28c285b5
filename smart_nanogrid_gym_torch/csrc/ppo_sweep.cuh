// The PPO update sweep (K3, K4): per gradient step, the gradient of the
// clipped-surrogate + value + entropy loss of the SB3 actor-critic over one
// minibatch, global-norm clip and Adam.
//
// Replaces the Pallas TPU kernels of smart_nanogrid_gym_tpu/ops/pallas_ppo_sweep.py:
//   K3 ppo_sweep_pallas_streamed (featlane and sample layouts) and
//   K4 ppo_sweep_pallas (pre-gathered minibatches)
// with two kernels per gradient step g, launched in order on one stream:
//   ppo_grad_partial<Net>: a fixed grid; block k takes the k-th run of the
//     minibatch's samples, in tiles of kTile, and accumulates their gradient
//     (forward of both torsos, the loss, the hand-written backward of
//     pallas_ppo_sweep.py:229-295) and the three metric sums in shared memory;
//     it writes one partial per block;
//   ppo_adam_update<Net>: one block sums the partials in block order (no float
//     atomics, so reruns are bit-identical), adds the entropy term, clips by
//     the global norm (trigger norm < max_norm) and applies Adam with
//     t = count + g + 1 and bias correction 1 - exp(t log b) to the flat
//     params, mu and nu in place (about 150 KB, resident in L2).
// The TPU kernel ran the G steps as a sequential grid with the gradient in
// VMEM scratch; here blocks run in parallel, so each step needs a reduction
// across blocks, and the steps stay sequential launches.
//
// Bound: the two torsos' forward and backward, about 7.2e4 flops per sample
// (G x M samples per update), in float32 outside the tensor cores.  The
// design keeps every activation of a tile, the block's gradient and the
// parameters in shared memory; rows are padded to kTile + 1 floats so that
// the warps' column reads hit distinct banks.  Multiply-adds are written out
// (the build uses --fmad=false).
//
// The bf16 operand option (SweepHypers.matmul_dtype, pallas_ppo_sweep.py:191-206)
// is the template flag BF16, chosen at launch: both operands of every network
// product (the forward of both torsos, lanedot, subdot and gW1) are rounded
// where they enter the product (operand.cuh), the weight matrices once as
// the block loads them.  The tile keeps f32 activations, because the tanh
// derivative 1 - y^2, the loss, the clip and Adam read f32 values.  The
// tensor cores are not used: their accumulation order is not the twin's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "operand.cuh"

namespace ngs {

using ngo::operand;

constexpr int kTile = 32;          // samples per tile (one per lane)
constexpr int kRow = kTile + 1;    // padded row of a feature-major tile
constexpr int kThreads = 256;      // threads of a ppo_grad_partial block
constexpr int kAdamThreads = 1024; // threads of the ppo_adam_update block
constexpr float kLog2Pi = 1.8378770664093453f;     // f32(log(2 pi))
constexpr float kEntropy = 1.4189385332046727f;    // f32(0.5 log(2 pi e)), entropy per action dim

// Flat parameter layout: the 13 leaves of actor_critic_leaves, each row-major.
template <int F_, int A_, int H1_, int H2_>
struct Net {
  static constexpr int F = F_, A = A_, H1 = H1_, H2 = H2_;
  static constexpr int PW1 = 0, PB1 = PW1 + H1 * F, PW2 = PB1 + H1, PB2 = PW2 + H2 * H1, PW3 = PB2 + H2,
                       PB3 = PW3 + A * H2;
  static constexpr int VW1 = PB3 + A, VB1 = VW1 + H1 * F, VW2 = VB1 + H1, VB2 = VW2 + H2 * H1,
                       VW3 = VB2 + H2, VB3 = VW3 + H2;
  static constexpr int LOG_STD = VB3 + 1;
  static constexpr int P = LOG_STD + A;       // parameter count
  static constexpr int PARTIAL = P + 3;       // + policy loss, squared value error, approx KL sums

  // element i of the flat parameters belongs to a weight matrix (a product operand)
  __device__ static bool is_weight(int i) {
    return (i >= PW1 && i < PB1) || (i >= PW2 && i < PB2) || (i >= PW3 && i < PB3) || (i >= VW1 && i < VB1) ||
           (i >= VW2 && i < VB2) || (i >= VW3 && i < VB3);
  }
};

// Where the samples of the minibatch live.
struct Data {
  const float *obs, *act, *logp, *adv, *ret;
  const int* block_perm;  // (G, K) for the streamed layouts
  const float* stats;     // (2, G): advantage mean and centred std, streamed layouts
  int layout;             // 0 featlane (T, feat, B), 1 sample (S, feat), 2 gathered (G, M, feat)
  int g, G, K, granule, M, lanes;
};

// Memory position of minibatch sample m (see feat_at and row_at).
struct Where {
  int64_t pos, row;  // pos: sample-major index (sample/gathered) or lane; row: featlane time step
};

__device__ __forceinline__ Where locate(const Data& d, int m) {
  Where w;
  if (d.layout == 2) {
    w.pos = static_cast<int64_t>(d.g) * d.M + m;
    w.row = 0;
    return w;
  }
  const int c = m / d.granule, o = m % d.granule;
  const int bid = d.block_perm[d.g * d.K + c];
  if (d.layout == 1) {
    w.pos = static_cast<int64_t>(bid) * d.granule + o;
    w.row = 0;
  } else {
    const int nslab = d.lanes / d.granule;
    w.row = bid / nslab;
    w.pos = static_cast<int64_t>(bid % nslab) * d.granule + o;
  }
  return w;
}

// Element f of a (feat)-wide array at sample w.
__device__ __forceinline__ float feat_at(const Data& d, const float* x, int feat, const Where& w, int f) {
  if (d.layout == 0) return x[(w.row * feat + f) * d.lanes + w.pos];
  return x[w.pos * feat + f];
}

// A per-sample scalar at sample w.
__device__ __forceinline__ float row_at(const Data& d, const float* x, const Where& w) {
  if (d.layout == 0) return x[w.row * d.lanes + w.pos];
  return x[w.pos];
}

// Shared-memory tile of kTile samples, feature-major with padded rows.
template <class N>
struct Tile {
  float x[N::F * kRow], act[N::A * kRow];
  float y1p[N::H1 * kRow], y2p[N::H2 * kRow], y1v[N::H1 * kRow], y2v[N::H2 * kRow];
  float mean[N::A * kRow], gmean[N::A * kRow], diff[N::A * kRow];
  float g2p[N::H2 * kRow], g2v[N::H2 * kRow], g1p[N::H1 * kRow], g1v[N::H1 * kRow];
  float old_logp[kTile], nadv[kTile], ret[kTile], value[kTile], dl[kTile], gval[kTile];
  float min_pg[kTile], verr2[kTile], kl[kTile];
};

template <class N>
constexpr size_t grad_smem_bytes() {
  return (static_cast<size_t>(N::P) + N::PARTIAL) * sizeof(float) + sizeof(Tile<N>);
}

// sum_k w[k] * x[k * kRow] for k = 0..K-1, in index order; the weights are
// rounded already, x is rounded here with BF16
template <int K, bool BF16>
__device__ __forceinline__ float dot_col(const float* w, int wstride, const float* x) {
  float acc = w[0] * operand<BF16>(x[0]);
#pragma unroll 8
  for (int k = 1; k < K; ++k) acc = acc + w[k * wstride] * operand<BF16>(x[k * kRow]);
  return acc;
}

// sum over the tile of a[s] * b[s], in sample order (both operands rounded with BF16)
template <bool BF16>
__device__ __forceinline__ float tile_dot(const float* a, const float* b) {
  float acc = operand<BF16>(a[0]) * operand<BF16>(b[0]);
#pragma unroll
  for (int s = 1; s < kTile; ++s) acc = acc + operand<BF16>(a[s]) * operand<BF16>(b[s]);
  return acc;
}

__device__ __forceinline__ float tile_sum(const float* a) {
  float acc = a[0];
#pragma unroll
  for (int s = 1; s < kTile; ++s) acc = acc + a[s];
  return acc;
}

// The gradient of block blockIdx.x's samples [m0, m1) of minibatch g:
// partials[blockIdx.x] = (13 gradient leaves flat, sum -min_pg, sum verr^2, sum KL).
template <class N, bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
ppo_grad_partial(const float* __restrict__ params, Data d, int samples_per_block, float lo, float hi,
                 float vf_coef, float inv_m, float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* w = smem;                   // params (P)
  float* acc = w + N::P;             // gradient + metric sums (PARTIAL)
  Tile<N>& tl = *reinterpret_cast<Tile<N>*>(acc + N::PARTIAL);
  const int tid = threadIdx.x;
  for (int i = tid; i < N::P; i += kThreads) {
    w[i] = BF16 && N::is_weight(i) ? operand<true>(params[i]) : params[i];
  }
  for (int i = tid; i < N::PARTIAL; i += kThreads) acc[i] = 0.0f;

  const float neg_inv_m = -inv_m;
  const float vf_scale = vf_coef * inv_m;
  // the streamed layouts normalise the advantages with the minibatch's stats
  const float mean_g = d.layout != 2 ? d.stats[d.g] : 0.0f;
  const float std_g = d.layout != 2 ? d.stats[d.G + d.g] : 0.0f;
  const int m_begin = blockIdx.x * samples_per_block;
  const int m_end = min(d.M, m_begin + samples_per_block);
  __syncthreads();

  for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
    // ---- load the tile; samples past the block's range are zero and carry no gradient ----
    for (int i = tid; i < (N::F + N::A + 3) * kTile; i += kThreads) {
      const int r = i / kTile, s = i % kTile, m = m0 + s;
      float v = 0.0f;
      if (m < m_end) {
        const Where at = locate(d, m);
        if (r < N::F) {
          v = feat_at(d, d.obs, N::F, at, r);
        } else if (r < N::F + N::A) {
          v = feat_at(d, d.act, N::A, at, r - N::F);
        } else if (r == N::F + N::A) {
          v = row_at(d, d.logp, at);
        } else if (r == N::F + N::A + 1) {
          v = row_at(d, d.adv, at);
          if (d.layout != 2) v = (v - mean_g) / (std_g + 1e-8f);
        } else {
          v = row_at(d, d.ret, at);
        }
      }
      if (r < N::F) tl.x[r * kRow + s] = v;
      else if (r < N::F + N::A) tl.act[(r - N::F) * kRow + s] = v;
      else if (r == N::F + N::A) tl.old_logp[s] = v;
      else if (r == N::F + N::A + 1) tl.nadv[s] = v;
      else tl.ret[s] = v;
    }
    __syncthreads();

    // ---- hidden layer 1 of both torsos ----
    for (int i = tid; i < 2 * N::H1 * kTile; i += kThreads) {
      const int net = i / (N::H1 * kTile), rem = i % (N::H1 * kTile), j = rem / kTile, s = rem % kTile;
      const int W = net ? N::VW1 : N::PW1, Bi = net ? N::VB1 : N::PB1;
      const float z = dot_col<N::F, BF16>(w + W + j * N::F, 1, tl.x + s) + w[Bi + j];
      (net ? tl.y1v : tl.y1p)[j * kRow + s] = tanhf(z);
    }
    __syncthreads();
    // ---- hidden layer 2 ----
    for (int i = tid; i < 2 * N::H2 * kTile; i += kThreads) {
      const int net = i / (N::H2 * kTile), rem = i % (N::H2 * kTile), j = rem / kTile, s = rem % kTile;
      const int W = net ? N::VW2 : N::PW2, Bi = net ? N::VB2 : N::PB2;
      const float* y1 = net ? tl.y1v : tl.y1p;
      const float z = dot_col<N::H1, BF16>(w + W + j * N::H1, 1, y1 + s) + w[Bi + j];
      (net ? tl.y2v : tl.y2p)[j * kRow + s] = tanhf(z);
    }
    __syncthreads();
    // ---- outputs: the action mean (A) and the value ----
    for (int i = tid; i < (N::A + 1) * kTile; i += kThreads) {
      const int a = i / kTile, s = i % kTile;
      if (a < N::A) {
        tl.mean[a * kRow + s] = dot_col<N::H2, BF16>(w + N::PW3 + a * N::H2, 1, tl.y2p + s) + w[N::PB3 + a];
      } else {
        tl.value[s] = dot_col<N::H2, BF16>(w + N::VW3, 1, tl.y2v + s) + w[N::VB3];
      }
    }
    __syncthreads();

    // ---- the loss and its derivative per sample (one lane per sample) ----
    if (tid < kTile) {
      const int s = tid;
      const bool valid = m0 + s < m_end;
      float logp = 0.0f;
#pragma unroll
      for (int a = 0; a < N::A; ++a) {
        const float ls = w[N::LOG_STD + a];
        const float var = expf(2.0f * ls);
        const float df = tl.act[a * kRow + s] - tl.mean[a * kRow + s];
        tl.diff[a * kRow + s] = df;
        const float term = -0.5f * (df * df / var + 2.0f * ls + kLog2Pi);
        logp = a == 0 ? term : logp + term;
      }
      const float nadv = tl.nadv[s];
      const float ratio = expf(logp - tl.old_logp[s]);
      const float pg1 = ratio * nadv;
      const float pg2 = fminf(fmaxf(ratio, lo), hi) * nadv;
      const float verr = tl.value[s] - tl.ret[s];
      const float in_region = (ratio > lo && ratio < hi) ? 1.0f : 0.0f;
      const float d_pg1 = nadv, d_pg2 = nadv * in_region;
      const float tie = 0.5f * (d_pg1 + d_pg2);
      const float d_ratio = pg1 < pg2 ? d_pg1 : (pg1 > pg2 ? d_pg2 : tie);
      const float dl = valid ? neg_inv_m * d_ratio * ratio : 0.0f;
      tl.dl[s] = dl;
      tl.gval[s] = valid ? vf_scale * verr : 0.0f;
      tl.min_pg[s] = valid ? -fminf(pg1, pg2) : 0.0f;
      tl.verr2[s] = valid ? verr * verr : 0.0f;
      tl.kl[s] = valid ? (ratio - 1.0f) - logf(ratio) : 0.0f;
#pragma unroll
      for (int a = 0; a < N::A; ++a) {
        const float var = expf(2.0f * w[N::LOG_STD + a]);
        tl.gmean[a * kRow + s] = dl * (tl.diff[a * kRow + s] / var);
      }
    }
    __syncthreads();

    // ---- backward 1: output layers, log_std, metric sums; g2 = W3^T g_out * (1 - y2^2) ----
    {
      constexpr int nW3p = N::A * N::H2, nB3p = N::A, nW3v = N::H2, nLs = N::A, nG2 = 2 * N::H2 * kTile;
      for (int i = tid; i < nW3p + nB3p + nW3v + 1 + nLs + 3 + nG2; i += kThreads) {
        int e = i;
        if (e < nW3p) {  // gW3p[a][k] (row-major a, k)
          const int a = e / N::H2, k = e % N::H2;
          const float sum = tile_dot<BF16>(tl.gmean + a * kRow, tl.y2p + k * kRow);
          acc[N::PW3 + e] += sum;
          continue;
        }
        e -= nW3p;
        if (e < nB3p) {
          acc[N::PB3 + e] += tile_sum(tl.gmean + e * kRow);
          continue;
        }
        e -= nB3p;
        if (e < nW3v) {
          acc[N::VW3 + e] += tile_dot<BF16>(tl.gval, tl.y2v + e * kRow);
          continue;
        }
        e -= nW3v;
        if (e < 1) {
          acc[N::VB3] += tile_sum(tl.gval);
          continue;
        }
        e -= 1;
        if (e < nLs) {  // d logp / d log_std_a = diff^2 / var - 1
          const float var = expf(2.0f * w[N::LOG_STD + e]);
          float sum = 0.0f;
#pragma unroll
          for (int s = 0; s < kTile; ++s) {
            const float df = tl.diff[e * kRow + s];
            const float v = tl.dl[s] * (df * df / var - 1.0f);
            sum = s == 0 ? v : sum + v;
          }
          acc[N::LOG_STD + e] += sum;
          continue;
        }
        e -= nLs;
        if (e < 3) {
          acc[N::P + e] += tile_sum(e == 0 ? tl.min_pg : (e == 1 ? tl.verr2 : tl.kl));
          continue;
        }
        e -= 3;
        const int net = e / (N::H2 * kTile), rem = e % (N::H2 * kTile), k = rem / kTile, s = rem % kTile;
        float back;
        if (net == 0) {
          back = dot_col<N::A, BF16>(w + N::PW3 + k, N::H2, tl.gmean + s);
        } else {
          back = w[N::VW3 + k] * operand<BF16>(tl.gval[s]);
        }
        const float y = (net ? tl.y2v : tl.y2p)[k * kRow + s];
        (net ? tl.g2v : tl.g2p)[k * kRow + s] = back * (1.0f - y * y);
      }
    }
    __syncthreads();

    // ---- backward 2: hidden layer 2 weights; g1 = W2^T g2 * (1 - y1^2) ----
    {
      constexpr int nW2 = N::H2 * N::H1, nG1 = N::H1 * kTile;
      for (int i = tid; i < 2 * (nW2 + N::H2 + nG1); i += kThreads) {
        const int net = i / (nW2 + N::H2 + nG1);
        int e = i % (nW2 + N::H2 + nG1);
        const float* g2 = net ? tl.g2v : tl.g2p;
        const float* y1 = net ? tl.y1v : tl.y1p;
        if (e < nW2) {  // gW2[k][j]
          const int k = e / N::H1, j = e % N::H1;
          acc[(net ? N::VW2 : N::PW2) + e] += tile_dot<BF16>(g2 + k * kRow, y1 + j * kRow);
          continue;
        }
        e -= nW2;
        if (e < N::H2) {
          acc[(net ? N::VB2 : N::PB2) + e] += tile_sum(g2 + e * kRow);
          continue;
        }
        e -= N::H2;
        const int j = e / kTile, s = e % kTile;
        const float back = dot_col<N::H2, BF16>(w + (net ? N::VW2 : N::PW2) + j, N::H1, g2 + s);
        const float y = y1[j * kRow + s];
        (net ? tl.g1v : tl.g1p)[j * kRow + s] = back * (1.0f - y * y);
      }
    }
    __syncthreads();

    // ---- backward 3: hidden layer 1 weights ----
    {
      constexpr int nW1 = N::H1 * N::F;
      for (int i = tid; i < 2 * (nW1 + N::H1); i += kThreads) {
        const int net = i / (nW1 + N::H1);
        const int e = i % (nW1 + N::H1);
        const float* g1 = net ? tl.g1v : tl.g1p;
        if (e < nW1) {  // gW1[j][f]
          const int j = e / N::F, f = e % N::F;
          acc[(net ? N::VW1 : N::PW1) + e] += tile_dot<BF16>(g1 + j * kRow, tl.x + f * kRow);
        } else {
          acc[(net ? N::VB1 : N::PB1) + e - nW1] += tile_sum(g1 + (e - nW1) * kRow);
        }
      }
    }
    __syncthreads();
  }

  float* out = partials + static_cast<int64_t>(blockIdx.x) * N::PARTIAL;
  for (int i = tid; i < N::PARTIAL; i += kThreads) out[i] = acc[i];
}

// Deterministic sum over the block (fixed shuffle tree, then warps in order).
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = scratch[0];
    for (int i = 1; i < static_cast<int>(blockDim.x) / 32; ++i) total = total + scratch[i];
    scratch[32] = total;
  }
  __syncthreads();
  return scratch[32];
}

struct AdamArgs {
  int g, t;
  float inv_m, lr, max_norm, neg_ent_coef;
  float b1, one_minus_b1, log_b1, b2, one_minus_b2, log_b2, eps;
};

// Sum the nb partials in block order, clip by the global norm, one Adam step
// on params/mu/nu in place; metrics row g = (policy loss, value loss,
// entropy, approx KL).  One block of kAdamThreads threads.
template <class N>
__global__ void __launch_bounds__(kAdamThreads, 1)
ppo_adam_update(float* __restrict__ params, float* __restrict__ mu, float* __restrict__ nu,
                const float* __restrict__ partials, int nb, float* __restrict__ metrics, AdamArgs h) {
  constexpr int PER = (N::P + kAdamThreads - 1) / kAdamThreads;
  __shared__ float scratch[33];
  const int tid = threadIdx.x;
  float grad[PER];
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * kAdamThreads;
    float g = 0.0f;
    if (e < N::P) {
      g = partials[e];
      for (int b = 1; b < nb; ++b) g = g + partials[static_cast<int64_t>(b) * N::PARTIAL + e];
      if (e >= N::LOG_STD) g = g + h.neg_ent_coef;
    }
    grad[k] = g;
    sq = k == 0 ? g * g : sq + g * g;
  }
  if (tid == 0) {
    float sums[3];
    for (int i = 0; i < 3; ++i) {
      float v = partials[N::P + i];
      for (int b = 1; b < nb; ++b) v = v + partials[static_cast<int64_t>(b) * N::PARTIAL + N::P + i];
      sums[i] = v;
    }
    float entropy = params[N::LOG_STD] + kEntropy;
    for (int a = 1; a < N::A; ++a) entropy = entropy + (params[N::LOG_STD + a] + kEntropy);
    metrics[h.g * 4 + 0] = sums[0] * h.inv_m;
    metrics[h.g * 4 + 1] = (0.5f * sums[1]) * h.inv_m;
    metrics[h.g * 4 + 2] = entropy;
    metrics[h.g * 4 + 3] = sums[2] * h.inv_m;
  }
  const float g_norm = sqrtf(block_sum(sq, scratch));
  const bool trigger = g_norm < h.max_norm;
  const float tf = static_cast<float>(h.t);
  const float bc1 = 1.0f - expf(tf * h.log_b1);
  const float bc2 = 1.0f - expf(tf * h.log_b2);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * kAdamThreads;
    if (e >= N::P) continue;
    const float g = trigger ? grad[k] : (grad[k] / g_norm) * h.max_norm;
    const float m = h.b1 * mu[e] + h.one_minus_b1 * g;
    const float v = h.b2 * nu[e] + h.one_minus_b2 * g * g;
    mu[e] = m;
    nu[e] = v;
    const float upd = (m / bc1) / (sqrtf(v / bc2) + h.eps);
    params[e] = params[e] - h.lr * upd;
  }
}

}  // namespace ngs
