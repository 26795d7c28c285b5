// The DDPG update sweep (K10): one gradient step of SB3's DDPG on pre-gathered
// replay minibatches: target bootstrap, critic MSE step with bare Adam, actor
// step through the updated critic, polyak averaging of both targets.
//
// Replaces the Pallas TPU kernel smart_nanogrid_gym_tpu/ops/pallas_ddpg_sweep.py
// (ddpg_sweep_pallas, contract at :24-32 and :138-232).  The TPU kernel kept
// the four networks and both Adam states resident in VMEM across its
// sequential grid of G steps.  Here that state (about 8 x 133k floats, 4.3 MB)
// lives in device memory and L2, and each gradient step is a fixed sequence
// of launches on one stream (ddpg_step below): the hard order critic
// gradient -> critic Adam -> actor gradient through the updated critic ->
// actor Adam -> polyak needs a grid-wide barrier between phases, and stream
// order gives it.
//
// Every product is one generic kernel, gemm_kernel: C[i][j] = sum_k A[i][k]
// B[k][j] with strided operands (so the forward x W^T, the weight gradient
// G^T x and the input gradient G W read the same buffers without copies)
// and a fused epilogue (bias + ReLU, ReLU-mask, squash, bootstrap target,
// critic error, tanh derivative).  A block owns a 64 x 64 output tile and
// walks k in order, so each output's sum runs over its reduction index in
// index order, starting from the first product: no partial sums, no atomics,
// reruns are bit-identical, and the plain twin (ops/ddpg_sweep.py) writes
// the same order out.  Bias gradients are column sums in sample order
// (colsum_kernel).  Multiply-adds are written out (the build uses
// --fmad=false).
//
// Bound: the products, about 2.7e6 flops per sample and step (G x M samples
// per update), in float32 outside the tensor cores; Adam and polyak move
// about 8 MB per step.
//
// The bf16 operand option (DDPGSweepHypers.matmul_dtype,
// pallas_ddpg_sweep.py:105-135, 153-154) is gemm_kernel's template flag:
// every product in the step casts both operands (target bootstrap, critic
// forward and backward, actor forward, the critic's input gradient, actor
// backward), so the block rounds each A and B element as it stages it into
// shared memory (operand.cuh).  The epilogues read f32 aux: the ReLU masks,
// the squash, tanh_u, the TD error, Adam, polyak and the bias column sums
// stay f32.  The tensor cores are not used: their accumulation order is not
// the twin's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "operand.cuh"

namespace ngd {

using ngo::operand;

constexpr int kTileM = 64, kTileN = 64, kTileK = 16;
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kVecThreads = 256;

// Flat layout of one 2-hidden-layer network: W1 (H1, In) b1 W2 (H2, H1) b2 W3 (Out, H2) b3.
template <int IN, int OUT, int H1, int H2>
struct Mlp {
  static constexpr int W1 = 0, B1 = W1 + H1 * IN, W2 = B1 + H1, B2 = W2 + H2 * H1, W3 = B2 + H2,
                       B3 = W3 + OUT * H2;
  static constexpr int P = B3 + OUT;
};

enum Epilogue : int {
  kNone = 0,      // c = acc
  kBiasRelu = 1,  // c = relu(acc + bias[n])
  kMask = 2,      // c = acc * (aux[m][n] > 0)          (ReLU backward from the post-activation)
  kSquash = 3,    // c = lo + (tanh(u) + 1) * half_span,  u = acc + bias[n]; aux_out = tanh(u)
  kTarget = 4,    // c = v0[m] + (s0 * (1 - v1[m])) * (acc + bias[n])      (r + gamma (1 - d) Q')
  kCritic = 5,    // cerr = (acc + bias[n]) - v0[m]; aux_out = cerr; c = s0 * cerr
  kBias = 6,      // c = acc + bias[n]
  kTanhGrad = 7,  // c = (acc * half_span[n]) * (1 - aux[m][n]^2)
};

struct Gemm {
  const float* a;
  int64_t am, ak;  // A[i][k] = a[i * am + k * ak]
  const float* b;
  int64_t bk, bn;  // B[k][j] = b[k * bk + j * bn]
  float* c;
  int64_t cm, cn;  // C[i][j] = c[i * cm + j * cn]
  int M, N, K;
};

struct Epi {
  int kind;
  const float* bias;   // (N)
  const float* aux;    // kMask, kTanhGrad: (M, N) at aux[m * xm + n]
  int64_t xm;
  float* aux_out;      // kSquash, kCritic: at aux_out[m * om + n]
  int64_t om;
  const float* v0;     // kTarget: rewards (M); kCritic: targets (M); kSquash, kTanhGrad: low (N)
  const float* v1;     // kTarget: dones (M); kSquash, kTanhGrad: high (N)
  float s0;            // kTarget: gamma; kCritic: 2 / M
};

__device__ __forceinline__ float epilogue(const Epi& e, float acc, int m, int n) {
  switch (e.kind) {
    case kBiasRelu: {
      const float v = acc + e.bias[n];
      return v > 0.0f ? v : 0.0f;
    }
    case kMask:
      return acc * (e.aux[m * e.xm + n] > 0.0f ? 1.0f : 0.0f);
    case kSquash: {
      const float lo = e.v0[n], hi = e.v1[n];
      const float th = tanhf(acc + e.bias[n]);
      if (e.aux_out != nullptr) e.aux_out[m * e.om + n] = th;
      return lo + (th + 1.0f) * (0.5f * (hi - lo));
    }
    case kTarget:
      return e.v0[m] + (e.s0 * (1.0f - e.v1[m])) * (acc + e.bias[n]);
    case kCritic: {
      const float cerr = (acc + e.bias[n]) - e.v0[m];
      e.aux_out[m * e.om + n] = cerr;
      return e.s0 * cerr;
    }
    case kBias:
      return acc + e.bias[n];
    case kTanhGrad: {
      const float lo = e.v0[n], hi = e.v1[n];
      const float th = e.aux[m * e.xm + n];
      return (acc * (0.5f * (hi - lo))) * (1.0f - th * th);
    }
    default:
      return acc;
  }
}

// C = epilogue(A B): a block per 64 x 64 tile of C, k in chunks of 16 in order;
// with BF16 the staged A and B elements are rounded to bf16 values.
template <bool BF16>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(Gemm g, Epi e) {
  __shared__ float as[kTileK][kTileM + 1];
  __shared__ float bs[kTileK][kTileN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = -0.0f;  // -0 + p == p for every p: the sum starts at its first product

  for (int k0 = 0; k0 < g.K; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTileM * kTileK; i += kGemmThreads) {
      // the unit-stride index runs fastest across threads
      const int mm = g.ak == 1 ? i / kTileK : i % kTileM;
      const int kk = g.ak == 1 ? i % kTileK : i / kTileM;
      const int m = m0 + mm, k = k0 + kk;
      as[kk][mm] = (m < g.M && k < g.K) ? operand<BF16>(g.a[m * g.am + k * g.ak]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kTileN * kTileK; i += kGemmThreads) {
      const int nn = g.bn == 1 ? i % kTileN : i / kTileK;
      const int kk = g.bn == 1 ? i / kTileN : i % kTileK;
      const int n = n0 + nn, k = k0 + kk;
      bs[kk][nn] = (n < g.N && k < g.K) ? operand<BF16>(g.b[k * g.bk + n * g.bn]) : 0.0f;
    }
    __syncthreads();
    const int kmax = min(kTileK, g.K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.N) g.c[m * g.cm + n * g.cn] = epilogue(e, acc[i][j], m, n);
    }
  }
}

// out[n] = sum_m x[m * ld + n] in sample order (a bias gradient).
__global__ void colsum_kernel(const float* __restrict__ x, int M, int N, int ld, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = x[n];
  for (int m = 1; m < M; ++m) acc = acc + x[static_cast<int64_t>(m) * ld + n];
  out[n] = acc;
}

struct AdamArgs {
  int t;
  float lr, b1, one_minus_b1, log_b1, b2, one_minus_b2, log_b2, eps;
};

// Bare Adam (no clipping) in place, bias correction 1 - exp(t log b)
// (pallas_ddpg_sweep.py:178-190).
__global__ void adam_kernel(float* __restrict__ p, float* __restrict__ mu, float* __restrict__ nu,
                            const float* __restrict__ grad, int n, AdamArgs h) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tf = static_cast<float>(h.t);
  const float bc1 = 1.0f - expf(tf * h.log_b1);
  const float bc2 = 1.0f - expf(tf * h.log_b2);
  const float g = grad[i];
  const float m = h.b1 * mu[i] + h.one_minus_b1 * g;
  const float v = h.b2 * nu[i] + h.one_minus_b2 * g * g;
  mu[i] = m;
  nu[i] = v;
  const float upd = (m / bc1) / (sqrtf(v / bc2) + h.eps);
  p[i] = p[i] - h.lr * upd;
}

// target = (1 - tau) * target + tau * online, in place.
__global__ void polyak_kernel(float* __restrict__ target, const float* __restrict__ online, int n,
                              float one_minus_tau, float tau) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  target[i] = one_minus_tau * target[i] + tau * online[i];
}

// metrics row g: critic loss sum(cerr^2) / M, actor loss -sum(Q(s, mu(s))) / M.
__global__ void metrics_kernel(const float* __restrict__ cerr, const float* __restrict__ q_pi, int M, float inv_m,
                               float* __restrict__ row) {
  if (threadIdx.x != 0) return;
  float c = cerr[0] * cerr[0], q = q_pi[0];
  for (int m = 1; m < M; ++m) {
    c = c + cerr[m] * cerr[m];
    q = q + q_pi[m];
  }
  row[0] = c * inv_m;
  row[1] = -q * inv_m;
}

// The operands of one gradient step; every pointer is device memory.
struct StepArgs {
  // state, updated in place: online and target networks, Adam moments, gradient scratch
  float *actor, *critic, *t_actor, *t_critic, *a_mu, *a_nu, *c_mu, *c_nu, *a_grad, *c_grad;
  // the step's minibatch: xa = [obs | act] (M, F + A); xa_next = [next_obs | .] and
  // xa_pi = [obs | .], whose action columns the step writes; rew, done, neg_inv (M)
  const float *xa, *rew, *done, *neg_inv;
  float *xa_next, *xa_pi;
  const float *low, *high;  // (A)
  // activations (M, H1) x3, (M, H2) x3, gradients (M, H1), (M, H2), per-sample vectors
  float *a1, *q1, *p1, *a2, *q2, *p2, *g1, *g2, *y, *gq, *cerr, *q_pi, *tanh_u, *g_u;
  float* metrics_row;  // (2)
  // ngk_ddpg_step's ptrs array lists the pointers above in this order
  int M, t_actor_step, t_critic_step;
  bool bf16;  // the matmul_dtype option
  float gamma, two_inv_m, inv_m, tau, one_minus_tau;
  AdamArgs adam;
};

inline dim3 tiles(int M, int N) { return dim3((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM); }

// The stream of a step's launches and its operand type.
struct Ctx {
  cudaStream_t s;
  bool bf16;
};

inline void gemm(const Ctx& x, const float* a, int64_t am, int64_t ak, const float* b, int64_t bk, int64_t bn,
                 float* c, int64_t cm, int M, int N, int K, Epi e) {
  const Gemm g{a, am, ak, b, bk, bn, c, cm, 1, M, N, K};
  if (x.bf16) {
    gemm_kernel<true><<<tiles(M, N), kGemmThreads, 0, x.s>>>(g, e);
  } else {
    gemm_kernel<false><<<tiles(M, N), kGemmThreads, 0, x.s>>>(g, e);
  }
}

inline Epi epi(int kind, const float* bias = nullptr) {
  Epi e{};
  e.kind = kind;
  e.bias = bias;
  return e;
}

inline Epi mask(const float* aux, int64_t xm) {
  Epi e = epi(kMask);
  e.aux = aux;
  e.xm = xm;
  return e;
}

inline void colsum(const Ctx& x, const float* v, int M, int N, float* out) {
  colsum_kernel<<<(N + kVecThreads - 1) / kVecThreads, kVecThreads, 0, x.s>>>(v, M, N, N, out);
}

// Forward of the two hidden layers of `net` on x (M, in) with row stride ldx.
template <class L>
void hidden_fwd(const Ctx& s, const float* net, const float* x, int64_t ldx, int in, int M, int H1, int H2,
                float* h1, float* h2) {
  gemm(s, x, ldx, 1, net + L::W1, 1, in, h1, H1, M, H1, in, epi(kBiasRelu, net + L::B1));
  gemm(s, h1, H1, 1, net + L::W2, 1, H1, h2, H2, M, H2, H1, epi(kBiasRelu, net + L::B2));
}

// Weight and bias gradients of one layer: grad W (out, in) = G^T X, grad b = colsum G.
inline void layer_grads(const Ctx& s, const float* g, int out, const float* x, int64_t ldx, int in, int M,
                        float* gw, float* gb) {
  gemm(s, g, 1, out, x, ldx, 1, gw, in, out, in, M, epi(kNone));
  colsum(s, g, M, out, gb);
}

// One gradient step (pallas_ddpg_sweep.py:138-232, in its order).
template <int F, int A, int H1, int H2>
void ddpg_step(const StepArgs& p, cudaStream_t stream) {
  using Ac = Mlp<F, A, H1, H2>;
  using Cr = Mlp<F + A, 1, H1, H2>;
  constexpr int FC = F + A;
  const int M = p.M;
  const Ctx s{stream, p.bf16};

  // ---- target bootstrap: y = r + gamma (1 - d) Q'(s', mu'(s')) ----
  hidden_fwd<Ac>(s, p.t_actor, p.xa_next, FC, F, M, H1, H2, p.a1, p.a2);
  Epi sq = epi(kSquash, p.t_actor + Ac::B3);
  sq.v0 = p.low;
  sq.v1 = p.high;
  gemm(s, p.a2, H2, 1, p.t_actor + Ac::W3, 1, H2, p.xa_next + F, FC, M, A, H2, sq);
  hidden_fwd<Cr>(s, p.t_critic, p.xa_next, FC, FC, M, H1, H2, p.p1, p.p2);
  Epi tg = epi(kTarget, p.t_critic + Cr::B3);
  tg.v0 = p.rew;
  tg.v1 = p.done;
  tg.s0 = p.gamma;
  gemm(s, p.p2, H2, 1, p.t_critic + Cr::W3, 1, H2, p.y, 1, M, 1, H2, tg);

  // ---- critic step: MSE against y, backward, Adam ----
  hidden_fwd<Cr>(s, p.critic, p.xa, FC, FC, M, H1, H2, p.q1, p.q2);
  Epi ce = epi(kCritic, p.critic + Cr::B3);
  ce.v0 = p.y;
  ce.aux_out = p.cerr;
  ce.om = 1;
  ce.s0 = p.two_inv_m;
  gemm(s, p.q2, H2, 1, p.critic + Cr::W3, 1, H2, p.gq, 1, M, 1, H2, ce);
  layer_grads(s, p.gq, 1, p.q2, H2, H2, M, p.c_grad + Cr::W3, p.c_grad + Cr::B3);
  gemm(s, p.gq, 1, 0, p.critic + Cr::W3, 0, 1, p.g2, H2, M, H2, 1, mask(p.q2, H2));
  layer_grads(s, p.g2, H2, p.q1, H1, H1, M, p.c_grad + Cr::W2, p.c_grad + Cr::B2);
  gemm(s, p.g2, H2, 1, p.critic + Cr::W2, H1, 1, p.g1, H1, M, H1, H2, mask(p.q1, H1));
  layer_grads(s, p.g1, H1, p.xa, FC, FC, M, p.c_grad + Cr::W1, p.c_grad + Cr::B1);
  AdamArgs ha = p.adam;
  ha.t = p.t_critic_step;
  adam_kernel<<<(Cr::P + kVecThreads - 1) / kVecThreads, kVecThreads, 0, stream>>>(p.critic, p.c_mu, p.c_nu,
                                                                                     p.c_grad, Cr::P, ha);

  // ---- actor step through the updated critic ----
  hidden_fwd<Ac>(s, p.actor, p.xa_pi, FC, F, M, H1, H2, p.a1, p.a2);
  Epi sa = epi(kSquash, p.actor + Ac::B3);
  sa.v0 = p.low;
  sa.v1 = p.high;
  sa.aux_out = p.tanh_u;
  sa.om = A;
  gemm(s, p.a2, H2, 1, p.actor + Ac::W3, 1, H2, p.xa_pi + F, FC, M, A, H2, sa);
  hidden_fwd<Cr>(s, p.critic, p.xa_pi, FC, FC, M, H1, H2, p.p1, p.p2);
  gemm(s, p.p2, H2, 1, p.critic + Cr::W3, 1, H2, p.q_pi, 1, M, 1, H2, epi(kBias, p.critic + Cr::B3));
  // dQ/d(action): the loss -mean(Q) has dL/dQ = -1/M; only the action columns of W1
  gemm(s, p.neg_inv, 1, 0, p.critic + Cr::W3, 0, 1, p.g2, H2, M, H2, 1, mask(p.p2, H2));
  gemm(s, p.g2, H2, 1, p.critic + Cr::W2, H1, 1, p.g1, H1, M, H1, H2, mask(p.p1, H1));
  Epi tgd = epi(kTanhGrad);
  tgd.aux = p.tanh_u;
  tgd.xm = A;
  tgd.v0 = p.low;
  tgd.v1 = p.high;
  gemm(s, p.g1, H1, 1, p.critic + Cr::W1 + F, FC, 1, p.g_u, A, M, A, H1, tgd);
  layer_grads(s, p.g_u, A, p.a2, H2, H2, M, p.a_grad + Ac::W3, p.a_grad + Ac::B3);
  gemm(s, p.g_u, A, 1, p.actor + Ac::W3, H2, 1, p.g2, H2, M, H2, A, mask(p.a2, H2));
  layer_grads(s, p.g2, H2, p.a1, H1, H1, M, p.a_grad + Ac::W2, p.a_grad + Ac::B2);
  gemm(s, p.g2, H2, 1, p.actor + Ac::W2, H1, 1, p.g1, H1, M, H1, H2, mask(p.a1, H1));
  layer_grads(s, p.g1, H1, p.xa_pi, FC, F, M, p.a_grad + Ac::W1, p.a_grad + Ac::B1);
  ha.t = p.t_actor_step;
  adam_kernel<<<(Ac::P + kVecThreads - 1) / kVecThreads, kVecThreads, 0, stream>>>(p.actor, p.a_mu, p.a_nu,
                                                                                     p.a_grad, Ac::P, ha);

  // ---- polyak on both targets, then the step's metrics ----
  polyak_kernel<<<(Ac::P + kVecThreads - 1) / kVecThreads, kVecThreads, 0, stream>>>(
      p.t_actor, p.actor, Ac::P, p.one_minus_tau, p.tau);
  polyak_kernel<<<(Cr::P + kVecThreads - 1) / kVecThreads, kVecThreads, 0, stream>>>(
      p.t_critic, p.critic, Cr::P, p.one_minus_tau, p.tau);
  metrics_kernel<<<1, 32, 0, stream>>>(p.cerr, p.q_pi, M, p.inv_m, p.metrics_row);
}

}  // namespace ngd
