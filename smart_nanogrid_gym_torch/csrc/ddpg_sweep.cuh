// The DDPG update sweep (K10): G gradient steps of SB3's DDPG on pre-gathered
// replay minibatches, each a target bootstrap, a critic MSE step with bare
// Adam, an actor step through the updated critic and polyak averaging of both
// targets.
//
// Replaces the Pallas TPU kernel smart_nanogrid_gym_tpu/ops/pallas_ddpg_sweep.py
// (ddpg_sweep_pallas, contract at :24-32 and :138-232).  The TPU kernel kept
// the four networks and both Adam states resident in VMEM across its
// sequential grid of G steps.  Here that state (about 8 x 133k floats, 4.3 MB)
// lives in device memory and L2, and the whole update is ONE persistent
// cooperative launch (ddpg_sweep_kernel): every block of the grid (one per
// SM) loops over the G steps, and each step is a fixed list of phases
// separated by grid-wide barriers (cooperative_groups::this_grid().sync()).
//
// A phase holds the products that do not depend on each other, grouped by
// dependency depth rather than by call: the target actor's, the critic's and
// the actor's first layers share a phase, and so do each layer's weight
// gradient, bias gradient and input gradient.  Each chain has its own
// activation buffers.  Adam (with polyak of the matching target fused in, the
// same element by the same thread) is a phase of its own; the two loss
// metrics are products too (a sum of squares, a sum).
//
// Every product C[i][j] = epilogue(sum_k A[i][k] B[k][j]) reads strided
// operands (the forward x W^T, the weight gradient G^T X and the input
// gradient G W read the same buffers without copies) and runs a fused
// epilogue (bias + ReLU, ReLU-mask, squash, bootstrap target and TD error,
// tanh derivative, scale); a bias gradient is the product of a row of ones
// with the layer's output gradient.  A phase splits all its products into
// 32 x 32 output tiles (the 300 x 400 weight gradient gives 130 tiles, a
// 256 x 400 forward 104).  A block holds two tile workers of 256 threads (8
// warps), and worker w of block b takes tiles b + w gridDim.x, b + (w + 2)
// gridDim.x, ...: a phase's first tiles go one to an SM, the next ones to the
// SMs' second workers.  The sum over k is a serial chain per output, so a
// tile's time is its k-length, and the phases whose few tiles have long k
// (the heads, the TD error, the input gradient into the action, the narrow
// weight gradients) run at the speed of one tile.  A worker stages its tile's
// k-chunks of 32 through registers (ld.global.cg, since other SMs wrote the
// operands in the phase before) into two shared buffers: the next chunk
// loads while this one multiplies, one worker barrier a chunk.
//
// f32 (the default): each thread owns a 2 x 2 register tile (two loads feed
// four multiply-adds) and walks k in order, so each output's sum runs over
// its reduction index in index order, starting from the first product: no
// split-K, no atomics, reruns are bit-identical, and the plain twin
// (ops/ddpg_sweep.py) writes the same order out.  Multiply-adds are written
// out (the build uses --fmad=false).
//
// bf16 (DDPGSweepHypers.matmul_dtype, pallas_ddpg_sweep.py:105-135, 153-154):
// the network products run on the tensor cores, mma.sync.m16n8k16 with bf16
// operands (each A and B element rounded to the nearest bf16 as the
// fragments are built) and f32 accumulation; each warp of a worker owns one
// 16 x 8 block of the tile.  The bias column sums, the metrics, the masks, the
// squash, the TD error, Adam and polyak stay f32.  The tensor core's
// accumulation order is not the twin's, so this path states a tolerance
// against the twin (tests/test_torch_cuda.py); the f32 default never takes
// the tensor cores.
//
// Bound: the products, about 2.6e6 flops per sample and step (G x M samples
// per update); at M = 256 the phases are short, so the grid barriers (19 per
// step) and the long-k tiles of the narrow products set the time.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "operand.cuh"

namespace ngd {

namespace cg = cooperative_groups;

constexpr int kWorker = 256;                          // threads of a tile worker (8 warps), one tile at a time
constexpr int kWorkers = 2;                           // tile workers of a block
constexpr int kThreads = kWorker * kWorkers;          // threads of a block, one block per SM
constexpr int kTile = 32;                             // output tile kTile x kTile
constexpr int kChunk = 32;                            // k-chunk staged at a time (two mma k-steps)
constexpr int kRow = kTile + 4;                       // staged row, padded (16-byte aligned)
constexpr int kPerThread = kTile * kChunk / kWorker;  // elements of each operand a thread stages
constexpr int kMaxJobs = 4;                           // products in one phase

// Flat layout of one 2-hidden-layer network: W1 (H1, In) b1 W2 (H2, H1) b2 W3 (Out, H2) b3.
template <int IN, int OUT, int H1, int H2>
struct Mlp {
  static constexpr int W1 = 0, B1 = W1 + H1 * IN, W2 = B1 + H1, B2 = W2 + H2 * H1, W3 = B2 + H2,
                       B3 = W3 + OUT * H2;
  static constexpr int P = B3 + OUT;
};

enum Epilogue : int {
  kNone = 0,       // c = acc
  kBiasRelu = 1,   // c = relu(acc + bias[n])
  kMask = 2,       // c = acc * (aux[m][n] > 0)          (ReLU backward from the post-activation)
  kSquash = 3,     // c = lo + (tanh(u) + 1) * half_span,  u = acc + bias[n]; aux_out = tanh(u)
  kBias = 4,       // c = acc + bias[n]
  kTargetErr = 5,  // y = v0[m] + (s0 (1 - v1[m])) (acc + bias[n]); cerr = v2[m] - y; aux_out = cerr; c = s1 cerr
  kTanhGrad = 6,   // c = (acc * half_span[n]) * (1 - aux[m][n]^2)
  kScale = 7,      // c = acc * s0
};

struct Epi {
  int kind;
  const float* bias;  // (N)
  const float* aux;   // kMask, kTanhGrad: (M, N) at aux[m * xm + n]
  int xm;
  float* aux_out;     // kSquash, kTargetErr: at aux_out[m * om + n]
  int om;
  const float* v0;    // kTargetErr: rewards (M); kSquash, kTanhGrad: low (N)
  const float* v1;    // kTargetErr: dones (M); kSquash, kTanhGrad: high (N)
  const float* v2;    // kTargetErr: the critic's Q(s, a) (M)
  float s0, s1;       // kTargetErr: gamma, 2 / M; kScale: the factor
};

// One product: C[i][j] = epilogue(sum_k A[i][k] B[k][j]), A[i][k] = a[i am + k ak],
// B[k][j] = b[k bk + j bn], C[i][j] = c[i cm + j cn]; tc: on the bf16 tensor cores.
struct Job {
  const float* a;
  int am, ak;
  const float* b;
  int bk, bn;
  float* c;
  int cm, cn;
  int M, N, K;
  int tc;
  Epi e;
};

struct Phase {
  Job job[kMaxJobs];
  int start[kMaxJobs + 1];  // first tile of each job; start[n] = the phase's tiles
  int n;
};

struct AdamArgs {
  float lr, b1, one_minus_b1, log_b1, b2, one_minus_b2, log_b2, eps;
};

// The operands of one update; every pointer is device memory.
struct Sweep {
  // state, updated in place: online and target networks, Adam moments, gradient scratch
  float *actor, *critic, *t_actor, *t_critic, *a_mu, *a_nu, *c_mu, *c_nu, *a_grad, *c_grad;
  // the minibatches: xa = [obs | act] (G, M, F + A), rew and done (G, M); xa_next =
  // [next_obs | .] and xa_pi = [obs | .] (G, M, F + A), whose action columns the sweep writes
  const float *xa, *rew, *done;
  float *xa_next, *xa_pi;
  const float *neg_inv, *low, *high;  // (M) of -1/M, the action box (A) x2
  float* scratch;                     // activations, ngk_ddpg_scratch_floats(M) floats
  float* metrics;                     // (G, 2)
  int G, M, t_actor0, t_critic0, bf16;  // the Adam steps of step g are t0 + g + 1
  float gamma, two_inv_m, inv_m, tau, one_minus_tau;
  AdamArgs adam;
};

// The activations of one step, carved from Sweep::scratch; a chain has its own buffers.
template <int A, int H1, int H2>
struct Acts {
  float *t1, *q1, *a1, *u1, *p1, *cg1, *h1g, *ag1;  // (M, H1): target actor, critic, actor, target
                                                    // critic, critic on mu(s); the three backward chains
  float *t2, *q2, *a2, *u2, *p2, *cg2, *h2g, *ag2;  // (M, H2), the same
  float *qv, *cerr, *gq, *q_pi;                     // (M)
  float *tanh_u, *g_u;                              // (M, A)

  static constexpr int64_t floats(int M) { return (8LL * H1 + 8LL * H2 + 4 + 2LL * A) * M; }

  __device__ explicit Acts(float* s, int M) {
    float** h1[] = {&t1, &q1, &a1, &u1, &p1, &cg1, &h1g, &ag1};
    float** h2[] = {&t2, &q2, &a2, &u2, &p2, &cg2, &h2g, &ag2};
    for (float** p : h1) { *p = s; s += static_cast<int64_t>(M) * H1; }
    for (float** p : h2) { *p = s; s += static_cast<int64_t>(M) * H2; }
    float** v[] = {&qv, &cerr, &gq, &q_pi};
    for (float** p : v) { *p = s; s += M; }
    tanh_u = s;
    g_u = s + static_cast<int64_t>(M) * A;
  }
};

__device__ float kOne = 1.0f;  // the ones row of a bias gradient (stride 0)

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
    case kBias:
      return acc + e.bias[n];
    case kTargetErr: {
      const float y = e.v0[m] + (e.s0 * (1.0f - e.v1[m])) * (acc + e.bias[n]);
      const float cerr = e.v2[m] - y;
      e.aux_out[m * e.om + n] = cerr;
      return e.s1 * cerr;
    }
    case kTanhGrad: {
      const float lo = e.v0[n], hi = e.v1[n];
      const float th = e.aux[m * e.xm + n];
      return (acc * (0.5f * (hi - lo))) * (1.0f - th * th);
    }
    case kScale:
      return acc * e.s0;
    default:
      return acc;
  }
}

// ---------------------------------------------------------------- a tile ---

struct alignas(16) Stage {
  float a[kChunk][kRow];  // a[k][i]
  float b[kChunk][kRow];  // b[k][j]
};

// barrier of one tile worker's threads (named barriers 1..kWorkers; 0 is __syncthreads)
__device__ __forceinline__ void worker_sync(int worker) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(worker + 1), "n"(kWorker) : "memory");
}

// One operand of a tile, x[i][k] = p[i si + k sk] for the tile's kTile values
// of i (from i0, below n) and k below K, as thread `lane` of the worker stages
// it: kPerThread elements, the operand's unit-stride index running fastest
// across threads.  Element e goes to stage row kk[e], column col[e], from
// src[e] plus the chunk's offset; ok[e]: its i lies inside the product.  A
// chunk is loaded into registers (ld.global.cg: the operands were written by
// other SMs in the phase before) while the one before multiplies, then stored.
struct Loader {
  const float* src[kPerThread];
  int kk[kPerThread], col[kPerThread];
  bool ok[kPerThread];
  float reg[kPerThread];
  int64_t kstep;  // elements between chunks
  int K;

  __device__ __forceinline__ Loader(const float* p, int si, int sk, int i0, int n, int K_, int lane)
      : kstep(static_cast<int64_t>(kChunk) * sk), K(K_) {
    const bool k_fast = sk == 1;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int idx = lane + e * kWorker;
      kk[e] = k_fast ? idx % kChunk : idx / kTile;
      col[e] = k_fast ? idx / kChunk : idx % kTile;
      ok[e] = i0 + col[e] < n;
      src[e] = p + static_cast<int64_t>(ok[e] ? i0 + col[e] : 0) * si + static_cast<int64_t>(kk[e]) * sk;
    }
  }

  // chunk c into the registers; elements outside the product are zero
  __device__ __forceinline__ void load(int c) {
    const int64_t off = c * kstep;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) reg[e] = ok[e] && c * kChunk + kk[e] < K ? __ldcg(src[e] + off) : 0.0f;
  }

  __device__ __forceinline__ void store(float (&dst)[kChunk][kRow]) const {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) dst[kk[e]][col[e]] = reg[e];
  }
};

// f32: thread (ty, tx) owns rows 2 ty, 2 ty + 1 and columns 2 tx, 2 tx + 1 of the
// tile (acc[2 i + j]); k in order.
__device__ __forceinline__ void mac_f32(const Stage& s, int kmax, int ty, int tx, float (&acc)[4]) {
  auto step = [&](int kk) {
    const float2 a = *reinterpret_cast<const float2*>(&s.a[kk][2 * ty]);
    const float2 b = *reinterpret_cast<const float2*>(&s.b[kk][2 * tx]);
    acc[0] = acc[0] + a.x * b.x;
    acc[1] = acc[1] + a.x * b.y;
    acc[2] = acc[2] + a.y * b.x;
    acc[3] = acc[3] + a.y * b.y;
  };
  if (kmax == kChunk) {
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) step(kk);
  } else {
    for (int kk = 0; kk < kmax; ++kk) step(kk);
  }
}

// bf16 tensor cores: warp w owns rows 16 (w / 4).. + 15 and columns 8 (w % 4).. + 7 of
// the tile, acc its m16n8 fragment (rows g, g + 8; columns 2 t, 2 t + 1); ksteps k-steps
// of 16.
__device__ __forceinline__ void mac_bf16(const Stage& s, int ksteps, int warp, int lane, float (&acc)[4]) {
  const int g = lane >> 2, t = lane & 3;
  const int r = (warp >> 2) * 16 + g, n = (warp & 3) * 8 + g;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 16 + 2 * t;
    const uint32_t a0 = ngo::pack_bf16(s.a[k][r], s.a[k + 1][r]);
    const uint32_t a1 = ngo::pack_bf16(s.a[k][r + 8], s.a[k + 1][r + 8]);
    const uint32_t a2 = ngo::pack_bf16(s.a[k + 8][r], s.a[k + 9][r]);
    const uint32_t a3 = ngo::pack_bf16(s.a[k + 8][r + 8], s.a[k + 9][r + 8]);
    const uint32_t b0 = ngo::pack_bf16(s.b[k][n], s.b[k + 1][n]);
    const uint32_t b1 = ngo::pack_bf16(s.b[k + 8][n], s.b[k + 9][n]);
    ngo::mma_bf16(acc, a0, a1, a2, a3, b0, b1);
  }
}

// Tile `tile` of a job, by tile worker `worker` (its threads lane = 0..kWorker-1).
__device__ void run_tile(const Job& job, int tile, Stage (&st)[2], int worker, int lane) {
  const int tiles_n = (job.N + kTile - 1) / kTile;
  const int m0 = (tile / tiles_n) * kTile, n0 = (tile % tiles_n) * kTile;
  const int chunks = (job.K + kChunk - 1) / kChunk;
  const bool tc = job.tc != 0;
  const int warp = lane / 32, lane32 = lane % 32;
  Loader la(job.a, job.am, job.ak, m0, job.M, job.K, lane);
  Loader lb(job.b, job.bn, job.bk, n0, job.N, job.K, lane);
  float acc[4];
  // f32: -0 + p == p for every p, so each sum starts at its first product
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = tc ? 0.0f : -0.0f;

  la.load(0);
  lb.load(0);
  la.store(st[0].a);
  lb.store(st[0].b);
  worker_sync(worker);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {  // in flight while chunk c multiplies
      la.load(c + 1);
      lb.load(c + 1);
    }
    const Stage& s = st[c & 1];
    const int kmax = min(kChunk, job.K - c * kChunk);
    if (tc) {
      mac_bf16(s, (kmax + 15) / 16, warp, lane32, acc);
    } else {
      mac_f32(s, kmax, lane / 16, lane % 16, acc);
    }
    if (c + 1 < chunks) {
      la.store(st[(c + 1) & 1].a);
      lb.store(st[(c + 1) & 1].b);
    }
    worker_sync(worker);  // chunk c + 1 is staged, and chunk c's buffer free
  }

  const Epi& e = job.e;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // f32: (2 ty + q / 2, 2 tx + q % 2); bf16: element q of the warp's fragment (mac_bf16)
    const int m = m0 + (tc ? (warp >> 2) * 16 + lane32 / 4 + (q >= 2 ? 8 : 0) : 2 * (lane / 16) + q / 2);
    const int n = n0 + (tc ? (warp & 3) * 8 + 2 * (lane32 % 4) + (q & 1) : 2 * (lane % 16) + q % 2);
    if (m < job.M && n < job.N) {
      job.c[static_cast<int64_t>(m) * job.cm + static_cast<int64_t>(n) * job.cn] = epilogue(e, acc[q], m, n);
    }
  }
}

// ---------------------------------------------------------- the phases ---

__device__ __forceinline__ int tiles_of(int M, int N) {
  return ((M + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
}

__device__ __forceinline__ void add(Phase& ph, const float* a, int am, int ak, const float* b, int bk, int bn,
                                    float* c, int cm, int cn, int M, int N, int K, bool tc, const Epi& e) {
  ph.job[ph.n] = Job{a, am, ak, b, bk, bn, c, cm, cn, M, N, K, tc ? 1 : 0, e};
  ph.start[ph.n + 1] = ph.start[ph.n] + tiles_of(M, N);
  ++ph.n;
}

__device__ __forceinline__ Epi epi(int kind, const float* bias = nullptr) {
  Epi e{};
  e.kind = kind;
  e.bias = bias;
  return e;
}

__device__ __forceinline__ Epi mask(const float* aux, int xm) {
  Epi e = epi(kMask);
  e.aux = aux;
  e.xm = xm;
  return e;
}

__device__ __forceinline__ Epi squash(const float* bias, const Sweep& s, float* tanh_out, int om) {
  Epi e = epi(kSquash, bias);
  e.v0 = s.low;
  e.v1 = s.high;
  e.aux_out = tanh_out;
  e.om = om;
  return e;
}

__device__ __forceinline__ Epi scale(float s0) {
  Epi e = epi(kScale);
  e.s0 = s0;
  return e;
}

// y = x W^T + b of one layer: x (M, in) with row stride ldx, W (out, in).
__device__ __forceinline__ void linear(Phase& ph, const float* x, int ldx, const float* w, float* y, int ldy,
                                       int M, int out, int in, bool tc, const Epi& e) {
  add(ph, x, ldx, 1, w, 1, in, y, ldy, 1, M, out, in, tc, e);
}

// A layer's weight gradient G^T X (out, in) and bias gradient (the ones row times G),
// from its output gradient g (M, out) and input x (M, in) with row stride ldx.
__device__ __forceinline__ void layer_grads(Phase& ph, const float* g, int out, const float* x, int ldx, int in,
                                            int M, float* gw, float* gb, bool tc) {
  add(ph, g, 1, out, x, ldx, 1, gw, in, 1, out, in, M, tc, epi(kNone));
  add(ph, &kOne, 0, 0, g, out, 1, gb, 0, 1, 1, out, M, false, epi(kNone));
}

enum PhaseId : int {
  kFwd1 = 0,      // first layers: target actor on s', critic on (s, a), actor on s
  kFwd2,          // second layers of the same three chains
  kHeads,         // mu'(s') into xa_next, Q(s, a), mu(s) into xa_pi (and tanh u)
  kTarget1,       // target critic on (s', mu'(s'))
  kTarget2,
  kTargetQ,       // y, the TD error and its gradient
  kCriticBack3,   // critic W3/b3 gradients, the gradient into layer 2
  kCriticBack2,
  kCriticBack1,   // + the critic-loss metric
  kCriticAdam,    // critic Adam + polyak of the target critic
  kPi1,           // the updated critic on (s, mu(s))
  kPi2,
  kPi3,           // Q(s, mu(s)); dQ into its layer 2
  kPi4,           // dQ into layer 1; the actor-loss metric
  kPiAction,      // dQ/da through the action columns, times the squash derivative
  kActorBack3,
  kActorBack2,
  kActorBack1,
  kActorAdam,     // actor Adam + polyak of the target actor
  kPhases,
};

template <int F, int A, int H1, int H2>
__device__ void build_phase(Phase& ph, int id, const Sweep& s, int g) {
  using Ac = Mlp<F, A, H1, H2>;
  using Cr = Mlp<F + A, 1, H1, H2>;
  constexpr int FC = F + A;
  const int M = s.M;
  const bool tc = s.bf16 != 0;
  const int64_t step = static_cast<int64_t>(g) * M;
  const float* xa = s.xa + step * FC;
  float* xn = s.xa_next + step * FC;
  float* xpi = s.xa_pi + step * FC;
  const Acts<A, H1, H2> x(s.scratch, M);
  ph.n = 0;
  ph.start[0] = 0;
  switch (id) {
    case kFwd1:
      linear(ph, xn, FC, s.t_actor + Ac::W1, x.t1, H1, M, H1, F, tc, epi(kBiasRelu, s.t_actor + Ac::B1));
      linear(ph, xa, FC, s.critic + Cr::W1, x.q1, H1, M, H1, FC, tc, epi(kBiasRelu, s.critic + Cr::B1));
      linear(ph, xpi, FC, s.actor + Ac::W1, x.a1, H1, M, H1, F, tc, epi(kBiasRelu, s.actor + Ac::B1));
      break;
    case kFwd2:
      linear(ph, x.t1, H1, s.t_actor + Ac::W2, x.t2, H2, M, H2, H1, tc, epi(kBiasRelu, s.t_actor + Ac::B2));
      linear(ph, x.q1, H1, s.critic + Cr::W2, x.q2, H2, M, H2, H1, tc, epi(kBiasRelu, s.critic + Cr::B2));
      linear(ph, x.a1, H1, s.actor + Ac::W2, x.a2, H2, M, H2, H1, tc, epi(kBiasRelu, s.actor + Ac::B2));
      break;
    case kHeads:
      linear(ph, x.t2, H2, s.t_actor + Ac::W3, xn + F, FC, M, A, H2, tc, squash(s.t_actor + Ac::B3, s, nullptr, 0));
      linear(ph, x.q2, H2, s.critic + Cr::W3, x.qv, 1, M, 1, H2, tc, epi(kBias, s.critic + Cr::B3));
      linear(ph, x.a2, H2, s.actor + Ac::W3, xpi + F, FC, M, A, H2, tc, squash(s.actor + Ac::B3, s, x.tanh_u, A));
      break;
    case kTarget1:
      linear(ph, xn, FC, s.t_critic + Cr::W1, x.u1, H1, M, H1, FC, tc, epi(kBiasRelu, s.t_critic + Cr::B1));
      break;
    case kTarget2:
      linear(ph, x.u1, H1, s.t_critic + Cr::W2, x.u2, H2, M, H2, H1, tc, epi(kBiasRelu, s.t_critic + Cr::B2));
      break;
    case kTargetQ: {
      Epi e = epi(kTargetErr, s.t_critic + Cr::B3);
      e.v0 = s.rew + step;
      e.v1 = s.done + step;
      e.v2 = x.qv;
      e.s0 = s.gamma;
      e.s1 = s.two_inv_m;
      e.aux_out = x.cerr;
      e.om = 1;
      linear(ph, x.u2, H2, s.t_critic + Cr::W3, x.gq, 1, M, 1, H2, tc, e);
      break;
    }
    case kCriticBack3:
      layer_grads(ph, x.gq, 1, x.q2, H2, H2, M, s.c_grad + Cr::W3, s.c_grad + Cr::B3, tc);
      add(ph, x.gq, 1, 0, s.critic + Cr::W3, 0, 1, x.cg2, H2, 1, M, H2, 1, tc, mask(x.q2, H2));
      break;
    case kCriticBack2:
      layer_grads(ph, x.cg2, H2, x.q1, H1, H1, M, s.c_grad + Cr::W2, s.c_grad + Cr::B2, tc);
      add(ph, x.cg2, H2, 1, s.critic + Cr::W2, H1, 1, x.cg1, H1, 1, M, H1, H2, tc, mask(x.q1, H1));
      break;
    case kCriticBack1:
      layer_grads(ph, x.cg1, H1, xa, FC, FC, M, s.c_grad + Cr::W1, s.c_grad + Cr::B1, tc);
      // critic loss sum(cerr^2) / M
      add(ph, x.cerr, 0, 1, x.cerr, 1, 0, s.metrics + 2 * g, 0, 0, 1, 1, M, false, scale(s.inv_m));
      break;
    case kPi1:
      linear(ph, xpi, FC, s.critic + Cr::W1, x.p1, H1, M, H1, FC, tc, epi(kBiasRelu, s.critic + Cr::B1));
      break;
    case kPi2:
      linear(ph, x.p1, H1, s.critic + Cr::W2, x.p2, H2, M, H2, H1, tc, epi(kBiasRelu, s.critic + Cr::B2));
      break;
    case kPi3:
      linear(ph, x.p2, H2, s.critic + Cr::W3, x.q_pi, 1, M, 1, H2, tc, epi(kBias, s.critic + Cr::B3));
      // dQ/d(action): the loss -mean(Q) has dL/dQ = -1/M
      add(ph, s.neg_inv, 1, 0, s.critic + Cr::W3, 0, 1, x.h2g, H2, 1, M, H2, 1, tc, mask(x.p2, H2));
      break;
    case kPi4:
      add(ph, x.h2g, H2, 1, s.critic + Cr::W2, H1, 1, x.h1g, H1, 1, M, H1, H2, tc, mask(x.p1, H1));
      // actor loss -sum(Q(s, mu(s))) / M
      add(ph, &kOne, 0, 0, x.q_pi, 1, 0, s.metrics + 2 * g + 1, 0, 0, 1, 1, M, false, scale(-s.inv_m));
      break;
    case kPiAction: {  // only the action columns of the critic's W1
      Epi e = epi(kTanhGrad);
      e.aux = x.tanh_u;
      e.xm = A;
      e.v0 = s.low;
      e.v1 = s.high;
      add(ph, x.h1g, H1, 1, s.critic + Cr::W1 + F, FC, 1, x.g_u, A, 1, M, A, H1, tc, e);
      break;
    }
    case kActorBack3:
      layer_grads(ph, x.g_u, A, x.a2, H2, H2, M, s.a_grad + Ac::W3, s.a_grad + Ac::B3, tc);
      add(ph, x.g_u, A, 1, s.actor + Ac::W3, H2, 1, x.ag2, H2, 1, M, H2, A, tc, mask(x.a2, H2));
      break;
    case kActorBack2:
      layer_grads(ph, x.ag2, H2, x.a1, H1, H1, M, s.a_grad + Ac::W2, s.a_grad + Ac::B2, tc);
      add(ph, x.ag2, H2, 1, s.actor + Ac::W2, H1, 1, x.ag1, H1, 1, M, H1, H2, tc, mask(x.a1, H1));
      break;
    case kActorBack1:
      layer_grads(ph, x.ag1, H1, xpi, FC, F, M, s.a_grad + Ac::W1, s.a_grad + Ac::B1, tc);
      break;
    default:
      break;
  }
}

// Bare Adam (no clipping) with bias correction 1 - exp(t log b) (pallas_ddpg_sweep.py:178-190),
// then polyak target = (1 - tau) target + tau p of the same element, over the whole grid.
__device__ void adam_polyak(float* p, float* mu, float* nu, const float* grad, float* target, int n, int t,
                            const AdamArgs& h, float one_minus_tau, float tau) {
  const float tf = static_cast<float>(t);
  const float bc1 = 1.0f - expf(tf * h.log_b1);
  const float bc2 = 1.0f - expf(tf * h.log_b2);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float g = grad[i];
    const float m = h.b1 * mu[i] + h.one_minus_b1 * g;
    const float v = h.b2 * nu[i] + h.one_minus_b2 * g * g;
    mu[i] = m;
    nu[i] = v;
    const float upd = (m / bc1) / (sqrtf(v / bc2) + h.eps);
    const float pn = p[i] - h.lr * upd;
    p[i] = pn;
    target[i] = one_minus_tau * target[i] + tau * pn;
  }
}

// The whole update: G steps of kPhases phases, a grid barrier after each.
template <int F, int A, int H1, int H2>
__global__ void __launch_bounds__(kThreads, 1) ddpg_sweep_kernel(Sweep s) {
  using Ac = Mlp<F, A, H1, H2>;
  using Cr = Mlp<F + A, 1, H1, H2>;
  __shared__ Stage st[kWorkers][2];
  __shared__ Phase ph;
  cg::grid_group grid = cg::this_grid();
  // worker w of block b is tile worker b + w gridDim.x: a phase's first tiles go one to an SM
  const int worker = threadIdx.x / kWorker, lane = threadIdx.x % kWorker;
  const int wid = blockIdx.x + worker * gridDim.x, workers = kWorkers * gridDim.x;
  for (int g = 0; g < s.G; ++g) {
    for (int id = 0; id < kPhases; ++id) {
      if (id == kCriticAdam) {
        adam_polyak(s.critic, s.c_mu, s.c_nu, s.c_grad, s.t_critic, Cr::P, s.t_critic0 + g + 1, s.adam,
                    s.one_minus_tau, s.tau);
      } else if (id == kActorAdam) {
        adam_polyak(s.actor, s.a_mu, s.a_nu, s.a_grad, s.t_actor, Ac::P, s.t_actor0 + g + 1, s.adam,
                    s.one_minus_tau, s.tau);
      } else {
        if (threadIdx.x == 0) build_phase<F, A, H1, H2>(ph, id, s, g);
        __syncthreads();
        int q = 0;
        for (int t = wid; t < ph.start[ph.n]; t += workers) {
          while (t >= ph.start[q + 1]) ++q;
          run_tile(ph.job[q], t - ph.start[q], st[worker], worker, lane);
        }
      }
      grid.sync();
    }
  }
}

}  // namespace ngd
