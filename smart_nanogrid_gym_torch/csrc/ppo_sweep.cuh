// The PPO update sweep (K3, K4): per gradient step, the gradient of the
// clipped-surrogate + value + entropy loss of the SB3 actor-critic over one
// minibatch, global-norm clip and Adam.
//
// Replaces the Pallas TPU kernels of smart_nanogrid_gym_tpu/ops/pallas_ppo_sweep.py:
//   K3 ppo_sweep_pallas_streamed (featlane and sample layouts) and
//   K4 ppo_sweep_pallas (pre-gathered minibatches).
// The TPU kernel ran the G steps as a sequential grid with the gradient in
// VMEM scratch.  Here the whole update is ONE persistent cooperative launch
// (ppo_sweep_kernel, one block per SM, all G steps); each step g has three
// phases separated by grid-wide barriers:
//   (a) partial gradients: the minibatch's M samples are cut into nb ranges
//       (ops/ppo_sweep.py::grad_blocks, at most kMaxRanges) and a block takes
//       range r (looping when the grid holds fewer blocks): the forward of both
//       torsos, the loss, the hand-written backward of pallas_ppo_sweep.py:229-295
//       over tiles of kTile samples, accumulated in shared memory, and the three
//       metric sums; partials[r] = the range's gradient;
//   (b) reduction: slice l of kSlices holds ceil(P / kSlices) parameters; a
//       block sums each of its elements over the partials in range order (no
//       float atomics, so reruns are bit-identical), adds the entropy term, and
//       sums the slice's squares in element order;
//   (c) Adam: every block adds the slices' squares in slice order (the global
//       norm), clips (trigger norm < max_norm) and applies Adam with
//       t = count + g + 1 and bias correction 1 - exp(t log b) to the flat
//       params, mu and nu in place; the next step reloads the params.
// The partition (kTile, kMaxRanges, kSlices) is fixed, not taken from the
// card, because the plain twin writes the same summation order out
// (_kernel_order_sum, _adam_block_norm).
//
// Inside a tile every product is register-tiled: a thread owns 4 features x
// 8 samples of a forward or input-gradient product, or 4 x 8 (8 x 1 for the
// first layer) outputs of a weight gradient, so each shared-memory load
// feeds several multiply-adds.  Each output is summed over its reduction
// index in index order, from the first product.  The parameters sit in
// shared memory with weight rows at odd strides (column reads hit distinct
// banks); activations are feature-major rows of kTile + 4 floats (float4
// loads, and rows 8 apart never share a bank group in the weight gradients,
// whose feature index is strided by 8).  A tile crosses 8 __syncthreads; the
// loss runs one sample per thread on kTile threads.
//
// Bound: the two torsos' forward and backward, about 7.2e4 flops per sample
// (G x M samples per update), in float32 outside the tensor cores.
// Multiply-adds are written out (the build uses --fmad=false).
//
// The bf16 option (SweepHypers.matmul_dtype, pallas_ppo_sweep.py:191-206) is
// the template flag BF16, chosen at launch: both operands of every network
// product are rounded to bf16 and the products accumulate in f32.  The five
// large products of a tile (both hidden layers of both torsos, gW2, g1 =
// W2^T g2 and gW1) run on the tensor cores, mma.sync.m16n8k16, 16 rows a
// warp, F padded with zeros to a multiple of 16 (of 8 as gW1's columns); the
// small ones (the output layers, g2 = W3^T g_out, gW3) stay scalar f32 sums
// of rounded operands (operand.cuh), the weight matrices rounded once as the
// block loads them.  The tile keeps f32 activations, because the tanh
// derivative 1 - y^2, the loss, the bias sums, the clip and Adam read f32
// values.  The tensor core's accumulation order is not the twin's, so the
// bf16 path states a tolerance against its twin (tests/test_torch_cuda.py);
// the f32 default never takes the tensor cores.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "operand.cuh"

namespace ngs {

namespace cg = cooperative_groups;
using ngo::operand;

constexpr int kTile = 64;        // samples per tile (GRAD_TILE in ops/ppo_sweep.py)
constexpr int kMaxRanges = 128;  // partial gradients per step at most (MAX_GRAD_BLOCKS)
constexpr int kSlices = 128;     // slices of the reduction and the norm (NORM_SLICES)
constexpr int kRow = kTile + 4;  // a feature-major activation row
constexpr int kThreads = 256;
constexpr float kLog2Pi = 1.8378770664093453f;   // f32(log(2 pi))
constexpr float kEntropy = 1.4189385332046727f;  // f32(0.5 log(2 pi e)), entropy per action dim

// One torso, flat: W1 (H1, IN) b1 W2 (H2, H1) b2 W3 (OUT, H2) b3.  In shared
// memory its weight rows sit at odd strides S1, S2, S3.
template <int IN, int OUT, int H1, int H2>
struct Torso {
  static constexpr int W1 = 0, B1 = H1 * IN, W2 = B1 + H1, B2 = W2 + H2 * H1, W3 = B2 + H2, B3 = W3 + OUT * H2;
  static constexpr int SIZE = B3 + OUT;
  static constexpr int S1 = IN | 1, S2 = H1 | 1, S3 = H2 | 1;
  static constexpr int sW1 = 0, sB1 = H1 * S1, sW2 = sB1 + H1, sB2 = sW2 + H2 * S2, sW3 = sB2 + H2,
                       sB3 = sW3 + OUT * S3;
  static constexpr int SSIZE = sB3 + OUT;

  // shared-memory position of flat element i, and whether it belongs to a weight matrix
  __device__ static int smem_index(int i, bool* weight) {
    *weight = true;
    if (i < B1) return sW1 + (i / IN) * S1 + i % IN;
    if (i >= W2 && i < B2) return sW2 + ((i - W2) / H1) * S2 + (i - W2) % H1;
    if (i >= W3 && i < B3) return sW3 + ((i - W3) / H2) * S3 + (i - W3) % H2;
    *weight = false;
    if (i < W2) return sB1 + i - B1;
    if (i < W3) return sB2 + i - B2;
    return sB3 + i - B3;
  }
};

// The flat parameters: the 13 leaves of actor_critic_leaves, each row-major.
template <int F_, int A_, int H1_, int H2_>
struct Net {
  static constexpr int F = F_, A = A_, H1 = H1_, H2 = H2_;
  using Pi = Torso<F, A, H1, H2>;
  using Vf = Torso<F, 1, H1, H2>;
  static constexpr int PW1 = Pi::W1, PB1 = Pi::B1, PW2 = Pi::W2, PB2 = Pi::B2, PW3 = Pi::W3, PB3 = Pi::B3;
  static constexpr int V0 = Pi::SIZE;
  static constexpr int VW1 = V0 + Vf::W1, VB1 = V0 + Vf::B1, VW2 = V0 + Vf::W2, VB2 = V0 + Vf::B2,
                       VW3 = V0 + Vf::W3, VB3 = V0 + Vf::B3;
  static constexpr int LOG_STD = V0 + Vf::SIZE;
  static constexpr int P = LOG_STD + A;    // parameter count
  static constexpr int PARTIAL = P + 3;    // + policy loss, squared value error, approx KL sums
  // shared-memory copy: policy torso, value torso, log_std
  static constexpr int sV0 = Pi::SSIZE, sLOG_STD = sV0 + Vf::SSIZE;
  static constexpr int SP = (sLOG_STD + A + 3) / 4 * 4;
  static constexpr int SACC = (PARTIAL + 3) / 4 * 4;
  static constexpr int HMAX = H1 > H2 ? H1 : H2;
  static constexpr int SLICE = (P + kSlices - 1) / kSlices;  // parameters per slice
  static constexpr int NSLICES = (P + SLICE - 1) / SLICE;

  static_assert(H1 % 16 == 0 && H2 % 16 == 0, "hidden sizes must be multiples of 16");
  static_assert(SLICE <= kThreads, "a slice is one element per thread");

  __device__ static int smem_index(int i, bool* weight) {
    if (i < V0) return Pi::smem_index(i, weight);
    if (i < LOG_STD) return sV0 + Vf::smem_index(i - V0, weight);
    *weight = false;
    return sLOG_STD + i - LOG_STD;
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

// Shared-memory tile of kTile samples, feature-major rows of kRow floats; [net] 0 policy, 1 value.
template <class N>
struct Tile {
  float x[N::F * kRow], act[N::A * kRow];
  float y1[2][N::H1 * kRow];
  float y2[2][N::HMAX * kRow];  // y2, then (after backward 1) g1
  float g2[2][N::H2 * kRow];
  float mean[N::A * kRow], gmean[N::A * kRow], diff[N::A * kRow];
  float old_logp[kTile], nadv[kTile], ret[kTile], value[kTile], dl[kTile], gval[kTile];
  float min_pg[kTile], verr2[kTile], kl[kTile];
};

template <class N>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(N::SP) + N::SACC) * sizeof(float) + sizeof(Tile<N>);
}

template <bool BF16>
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = operand<BF16>(a.x), v[1] = operand<BF16>(a.y), v[2] = operand<BF16>(a.z), v[3] = operand<BF16>(a.w);
  v[4] = operand<BF16>(b.x), v[5] = operand<BF16>(b.y), v[6] = operand<BF16>(b.z), v[7] = operand<BF16>(b.w);
}

template <bool BF16>
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = operand<BF16>(a.x), v[1] = operand<BF16>(a.y), v[2] = operand<BF16>(a.z), v[3] = operand<BF16>(a.w);
}

// acc[i][c] = sum_k W[4 jb + i][k] in[k][8 sb + c], k in order from the first product;
// W at w[j * WS + k] (rounded already with BF16), in feature-major tile rows.
template <int K, int WS, bool BF16>
__device__ __forceinline__ void feat_by_sample(const float* w, const float* in, int jb, int sb, float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = -0.0f;  // -0 + p == p: the sum starts at its first product
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float wv[4], xv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[(4 * jb + i) * WS + k];
    load8<BF16>(in + k * kRow + 8 * sb, xv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = acc[i][c] + wv[i] * xv[c];
  }
}

// The same with the transposed weight: acc[i][c] = sum_k W[k][4 jb + i] in[k][8 sb + c].
template <int K, int WS, bool BF16>
__device__ __forceinline__ void featT_by_sample(const float* w, const float* in, int jb, int sb, float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = -0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float wv[4], xv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[k * WS + 4 * jb + i];
    load8<BF16>(in + k * kRow + 8 * sb, xv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = acc[i][c] + wv[i] * xv[c];
  }
}

// acc[i][r] = sum over the tile's samples of g[gi[i]][s] y[yr[r]][s], in sample order from
// the first product (both operands rounded with BF16): one weight-gradient register tile.
template <int NI, int NR, bool BF16>
__device__ __forceinline__ void sample_dot(const float* g, const int (&gi)[NI], const float* y, const int (&yr)[NR],
                                           float (&acc)[NI][NR]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[i][r] = -0.0f;
#pragma unroll 2
  for (int s = 0; s < kTile; s += 4) {
    float gv[NI][4], yv[NR][4];
#pragma unroll
    for (int i = 0; i < NI; ++i) load4<BF16>(g + gi[i] * kRow + s, gv[i]);
#pragma unroll
    for (int r = 0; r < NR; ++r) load4<BF16>(y + yr[r] * kRow + s, yv[r]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[i][r] = acc[i][r] + gv[i][q] * yv[r][q];
  }
}

__device__ __forceinline__ float tile_sum(const float* a) {
  float acc = a[0];
#pragma unroll 8
  for (int s = 1; s < kTile; ++s) acc = acc + a[s];
  return acc;
}

// One warp on the bf16 tensor cores: c[nt] = the m16n8 fragment of block nt of
// A (16 x 16 KSTEPS) B (16 KSTEPS x 8 NT), each operand rounded to bf16 from the
// getters' f32 (ga(r, k) = A[r][k], gb(k, n) = B[k][n]), f32 accumulation
// (mma.sync.m16n8k16).  Lane (g, t) = (lane / 4, lane % 4) holds rows g, g + 8 and
// columns 2 t, 2 t + 1 of each block.
template <int NT, int KSTEPS, class GA, class GB>
__device__ __forceinline__ void warp_mma(const GA& ga, const GB& gb, float (&c)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[nt][q] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int k = ks * 16 + 2 * t;
    const uint32_t a0 = ngo::pack_bf16(ga(g, k), ga(g, k + 1));
    const uint32_t a1 = ngo::pack_bf16(ga(g + 8, k), ga(g + 8, k + 1));
    const uint32_t a2 = ngo::pack_bf16(ga(g, k + 8), ga(g, k + 9));
    const uint32_t a3 = ngo::pack_bf16(ga(g + 8, k + 8), ga(g + 8, k + 9));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + g;
      const uint32_t b0 = ngo::pack_bf16(gb(k, n), gb(k + 1, n));
      const uint32_t b1 = ngo::pack_bf16(gb(k + 8, n), gb(k + 9, n));
      ngo::mma_bf16(c[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

// fn(row, column, value) for every element of a warp's fragments from warp_mma
template <int NT, class Fn>
__device__ __forceinline__ void for_fragment(const float (&c)[NT][4], const Fn& fn) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) fn(g + (q >= 2 ? 8 : 0), nt * 8 + 2 * t + (q & 1), c[nt][q]);
}

// The arguments of one update.
struct Sweep {
  float *params, *mu, *nu;   // flat (P), updated in place
  Data data;                 // data.g is set per step
  float* partials;           // (nb, PARTIAL)
  float* grad;               // (P) the step's summed gradient
  float* slice_sq;           // (NSLICES) the slices' sums of squares
  float* metrics;            // (G, 4)
  int nb, spb, count;        // ranges, samples per range, the Adam count before the update
  float lo, hi, vf_coef, inv_m;
  float lr, max_norm, neg_ent_coef, b1, one_minus_b1, log_b1, b2, one_minus_b2, log_b2, eps;
};

// Phase (a) for range r: the block's gradient of samples [r spb, min(M, (r + 1) spb)),
// written to partials[r]; the parameters are in shared memory already.
template <class N, bool BF16>
__device__ void range_gradient(const Sweep& s, const Data& d, int r, const float* w, float* acc, Tile<N>& tl) {
  using Pi = typename N::Pi;
  using Vf = typename N::Vf;
  constexpr int H1 = N::H1, H2 = N::H2, A = N::A, F = N::F;
  const int tid = threadIdx.x;
  const float* wv = w + N::sV0;  // the value torso
  const float* log_std = w + N::sLOG_STD;
  const float neg_inv_m = -s.inv_m;
  const float vf_scale = s.vf_coef * s.inv_m;
  // the streamed layouts normalise the advantages with the minibatch's stats
  const float mean_g = d.layout != 2 ? d.stats[d.g] : 0.0f;
  const float std_g = d.layout != 2 ? d.stats[d.G + d.g] : 0.0f;
  const int m_begin = r * s.spb;
  const int m_end = min(d.M, m_begin + s.spb);
  for (int i = tid; i < N::PARTIAL; i += kThreads) acc[i] = 0.0f;

  for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
    // ---- load the tile; samples past the range are zero and carry no gradient ----
    for (int i = tid; i < (F + A + 3) * kTile; i += kThreads) {
      const int row = i / kTile, sm = i % kTile, m = m0 + sm;
      float v = 0.0f;
      if (m < m_end) {
        const Where at = locate(d, m);
        if (row < F) {
          v = feat_at(d, d.obs, F, at, row);
        } else if (row < F + A) {
          v = feat_at(d, d.act, A, at, row - F);
        } else if (row == F + A) {
          v = row_at(d, d.logp, at);
        } else if (row == F + A + 1) {
          v = row_at(d, d.adv, at);
          if (d.layout != 2) v = (v - mean_g) / (std_g + 1e-8f);
        } else {
          v = row_at(d, d.ret, at);
        }
      }
      if (row < F) tl.x[row * kRow + sm] = v;
      else if (row < F + A) tl.act[(row - F) * kRow + sm] = v;
      else if (row == F + A) tl.old_logp[sm] = v;
      else if (row == F + A + 1) tl.nadv[sm] = v;
      else tl.ret[sm] = v;
    }
    __syncthreads();

    // ---- hidden layers of both torsos: y = tanh(W x + b), 4 features x 8 samples a thread,
    // or with bf16 16 features x the tile a warp on the tensor cores ----
    constexpr int kSb = kTile / 8, kWarps = kThreads / 32;
    const int warp = tid / 32;
    if constexpr (BF16) {
      for (int rb = warp; rb < 2 * (H1 / 16); rb += kWarps) {
        const int net = rb / (H1 / 16), r0 = 16 * (rb % (H1 / 16));
        const float* t = (net ? wv : w);
        float c[kSb][4];
        warp_mma<kSb, (F + 15) / 16>([&](int rr, int k) { return k < F ? t[Pi::sW1 + (r0 + rr) * Pi::S1 + k] : 0.0f; },
                                     [&](int k, int n) { return k < F ? tl.x[k * kRow + n] : 0.0f; }, c);
        for_fragment(c, [&](int rr, int n, float v) {
          tl.y1[net][(r0 + rr) * kRow + n] = tanhf(v + t[Pi::sB1 + r0 + rr]);
        });
      }
    }
    for (int it = tid; it < (BF16 ? 0 : 2 * (H1 / 4) * kSb); it += kThreads) {
      const int net = it / ((H1 / 4) * kSb), jb = (it / kSb) % (H1 / 4), sb = it % kSb;
      const float* t = net ? wv : w;
      float a[4][8];
      feat_by_sample<F, Pi::S1, BF16>(t + Pi::sW1, tl.x, jb, sb, a);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          tl.y1[net][(4 * jb + i) * kRow + 8 * sb + c] = tanhf(a[i][c] + t[Pi::sB1 + 4 * jb + i]);
        }
    }
    __syncthreads();
    if constexpr (BF16) {
      for (int rb = warp; rb < 2 * (H2 / 16); rb += kWarps) {
        const int net = rb / (H2 / 16), r0 = 16 * (rb % (H2 / 16));
        const float* t = (net ? wv : w);
        const float* y1 = tl.y1[net];
        float c[kSb][4];
        warp_mma<kSb, H1 / 16>([&](int rr, int k) { return t[Pi::sW2 + (r0 + rr) * Pi::S2 + k]; },
                               [&](int k, int n) { return y1[k * kRow + n]; }, c);
        for_fragment(c, [&](int rr, int n, float v) {
          tl.y2[net][(r0 + rr) * kRow + n] = tanhf(v + t[Pi::sB2 + r0 + rr]);
        });
      }
    }
    for (int it = tid; it < (BF16 ? 0 : 2 * (H2 / 4) * kSb); it += kThreads) {
      const int net = it / ((H2 / 4) * kSb), jb = (it / kSb) % (H2 / 4), sb = it % kSb;
      const float* t = net ? wv : w;
      float a[4][8];
      feat_by_sample<H1, Pi::S2, BF16>(t + Pi::sW2, tl.y1[net], jb, sb, a);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          tl.y2[net][(4 * jb + i) * kRow + 8 * sb + c] = tanhf(a[i][c] + t[Pi::sB2 + 4 * jb + i]);
        }
    }
    __syncthreads();
    // ---- outputs: the action mean (A rows) and the value, 4 samples a thread ----
    for (int it = tid; it < (A + 1) * (kTile / 4); it += kThreads) {
      const int a = it / (kTile / 4), s4 = 4 * (it % (kTile / 4));
      const bool value = a == A;
      const float* wr = value ? wv + Vf::sW3 : w + Pi::sW3 + a * Pi::S3;
      const float* y2 = tl.y2[value ? 1 : 0];
      float o[4] = {-0.0f, -0.0f, -0.0f, -0.0f};
#pragma unroll 4
      for (int k = 0; k < H2; ++k) {
        float yv[4];
        load4<BF16>(y2 + k * kRow + s4, yv);
        const float wk = wr[k];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = o[c] + wk * yv[c];
      }
      const float b = value ? wv[Vf::sB3] : w[Pi::sB3 + a];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (value) tl.value[s4 + c] = o[c] + b;
        else tl.mean[a * kRow + s4 + c] = o[c] + b;
      }
    }
    __syncthreads();

    // ---- the loss and its derivative per sample (one thread per sample) ----
    if (tid < kTile) {
      const int sm = tid;
      const bool valid = m0 + sm < m_end;
      float logp = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float ls = log_std[a];
        const float var = expf(2.0f * ls);
        const float df = tl.act[a * kRow + sm] - tl.mean[a * kRow + sm];
        tl.diff[a * kRow + sm] = df;
        const float term = -0.5f * (df * df / var + 2.0f * ls + kLog2Pi);
        logp = a == 0 ? term : logp + term;
      }
      const float nadv = tl.nadv[sm];
      const float ratio = expf(logp - tl.old_logp[sm]);
      const float pg1 = ratio * nadv;
      const float pg2 = fminf(fmaxf(ratio, s.lo), s.hi) * nadv;
      const float verr = tl.value[sm] - tl.ret[sm];
      const float in_region = (ratio > s.lo && ratio < s.hi) ? 1.0f : 0.0f;
      const float d_pg1 = nadv, d_pg2 = nadv * in_region;
      const float tie = 0.5f * (d_pg1 + d_pg2);
      const float d_ratio = pg1 < pg2 ? d_pg1 : (pg1 > pg2 ? d_pg2 : tie);
      const float dl = valid ? neg_inv_m * d_ratio * ratio : 0.0f;
      tl.dl[sm] = dl;
      tl.gval[sm] = valid ? vf_scale * verr : 0.0f;
      tl.min_pg[sm] = valid ? -fminf(pg1, pg2) : 0.0f;
      tl.verr2[sm] = valid ? verr * verr : 0.0f;
      tl.kl[sm] = valid ? (ratio - 1.0f) - logf(ratio) : 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float var = expf(2.0f * log_std[a]);
        tl.gmean[a * kRow + sm] = dl * (tl.diff[a * kRow + sm] / var);
      }
    }
    __syncthreads();

    // ---- backward 1: g2 = W3^T g_out * (1 - y2^2); output layers, log_std, metric sums ----
    {
      constexpr int nG2 = (H2 / 4) * kSb, nW3 = A * (H2 / 8), nVW3 = H2 / 8;
      constexpr int nItems = 2 * nG2 + nW3 + nVW3 + A + 1 + A + 3;
      for (int it = tid; it < nItems; it += kThreads) {
        int e = it;
        if (e < 2 * nG2) {  // g2[net][4 kb + i][8 sb + c]
          const int net = e / nG2, kb = (e / kSb) % (H2 / 4), sb = e % kSb;
          float a[4][8];
          if (net == 0) {
            featT_by_sample<A, Pi::S3, BF16>(w + Pi::sW3, tl.gmean, kb, sb, a);
          } else {
            float gv[8];
            load8<BF16>(tl.gval + 8 * sb, gv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 8; ++c) a[i][c] = wv[Vf::sW3 + 4 * kb + i] * gv[c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int at = (4 * kb + i) * kRow + 8 * sb + c;
              const float y = tl.y2[net][at];
              tl.g2[net][at] = a[i][c] * (1.0f - y * y);
            }
          continue;
        }
        e -= 2 * nG2;
        if (e < nW3 + nVW3) {  // gW3p[a][k], gVW3[k] for k = kb + (H2 / 8) r
          const bool value = e >= nW3;
          const int a = value ? 0 : e / (H2 / 8), kb = value ? e - nW3 : e % (H2 / 8);
          const int gi[1] = {a};
          int yr[8];
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) yr[rr] = kb + (H2 / 8) * rr;
          float sums[1][8];
          sample_dot<1, 8, BF16>(value ? tl.gval : tl.gmean, gi, tl.y2[value ? 1 : 0], yr, sums);
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) acc[(value ? N::VW3 : N::PW3 + a * H2) + yr[rr]] += sums[0][rr];
          continue;
        }
        e -= nW3 + nVW3;
        if (e < A) {
          acc[N::PB3 + e] += tile_sum(tl.gmean + e * kRow);
          continue;
        }
        e -= A;
        if (e < 1) {
          acc[N::VB3] += tile_sum(tl.gval);
          continue;
        }
        e -= 1;
        if (e < A) {  // d logp / d log_std_a = diff^2 / var - 1
          const float var = expf(2.0f * log_std[e]);
          float sum = 0.0f;
#pragma unroll 8
          for (int sm = 0; sm < kTile; ++sm) {
            const float df = tl.diff[e * kRow + sm];
            const float v = tl.dl[sm] * (df * df / var - 1.0f);
            sum = sm == 0 ? v : sum + v;
          }
          acc[N::LOG_STD + e] += sum;
          continue;
        }
        e -= A;
        acc[N::P + e] += tile_sum(e == 0 ? tl.min_pg : (e == 1 ? tl.verr2 : tl.kl));
      }
    }
    __syncthreads();

    // ---- backward 2: gW2, gB2; g1 = W2^T g2 * (1 - y1^2) into the y2 rows ----
    {
      if constexpr (BF16) {  // gW2 and g1 on the tensor cores, 16 rows a warp
        for (int rb = warp; rb < 2 * (H2 / 16); rb += kWarps) {  // gW2[k][j] = sum_s g2[k][s] y1[j][s]
          const int net = rb / (H2 / 16), r0 = 16 * (rb % (H2 / 16));
          const float *g2 = tl.g2[net], *y1 = tl.y1[net];
          float c[H1 / 8][4];
          warp_mma<H1 / 8, kTile / 16>([&](int rr, int sm) { return g2[(r0 + rr) * kRow + sm]; },
                                       [&](int sm, int j) { return y1[j * kRow + sm]; }, c);
          float* out = acc + (net ? N::VW2 : N::PW2);
          for_fragment(c, [&](int rr, int j, float v) { out[(r0 + rr) * H1 + j] += v; });
        }
        for (int rb = warp; rb < 2 * (H1 / 16); rb += kWarps) {  // g1[j][s] = sum_k W2[k][j] g2[k][s]
          const int net = rb / (H1 / 16), r0 = 16 * (rb % (H1 / 16));
          const float* t = (net ? wv : w);
          const float* g2 = tl.g2[net];
          float c[kSb][4];
          warp_mma<kSb, H2 / 16>([&](int rr, int k) { return t[Pi::sW2 + k * Pi::S2 + r0 + rr]; },
                                 [&](int k, int sm) { return g2[k * kRow + sm]; }, c);
          for_fragment(c, [&](int rr, int sm, float v) {
            const int at = (r0 + rr) * kRow + sm;
            const float y = tl.y1[net][at];
            tl.y2[net][at] = v * (1.0f - y * y);
          });
        }
      }
      constexpr int nW2 = BF16 ? 0 : (H2 / 4) * (H1 / 8), nG1 = BF16 ? 0 : (H1 / 4) * kSb;
      constexpr int nItems = 2 * (nW2 + nG1) + 2 * H2;
      for (int it = tid; it < nItems; it += kThreads) {
        int e = it;
        if (e < 2 * nW2) {  // gW2[k][j], k = kb + (H2 / 4) i, j = jb + (H1 / 8) r
          const int net = e / nW2, kb = (e % nW2) / (H1 / 8), jb = e % (H1 / 8);
          int gi[4], yr[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) gi[i] = kb + (H2 / 4) * i;
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) yr[rr] = jb + (H1 / 8) * rr;
          float sums[4][8];
          sample_dot<4, 8, BF16>(tl.g2[net], gi, tl.y1[net], yr, sums);
          float* out = acc + (net ? N::VW2 : N::PW2);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int rr = 0; rr < 8; ++rr) out[gi[i] * H1 + yr[rr]] += sums[i][rr];
          continue;
        }
        e -= 2 * nW2;
        if (e < 2 * nG1) {  // g1[net][4 jb + i][8 sb + c]
          const int net = e / nG1, jb = (e / kSb) % (H1 / 4), sb = e % kSb;
          float a[4][8];
          featT_by_sample<H2, Pi::S2, BF16>((net ? wv : w) + Pi::sW2, tl.g2[net], jb, sb, a);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int at = (4 * jb + i) * kRow + 8 * sb + c;
              const float y = tl.y1[net][at];
              tl.y2[net][at] = a[i][c] * (1.0f - y * y);
            }
          continue;
        }
        e -= 2 * nG1;
        const int net = e / H2, k = e % H2;
        acc[(net ? N::VB2 : N::PB2) + k] += tile_sum(tl.g2[net] + k * kRow);
      }
    }
    __syncthreads();

    // ---- backward 3: gW1 (8 features x 1 input a thread, or 16 features a warp with bf16), gB1 ----
    {
      if constexpr (BF16) {  // gW1[j][f] = sum_s g1[j][s] x[f][s], the inputs padded to 8 (F + 7) / 8
        for (int rb = warp; rb < 2 * (H1 / 16); rb += kWarps) {
          const int net = rb / (H1 / 16), r0 = 16 * (rb % (H1 / 16));
          const float* g1 = tl.y2[net];
          float c[(F + 7) / 8][4];
          warp_mma<(F + 7) / 8, kTile / 16>([&](int rr, int sm) { return g1[(r0 + rr) * kRow + sm]; },
                                            [&](int sm, int f) { return f < F ? tl.x[f * kRow + sm] : 0.0f; }, c);
          float* out = acc + (net ? N::VW1 : N::PW1);
          for_fragment(c, [&](int rr, int f, float v) {
            if (f < F) out[(r0 + rr) * F + f] += v;
          });
        }
      }
      constexpr int nW1 = BF16 ? 0 : (H1 / 8) * F;
      constexpr int nItems = 2 * nW1 + 2 * H1;
      for (int it = tid; it < nItems; it += kThreads) {
        if (it < 2 * nW1) {  // gW1[j][f], j = jb + (H1 / 8) r
          const int net = it / nW1, jb = (it % nW1) / F, f = it % F;
          int gi[8];
          const int yr[1] = {f};
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) gi[rr] = jb + (H1 / 8) * rr;
          float sums[8][1];
          sample_dot<8, 1, BF16>(tl.y2[net], gi, tl.x, yr, sums);
          float* out = acc + (net ? N::VW1 : N::PW1);
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) out[gi[rr] * F + f] += sums[rr][0];
        } else {
          const int e = it - 2 * nW1, net = e / H1, j = e % H1;
          acc[(net ? N::VB1 : N::PB1) + j] += tile_sum(tl.y2[net] + j * kRow);
        }
      }
    }
    __syncthreads();
  }

  float* out = s.partials + static_cast<int64_t>(r) * N::PARTIAL;
  for (int i = tid; i < N::PARTIAL; i += kThreads) out[i] = acc[i];
}

// The whole update: G steps of phases (a), (b), (c), a grid barrier after each.
template <class N, bool BF16>
__global__ void __launch_bounds__(kThreads, 1) ppo_sweep_kernel(Sweep s) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;                  // params in the product layout (SP)
  float* acc = w + N::SP;           // the range's gradient + metric sums (PARTIAL)
  Tile<N>& tl = *reinterpret_cast<Tile<N>*>(acc + N::SACC);
  __shared__ float scratch[kThreads];
  __shared__ float step_norm;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  for (int g = 0; g < s.data.G; ++g) {
    Data d = s.data;
    d.g = g;
    // ---- (a) partial gradients ----
    if (static_cast<int>(blockIdx.x) < s.nb) {
      for (int i = tid; i < N::P; i += kThreads) {
        bool weight;
        const int at = N::smem_index(i, &weight);
        w[at] = BF16 && weight ? operand<true>(s.params[i]) : s.params[i];
      }
      __syncthreads();
      for (int r = blockIdx.x; r < s.nb; r += gridDim.x) range_gradient<N, BF16>(s, d, r, w, acc, tl);
    }
    grid.sync();

    // ---- (b) the sum over ranges and each slice's sum of squares ----
    for (int l = blockIdx.x; l < N::NSLICES; l += gridDim.x) {
      const int e = l * N::SLICE + tid;
      float sq = 0.0f;
      if (tid < N::SLICE && e < N::P) {
        float gsum = s.partials[e];
        for (int b = 1; b < s.nb; ++b) gsum = gsum + s.partials[static_cast<int64_t>(b) * N::PARTIAL + e];
        if (e >= N::LOG_STD) gsum = gsum + s.neg_ent_coef;
        s.grad[e] = gsum;
        sq = gsum * gsum;
      }
      scratch[tid] = sq;
      __syncthreads();
      if (tid == 0) {
        float total = scratch[0];
        const int n = min(N::SLICE, N::P - l * N::SLICE);
        for (int i = 1; i < n; ++i) total = total + scratch[i];
        s.slice_sq[l] = total;
      }
      if (l == 0 && tid == 32) {  // the step's metrics, from the params before its Adam
        float sums[3];
        for (int i = 0; i < 3; ++i) {
          float v = s.partials[N::P + i];
          for (int b = 1; b < s.nb; ++b) v = v + s.partials[static_cast<int64_t>(b) * N::PARTIAL + N::P + i];
          sums[i] = v;
        }
        float entropy = s.params[N::LOG_STD] + kEntropy;
        for (int a = 1; a < N::A; ++a) entropy = entropy + (s.params[N::LOG_STD + a] + kEntropy);
        s.metrics[g * 4 + 0] = sums[0] * s.inv_m;
        s.metrics[g * 4 + 1] = (0.5f * sums[1]) * s.inv_m;
        s.metrics[g * 4 + 2] = entropy;
        s.metrics[g * 4 + 3] = sums[2] * s.inv_m;
      }
      __syncthreads();
    }
    grid.sync();

    // ---- (c) the global norm, clip, Adam ----
    if (tid == 0) {
      float total = s.slice_sq[0];
      for (int l = 1; l < N::NSLICES; ++l) total = total + s.slice_sq[l];
      step_norm = sqrtf(total);
    }
    __syncthreads();
    const float g_norm = step_norm;
    const bool trigger = g_norm < s.max_norm;
    const float tf = static_cast<float>(s.count + g + 1);
    const float bc1 = 1.0f - expf(tf * s.log_b1);
    const float bc2 = 1.0f - expf(tf * s.log_b2);
    for (int e = blockIdx.x * kThreads + tid; e < N::P; e += gridDim.x * kThreads) {
      const float gr = trigger ? s.grad[e] : (s.grad[e] / g_norm) * s.max_norm;
      const float m = s.b1 * s.mu[e] + s.one_minus_b1 * gr;
      const float v = s.b2 * s.nu[e] + s.one_minus_b2 * gr * gr;
      s.mu[e] = m;
      s.nu[e] = v;
      const float upd = (m / bc1) / (sqrtf(v / bc2) + s.eps);
      s.params[e] = s.params[e] - s.lr * upd;
    }
    grid.sync();
  }
}

}  // namespace ngs
