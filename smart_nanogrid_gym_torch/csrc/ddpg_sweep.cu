// C entry points of the DDPG update sweep (K10) for one network shape.
//
// The shape comes from -D flags (ops/_build.py builds one shared library per
// shape at first use): NG_F observation size, NG_A action size, NG_H1/NG_H2
// hidden sizes of both networks.  ngk_ddpg_sweep launches one update (all G
// steps) as one cooperative kernel on the given stream, does not
// synchronise, and returns the CUDA error code (0 on success) so the caller
// can raise on a refused launch.
#include "ddpg_sweep.cuh"

#if !defined(NG_F) || !defined(NG_A) || !defined(NG_H1) || !defined(NG_H2)
#error "build with -DNG_F= -DNG_A= -DNG_H1= -DNG_H2="
#endif

namespace {

using Actor = ngd::Mlp<NG_F, NG_A, NG_H1, NG_H2>;
using Critic = ngd::Mlp<NG_F + NG_A, 1, NG_H1, NG_H2>;
void (*const kKernel)(ngd::Sweep) = ngd::ddpg_sweep_kernel<NG_F, NG_A, NG_H1, NG_H2>;

// Blocks of the cooperative grid: one on every SM (a block holds kWorkers tile
// workers); 0 with *err set when the occupancy query says none can be resident.
int grid_blocks(cudaError_t* err) {
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  if ((*err = cudaGetDevice(&device)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, ngd::kThreads, 0);
  if (*err != cudaSuccess) return 0;
  if (!coop || per_sm < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  return sms;
}

}  // namespace

extern "C" {

int ngk_ddpg_actor_size() { return Actor::P; }

int ngk_ddpg_critic_size() { return Critic::P; }

// floats of the activation scratch for minibatches of M samples
int ngk_ddpg_scratch_floats(int M) { return static_cast<int>(ngd::Acts<NG_A, NG_H1, NG_H2>::floats(M)); }

// blocks of the cooperative grid on the current device (negative: the CUDA error)
int ngk_ddpg_grid_blocks() {
  cudaError_t err = cudaSuccess;
  const int blocks = grid_blocks(&err);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// ptrs: actor, critic, t_actor, t_critic, a_mu, a_nu, c_mu, c_nu, a_grad, c_grad, xa, rew, done,
//       xa_next, xa_pi, neg_inv, low, high, scratch, metrics (ngd::Sweep's pointers in order);
// ints: G, M, the actor's Adam count, the critic's Adam count, bf16 (the matmul_dtype option);
// floats: gamma, 2/M, 1/M, tau, 1 - tau, lr, b1, 1 - b1, log b1, b2, 1 - b2, log b2, eps.
int ngk_ddpg_sweep(void* const* ptrs, const int* ints, const float* floats, void* stream) {
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  ngd::Sweep s{};
  s.actor = f(0);
  s.critic = f(1);
  s.t_actor = f(2);
  s.t_critic = f(3);
  s.a_mu = f(4);
  s.a_nu = f(5);
  s.c_mu = f(6);
  s.c_nu = f(7);
  s.a_grad = f(8);
  s.c_grad = f(9);
  s.xa = f(10);
  s.rew = f(11);
  s.done = f(12);
  s.xa_next = f(13);
  s.xa_pi = f(14);
  s.neg_inv = f(15);
  s.low = f(16);
  s.high = f(17);
  s.scratch = f(18);
  s.metrics = f(19);
  s.G = ints[0];
  s.M = ints[1];
  s.t_actor0 = ints[2];
  s.t_critic0 = ints[3];
  s.bf16 = ints[4];
  s.gamma = floats[0];
  s.two_inv_m = floats[1];
  s.inv_m = floats[2];
  s.tau = floats[3];
  s.one_minus_tau = floats[4];
  s.adam = ngd::AdamArgs{floats[5], floats[6], floats[7], floats[8], floats[9], floats[10], floats[11], floats[12]};
  cudaError_t err = cudaSuccess;
  const int blocks = grid_blocks(&err);
  if (blocks == 0) return static_cast<int>(err);
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kKernel), dim3(blocks), dim3(ngd::kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
