// C entry points of the DDPG update sweep (K10) for one network shape.
//
// The shape comes from -D flags (ops/_build.py builds one shared library per
// shape at first use): NG_F observation size, NG_A action size, NG_H1/NG_H2
// hidden sizes of both networks.  ngk_ddpg_step launches one gradient step's
// kernels on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
#include "ddpg_sweep.cuh"

#if !defined(NG_F) || !defined(NG_A) || !defined(NG_H1) || !defined(NG_H2)
#error "build with -DNG_F= -DNG_A= -DNG_H1= -DNG_H2="
#endif

extern "C" {

int ngk_ddpg_actor_size() { return ngd::Mlp<NG_F, NG_A, NG_H1, NG_H2>::P; }

int ngk_ddpg_critic_size() { return ngd::Mlp<NG_F + NG_A, 1, NG_H1, NG_H2>::P; }

// ptrs: the device pointers of ngd::StepArgs in declaration order (33);
// ints: M, the actor's Adam step, the critic's Adam step, bf16 (the matmul_dtype option);
// floats: gamma, 2/M, 1/M, tau, 1 - tau, lr, b1, 1 - b1, log b1, b2, 1 - b2, log b2, eps.
int ngk_ddpg_step(void* const* ptrs, const int* ints, const float* floats, void* stream) {
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  ngd::StepArgs p{};
  p.actor = f(0);
  p.critic = f(1);
  p.t_actor = f(2);
  p.t_critic = f(3);
  p.a_mu = f(4);
  p.a_nu = f(5);
  p.c_mu = f(6);
  p.c_nu = f(7);
  p.a_grad = f(8);
  p.c_grad = f(9);
  p.xa = f(10);
  p.rew = f(11);
  p.done = f(12);
  p.neg_inv = f(13);
  p.xa_next = f(14);
  p.xa_pi = f(15);
  p.low = f(16);
  p.high = f(17);
  p.a1 = f(18);
  p.q1 = f(19);
  p.p1 = f(20);
  p.a2 = f(21);
  p.q2 = f(22);
  p.p2 = f(23);
  p.g1 = f(24);
  p.g2 = f(25);
  p.y = f(26);
  p.gq = f(27);
  p.cerr = f(28);
  p.q_pi = f(29);
  p.tanh_u = f(30);
  p.g_u = f(31);
  p.metrics_row = f(32);
  p.M = ints[0];
  p.t_actor_step = ints[1];
  p.t_critic_step = ints[2];
  p.bf16 = ints[3] != 0;
  p.gamma = floats[0];
  p.two_inv_m = floats[1];
  p.inv_m = floats[2];
  p.tau = floats[3];
  p.one_minus_tau = floats[4];
  p.adam = ngd::AdamArgs{0, floats[5], floats[6], floats[7], floats[8], floats[9], floats[10], floats[11],
                         floats[12]};
  ngd::ddpg_step<NG_F, NG_A, NG_H1, NG_H2>(p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
