// C entry points of the day kernels (K1, K2, K5-K9, K11a/K11b) for one static configuration.
//
// The configuration comes from -D flags (ops/_build.py builds one shared
// library per configuration at first use):
//   NG_N charger count, NG_PV, NG_BATT, NG_PMODE (0-3), NG_DIFF_CAPS,
//   NG_REQ_SOC, NG_H1/NG_H2 actor hidden sizes, NG_ACTOR the actor kind:
//   0 the PPO actor (K5/K6 and the collection kernels K1/K2), 1 the DDPG
//   actor (K5/K6 actor="ddpg" and the collection kernel K9).
// Both kinds carry the RBC kernels K7/K8 and K11a; the PPO kind K11b.
// Every entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
#include "day_step.cuh"

#if !defined(NG_N) || !defined(NG_PV) || !defined(NG_BATT) || !defined(NG_PMODE) || \
    !defined(NG_DIFF_CAPS) || !defined(NG_REQ_SOC) || !defined(NG_H1) || !defined(NG_H2) || !defined(NG_ACTOR)
#error "build with -DNG_N= -DNG_PV= -DNG_BATT= -DNG_PMODE= -DNG_DIFF_CAPS= -DNG_REQ_SOC= -DNG_H1= -DNG_H2= -DNG_ACTOR="
#endif

namespace {

using C = ngk::Cfg<NG_N, NG_PV != 0, NG_BATT != 0, NG_PMODE, NG_DIFF_CAPS != 0, NG_REQ_SOC != 0, NG_H1, NG_H2>;
constexpr int kThreads = 128;
// The collection kernel keeps one warp per block, so that a batch of 4096
// envs spreads over 128 SMs (each thread runs a whole day, so a block's
// shared-memory pipe serves few warps).
constexpr int kCollectThreads = 32;

inline dim3 grid_for(int B, int threads = kThreads) { return dim3((B + threads - 1) / threads); }

inline ngk::Dims dims(int T, int k4, int k10, int k1, float dt) { return ngk::Dims{T, k4, k10, k1, dt}; }

template <class Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes)));
  }
  return 0;
}

}  // namespace

extern "C" {

int ngk_weights_size() { return C::WEIGHTS; }

int ngk_gen_rbc_day(const float* price, const float* rad_norm, int S, const float* solar, const float* u,
                    const float* batt_soc, const float* pv_shift, float* rewards, float* soc_final, int B, int T,
                    int k4, int k10, int k1, float dt, void* stream) {
  const size_t smem = static_cast<size_t>(S + 2 * T) * sizeof(float);
  ngk::gen_rbc_day_kernel<C><<<grid_for(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      price, rad_norm, S, solar, u, batt_soc, pv_shift, rewards, soc_final, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

int ngk_gen_rbc_multiday(const float* price, const float* rad_norm, int S, const float* solar, unsigned int seed,
                         int num_days, float* stats, int B, int T, int k4, int k10, int k1, float dt,
                         void* stream) {
  const size_t smem = static_cast<size_t>(S + 2 * T) * sizeof(float);
  ngk::gen_rbc_multiday_kernel<C><<<grid_for(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      price, rad_norm, S, solar, seed, num_days, stats, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

int ngk_rbc_day_rollout(const float* price, const float* rad_norm, int S, const float* solar, const float* tables,
                        const float* prev_col, const float* pmask, const float* batt_soc, const float* pv_shift,
                        float* rewards, float* soc_final, int B, int T, float dt, void* stream) {
  const size_t smem = static_cast<size_t>(S + 2 * T) * sizeof(float);
  ngk::rbc_day_rollout_kernel<C><<<grid_for(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      price, rad_norm, S, solar, tables, prev_col, pmask, batt_soc, pv_shift, rewards, soc_final, B, T, dt);
  return static_cast<int>(cudaGetLastError());
}

#if NG_ACTOR == 0

int ngk_collect_weights_size() { return C::COLLECT_WEIGHTS; }

int ngk_policy_day_rollout(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                           const float* solar, const float* tables, const float* prev_col, const float* pmask,
                           const float* batt_soc, const float* pv_shift, const float* weights, float* rewards,
                           float* actions, float* soc_final, int B, int T, float dt, void* stream) {
  const size_t smem = static_cast<size_t>(C::WEIGHTS + S + P + 2 * T) * sizeof(float);
  const int err = set_smem(ngk::policy_day_rollout_kernel<C>, smem);
  if (err != 0) return err;
  ngk::policy_day_rollout_kernel<C><<<grid_for(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      price, price_norm, P, rad_norm, S, solar, tables, prev_col, pmask, batt_soc, pv_shift, weights, rewards,
      actions, soc_final, B, T, dt);
  return static_cast<int>(cudaGetLastError());
}

int ngk_gen_policy_day(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                       const float* solar, const float* u, const float* batt_soc, const float* pv_shift,
                       const float* weights, float* rewards, float* actions, float* soc_final, float* batt_final,
                       int B, int T, int k4, int k10, int k1, float dt, void* stream) {
  const size_t smem = static_cast<size_t>(C::WEIGHTS + S + P + 2 * T) * sizeof(float);
  const int err = set_smem(ngk::gen_policy_day_kernel<C>, smem);
  if (err != 0) return err;
  ngk::gen_policy_day_kernel<C><<<grid_for(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      price, price_norm, P, rad_norm, S, solar, u, batt_soc, pv_shift, weights, rewards, actions, soc_final,
      batt_final, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

int ngk_gen_policy_multiday(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                            const float* solar, unsigned int seed, int num_days, const float* weights,
                            float* stats, int B, int T, int k4, int k10, int k1, float dt, void* stream) {
  const size_t smem = static_cast<size_t>(C::WEIGHTS + S + P + 2 * T) * sizeof(float);
  const int err = set_smem(ngk::gen_policy_multiday_kernel<C>, smem);
  if (err != 0) return err;
  ngk::gen_policy_multiday_kernel<C><<<grid_for(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      price, price_norm, P, rad_norm, S, solar, seed, num_days, weights, stats, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

int ngk_ppo_collect_day(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                        const float* solar, const float* u, const float* normals, const float* batt_soc,
                        const float* pv_shift, const float* weights, float* obs, float* act, float* logp,
                        float* value, float* rewards, float* batt_final, int B, int T, int k4, int k10, int k1,
                        float dt, void* stream) {
  const size_t smem = static_cast<size_t>(C::COLLECT_WEIGHTS + S + P + 2 * T) * sizeof(float);
  const int err = set_smem(ngk::ppo_collect_day_kernel<C, false>, smem);
  if (err != 0) return err;
  ngk::ppo_collect_day_kernel<C, false>
      <<<grid_for(B, kCollectThreads), kCollectThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          price, price_norm, P, rad_norm, S, solar, u, normals, 0u, batt_soc, pv_shift, weights, obs, act, logp,
          value, rewards, batt_final, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

int ngk_ppo_collect_day_seeded(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                               const float* solar, unsigned int seed, const float* batt_soc, const float* weights,
                               float* obs, float* act, float* logp, float* value, float* rewards,
                               float* batt_final, int B, int T, int k4, int k10, int k1, float dt, void* stream) {
  const size_t smem = static_cast<size_t>(C::COLLECT_WEIGHTS + S + P + 2 * T) * sizeof(float);
  const int err = set_smem(ngk::ppo_collect_day_kernel<C, true>, smem);
  if (err != 0) return err;
  ngk::ppo_collect_day_kernel<C, true>
      <<<grid_for(B, kCollectThreads), kCollectThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          price, price_norm, P, rad_norm, S, solar, nullptr, nullptr, seed, batt_soc, nullptr, weights, obs, act,
          logp, value, rewards, batt_final, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

#else  // NG_ACTOR == 1: the DDPG actor, a block of kDdpgThreads threads per kDdpgEnvs envs

// the block's activations and traces (ops/gen_policy_rollout.py::check_ddpg_torso
// refuses torsos for which this exceeds a block's shared memory)
static size_t ddpg_smem_bytes(int S, int P, int T) {
  return static_cast<size_t>(ngk::ddpg_shared_floats<C>() + S + P + 2 * T) * sizeof(float);
}

int ngk_gen_policy_day_ddpg(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                            const float* solar, const float* u, const float* batt_soc, const float* pv_shift,
                            const float* weights, float* rewards, float* actions, float* soc_final,
                            float* batt_final, int B, int T, int k4, int k10, int k1, float dt, void* stream) {
  const size_t smem = ddpg_smem_bytes(S, P, T);
  const int err = set_smem(ngk::gen_policy_day_ddpg_kernel<C>, smem);
  if (err != 0) return err;
  ngk::gen_policy_day_ddpg_kernel<C>
      <<<grid_for(B, ngk::kDdpgEnvs), ngk::kDdpgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          price, price_norm, P, rad_norm, S, solar, u, batt_soc, pv_shift, weights, rewards, actions, soc_final,
          batt_final, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

int ngk_gen_policy_multiday_ddpg(const float* price, const float* price_norm, int P, const float* rad_norm,
                                 int S, const float* solar, unsigned int seed, int num_days, const float* weights,
                                 float* stats, int B, int T, int k4, int k10, int k1, float dt, void* stream) {
  const size_t smem = ddpg_smem_bytes(S, P, T);
  const int err = set_smem(ngk::gen_policy_multiday_ddpg_kernel<C>, smem);
  if (err != 0) return err;
  ngk::gen_policy_multiday_ddpg_kernel<C>
      <<<grid_for(B, ngk::kDdpgEnvs), ngk::kDdpgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          price, price_norm, P, rad_norm, S, solar, seed, num_days, weights, stats, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

int ngk_ddpg_collect_day(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                         const float* solar, const float* u, const float* ou, const float* batt_soc,
                         const float* pv_shift, const float* weights, float* obs, float* act, float* rewards,
                         float* next_obs, float* batt_final, int B, int T, int k4, int k10, int k1, float dt,
                         void* stream) {
  const size_t smem = ddpg_smem_bytes(S, P, T);
  const int err = set_smem(ngk::ddpg_collect_day_kernel<C, false>, smem);
  if (err != 0) return err;
  ngk::ddpg_collect_day_kernel<C, false>
      <<<grid_for(B, ngk::kDdpgEnvs), ngk::kDdpgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          price, price_norm, P, rad_norm, S, solar, u, 0u, ou, batt_soc, pv_shift, weights, obs, act, rewards,
          next_obs, batt_final, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

int ngk_ddpg_collect_day_seeded(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                                const float* solar, unsigned int seed, const float* ou, const float* batt_soc,
                                const float* weights, float* obs, float* act, float* rewards, float* next_obs,
                                float* batt_final, int B, int T, int k4, int k10, int k1, float dt,
                                void* stream) {
  const size_t smem = ddpg_smem_bytes(S, P, T);
  const int err = set_smem(ngk::ddpg_collect_day_kernel<C, true>, smem);
  if (err != 0) return err;
  ngk::ddpg_collect_day_kernel<C, true>
      <<<grid_for(B, ngk::kDdpgEnvs), ngk::kDdpgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          price, price_norm, P, rad_norm, S, solar, nullptr, seed, ou, batt_soc, nullptr, weights, obs, act,
          rewards, next_obs, batt_final, B, dims(T, k4, k10, k1, dt));
  return static_cast<int>(cudaGetLastError());
}

#endif  // NG_ACTOR

}  // extern "C"
