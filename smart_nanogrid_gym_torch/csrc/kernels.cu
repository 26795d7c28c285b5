// C entry points of the day kernels (K1, K2, K5-K9, K11a/K11b) for one static configuration.
//
// The configuration comes from -D flags (ops/_build.py builds one shared
// library per configuration at first use):
//   NG_N charger count, NG_PV, NG_BATT, NG_PMODE (0-3), NG_DIFF_CAPS,
//   NG_REQ_SOC, NG_H1/NG_H2 actor hidden sizes, NG_ACTOR the actor kind:
//   0 the PPO actor (K5/K6 and the collection kernels K1/K2), 1 the DDPG
//   actor (K5/K6 actor="ddpg" and the collection kernel K9).
// Both kinds carry the RBC kernels K7/K8 and K11a; the PPO kind K11b.
// K5, K6 and K11b run K9's block and ring for every torso
// (gen_policy_day_block_kernel, gen_policy_multiday_block_kernel,
// policy_day_rollout_tables_kernel); K6 takes the bf16 operand option as an
// argument (one template instance each), so it adds no library.  K7 and K11a
// run one ring-block template (rbc_ring_day) on their own rows.
// Every entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
#include "day_step.cuh"

#if !defined(NG_N) || !defined(NG_PV) || !defined(NG_BATT) || !defined(NG_PMODE) || \
    !defined(NG_DIFF_CAPS) || !defined(NG_REQ_SOC) || !defined(NG_H1) || !defined(NG_H2) || !defined(NG_ACTOR)
#error "build with -DNG_N= -DNG_PV= -DNG_BATT= -DNG_PMODE= -DNG_DIFF_CAPS= -DNG_REQ_SOC= -DNG_H1= -DNG_H2= -DNG_ACTOR="
#endif

namespace {

using C = ngk::Cfg<NG_N, NG_PV != 0, NG_BATT != 0, NG_PMODE, NG_DIFF_CAPS != 0, NG_REQ_SOC != 0, NG_H1, NG_H2>;
// An actor whose launches of K5, K6 and K11b count under a name of its own
// (ngk_block_actor; the kernels are the same): the DDPG actor, or a PPO
// actor whose f32 block alone leaves no room for the traces in a block's
// shared memory (the bench's 256x256 torso), which K1/K2, holding the whole
// actor-critic there, have no instance for.
constexpr bool kWideActor =
    NG_ACTOR == ngk::kDdpgActor || C::WEIGHTS * sizeof(float) + ngk::kTraceReserveBytes > ngk::kMaxSmemBytes;

// K8's lanes an env for a batch of B envs: one once the batch alone gives
// kRbcFillThreads threads, about two warps a scheduler on 128 SMs, else the
// full layout.  One lane an env issues fewer instructions an env-step (each
// lane repeats the env's transposes, sums and reward), the full layout hides
// the latency of a small batch (tools/profile_rbc.py --lanes).
constexpr int kRbcFull = ngk::RbcLanes<C, 1>::FULL;
constexpr int64_t kRbcFillThreads = 32768;
inline int rbc_lanes(int B) { return B >= kRbcFillThreads ? 1 : kRbcFull; }

inline dim3 grid_for(int B, int threads) { return dim3((B + threads - 1) / threads); }

inline ngk::Dims dims(int T, int k4, int k10, int k1, float dt) { return ngk::Dims{T, k4, k10, k1, dt}; }

// Launch `kernel` with `smem` bytes of dynamic shared memory (raising the
// kernel's limit above 48 KB first).
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The collection kernels: one block per kCollectEnvs envs, their shared
// memory (ppo_collect_day_kernel's or ddpg_collect_day_kernel's layout),
// then the traces.
dim3 collect_grid(int B) { return grid_for(B, ngk::kCollectEnvs); }

size_t collect_smem(int floats, int S, int P, int T) {
  return static_cast<size_t>(floats + S + P + 2 * T) * sizeof(float);
}

// K6: the block actor with K9's block (an env warp and 11 product warps per
// kCollectEnvs envs, its ring and activations in shared memory).
template <bool BF16>
int gen_policy_multiday(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                        const float* solar, unsigned int seed, int num_days, const float* weights, float* stats,
                        int B, const ngk::Dims& d, void* stream) {
  return launch(ngk::gen_policy_multiday_block_kernel<C, NG_ACTOR, BF16>, collect_grid(B), ngk::kDdpgCollectThreads,
                collect_smem(ngk::K6<C, BF16>::FLOATS, S, P, d.T), stream, price, price_norm, P, rad_norm, S,
                solar, seed, num_days, weights, stats, B, d);
}

// K8 with L lanes an env, in blocks of kRbcLaneThreads.
template <int L>
int rbc_multiday(const float* price, const float* rad_norm, int S, const float* solar, unsigned int seed,
                 int num_days, float* stats, int B, const ngk::Dims& d, void* stream) {
  const int64_t threads = static_cast<int64_t>(B) * L;
  const dim3 grid(static_cast<unsigned>((threads + ngk::kRbcLaneThreads - 1) / ngk::kRbcLaneThreads));
  return launch(ngk::gen_rbc_multiday_kernel<C, L>, grid, ngk::kRbcLaneThreads,
                static_cast<size_t>(S + 2 * d.T) * sizeof(float), stream, price, rad_norm, S, solar, seed, num_days,
                stats, B, d);
}

}  // namespace

extern "C" {

// Probes that chip_smoke.py reads in the library's SASS (cuobjdump -sass),
// never launched: one Philox block a thread, and the same kernel without it.
// The difference of their instructions, sorted by pipe, is a block's work,
// the unit of the Philox part of the multiday and seeded kernels' bounds.
// The key comes in as kernel arguments, so its schedule is uniform: the
// kernels' key (seed, env) is fixed for all of an env's blocks.
__global__ void ngk_philox_probe_kernel(uint4* out, unsigned int day, unsigned int k0, unsigned int k1) {
  const unsigned int i = threadIdx.x;
  out[i] = ngk::philox4x32_10(make_uint4(day + i, i * 3u, i ^ k0, i + 7u), make_uint2(k0, k1));
}
__global__ void ngk_philox_probe_base_kernel(uint4* out, unsigned int day, unsigned int k0, unsigned int k1) {
  const unsigned int i = threadIdx.x;
  out[i] = make_uint4(day + i, i * 3u, i ^ k0, (i + 7u) ^ k1);
}

// Only the launch-count name: 1 when the actor's launches count as `_ddpg`
// or `_block` (kWideActor), 0 for a PPO actor whose block fits.
int ngk_block_actor() { return kWideActor ? 1 : 0; }

// K8's lanes an env and threads a block; K7's and K11a's envs a block, and
// each one's ring depth (steps in flight) and shared memory before the traces
// (floats: the ring and the per-charger sums).
int ngk_rbc_lanes(int B) { return rbc_lanes(B); }
int ngk_rbc_lane_threads() { return ngk::kRbcLaneThreads; }
int ngk_rbc_envs() { return ngk::kRbcEnvs; }
int ngk_rbc_ring_depth() { return ngk::RbcRingOf<C, ngk::kTablesDay>::DEPTH; }
int ngk_rbc_ring_floats() { return ngk::RbcRingOf<C, ngk::kTablesDay>::FLOATS; }
int ngk_gen_rbc_ring_depth() { return ngk::RbcRingOf<C, ngk::kExplicitDay>::DEPTH; }
int ngk_gen_rbc_ring_floats() { return ngk::RbcRingOf<C, ngk::kExplicitDay>::FLOATS; }

// K6's block actor (and K5's, whose explicit-draw slots are the size of
// K6's Philox ones, and K11b's in PPO libraries, whose f32 block is K6's):
// its packed block and its shared memory before the traces (floats), f32
// (bf16 = 0) or bf16, and the rows an f32 k-row of layer 1 or 2 is padded to
// (ops/gen_policy_rollout.py::k6_block).
int ngk_collect_envs() { return ngk::kCollectEnvs; }  // envs a block of K6's (K5's, K11b's) block actor
int ngk_k6_weights_size(int bf16) { return bf16 ? ngk::K6<C, true>::G::BLOCK : ngk::K6<C, false>::G::BLOCK; }
int ngk_k6_smem_floats(int bf16) { return bf16 ? ngk::K6<C, true>::FLOATS : ngk::K6<C, false>::FLOATS; }
int ngk_k6_pad(int layer) { return layer == 1 ? ngk::K6<C, false>::G::R1 : ngk::K6<C, false>::G::R2; }
static_assert(ngk::K6<C, false, ngk::kExplicitDay>::FLOATS == ngk::K6<C, false>::FLOATS,
              "K5's layout is K6's f32 one: the wrapper checks and packs K6's");

#ifdef NGK_K6_CLOCK
// tools/profile_k6.py: block 0's step record of the last launch, then the ring-wait counter reset.
int ngk_k6_clock(unsigned long long* out) {
  const unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(out, ngk::k6_clock, sizeof(ngk::k6_clock));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(ngk::k6_ring_wait, &zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

int ngk_gen_rbc_day(const float* price, const float* rad_norm, int S, const float* solar, const float* u,
                    const float* batt_soc, const float* pv_shift, float* rewards, float* soc_final, int B, int T,
                    int k4, int k10, int k1, float dt, void* stream) {
  using R = ngk::RbcRingOf<C, ngk::kExplicitDay>;
  return launch(ngk::gen_rbc_day_ring_kernel<C>, grid_for(B, ngk::kRbcEnvs), R::THREADS,
                static_cast<size_t>(R::FLOATS + S + 2 * T) * sizeof(float), stream, price, rad_norm, S, solar, u,
                batt_soc, pv_shift, rewards, soc_final, B, dims(T, k4, k10, k1, dt));
}

int ngk_gen_rbc_multiday(const float* price, const float* rad_norm, int S, const float* solar, unsigned int seed,
                         int num_days, float* stats, int B, int T, int k4, int k10, int k1, float dt,
                         void* stream) {
  const ngk::Dims d = dims(T, k4, k10, k1, dt);
  return rbc_lanes(B) == 1
             ? rbc_multiday<1>(price, rad_norm, S, solar, seed, num_days, stats, B, d, stream)
             : rbc_multiday<kRbcFull>(price, rad_norm, S, solar, seed, num_days, stats, B, d, stream);
}

int ngk_rbc_day_rollout(const float* price, const float* rad_norm, int S, const float* solar, const float* tables,
                        const float* prev_col, const float* pmask, const float* batt_soc, const float* pv_shift,
                        float* rewards, float* soc_final, int B, int T, float dt, void* stream) {
  using R = ngk::RbcRingOf<C, ngk::kTablesDay>;
  return launch(ngk::rbc_day_rollout_kernel<C>, grid_for(B, ngk::kRbcEnvs), R::THREADS,
                static_cast<size_t>(R::FLOATS + S + 2 * T) * sizeof(float), stream, price, rad_norm, S, solar,
                tables, prev_col, pmask, batt_soc, pv_shift, rewards, soc_final, B, dims(T, 0, 0, 0, dt));
}

// K5 for either actor and every torso: K6's block and ring with the day's
// explicit uniforms in its draw slots; the weights in k6_block's f32 layout.
int ngk_gen_policy_day(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                       const float* solar, const float* u, const float* batt_soc, const float* pv_shift,
                       const float* weights, float* rewards, float* actions, float* soc_final, float* batt_final,
                       int B, int T, int k4, int k10, int k1, float dt, void* stream) {
  return launch(ngk::gen_policy_day_block_kernel<C, NG_ACTOR>, collect_grid(B), ngk::kDdpgCollectThreads,
                collect_smem(ngk::K6<C, false, ngk::kExplicitDay>::FLOATS, S, P, T), stream, price, price_norm, P,
                rad_norm, S, solar, u, batt_soc, pv_shift, weights, rewards, actions, soc_final, batt_final, B,
                dims(T, k4, k10, k1, dt));
}

// bf16 != 0: the mlp_dtype option, the weights already rounded to bf16 values.
int ngk_gen_policy_multiday(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                            const float* solar, unsigned int seed, int num_days, const float* weights,
                            float* stats, int B, int T, int k4, int k10, int k1, float dt, int bf16, void* stream) {
  const ngk::Dims d = dims(T, k4, k10, k1, dt);
  return bf16 ? gen_policy_multiday<true>(price, price_norm, P, rad_norm, S, solar, seed, num_days, weights, stats,
                                          B, d, stream)
              : gen_policy_multiday<false>(price, price_norm, P, rad_norm, S, solar, seed, num_days, weights, stats,
                                           B, d, stream);
}

#if NG_ACTOR == 0

// The collection kernel's weight block and its shared memory before the traces (floats).
int ngk_collect_weights_size() { return C::COLLECT_WEIGHTS; }
int ngk_collect_smem_floats() { return ngk::PpoCollectShared<C>::FLOATS; }

// K11b's shared memory before the traces (floats): K6's f32 ring actor with
// two slots of table rows (its chunk and stages chosen for them).
using K11b = ngk::K6<C, false, ngk::kTablesDay>;
int ngk_k11b_smem_floats() { return K11b::FLOATS; }

// K11b: K6's block and ring with the day's tables in, for every PPO torso;
// the weights in k6_block's f32 layout.
int ngk_policy_day_rollout(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                           const float* solar, const float* tables, const float* prev_col, const float* pmask,
                           const float* batt_soc, const float* pv_shift, const float* weights, float* rewards,
                           float* actions, float* soc_final, int B, int T, float dt, void* stream) {
  return launch(ngk::policy_day_rollout_tables_kernel<C>, collect_grid(B), ngk::kDdpgCollectThreads,
                collect_smem(K11b::FLOATS, S, P, T), stream, price, price_norm, P, rad_norm, S, solar, tables,
                prev_col, pmask, batt_soc, pv_shift, weights, rewards, actions, soc_final, B, dims(T, 0, 0, 0, dt));
}

// K1/K2 hold the actor-critic in shared memory: a block-design library
// (its actor alone too large for that) has no collection kernel, and
// ops/collect.py refuses such a torso before it reaches here.
int ngk_ppo_collect_day(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                        const float* solar, const float* u, const float* normals, const float* batt_soc,
                        const float* pv_shift, const float* weights, float* obs, float* act, float* logp,
                        float* value, float* rewards, float* batt_final, int B, int T, int k4, int k10, int k1,
                        float dt, void* stream) {
  if constexpr (kWideActor) {
    return static_cast<int>(cudaErrorNotSupported);
  } else {
    return launch(ngk::ppo_collect_day_kernel<C, false>, collect_grid(B), ngk::kPpoCollectThreads,
                  collect_smem(ngk::PpoCollectShared<C>::FLOATS, S, P, T), stream, price, price_norm, P,
                  rad_norm, S, solar, u, normals, 0u, batt_soc, pv_shift, weights, obs, act, logp,
                  value, rewards, batt_final, B, dims(T, k4, k10, k1, dt));
  }
}

int ngk_ppo_collect_day_seeded(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                               const float* solar, unsigned int seed, const float* batt_soc, const float* weights,
                               float* obs, float* act, float* logp, float* value, float* rewards,
                               float* batt_final, int B, int T, int k4, int k10, int k1, float dt, void* stream) {
  const float* none = nullptr;
  if constexpr (kWideActor) {
    return static_cast<int>(cudaErrorNotSupported);
  } else {
    return launch(ngk::ppo_collect_day_kernel<C, true>, collect_grid(B), ngk::kPpoCollectThreads,
                  collect_smem(ngk::PpoCollectShared<C>::FLOATS, S, P, T), stream, price, price_norm, P,
                  rad_norm, S, solar, none, none, seed, batt_soc, none, weights, obs, act, logp,
                  value, rewards, batt_final, B, dims(T, k4, k10, k1, dt));
  }
}

#else  // NG_ACTOR == 1: the DDPG collection kernel K9

// K9's weight block holds W1 and W2 k-major, their k-rows padded
// (ops/ddpg_collect.py::k9_block).
int ngk_collect_weights_size() { return ngk::DdpgCollect<C>::BLOCK; }
int ngk_collect_smem_floats() { return ngk::DdpgCollect<C>::FLOATS; }

int ngk_ddpg_collect_day(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                         const float* solar, const float* u, const float* ou, const float* batt_soc,
                         const float* pv_shift, const float* weights, float* obs, float* act, float* rewards,
                         float* next_obs, float* batt_final, int B, int T, int k4, int k10, int k1, float dt,
                         void* stream) {
  return launch(ngk::ddpg_collect_day_kernel<C, false>, collect_grid(B), ngk::kDdpgCollectThreads,
                collect_smem(ngk::DdpgCollect<C>::FLOATS, S, P, T), stream, price, price_norm, P, rad_norm, S,
                solar, u, 0u, ou, batt_soc, pv_shift, weights, obs, act, rewards, next_obs, batt_final, B,
                dims(T, k4, k10, k1, dt));
}

int ngk_ddpg_collect_day_seeded(const float* price, const float* price_norm, int P, const float* rad_norm, int S,
                                const float* solar, unsigned int seed, const float* ou, const float* batt_soc,
                                const float* weights, float* obs, float* act, float* rewards, float* next_obs,
                                float* batt_final, int B, int T, int k4, int k10, int k1, float dt,
                                void* stream) {
  const float* none = nullptr;
  return launch(ngk::ddpg_collect_day_kernel<C, true>, collect_grid(B), ngk::kDdpgCollectThreads,
                collect_smem(ngk::DdpgCollect<C>::FLOATS, S, P, T), stream, price, price_norm, P, rad_norm, S,
                solar, none, seed, ou, batt_soc, none, weights, obs, act, rewards, next_obs, batt_final, B,
                dims(T, k4, k10, k1, dt));
}

#endif  // NG_ACTOR

}  // extern "C"
