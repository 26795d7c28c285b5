// C entry points of the PPO update sweep (K3, K4) for one network shape.
//
// The shape comes from -D flags (ops/_build.py builds one shared library per
// shape at first use): NG_F observation size, NG_A action size, NG_H1/NG_H2
// hidden sizes.  Every entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError() so the caller can raise on a
// refused launch.
#include "ppo_sweep.cuh"

#if !defined(NG_F) || !defined(NG_A) || !defined(NG_H1) || !defined(NG_H2)
#error "build with -DNG_F= -DNG_A= -DNG_H1= -DNG_H2="
#endif

namespace {

using N = ngs::Net<NG_F, NG_A, NG_H1, NG_H2>;

template <bool BF16>
int grad_partial(const float* params, const ngs::Data& d, int nb, int samples_per_block, float lo, float hi,
                 float vf_coef, float inv_m, float* partials, void* stream) {
  const size_t smem = ngs::grad_smem_bytes<N>();
  const cudaError_t err = cudaFuncSetAttribute(ngs::ppo_grad_partial<N, BF16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ngs::ppo_grad_partial<N, BF16><<<nb, ngs::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, d, samples_per_block, lo, hi, vf_coef, inv_m, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ngk_sweep_params_size() { return N::P; }

// bf16 != 0: the matmul_dtype option (both operands of every network product rounded to bf16).
int ngk_ppo_grad_partial(const float* params, const float* obs, const float* act, const float* logp,
                         const float* adv, const float* ret, const int* block_perm, const float* stats,
                         int layout, int g, int G, int K, int granule, int M, int lanes, float* partials, int nb,
                         int samples_per_block, float lo, float hi, float vf_coef, float inv_m, int bf16,
                         void* stream) {
  const ngs::Data d{obs, act, logp, adv, ret, block_perm, stats, layout, g, G, K, granule, M, lanes};
  return bf16 ? grad_partial<true>(params, d, nb, samples_per_block, lo, hi, vf_coef, inv_m, partials, stream)
              : grad_partial<false>(params, d, nb, samples_per_block, lo, hi, vf_coef, inv_m, partials, stream);
}

int ngk_ppo_adam_update(float* params, float* mu, float* nu, const float* partials, int nb, float* metrics, int g,
                        int t, float inv_m, float lr, float max_norm, float neg_ent_coef, float b1,
                        float one_minus_b1, float log_b1, float b2, float one_minus_b2, float log_b2, float eps,
                        void* stream) {
  const ngs::AdamArgs h{g, t, inv_m, lr, max_norm, neg_ent_coef, b1, one_minus_b1, log_b1, b2,
                        one_minus_b2, log_b2, eps};
  ngs::ppo_adam_update<N><<<1, ngs::kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, mu, nu, partials, nb, metrics, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
