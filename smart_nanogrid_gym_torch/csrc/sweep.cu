// C entry points of the PPO update sweep (K3, K4) for one network shape.
//
// The shape comes from -D flags (ops/_build.py builds one shared library per
// shape at first use): NG_F observation size, NG_A action size, NG_H1/NG_H2
// hidden sizes.  ngk_ppo_sweep launches one update (all G steps) as one
// cooperative kernel on the given stream, does not synchronise, and returns
// the CUDA error code (0 on success) so the caller can raise on a refused
// launch.
#include "ppo_sweep.cuh"

#if !defined(NG_F) || !defined(NG_A) || !defined(NG_H1) || !defined(NG_H2)
#error "build with -DNG_F= -DNG_A= -DNG_H1= -DNG_H2="
#endif

namespace {

using N = ngs::Net<NG_F, NG_A, NG_H1, NG_H2>;

// Blocks of the cooperative grid (one per SM: a block holds about 220 KB of
// shared memory), after raising the kernel's dynamic shared-memory limit;
// 0 with *err set when none can be resident.
template <bool BF16>
int grid_blocks(cudaError_t* err) {
  const auto kernel = ngs::ppo_sweep_kernel<N, BF16>;
  const int smem = static_cast<int>(ngs::smem_bytes<N>());
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  if ((*err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess) {
    return 0;
  }
  if ((*err = cudaGetDevice(&device)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return 0;
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ngs::kThreads, smem)) != cudaSuccess) {
    return 0;
  }
  if (!coop || per_sm < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  return sms;
}

template <bool BF16>
int launch(ngs::Sweep s, void* stream) {
  cudaError_t err = cudaSuccess;
  const int blocks = grid_blocks<BF16>(&err);
  if (blocks == 0) return static_cast<int>(err);
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ngs::ppo_sweep_kernel<N, BF16>), dim3(blocks),
                                    dim3(ngs::kThreads), args, ngs::smem_bytes<N>(),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ngk_sweep_params_size() { return N::P; }

// the norm's slices (the length of the slice_sq scratch)
int ngk_sweep_slices() { return N::NSLICES; }

// blocks of the cooperative grid on the current device (negative: the CUDA error)
int ngk_sweep_grid_blocks() {
  cudaError_t err = cudaSuccess;
  const int blocks = grid_blocks<false>(&err);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// ptrs: params, mu, nu, obs, act, logp, adv, ret, block_perm, stats, partials (nb, P + 3),
//       grad (P), slice_sq (ngk_sweep_slices()), metrics (G, 4);
// ints: layout, G, K, granule, M, lanes, nb, samples per range, the Adam count, bf16 (the
//       matmul_dtype option: both operands of every network product rounded to bf16);
// floats: lo, hi, vf_coef, 1/M, lr, max_norm, -ent_coef, b1, 1 - b1, log b1, b2, 1 - b2, log b2, eps.
int ngk_ppo_sweep(void* const* ptrs, const int* ints, const float* floats, void* stream) {
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  ngs::Sweep s{};
  s.params = f(0);
  s.mu = f(1);
  s.nu = f(2);
  s.data = ngs::Data{f(3), f(4), f(5), f(6), f(7), static_cast<const int*>(ptrs[8]), f(9),
                     ints[0], 0, ints[1], ints[2], ints[3], ints[4], ints[5]};
  s.partials = f(10);
  s.grad = f(11);
  s.slice_sq = f(12);
  s.metrics = f(13);
  s.nb = ints[6];
  s.spb = ints[7];
  s.count = ints[8];
  s.lo = floats[0];
  s.hi = floats[1];
  s.vf_coef = floats[2];
  s.inv_m = floats[3];
  s.lr = floats[4];
  s.max_norm = floats[5];
  s.neg_ent_coef = floats[6];
  s.b1 = floats[7];
  s.one_minus_b1 = floats[8];
  s.log_b1 = floats[9];
  s.b2 = floats[10];
  s.one_minus_b2 = floats[11];
  s.log_b2 = floats[12];
  s.eps = floats[13];
  return ints[9] ? launch<true>(s, stream) : launch<false>(s, stream);
}

}  // extern "C"
