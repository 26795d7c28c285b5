// C entry point of generalised advantage estimation: the advantages and
// returns of a (T, B) rollout in one launch.
//
// It replaces no Pallas kernel: the JAX package's PPOLearner._gae is a
// lax.scan over the day, which XLA compiles into one loop.  Its twin,
// ops/gae.py::gae_plain, runs the scan eagerly: 9 element-wise launches a
// step, 222 an update of one 24-step day with the dones and the stack.
//
// Bound: bytes, and far below the launch's own cost.  The rewards, values
// and dones are read once, the advantages and returns written once; at
// B=4096, T=24 in f32, about 1.7 MB, or 0.5 us at 3.35 TB/s.  Design: a
// thread an env, running the recurrence backwards from t = T-1 in registers;
// B is the contiguous axis, so a warp's loads and stores of one step are
// contiguous.  The loads of a window of kGaeWindow steps are issued before
// their arithmetic, so that they are in flight together while the
// recurrence runs serially.  No shared memory, so no limit on T or B.
//
// The arithmetic is the twin's, op for op, each a separate IEEE operation
// under --fmad=false:
//   nonterminal = 1 - done
//   delta = (r + (gamma * next_value) * nonterminal) - v
//   gae = delta + (gamma_lam * nonterminal) * gae
//   return = gae + v
// with gamma and gamma_lam rounded to the scalar type as torch rounds a
// Python float operand (gamma_lam is the product gamma * lam taken in double
// on the host, as the twin's Python expression takes it).  Every input is
// read through its element strides, so the wrapper copies nothing; the
// outputs are (T, B) contiguous.  Templated on the scalar type (f32, f64);
// the dones are bool.  The entry point launches on the given stream, does
// not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>

namespace ngk {

// the inputs' element strides, in the order of the wrapper's array
enum GaeStride { kRewardT, kRewardB, kValueT, kValueB, kDoneT, kDoneB, kLastB, kGaeStrides };
// threads a block: 4096 envs make 64 blocks
constexpr int kGaeThreads = 64;
// steps whose loads are issued together
constexpr int kGaeWindow = 8;

struct GaeStrides {
  long long at[kGaeStrides];
};

template <class S>
__global__ void __launch_bounds__(kGaeThreads) gae_kernel(const S* __restrict__ rewards, const S* __restrict__ values,
                                                          const bool* __restrict__ dones,
                                                          const S* __restrict__ last_value, GaeStrides st,
                                                          S* __restrict__ advantages, S* __restrict__ returns,
                                                          long long B, int T, S gamma, S gamma_lam) {
  const long long b = static_cast<long long>(blockIdx.x) * kGaeThreads + threadIdx.x;
  if (b >= B) return;
  const S* r_env = rewards + b * st.at[kRewardB];
  const S* v_env = values + b * st.at[kValueB];
  const bool* d_env = dones + b * st.at[kDoneB];
  S next_value = last_value[b * st.at[kLastB]];
  S gae = S(0);
  for (int top = T - 1; top >= 0; top -= kGaeWindow) {
    S r[kGaeWindow], v[kGaeWindow];
    bool d[kGaeWindow];
#pragma unroll
    for (int k = 0; k < kGaeWindow; ++k) {
      const int t = top - k;
      if (t >= 0) {
        r[k] = r_env[t * st.at[kRewardT]];
        v[k] = v_env[t * st.at[kValueT]];
        d[k] = d_env[t * st.at[kDoneT]];
      }
    }
#pragma unroll
    for (int k = 0; k < kGaeWindow; ++k) {
      const int t = top - k;
      if (t >= 0) {
        const S nonterminal = S(1) - (d[k] ? S(1) : S(0));
        const S delta = (r[k] + (gamma * next_value) * nonterminal) - v[k];
        gae = delta + (gamma_lam * nonterminal) * gae;
        advantages[t * B + b] = gae;
        returns[t * B + b] = gae + v[k];
        next_value = v[k];
      }
    }
  }
}

template <class S>
int launch_gae(const void* rewards, const void* values, const void* dones, const void* last_value, void* advantages,
               void* returns, const long long* strides, long long B, int T, double gamma, double gamma_lam,
               void* stream) {
  GaeStrides st;
  for (int k = 0; k < kGaeStrides; ++k) st.at[k] = strides[k];
  const dim3 grid(static_cast<unsigned>((B + kGaeThreads - 1) / kGaeThreads));
  gae_kernel<S><<<grid, kGaeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(rewards), static_cast<const S*>(values), static_cast<const bool*>(dones),
      static_cast<const S*>(last_value), st, static_cast<S*>(advantages), static_cast<S*>(returns), B, T,
      static_cast<S>(gamma), static_cast<S>(gamma_lam));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ngk

extern "C" {

// rewards, values, dones (T, B) and last_value (B,), read through strides
// (kGaeStrides element strides: rewards', values' and dones' along T and B,
// last_value's); advantages and returns (T, B) contiguous, of the rewards'
// type; gamma and gamma_lam as the host holds them.
int ngk_gae(const void* rewards, const void* values, const void* dones, const void* last_value, void* advantages,
            void* returns, const long long* strides, long long B, int T, double gamma, double gamma_lam, int f64,
            void* stream) {
  return f64 ? ngk::launch_gae<double>(rewards, values, dones, last_value, advantages, returns, strides, B, T, gamma,
                                       gamma_lam, stream)
             : ngk::launch_gae<float>(rewards, values, dones, last_value, advantages, returns, strides, B, T, gamma,
                                      gamma_lam, stream);
}

}  // extern "C"
