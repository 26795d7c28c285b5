// C entry point of the day-generation kernel: the eight (B, N, L) schedule
// tables of one day from a (B, T, 5, N) block of uniforms, in one launch.
//
// It replaces no Pallas kernel: the JAX package leaves generate.py's step
// loop to XLA, which fuses it.  Its twin, core/generate.py::
// generate_schedule_plain, runs the loop eagerly: about 33 element-wise
// launches a step and 8 table builds, some 800 launches a day at 1 h.
//
// Bound: bytes.  The uniforms are read once and the tables written once,
// (B*T*5*N + 8*B*N*L) values; at B=1024, 8 chargers, 1 h in f32, 10.5 MB, or
// 3.1 us at 3.35 TB/s.  Design: a thread carries one (env, charger)
// recurrence through the day in registers (the chargers are independent),
// reading its uniforms from global memory (a warp's loads of one kind are
// the N contiguous values of each of its envs) and writing its row of each
// table directly; the step loop is unrolled so that the loads of several
// steps are in flight at once.  No shared memory, so no limit on N or T.
//
// Built per static configuration by ops/_build.py: NG_N charger count,
// NG_DIFF_CAPS, NG_REQ_SOC.  The time grid is a runtime argument, and each
// param is read per env through its element stride (0 for an unbatched
// param, an expanded view).  The arithmetic is the twin's, op for op: its
// two torch.addcmul round once on the card, so they are fused multiply-adds
// here; everything else is a separate IEEE operation under --fmad=false.
// Templated on the scalar type (f32, f64).  The entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>

#if !defined(NG_N) || !defined(NG_DIFF_CAPS) || !defined(NG_REQ_SOC)
#error "build with -DNG_N= -DNG_DIFF_CAPS= -DNG_REQ_SOC="
#endif

namespace ngk {

// The params the generation reads, in the order of their pointers and strides.
enum GenParam { kThreshold, kSocLow, kSocSpan, kCapLow, kCapSpan, kDefaultCap, kMask, kGenParams };
// occupancy, capacity, requested SoC, initial SoC, arrival, departure observation, the two departing masks
constexpr int kGenTables = 8;
// threads a block: 1024 envs of 8 chargers make 128 blocks, about one an SM
constexpr int kGenThreads = 64;

template <class S>
struct GenParams {
  const S* at[kGenParams];
  long long env_stride[kGenParams];  // elements between two envs' values
  long long charger_stride;          // the mask's, between two chargers
};

__device__ __forceinline__ float fused(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fused(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float rounddown(float x) { return floorf(x); }
__device__ __forceinline__ double rounddown(double x) { return floor(x); }
__device__ __forceinline__ float smaller(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double smaller(double a, double b) { return fmin(a, b); }

template <class S, int N, bool DIFF_CAPS, bool REQ_SOC>
__global__ void __launch_bounds__(kGenThreads) generate_day_kernel(const S* __restrict__ u, GenParams<S> p,
                                                                   S* __restrict__ out, int B, int T, int L, int k4,
                                                                   int k10, int k1) {
  const long long i = static_cast<long long>(blockIdx.x) * kGenThreads + threadIdx.x;  // env * N + charger
  if (i >= static_cast<long long>(B) * N) return;
  const long long b = i / N;
  const int n = static_cast<int>(i % N);
  S v[kGenParams];
#pragma unroll
  for (int k = 0; k < kGenParams; ++k) v[k] = p.at[k][b * p.env_stride[k] + (k == kMask ? n * p.charger_stride : 0)];
  const S mask = v[kMask], zero = S(0), one = S(1);
  const S* ue = u + b * T * 5 * N + n;
  const long long table = static_cast<long long>(B) * N * L;  // table k's row at row + k * table
  S* row = out + i * L;

  // the carry (charging_station.py:200-279)
  bool present = false;
  long long dep = 0;
  S cap = zero, req = zero;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const S* ut = ue + t * 5 * N;  // kinds: arrival, SoC, capacity, requested SoC, departure
    const bool arrives = !present && ut[0] > v[kThreshold];
    const S soc_t = fused(v[kSocSpan], ut[N], v[kSocLow]);
    const S cap_new = DIFF_CAPS ? v[kCapLow] + rounddown(ut[2 * N] * v[kCapSpan]) : v[kDefaultCap];
    S req_new = one;
    if (REQ_SOC) {
      const S soc_prime = smaller(soc_t + S(0.1), one);
      req_new = fused(one - soc_prime, ut[3 * N], soc_prime);
    }
    const int low = t + k4, high = min(t + k10, T + k1);
    const long long dep_new =
        low >= high ? low  // the no-draw branch (charging_station.py:271-279)
                    : low + static_cast<long long>(rounddown(ut[4 * N] * static_cast<S>(high - low)));
    present = present || arrives;
    if (arrives) {
      dep = dep_new;
      cap = cap_new;
      req = req_new;
    }
    const bool occupied = present && t < dep;
    row[0 * table + t] = (occupied ? one : zero) * mask;
    row[1 * table + t] = (occupied ? cap : zero) * mask;
    row[2 * table + t] = (occupied ? req : zero) * mask;
    row[3 * table + t] = (arrives ? soc_t : zero) * mask;
    row[4 * table + t] = (arrives ? one : zero) * mask;
    row[5 * table + t] = (occupied ? static_cast<S>(dep - t) : zero) * mask;
    row[6 * table + t] = (occupied && dep == t + 1 ? one : zero) * mask;
    row[7 * table + t] = (occupied && dep <= t + 3 ? one : zero) * mask;
    present = occupied;  // a charger whose vehicle departed is free at the next step
  }
  for (int t = T; t < L; ++t) {
#pragma unroll
    for (int k = 0; k < kGenTables; ++k) row[k * table + t] = zero * mask;
  }
}

template <class S>
int launch_generate(const void* u, const void* const* at, const long long* strides, void* out, int B, int T, int L,
                    int k4, int k10, int k1, void* stream) {
  GenParams<S> p;
  for (int k = 0; k < kGenParams; ++k) {
    p.at[k] = static_cast<const S*>(at[k]);
    p.env_stride[k] = strides[k];
  }
  p.charger_stride = strides[kGenParams];
  const long long threads = static_cast<long long>(B) * NG_N;
  const dim3 grid(static_cast<unsigned>((threads + kGenThreads - 1) / kGenThreads));
  generate_day_kernel<S, NG_N, NG_DIFF_CAPS != 0, NG_REQ_SOC != 0><<<grid, kGenThreads, 0,
                                                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(u), p, static_cast<S*>(out), B, T, L, k4, k10, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ngk

extern "C" {

// u (B, T, 5, N) contiguous; the seven params (threshold, SoC low and span,
// capacity low and span, default capacity, charger mask) with their env
// strides and the mask's charger stride (strides[7]); out (8, B, N, L)
// contiguous.
int ngk_generate_day(const void* u, const void* threshold, const void* soc_low, const void* soc_span,
                     const void* cap_low, const void* cap_span, const void* default_capacity,
                     const void* charger_mask, void* out, const long long* strides, int B, int T, int L, int k4,
                     int k10, int k1, int f64, void* stream) {
  const void* at[ngk::kGenParams] = {threshold, soc_low, soc_span, cap_low, cap_span, default_capacity, charger_mask};
  return f64 ? ngk::launch_generate<double>(u, at, strides, out, B, T, L, k4, k10, k1, stream)
             : ngk::launch_generate<float>(u, at, strides, out, B, T, L, k4, k10, k1, stream);
}

}  // extern "C"
