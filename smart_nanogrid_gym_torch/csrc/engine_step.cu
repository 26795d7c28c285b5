// C entry point of the plain engine's step: core/transition.py::step for
// every env of a batch in one launch.
//
// It replaces no Pallas kernel: XLA fuses the JAX package's step into a few
// fused ops.  Its twin, core/transition.py::step_plain, runs the step
// eagerly: about 175 launches of element-wise ops, gathers and scatters a
// step at 8 chargers, each of which costs the host more than the card.
//
// Bound: bytes, and far below the launch's own cost.  The SoC history is
// read and written whole (the new one is a copy with column t replaced),
// the schedule's columns t and t-1 read, the outputs written once; at
// B=1024, 8 chargers, 1 h in f32, about 1.8 MB, or 0.5 us at 3.35 TB/s.
// Design: a thread an env, its chargers looped in registers (the step's
// sums over them are index-order sums, as the twin takes them), 64 threads
// a block; the history's copy is spread over a grid of four cells a thread
// (more blocks than envs need), so that a warp's loads and stores are
// contiguous and no thread walks a long loop, each thread skipping the
// cells of column t that the env's thread writes.  No shared memory, so no
// limit on N or the day's length.
//
// Built per static configuration by ops/_build.py, into the plain engine's
// library beside generate.cu: NG_N charger count, NG_PV, NG_BATT, NG_PMODE
// (the penalty-check table: 0 none, 1 on departure, 2 sparse, 3 dense),
// NG_LOOKAHEAD, NG_CAST_OBS (the observation in f32).  Every operand is
// read through its element strides (0 along an axis an unbatched param
// lacks), so the wrapper copies and views nothing.  The arithmetic is the
// twin's, op for op, each a separate IEEE operation under --fmad=false;
// where torch divides a tensor by a Python scalar (/ dt, / 24, / 100) it
// multiplies by the scalar's reciprocal, and so does this kernel.
// Templated on the scalar type (f32, f64).  The entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <type_traits>

#if !defined(NG_N) || !defined(NG_PV) || !defined(NG_BATT) || !defined(NG_PMODE) || !defined(NG_LOOKAHEAD) || \
    !defined(NG_CAST_OBS)
#error "build with -DNG_N= -DNG_PV= -DNG_BATT= -DNG_PMODE= -DNG_LOOKAHEAD= -DNG_CAST_OBS="
#endif

namespace ngk {

// The operands, in the order of the wrapper's pointers (ops/engine_step.py
// INPUTS): the params the step reads, the state's (B, N, L) tables, its
// per-env rows, the action and the next PV shift (given, or drawn as int64).
enum StepInput {
  kPrice, kPriceNorm, kRadNorm, kSolarPower, kChargerMaxPower, kChargerEfficiency, kChargerMask, kBattCapacity,
  kBattMaxPower, kBattEfficiency, kBattDod, kSocMarginRatio, kPenaltyGain, kWBatteryPenalty, kWVehiclePenalty,
  kGridCostWeight, kSellCoefficient, kNonexistentMarker,
  kOccupancy, kCapacity, kRequestedSoc, kIsArrival, kDepObs, kMaskDeparting, kMaskDeparting3, kSoc,
  kT, kDay, kBattSoc, kBattInitSoc, kPvShift, kPmask, kAction, kNextPvShift,
  kStepInputs
};
// The (B,) rows of the float output, in the order of ops/engine_step.py ROWS;
// the charger powers (B, N) and the next penalty-check mask (B, N) follow.
enum StepRow {
  kReward, kTotalCost, kGridCost, kGridEnergy, kGridPower, kSolar, kTotalPenalty, kDod, kZeros, kVehicle, kCharging,
  kDischarging, kBattUsed, kBattCalculated, kBattSocNext, kBattInitNext, kPvShiftNext, kNonexistent, kBattAction,
  kStepRows
};
// threads a block, and the history's cells a thread copies: at 1024 envs of
// 8 chargers and 25 columns, 800 blocks, the first 16 of which step the envs
constexpr int kStepThreads = 64;
constexpr int kCopyCells = 4;

template <class S>
struct StepArgs {
  const void* in[kStepInputs];
  long long stride[kStepInputs][3];  // elements between neighbours along each axis (0 where the operand lacks it)
  S* soc;                            // (B, N, L) contiguous
  S* rows;                           // kStepRows * B, then (B, N) powers, then (B, N) mask
  void* obs;                         // (B, F) contiguous, f32 under NG_CAST_OBS
  long long* ints;                   // (2, B): the next t, the next day
  bool* done;                        // (B,)
  long long B;
  int T, L, price_len, rad_len;      // the day, the tables' length, the normalised traces' lengths
  int drawn;                         // the next PV shift as int64 draws of randint(0, 181)
  S dt;
};

template <class S>
__device__ __forceinline__ S get(const StepArgs<S>& a, int k, long long b, long long i = 0, long long j = 0) {
  return static_cast<const S*>(a.in[k])[b * a.stride[k][0] + i * a.stride[k][1] + j * a.stride[k][2]];
}

template <class S>
__device__ __forceinline__ long long get_int(const StepArgs<S>& a, int k, long long b) {
  return static_cast<const long long*>(a.in[k])[b * a.stride[k][0]];
}

// torch.sign, torch.ceil, torch.clamp(max=), torch.clamp(min=) and torch.abs as torch computes them on the card
template <class S>
__device__ __forceinline__ S signum(S x) { return static_cast<S>(static_cast<int>(S(0) < x) - static_cast<int>(x < S(0))); }
__device__ __forceinline__ float roundup(float x) { return ceilf(x); }
__device__ __forceinline__ double roundup(double x) { return ceil(x); }
__device__ __forceinline__ float at_most(float x, float hi) { return x != x ? x : fminf(x, hi); }
__device__ __forceinline__ double at_most(double x, double hi) { return x != x ? x : fmin(x, hi); }
__device__ __forceinline__ float at_least(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ double at_least(double x, double lo) { return x != x ? x : fmax(x, lo); }
__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

template <class S, class O, int N, bool PV, bool BATT, int PMODE, int K>
__global__ void __launch_bounds__(kStepThreads) engine_step_kernel(StepArgs<S> a) {
  const long long B = a.B;
  const int L = a.L;
  const long long tid = static_cast<long long>(blockIdx.x) * kStepThreads + threadIdx.x;

  // the SoC history but for each env's column t, copied by the whole grid
  const long long cells = B * N * L, grid = static_cast<long long>(gridDim.x) * kStepThreads;
  for (long long i = tid; i < cells; i += grid) {
    const long long b = i / (N * L);
    const long long n = (i / L) % N, l = i % L;
    if (l != get_int(a, kT, b)) a.soc[i] = get(a, kSoc, b, n, l);
  }
  if (tid >= B) return;
  const long long b = tid;

  const S zero = S(0), one = S(1);
  const S dt = a.dt, per_dt = one / dt;  // x / dt on the card is x * (1 / dt)
  const long long t = get_int(a, kT, b);
  const long long tm1 = t == 0 ? L - 1 : t - 1;  // (t - 1) mod L
  const S max_power = get(a, kChargerMaxPower, b), efficiency = get(a, kChargerEfficiency, b);
  const S marker = get(a, kNonexistentMarker, b), margin = get(a, kSocMarginRatio, b);
  const S gain = get(a, kPenaltyGain, b);
  S* power_row = a.rows + kStepRows * B + b * N;
  S* pmask_row = a.rows + kStepRows * B + B * N + b * N;

  // the charging station (charging_station.py:281-300, charger.py:37-144) and the lagged vehicle penalty
  S soc_col[N];
  S charging = zero, discharging = zero, vehicle = zero, nonexistent = zero;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const bool occupied = get(a, kOccupancy, b, n, t) > zero;
    const bool arrival = get(a, kIsArrival, b, n, t) > zero;
    const S cap_eff = arrival ? get(a, kCapacity, b, n, t) : get(a, kCapacity, b, n, tm1);
    const S soc_t = get(a, kSoc, b, n, t), soc_prev = get(a, kSoc, b, n, tm1);
    const S soc_eff = arrival ? soc_t : soc_prev;
    const S action = get(a, kAction, b, n), mask = get(a, kChargerMask, b, n);

    const S safe_cap = cap_eff > zero ? cap_eff : one;
    const S p_raw = action * max_power * efficiency;
    const S calc = soc_eff + p_raw * dt / safe_cap;
    const S soc_charged = at_most(calc, one);
    const S od_flag = roundup(S(0.5) * (one + signum(calc)));
    const S p_discharge = od_flag > zero ? -(soc_eff * cap_eff) * per_dt : p_raw;
    const S soc_discharged = at_least(calc, zero);
    const bool pos = action > zero, neg = action < zero, live = mask > zero;
    const bool active = occupied && live;
    const S power = active ? (pos ? p_raw : (neg ? p_discharge : zero)) : zero;
    const S soc_new = pos ? soc_charged : (neg ? soc_discharged : soc_eff);
    soc_col[n] = active ? soc_new : soc_t;
    a.soc[(b * N + n) * L + t] = soc_col[n];
    power_row[n] = power;

    // the penaliser reads the history at t - 1, which the step does not write
    const S requested = get(a, kRequestedSoc, b, n, tm1);
    const S lower = margin * requested;
    const S diff = (requested - soc_prev) * gain;
    const S pen = soc_prev < requested - lower ? diff * diff : zero;
    const S term = get(a, kPmask, b, n) * pen;
    const S charge = power > zero ? power : zero, drain = power < zero ? power : zero;
    const S missing = !occupied && live && action != zero ? marker : zero;
    charging = n == 0 ? charge : charging + charge;
    discharging = n == 0 ? drain : discharging + drain;
    vehicle = n == 0 ? term : vehicle + term;
    nonexistent = n == 0 ? missing : nonexistent + missing;
    pmask_row[n] = PMODE == 0   ? zero
                   : PMODE == 1 ? get(a, kMaskDeparting, b, n, t)
                   : PMODE == 2 ? get(a, kMaskDeparting3, b, n, t)
                                : get(a, kOccupancy, b, n, t);
  }

  // PV, energy balance, the BESS and the grid (central_management_system.py:105-106,157-185)
  const S pv_shift = get(a, kPvShift, b);
  const S solar = PV ? get(a, kSolarPower, b, t) * pv_shift : zero;
  const S remaining = (charging + discharging) - solar;
  S grid_power = remaining, batt_soc = zero, batt_init = zero, dod = zero, used = zero, calculated = zero;
  if (BATT) {
    const S action = get(a, kAction, b, N), soc = get(a, kBattSoc, b), capacity = get(a, kBattCapacity, b);
    const S p_calc = action * get(a, kBattMaxPower, b) * get(a, kBattEfficiency, b);
    const S calc = soc + p_calc * dt / capacity;
    const S soc_charged = at_most(calc, one);
    const S od_flag = one - roundup(S(0.5) * (one + signum(calc)));
    const S p_discharge = od_flag > zero ? -(soc * capacity) * per_dt : p_calc;
    const S soc_discharged = at_least(calc, zero);
    const bool pos = action > zero, neg = action < zero, idle = action == zero;
    batt_soc = pos ? soc_charged : (neg ? soc_discharged : soc);
    used = pos ? p_calc : (neg ? p_discharge : zero);
    calculated = idle ? zero : p_calc;
    grid_power = remaining + (idle ? zero : used);
    const S batt_dod = get(a, kBattDod, b);
    const S gap = (batt_dod - batt_soc) * gain;
    dod = batt_soc < batt_dod ? gap * gap : zero;
    batt_init = t == 0 ? soc : get(a, kBattInitSoc, b);
  }
  const S grid_energy = grid_power * dt;
  const S price = get(a, kPrice, b, t);
  const S cost = grid_energy < zero ? grid_energy * get(a, kSellCoefficient, b) * price : grid_energy * price;
  const S total_penalty = get(a, kWBatteryPenalty, b) * dod + get(a, kWVehiclePenalty, b) * vehicle;
  const S total_cost = get(a, kGridCostWeight, b) * magnitude(cost) + total_penalty;

  // the observation at the old t, after the SoC and BESS updates (env.py:173-174, 190-231)
  constexpr int F = (1 + PV) * (1 + K) + 2 * N + BATT;
  O* obs = static_cast<O*>(a.obs) + b * F;
  int f = 0;
  const long long start = t + 1 < 0 ? 0 : t + 1;
  const long long price_at = start < a.price_len - K ? start : a.price_len - K;
  const long long rad_at = start < a.rad_len - K ? start : a.rad_len - K;
  if (PV) obs[f++] = static_cast<O>(get(a, kRadNorm, b, t) * pv_shift);
  obs[f++] = static_cast<O>(get(a, kPriceNorm, b, t));
  if (PV) {
#pragma unroll
    for (int j = 0; j < K; ++j) obs[f++] = static_cast<O>(get(a, kRadNorm, b, rad_at + j) * pv_shift);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) obs[f++] = static_cast<O>(get(a, kPriceNorm, b, price_at + j));
#pragma unroll
  for (int n = 0; n < N; ++n) obs[f++] = static_cast<O>(soc_col[n]);
  const S per_day = one / S(24);
#pragma unroll
  for (int n = 0; n < N; ++n) obs[f++] = static_cast<O>(get(a, kDepObs, b, n, t) * per_day);
  if (BATT) obs[f++] = static_cast<O>(batt_soc);

  // advance: a finished day resets t and takes the next PV shift
  const bool done = t + 1 == a.T;
  const S next_shift = a.drawn ? static_cast<S>(get_int(a, kNextPvShift, b)) * (one / S(100)) : get(a, kNextPvShift, b);
  a.done[b] = done;
  a.ints[b] = done ? 0 : t + 1;
  a.ints[B + b] = get_int(a, kDay, b) + (done ? 1 : 0);

  S* row = a.rows + b;
  row[kReward * B] = -total_cost;
  row[kTotalCost * B] = total_cost;
  row[kGridCost * B] = cost;
  row[kGridEnergy * B] = grid_energy;
  row[kGridPower * B] = grid_power;
  row[kSolar * B] = solar;
  row[kTotalPenalty * B] = total_penalty;
  row[kDod * B] = dod;
  row[kZeros * B] = zero;
  row[kVehicle * B] = vehicle;
  row[kCharging * B] = charging;
  row[kDischarging * B] = discharging;
  row[kBattUsed * B] = used;
  row[kBattCalculated * B] = calculated;
  row[kBattSocNext * B] = batt_soc;
  row[kBattInitNext * B] = batt_init;
  row[kPvShiftNext * B] = done ? next_shift : pv_shift;
  row[kNonexistent * B] = nonexistent;
  row[kBattAction * B] = zero;
}

template <class S, class O>
int launch_engine_step(const void* const* in, const long long* strides, void* rows, void* soc, void* obs, void* ints,
                       void* done, long long B, int T, int L, int price_len, int rad_len, double dt, int drawn,
                       void* stream) {
  StepArgs<S> a;
  for (int k = 0; k < kStepInputs; ++k) {
    a.in[k] = in[k];
    for (int d = 0; d < 3; ++d) a.stride[k][d] = strides[3 * k + d];
  }
  a.soc = static_cast<S*>(soc);
  a.rows = static_cast<S*>(rows);
  a.obs = obs;
  a.ints = static_cast<long long*>(ints);
  a.done = static_cast<bool*>(done);
  a.B = B;
  a.T = T;
  a.L = L;
  a.price_len = price_len;
  a.rad_len = rad_len;
  a.drawn = drawn;
  a.dt = static_cast<S>(dt);
  const long long env_blocks = (B + kStepThreads - 1) / kStepThreads;
  const long long copy_blocks = (B * NG_N * L + kStepThreads * kCopyCells - 1) / (kStepThreads * kCopyCells);
  const dim3 grid(static_cast<unsigned>(env_blocks > copy_blocks ? env_blocks : copy_blocks));
  engine_step_kernel<S, O, NG_N, NG_PV != 0, NG_BATT != 0, NG_PMODE, NG_LOOKAHEAD>
      <<<grid, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ngk

extern "C" {

// in: kStepInputs operand pointers; strides: three element strides each;
// rows, soc, obs, ints, done: the contiguous outputs (see StepArgs); dt the
// step's hours; drawn: the next PV shift is int64 draws.
int ngk_engine_step(const void* const* in, const long long* strides, void* rows, void* soc, void* obs, void* ints,
                    void* done, long long B, int T, int L, int price_len, int rad_len, double dt, int f64, int drawn,
                    void* stream) {
  if (f64) {
    using O = typename std::conditional<NG_CAST_OBS != 0, float, double>::type;
    return ngk::launch_engine_step<double, O>(in, strides, rows, soc, obs, ints, done, B, T, L, price_len, rad_len, dt,
                                              drawn, stream);
  }
  return ngk::launch_engine_step<float, float>(in, strides, rows, soc, obs, ints, done, B, T, L, price_len, rad_len, dt,
                                               drawn, stream);
}

}  // extern "C"
