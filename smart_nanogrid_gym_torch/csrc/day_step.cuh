// Day-step bodies of the fused generation + closed-loop kernels (K1, K2, K5-K9)
// and of the tables-in day kernels (K11a, K11b).
//
// Replaces the Pallas TPU kernels of smart_nanogrid_gym_tpu/ops/:
//   K7 pallas_gen_rollout.py::pallas_gen_rbc_day            -> gen_rbc_day_ring_kernel<C>
//   K8 pallas_gen_rollout.py::pallas_gen_rbc_multiday       -> gen_rbc_multiday_kernel<C>
//   K5 pallas_gen_policy_rollout.py::pallas_gen_policy_day  -> gen_policy_day_block_kernel<C, KIND> (every torso)
//   K6 pallas_gen_policy_rollout.py::pallas_gen_policy_multiday -> gen_policy_multiday_block_kernel<C, KIND, BF16>
//   K1 pallas_collect.py::pallas_ppo_collect_day            -> ppo_collect_day_kernel<C, false>
//   K2 pallas_collect.py::pallas_ppo_collect_day_seeded     -> ppo_collect_day_kernel<C, true>
//   K9 pallas_collect.py::pallas_ddpg_collect_day(_seeded)  -> ddpg_collect_day_kernel<C, SEEDED>
//   K11a pallas_rollout.py::pallas_rbc_day_rollout          -> rbc_day_rollout_kernel<C>
//   K11b pallas_policy_rollout.py::pallas_policy_day_rollout -> policy_day_rollout_tables_kernel<C>
//
// Below a batch that fills the card no kernel gives an env one thread: at
// B=4096 that put 32 of the 132 SMs to work, every sum over the chargers one
// thread's dependent chain (K8 takes one lane an env from 32,768 envs).  The
// per-charger carries live in registers, the price/radiation/solar traces in
// shared memory, read by every thread at the same address (broadcast).  Nothing
// of a generated schedule ever reaches device memory.  The tail of the batch
// is guarded, so any batch size works.
//
// K8 (the RBC's multiday evaluation) is bound on this card by the integer
// issue of its Philox draws: about 187 blocks of 10 rounds an env-day at 8
// chargers, each a chain of dependent multiplies.  One thread per env would
// put B=4096 on 32 of the 132 SMs with one warp a scheduler, every charger's
// draws and physics one thread's serial chain.  So an env takes L lanes of a
// warp (RbcLanes: 8 at 8 chargers, 4 envs a warp), a lane a charger with its
// carry: B=4096 runs 32,768 threads on every SM.  The lanes of a charger
// group of 4 split the group's Philox blocks by kind (lane q the q-th kind
// the step draws, lane 0 also the departure when all five are drawn) and
// hand each charger its words by a 4 x 4 transpose of shuffles; the next
// step's blocks are drawn before this step's physics, which they do not
// depend on, so the two chains interleave.  The charging power of a step and
// the penalties of a day are summed over the chargers in index order through
// shuffles, on every lane of the env.  The lanes' transposes, sums and
// per-env work repeated on every lane cost about 1.6x the instructions of one
// lane an env, so once the batch alone fills the card (kernels.cu's
// rbc_lanes) an env takes one lane of the same template (L = 1), which draws
// its blocks itself.
//
// K7 (an explicit-uniform RBC day) and K11a (a given state's RBC day) are
// bound by the bytes of their inputs: K7's uniforms (T, 5, N, B), 15.7 MB at
// B=4096 x 8 chargers x 24 steps, K11a's seven (T, N, B) f32 tables, 22 MB,
// each for a few dozen operations a charger-step.  One thread per env kept
// one step's loads in flight on 32 SMs.  Both take one template (rbc_ring_day,
// its day source a parameter): a block takes 32 envs on one warp a charger
// (RbcRing), so a warp's load of a row is one coalesced 128-byte line, and
// each thread copies its chargers' rows (K7: the uniform kinds the step draws;
// K11a: the seven tables) 4 steps ahead into a ring in shared memory by
// asynchronous copies (20 and 28 KB a block at 8 chargers, seven blocks an
// SM): B=4096 fills 128 SMs.  A thread runs its chargers' part of the step
// (K7: the generation of its columns and the RBC on a per-charger carry, as
// K8's lanes do); the env's sums over its chargers run in index order on a
// sum warp of the block, after a block barrier a step, while the charger warps
// go on to the next step.
//
// Parity with the plain twins (ops/gen_rollout.py, ops/gen_policy_rollout.py)
// rests on the same f32 operations in the same order: every constant is the
// f32 value of the Python expression the Pallas body uses, sums over chargers
// and over the day run in index order, the build uses --fmad=false (no FMA
// contraction) and IEEE division.
//
// Random numbers (K8/K6): Philox4x32-10 keyed by (seed, global env index),
// counter (day, t, draw kind, charger group of 4); uniforms are (x >> 8)*2^-24.
// The day's PV-shift draw uses counter (day, T, 0, 0).  K2 draws day 0 of its
// seed with two kinds of its own for the action normals (5, 6: Box-Muller of
// two uniforms) and one for the PV shift (7).  ops/philox.py is the twin.
//
// The collection kernels (K1/K2 with the stochastic actor-critic, K9 with
// the DDPG actor plus OU noise) run K5's step body once per env in an env
// warp and the products on the block's other warps as register-tiled f32
// products: see "collection kernels" below.
//
// K5, K6 and K11b run every actor on K9's block (see "K6 and K5 block actor"
// below): an env warp that runs the step body once per env, register-tiled
// products on the other warps, the weights streamed through a shared-memory
// ring by TMA (resident for the 64x64 torso), and K6's bf16 option on the
// tensor cores.  The DDPG actor (SB3's 400-300 ReLU torso, 129-133k floats)
// and the bench's 256x256 PPO torso do not fit a block's shared memory beside
// the traces; the 64x64 torso does, and runs the same template.
//
// The tables-in kernels (K11a RBC, K11b the PPO actor's mean) roll one day of
// a given state instead of generating it: the wrapper (ops/rollout.py) builds
// the seven (T, N, B) day tables of the state, packed as (7, T, N, B), and the
// kernel reads column t of each per step, coalesced across envs, with the
// state's carried SoC column and penalty mask in registers.  K11b, for every
// PPO torso, is K6's block-actor template with the day's tables in place of
// its generation (see "K6 and K5 block actor" below), bound by the actor's
// multiply-adds as K5.  They share the RBC action, the charger and battery
// physics and the penalty with K5/K7.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "operand.cuh"

namespace ngk {

// reference constants (charger.py:20-23, central_management_system.py:35,
// penaliser.py:7,79,177-181, accountant.py:6,35, charging_station.py:214,257-269)
constexpr float kMaxPEff = static_cast<float>(22.0 * 0.95);
constexpr float kBattMaxPEff = static_cast<float>(44.0 * 0.95);
constexpr float kBattCap = 80.0f;
constexpr float kBattDod = 0.15f;
constexpr float kBattInit = 0.5f;
constexpr float kMargin = 0.05f;
constexpr float kGain = 10.0f;
constexpr float kWBatt = 0.8f;
constexpr float kWVeh = 1.0f;
constexpr float kGridW = 0.75f;
constexpr float kSell = 0.8f;
constexpr float kArrival = 0.6f;
constexpr float kSocLow = 0.1f;
constexpr float kSocSpan = 0.8f;
constexpr float kCapLow = 15.0f;
constexpr float kCapSpan = 105.0f;
constexpr float kDefaultCap = 40.0f;
constexpr float kSoon = static_cast<float>(24.0 * 0.16667);  // RBC: departure/24 < 0.16667

// Static configuration: the flags of NanogridConfig the step body branches on.
template <int N_, bool PV_, bool BATT_, int PMODE_, bool DIFF_CAPS_, bool REQ_SOC_, int H1_, int H2_>
struct Cfg {
  static constexpr int N = N_;
  static constexpr bool PV = PV_;
  static constexpr bool BATT = BATT_;
  static constexpr int PMODE = PMODE_;  // 0 no_penalty, 1 on_departure, 2 sparse, 3 dense
  static constexpr bool DIFF_CAPS = DIFF_CAPS_;
  static constexpr bool REQ_SOC = REQ_SOC_;
  static constexpr int H1 = H1_;
  static constexpr int H2 = H2_;
  static constexpr int F = (1 + (PV ? 1 : 0)) * 4 + 2 * N + (BATT ? 1 : 0);  // obs_dim, lookahead 3
  static constexpr int A = N + (BATT ? 1 : 0);
  // actor block in shared memory: W1 (H1,F) b1 W2 (H2,H1) b2 W3 (A,H2) b3 low high
  static constexpr int WEIGHTS = H1 * F + H1 + H2 * H1 + H2 + A * H2 + 3 * A;
  // critic block: W1 (H1,F) b1 W2 (H2,H1) b2 W3 (1,H2) b3; then log_std (A)
  static constexpr int VF_WEIGHTS = H1 * F + H1 + H2 * H1 + H2 + H2 + 1;
  static constexpr int COLLECT_WEIGHTS = WEIGHTS + VF_WEIGHTS + A;
};

// Runtime step constants: steps per day, departure offsets 4h/10h/1h in steps, dt.
struct Dims {
  int T, k4, k10, k1;
  float dt;
};

// ---------------------------------------------------------------- Philox ---

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float to_uniform(uint32_t x) {
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

// Uniforms from an explicit block u (T, 5, N, B), the generate_schedule(uniforms=...) contract.
template <int N>
struct ExplicitDraws {
  const float* u;
  int64_t B, b;
  __device__ void draw(int t, int kind, float (&out)[N]) const {
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = u[(static_cast<int64_t>(t * 5 + kind) * N + n) * B + b];
  }
};

// Uniforms from Philox, keyed by (seed, env), counter (day, t, kind, group).
template <int N>
struct PhiloxDraws {
  uint2 key;
  uint32_t day;
  __device__ void draw(int t, int kind, float (&out)[N]) const {
#pragma unroll
    for (int g = 0; g < (N + 3) / 4; ++g) {
      const uint4 r = philox4x32_10(make_uint4(day, static_cast<uint32_t>(t), static_cast<uint32_t>(kind),
                                               static_cast<uint32_t>(g)), key);
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * g + i < N) out[4 * g + i] = to_uniform(w[i]);
    }
  }
  __device__ float pv_shift(int T) const {
    const uint4 r = philox4x32_10(make_uint4(day, static_cast<uint32_t>(T), 0u, 0u), key);
    return floorf(to_uniform(r.x) * 181.0f) / 100.0f;
  }
};

constexpr uint32_t kKindNormalU1 = 5u, kKindNormalU2 = 6u, kKindPvShift = 7u;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);  // f32(2*pi)
constexpr float kLog2Pi = 1.8378770664093453f;                             // f32(log(2*pi))

// Standard normals from two 24-bit uniforms (pallas_collect.py:262-268):
// 1 - u1 lies in (0, 1], so the log is finite.
__device__ __forceinline__ float box_muller(float u1, float u2) {
  return sqrtf(-2.0f * logf(1.0f - u1)) * cosf(kTwoPi * u2);
}

// Action normals n (T, A, B) given explicitly (K1).
template <int A>
struct ExplicitNormals {
  const float* n;
  int64_t B, b;
  __device__ void draw(int t, float (&out)[A]) const {
#pragma unroll
    for (int a = 0; a < A; ++a) out[a] = n[(static_cast<int64_t>(t) * A + a) * B + b];
  }
};

// Action normals from Philox (K2): action a = 4g + i takes word i of counters
// (0, t, 5, g) and (0, t, 6, g).
template <int A>
struct PhiloxNormals {
  uint2 key;
  __device__ void draw(int t, float (&out)[A]) const {
#pragma unroll
    for (int g = 0; g < (A + 3) / 4; ++g) {
      const uint4 r1 = philox4x32_10(make_uint4(0u, static_cast<uint32_t>(t), kKindNormalU1,
                                                static_cast<uint32_t>(g)), key);
      const uint4 r2 = philox4x32_10(make_uint4(0u, static_cast<uint32_t>(t), kKindNormalU2,
                                                static_cast<uint32_t>(g)), key);
      const uint32_t w1[4] = {r1.x, r1.y, r1.z, r1.w};
      const uint32_t w2[4] = {r2.x, r2.y, r2.z, r2.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * g + i < A) out[4 * g + i] = box_muller(to_uniform(w1[i]), to_uniform(w2[i]));
    }
  }
};

// The fresh day's PV shift of K2: word 0 of counter (0, 0, 7, 0).
__device__ __forceinline__ float collect_pv_shift(uint2 key) {
  const uint4 r = philox4x32_10(make_uint4(0u, 0u, kKindPvShift, 0u), key);
  return floorf(to_uniform(r.x) * 181.0f) / 100.0f;
}

// ------------------------------------------------------------ day carry ---

template <class C>
struct Carry {
  // generation (charging_station.py:200-279)
  float present[C::N], dep[C::N], cap[C::N], req[C::N];
  // rollout: previously written SoC column, previous departure column, trailing-observe mask
  float prev_col[C::N], prev_depcol[C::N], pmask[C::N], prev_capcol[C::N], prev_reqcol[C::N];

  __device__ void clear() {
#pragma unroll
    for (int n = 0; n < C::N; ++n) {
      present[n] = dep[n] = cap[n] = req[n] = 0.0f;
      prev_col[n] = prev_depcol[n] = pmask[n] = prev_capcol[n] = prev_reqcol[n] = 0.0f;
    }
  }
};

// The schedule column of one charger at step t (_generate_column).
struct Column {
  bool arrives, occupied;
  float occ_f, cap, cap_col, req, req_col, soc_t, dep, dep_col, mask_col;
};

// Draws of step t: only the kinds the recurrence reads (the others are never used).
template <class C>
struct StepDraws {
  float arr[C::N], soc[C::N], cap[C::N], req[C::N], dep[C::N];
  int low, high;

  template <class Src>
  __device__ void fill(const Src& src, int t, const Dims& d) {
    low = t + d.k4;
    high = min(t + d.k10, d.T + d.k1);
    src.draw(t, 0, arr);
    src.draw(t, 1, soc);
    if (C::DIFF_CAPS) src.draw(t, 2, cap);
    if (C::REQ_SOC) src.draw(t, 3, req);
    if (low < high) {
      src.draw(t, 4, dep);
    } else {  // no-draw branch: the departure is `low`
#pragma unroll
      for (int n = 0; n < C::N; ++n) dep[n] = 0.0f;
    }
  }
};

template <class C>
__device__ __forceinline__ Column generate_column(int t, int n, const StepDraws<C>& u, const Carry<C>& c) {
  Column k;
  k.arrives = (c.present[n] == 0.0f) && (u.arr[n] > kArrival);
  k.soc_t = kSocLow + kSocSpan * u.soc[n];
  const float dep_new = (u.low >= u.high)
                            ? static_cast<float>(u.low)
                            : static_cast<float>(u.low) + floorf(u.dep[n] * static_cast<float>(u.high - u.low));
  const float present = fmaxf(c.present[n], k.arrives ? 1.0f : 0.0f);
  k.dep = k.arrives ? dep_new : c.dep[n];
  k.occupied = (present > 0.0f) && (static_cast<float>(t) < k.dep);
  k.occ_f = k.occupied ? 1.0f : 0.0f;
  if (C::DIFF_CAPS) {
    const float cap_new = kCapLow + floorf(u.cap[n] * kCapSpan);
    k.cap = k.arrives ? cap_new : c.cap[n];
    k.cap_col = k.occupied ? k.cap : 0.0f;
  } else {
    k.cap = 0.0f;
    k.cap_col = k.occ_f * kDefaultCap;
  }
  if (C::REQ_SOC) {
    const float soc_prime = fminf(k.soc_t + 0.1f, 1.0f);
    const float req_new = soc_prime + (1.0f - soc_prime) * u.req[n];
    k.req = k.arrives ? req_new : c.req[n];
    k.req_col = k.occupied ? k.req : 0.0f;
  } else {
    k.req = 0.0f;
    k.req_col = k.occ_f;
  }
  k.dep_col = k.occupied ? k.dep - static_cast<float>(t) : 0.0f;
  if (C::PMODE == 0) {
    k.mask_col = 0.0f;
  } else if (C::PMODE == 1) {
    k.mask_col = (k.occupied && k.dep == static_cast<float>(t + 1)) ? 1.0f : 0.0f;
  } else if (C::PMODE == 2) {
    k.mask_col = (k.occupied && k.dep <= static_cast<float>(t + 3)) ? 1.0f : 0.0f;
  } else {
    k.mask_col = k.occ_f;
  }
  return k;
}

// Insufficiency penalty of one charger: the previous SoC column against the
// requested SoC at (t-1) mod L, for the chargers in the trailing-observe mask.
__device__ __forceinline__ float insufficiency_penalty(float pmask, float prev_col, float req_p) {
  const bool insufficient = prev_col < req_p - kMargin * req_p;
  const float gap = (req_p - prev_col) * kGain;
  return (pmask > 0.0f && insufficient) ? gap * gap : 0.0f;
}

// Insufficiency penalty of charger n from the previous step's carry (Q2 reads).
template <class C>
__device__ __forceinline__ float vehicle_penalty(int n, float pmask, const Carry<C>& c) {
  const float req_p = C::REQ_SOC ? c.prev_reqcol[n] : c.present[n];
  return insufficiency_penalty(pmask, c.prev_col[n], req_p);
}

// Generation-carry update of charger n (prev_col is written after the physics).
template <class C>
__device__ __forceinline__ void advance_carry(int n, const Column& k, Carry<C>& c) {
  c.present[n] = k.occ_f;
  c.dep[n] = k.dep;
  if (C::DIFF_CAPS) c.cap[n] = k.cap;
  if (C::REQ_SOC) c.req[n] = k.req;
  c.prev_depcol[n] = k.dep_col;
  c.pmask[n] = k.mask_col;
  if (C::DIFF_CAPS) c.prev_capcol[n] = k.cap_col;
  if (C::REQ_SOC) c.prev_reqcol[n] = k.req_col;
}

// ------------------------------------------------------------- RBC step ---

// The RBC's fallback action (r(o) + r(o+1)) / 2 of the shifted radiation.
template <class C>
__device__ __forceinline__ float rbc_fallback(int o, const float* rad_norm, float pv_shift) {
  return C::PV ? (rad_norm[o] * pv_shift + rad_norm[o + 1] * pv_shift) * 0.5f : 0.0f;
}

// The RBC's action for a departure countdown dep_o of the observation.
__device__ __forceinline__ float rbc_action(float dep_o, float fallback) {
  return (dep_o == 0.0f) ? 0.0f : ((dep_o < kSoon) ? 1.0f : fallback);
}

// Charger n's part of an RBC step (_gen_rbc_step): its schedule column, the
// RBC's action, the charge-only physics and its vehicle penalty `pen`;
// returns its charging power.
template <class C>
__device__ __forceinline__ float rbc_charger(int t, int n, const StepDraws<C>& u, Carry<C>& c, float fallback,
                                             float dt, float& pen) {
  const Column k = generate_column<C>(t, n, u, c);
  const float pmask = t == 0 ? k.mask_col : c.pmask[n];
  const float dep_o = t == 0 ? k.dep_col : c.prev_depcol[n];
  const float a = rbc_action(dep_o, fallback);

  const float soc_eff = k.arrives ? k.soc_t : c.prev_col[n];
  const float p_raw = a * kMaxPEff;
  float safe_cap = kDefaultCap;
  if (C::DIFF_CAPS) {
    const float cap_eff = k.arrives ? k.cap_col : c.prev_capcol[n];
    safe_cap = cap_eff > 0.0f ? cap_eff : 1.0f;
  }
  const float calc = soc_eff + (p_raw * dt) / safe_cap;
  const float power = (k.occupied && a > 0.0f) ? p_raw : 0.0f;
  const float soc_new = a > 0.0f ? fminf(calc, 1.0f) : soc_eff;

  pen = vehicle_penalty<C>(n, pmask, c);
  advance_carry<C>(n, k, c);
  c.prev_col[n] = k.occupied ? soc_new : 0.0f;
  return power;
}

// Reward of one RBC step without the vehicle penalty (_day_rewards).
template <class C>
__device__ __forceinline__ float rbc_reward(float charging, float solar_t, float price_t, float pv_shift,
                                            float dod_pen, float dt) {
  const float grid_power = C::PV ? charging - solar_t * pv_shift : charging;
  const float ge = grid_power * dt;
  const float g_cost = ge < 0.0f ? ge * (kSell * price_t) : ge * price_t;
  return kGridW * fabsf(g_cost) + kWBatt * dod_pen;  // the cost; the caller negates
}

template <class C>
__device__ __forceinline__ float idle_dod_penalty(float batt_soc) {
  if (!C::BATT) return 0.0f;
  const float gap = (kBattDod - batt_soc) * kGain;
  return batt_soc < kBattDod ? gap * gap : 0.0f;
}

// ---------------------------------------------------------- policy step ---

// Shared-memory views of the actor block (layout of Cfg::WEIGHTS).
template <class C>
struct Actor {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *low, *high;
  __device__ explicit Actor(const float* s) {
    w1 = s;
    b1 = w1 + C::H1 * C::F;
    w2 = b1 + C::H1;
    b2 = w2 + C::H2 * C::H1;
    w3 = b2 + C::H2;
    b3 = w3 + C::A * C::H2;
    low = b3 + C::A;
    high = low + C::A;
  }
};

// Shared-memory views of the critic block (layout of Cfg::VF_WEIGHTS).
template <class C>
struct Critic {
  const float *w1, *b1, *w2, *b2, *w3, *b3;
  __device__ explicit Critic(const float* s) {
    w1 = s;
    b1 = w1 + C::H1 * C::F;
    w2 = b1 + C::H1;
    b2 = w2 + C::H2 * C::H1;
    w3 = b2 + C::H2;
    b3 = w3 + C::H2;
  }
};

struct PolicyRows {
  float flows, p_used, dod;
};

struct ChargerFlow {
  float power, soc_new;
};

// Charger physics of one occupied-or-not charger under action a, both
// branches, with the inverted discharge flag quirk (charger.py:122-132).
__device__ __forceinline__ ChargerFlow charger_physics(float a, float soc_eff, float cap_eff, float safe_cap,
                                                       bool occupied, float dt) {
  const float p_raw = a * kMaxPEff;
  const float calc = soc_eff + (p_raw * dt) / safe_cap;
  const float p_dis = calc >= 0.0f ? -(soc_eff * cap_eff) / dt : p_raw;
  const float power = a > 0.0f ? p_raw : (a < 0.0f ? p_dis : 0.0f);
  ChargerFlow f;
  f.power = occupied ? power : 0.0f;
  f.soc_new = a > 0.0f ? fminf(calc, 1.0f) : (a < 0.0f ? fmaxf(calc, 0.0f) : soc_eff);
  return f;
}

// BESS physics under action ba (non-inverted discharge flag): updates the
// battery SoC and writes the power used and the DoD penalty into rows.
__device__ __forceinline__ void battery_physics(float ba, float& batt_soc, float dt, PolicyRows& rows) {
  const float p_calc = ba * kBattMaxPEff;
  const float b_calc = batt_soc + (p_calc * dt) / kBattCap;
  const float p_b_dis = b_calc < 0.0f ? -(batt_soc * kBattCap) / dt : p_calc;
  batt_soc = ba > 0.0f ? fminf(b_calc, 1.0f) : (ba < 0.0f ? fmaxf(b_calc, 0.0f) : batt_soc);
  rows.p_used = ba > 0.0f ? p_calc : (ba < 0.0f ? p_b_dis : 0.0f);
  const float gap = (kBattDod - batt_soc) * kGain;
  rows.dod = batt_soc < kBattDod ? gap * gap : 0.0f;
}

// The price/radiation part of the observation at trace offset o; returns
// the index of the first charger row.
template <class C>
__device__ __forceinline__ int observe_traces(int o, const float* rad_norm, const float* price_norm,
                                              float pv_shift, float (&obs)[C::F]) {
  if (C::PV) {
    obs[0] = rad_norm[o] * pv_shift;
    obs[1] = price_norm[o];
#pragma unroll
    for (int i = 1; i < 4; ++i) obs[1 + i] = rad_norm[o + i] * pv_shift;
#pragma unroll
    for (int i = 1; i < 4; ++i) obs[4 + i] = price_norm[o + i];
    return 8;
  }
  obs[0] = price_norm[o];
#pragma unroll
  for (int i = 1; i < 4; ++i) obs[i] = price_norm[o + i];
  return 4;
}

// The trailing day-end observation (t = T, pallas_collect.py:152-175): the
// t > 0 rows with o = T - 1 and the carries after the last step.
template <class C>
__device__ __forceinline__ void final_observe(const Dims& d, const Carry<C>& c, float batt_soc,
                                              const float* rad_norm, const float* price_norm, float pv_shift,
                                              float (&obs)[C::F]) {
  const int base = observe_traces<C>(d.T - 1, rad_norm, price_norm, pv_shift, obs);
#pragma unroll
  for (int n = 0; n < C::N; ++n) {
    obs[base + n] = c.prev_col[n];
    obs[base + C::N + n] = c.prev_depcol[n] / 24.0f;
  }
  if (C::BATT) obs[base + 2 * C::N] = batt_soc;
}

// What the physics half of an actor step needs from its observation half;
// idle_col: the SoC column written for a charger left unoccupied (0 in a
// generated day, the table's column in a given state's).
template <class C>
struct StepState {
  bool occupied[C::N];
  float soc_eff[C::N], cap_eff[C::N], safe_cap[C::N], idle_col[C::N];
};

// The observation half of an actor step (_gen_policy_step): the draws of
// step t, the schedule columns, the observation (F,), the vehicle penalty
// and the generation-carry update.
template <class C, class Src>
__device__ __forceinline__ void observe_step(int t, const Dims& d, const Src& src, Carry<C>& c, float batt_soc,
                                             const float* rad_norm, const float* price_norm, float pv_shift,
                                             float (&obs)[C::F], StepState<C>& st, float (&pen)[C::N]) {
  constexpr int N = C::N;
  StepDraws<C> u;
  u.fill(src, t, d);
  const int o = t > 0 ? t - 1 : 0;
  const int base = observe_traces<C>(o, rad_norm, price_norm, pv_shift, obs);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const Column k = generate_column<C>(t, n, u, c);
    const float pmask = t == 0 ? k.mask_col : c.pmask[n];
    obs[base + n] = t == 0 ? (k.arrives ? k.soc_t : 0.0f) : c.prev_col[n];
    obs[base + N + n] = (t == 0 ? k.dep_col : c.prev_depcol[n]) / 24.0f;
    st.occupied[n] = k.occupied;
    st.soc_eff[n] = k.arrives ? k.soc_t : c.prev_col[n];
    st.idle_col[n] = 0.0f;
    if (C::DIFF_CAPS) {
      st.cap_eff[n] = k.arrives ? k.cap_col : c.prev_capcol[n];
      st.safe_cap[n] = st.cap_eff[n] > 0.0f ? st.cap_eff[n] : 1.0f;
    } else {
      st.cap_eff[n] = k.occ_f * kDefaultCap;
      st.safe_cap[n] = kDefaultCap;
    }
    pen[n] = vehicle_penalty<C>(n, pmask, c);
    advance_carry<C>(n, k, c);
  }
  if (C::BATT) obs[base + 2 * N] = batt_soc;
}

// The physics half (_gen_policy_physics; pallas_policy_rollout.py's for a
// given state): bidirectional charger physics (the inverted discharge flag
// quirk) and the BESS under the action.
template <class C>
__device__ __forceinline__ PolicyRows physics_step(const StepState<C>& st, const float (&act)[C::A], Carry<C>& c,
                                                   float& batt_soc, float dt) {
  float charging = 0.0f, discharging = 0.0f;
#pragma unroll
  for (int n = 0; n < C::N; ++n) {
    const ChargerFlow f = charger_physics(act[n], st.soc_eff[n], st.cap_eff[n], st.safe_cap[n], st.occupied[n], dt);
    c.prev_col[n] = st.occupied[n] ? f.soc_new : st.idle_col[n];
    const float pos = f.power > 0.0f ? f.power : 0.0f;
    const float neg = f.power < 0.0f ? f.power : 0.0f;
    charging = n == 0 ? pos : charging + pos;
    discharging = n == 0 ? neg : discharging + neg;
  }
  PolicyRows rows;
  rows.flows = charging + discharging;
  rows.p_used = 0.0f;
  rows.dod = 0.0f;
  if (C::BATT) battery_physics(act[C::N], batt_soc, dt, rows);
  return rows;
}

// Cost of one actor step without the vehicle penalty (_policy_day_rewards).
template <class C>
__device__ __forceinline__ float policy_cost(const PolicyRows& r, float solar_t, float price_t, float pv_shift,
                                             float dt) {
  const float remaining = C::PV ? r.flows - solar_t * pv_shift : r.flows;
  const float grid_power = C::BATT ? remaining + r.p_used : remaining;
  const float ge = grid_power * dt;
  const float g_cost = ge < 0.0f ? ge * (kSell * price_t) : ge * price_t;
  return kGridW * fabsf(g_cost) + kWBatt * r.dod;
}

// --------------------------------------------------------------- kernels ---

// Shared traces: rad_norm (S), price_norm (P, policy only), price (T), solar (T).
struct SharedTraces {
  float *rad_norm, *price_norm, *price, *solar;
};

__device__ __forceinline__ SharedTraces load_traces(float* smem, const float* rad_norm, int S,
                                                    const float* price_norm, int P, const float* price,
                                                    const float* solar, int T) {
  SharedTraces s;
  s.rad_norm = smem;
  s.price_norm = s.rad_norm + S;
  s.price = s.price_norm + P;
  s.solar = s.price + T;
  for (int i = threadIdx.x; i < S; i += blockDim.x) s.rad_norm[i] = rad_norm[i];
  for (int i = threadIdx.x; i < P; i += blockDim.x) s.price_norm[i] = price_norm[i];
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    s.price[i] = price[i];
    s.solar[i] = solar[i];
  }
  return s;
}

// ------------------------------------------------------------- K8 lanes ---

// K8 gives each env L lanes of a warp.  The full layout takes the least power
// of two (4 to 32) that holds a lane for every charger slot of the env's
// groups of 4; lane j owns charger slots j, j + L, ... (one slot at up to 32
// chargers), draws the Philox blocks of kind position j mod 4 of its slots'
// groups, and a 4 x 4 word transpose within each group of 4 lanes hands every
// charger its words (ops/philox.py::day_uniforms gives the same draws).  L = 1
// is one lane an env: it owns every charger and draws every block itself.
__host__ __device__ constexpr int rbc_lanes_for(int slots) {
  return slots <= 4 ? 4 : slots <= 8 ? 8 : slots <= 16 ? 16 : 32;
}

// Kind of the p-th Philox block of a step: arrival, SoC, then the capacity and
// the requested SoC when configured, then the departure when its window is open.
__host__ __device__ constexpr uint32_t drawn_kind(int p, bool diff_caps, bool req_soc) {
  return p < 2 ? static_cast<uint32_t>(p)
               : p == 2 ? (diff_caps ? 2u : req_soc ? 3u : 4u) : p == 3 ? (diff_caps && req_soc ? 3u : 4u) : 4u;
}

template <class C, int L_>
struct RbcLanes {
  static constexpr int G = (C::N + 3) / 4;            // charger groups: one Philox block of a kind each
  static constexpr int FULL = rbc_lanes_for(4 * G);   // the full layout's lanes
  static constexpr int L = L_;                        // lanes of an env: 1, or a multiple of 4 dividing 32
  static constexpr int SLOTS = L == 1 ? C::N : (4 * G + L - 1) / L;  // charger slots of a lane
  static constexpr int KB = 2 + (C::DIFF_CAPS ? 1 : 0) + (C::REQ_SOC ? 1 : 0);  // kinds drawn every step
  // a lane's chargers: the configuration with SLOTS chargers
  using Lane = Cfg<SLOTS, C::PV, C::BATT, C::PMODE, C::DIFF_CAPS, C::REQ_SOC, C::H1, C::H2>;
  static_assert(L == 1 || (L % 4 == 0 && 32 % L == 0), "an env's lanes: 1, 4, 8, 16 or 32");
};
constexpr int kRbcLaneThreads = 128;  // K8's block: 4 warps

// The Philox blocks of one lane for one step: for each slot, kind position
// j mod 4 of its group, and the departure block when all five kinds are
// drawn (then kept by position 0 only).
template <class C, int L>
struct LaneBlocks {
  uint4 first[RbcLanes<C, L>::SLOTS];
  uint4 second[RbcLanes<C, L>::SLOTS];
};

// Draws step t of `day` for lane j of a multi-lane layout.  Every lane draws a
// block whether or not its kind or group is used that step (a warp issues it
// once either way), so the draws hold no branch and interleave with the
// previous step's physics.
template <class C, int L>
__device__ __forceinline__ void draw_lane_blocks(uint2 key, uint32_t day, int t, int j, LaneBlocks<C, L>& out) {
  using Lay = RbcLanes<C, L>;
  if constexpr (L > 1) {
    const uint32_t kind = drawn_kind(j & 3, C::DIFF_CAPS, C::REQ_SOC);
#pragma unroll
    for (int i = 0; i < Lay::SLOTS; ++i) {
      const uint32_t g = static_cast<uint32_t>((j + i * L) >> 2);
      out.first[i] = philox4x32_10(make_uint4(day, static_cast<uint32_t>(t), kind, g), key);
      if constexpr (Lay::KB == 4)
        out.second[i] = philox4x32_10(make_uint4(day, static_cast<uint32_t>(t), 4u, g), key);
    }
  }
}

__device__ __forceinline__ uint32_t word_of(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, int i) {
  return i == 0 ? w0 : i == 1 ? w1 : i == 2 ? w2 : w3;
}

// Word q (the lane's place in its group of 4 lanes) of the block each lane of
// the group holds: out[s] is lane s's.  Four shuffles: in round r lane q reads
// lane (q + r) mod 4, which sends its word (its place - r) mod 4, that is q.
__device__ __forceinline__ void quad_transpose(const uint4& v, int lane, uint32_t (&out)[4]) {
  const int q = lane & 3;
  uint32_t got[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    got[r] = __shfl_sync(0xffffffffu, word_of(v.x, v.y, v.z, v.w, (q - r) & 3), (lane & ~3) | ((q + r) & 3));
#pragma unroll
  for (int s = 0; s < 4; ++s) out[s] = word_of(got[0], got[1], got[2], got[3], (s - q) & 3);
}

// Word q of the block that lane 0 of the group of 4 holds.
__device__ __forceinline__ uint32_t quad_word_of_first(const uint4& v, int lane) {
  const int src = lane & ~3;
  const uint32_t w0 = __shfl_sync(0xffffffffu, v.x, src), w1 = __shfl_sync(0xffffffffu, v.y, src);
  const uint32_t w2 = __shfl_sync(0xffffffffu, v.z, src), w3 = __shfl_sync(0xffffffffu, v.w, src);
  return word_of(w0, w1, w2, w3, lane & 3);
}

// The uniforms of step t for a lane's chargers: from the group's blocks, or
// drawn by the lane itself at L = 1.
template <class C, int L>
__device__ __forceinline__ void lane_step_draws(const LaneBlocks<C, L>& blk, uint2 key, uint32_t day, int t,
                                                const Dims& d, int lane, StepDraws<typename RbcLanes<C, L>::Lane>& u) {
  using Lay = RbcLanes<C, L>;
  if constexpr (L == 1) {
    u.fill(PhiloxDraws<C::N>{key, day}, t, d);
  } else {
    u.low = t + d.k4;
    u.high = min(t + d.k10, d.T + d.k1);
    const bool dep = u.low < u.high;  // else the no-draw branch: the departure is `low`
#pragma unroll
    for (int i = 0; i < Lay::SLOTS; ++i) {
      uint32_t w[4];
      quad_transpose(blk.first[i], lane, w);
      u.arr[i] = to_uniform(w[0]);
      u.soc[i] = to_uniform(w[1]);
      if (C::DIFF_CAPS) u.cap[i] = to_uniform(w[2]);
      if (C::REQ_SOC) u.req[i] = to_uniform(w[C::DIFF_CAPS ? 3 : 2]);
      if constexpr (Lay::KB == 4) {
        const uint32_t w4 = quad_word_of_first(blk.second[i], lane);
        u.dep[i] = dep ? to_uniform(w4) : 0.0f;
      } else {
        u.dep[i] = dep ? to_uniform(w[Lay::KB]) : 0.0f;
      }
    }
  }
}

// The sum over the env's chargers, in index order, of a per-slot value; every
// lane of the env gets it.
template <class C, int L>
__device__ __forceinline__ float env_sum(const float (&v)[RbcLanes<C, L>::SLOTS], int lane) {
  const int base = lane & ~(L - 1);
  float acc = 0.0f;
#pragma unroll
  for (int n = 0; n < C::N; ++n) {
    const float x = L == 1 ? v[n] : __shfl_sync(0xffffffffu, v[n / L], base + n % L);
    acc = n == 0 ? x : acc + x;
  }
  return acc;
}

// K8: num_days Philox RBC days per env, an env on L lanes; stats (2, B) =
// sum and sum of squares of day returns.
template <class C, int L>
__global__ void __launch_bounds__(kRbcLaneThreads)
    gen_rbc_multiday_kernel(const float* __restrict__ price, const float* __restrict__ rad_norm, int S,
                            const float* __restrict__ solar, uint32_t seed, int num_days,
                            float* __restrict__ stats, int B, Dims d) {
  using Lay = RbcLanes<C, L>;
  using LC = typename Lay::Lane;
  extern __shared__ float smem[];
  const SharedTraces s = load_traces(smem, rad_norm, S, nullptr, 0, price, solar, d.T);
  __syncthreads();
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((thread & ~int64_t{31}) / L >= B) return;  // the warp holds no env of the batch
  const int lane = threadIdx.x & 31, j = lane & (L - 1);
  const int64_t b = thread / L;
  const uint2 key = make_uint2(seed, static_cast<uint32_t>(b));

  const float dod = idle_dod_penalty<C>(kBattInit);
  float rew_total = 0.0f, sq_total = 0.0f;
  Carry<LC> c;
  float power[Lay::SLOTS], pen[Lay::SLOTS], pen_acc[Lay::SLOTS];
  LaneBlocks<C, L> next;
  draw_lane_blocks<C, L>(key, 0u, 0, j, next);
#pragma unroll 1
  for (int day = 0; day < num_days; ++day) {
    const float pv = PhiloxDraws<C::N>{key, static_cast<uint32_t>(day)}.pv_shift(d.T);
    c.clear();
#pragma unroll
    for (int i = 0; i < Lay::SLOTS; ++i) pen_acc[i] = 0.0f;
    float day_sum = 0.0f;
#pragma unroll 1
    for (int t = 0; t < d.T; ++t) {
      StepDraws<LC> u;
      lane_step_draws<C, L>(next, key, static_cast<uint32_t>(day), t, d, lane, u);
      // the next step's draws (the next day's first at the day's end) do not
      // depend on this step's physics
      const bool last = t + 1 == d.T;
      draw_lane_blocks<C, L>(key, static_cast<uint32_t>(last ? day + 1 : day), last ? 0 : t + 1, j, next);
      const float fallback = rbc_fallback<C>(t > 0 ? t - 1 : 0, s.rad_norm, pv);
#pragma unroll
      for (int i = 0; i < Lay::SLOTS; ++i) {
        power[i] = rbc_charger<LC>(t, i, u, c, fallback, d.dt, pen[i]);
        pen_acc[i] = pen_acc[i] + pen[i];
      }
      const float charging = env_sum<C, L>(power, lane);
      const float reward = -rbc_reward<C>(charging, s.solar[t], s.price[t], pv, dod, d.dt);
      day_sum = t == 0 ? reward : day_sum + reward;
    }
    const float pen_total = env_sum<C, L>(pen_acc, lane);
    const float day_return = day_sum - kWVeh * pen_total;
    rew_total = rew_total + day_return;
    sq_total = sq_total + day_return * day_return;
  }
  if (j == 0 && b < B) {
    stats[b] = rew_total;
    stats[static_cast<int64_t>(B) + b] = sq_total;
  }
}

// The actor kinds, NG_ACTOR's values: the PPO actor (tanh torso, the mean
// clipped to the box) and the DDPG actor (ReLU torso, tanh-squashed head).
enum ActorKind : int { kPpoActor = 0, kDdpgActor = 1 };

// ---------------------------------------------------- collection kernels ---
//
// K1/K2 and K9, redesigned for Hopper.  A block takes kCollectEnvs = 32 envs
// and has two kinds of warp.  Warp 0, the env warp, runs the step body once
// per env, one env per lane: the draws, the generation, the observation, the
// physics, the penalty and the trajectory writes, coalesced across envs in
// the (T, ., B) layouts; tail lanes (B not a multiple of 32) mirror the last
// env and write nothing.  The product warps compute the torsos' products for
// the block's envs: each product thread owns an R x V register tile (R output
// rows x V envs) of y[j][e] = act(sum_k w[j][k] x[k][e] + b[j]), reading the
// weights k-major (one float4 holds 4 rows of one k) and the activations
// feature-major (one float4 holds 4 envs of one k) from shared memory, so a
// weight read serves V envs and an activation read R rows.  Every output sums
// k in index order with the product and the add rounded apart (no FMA, no
// split-K): the order of the twin's dense(), so the kernels stay bit-equal to
// their twins.  The head's outputs (A, and K1/K2's value) cannot be split
// over k either; they go over the product threads in 1 x HV tiles, and the
// threads that own them apply the DDPG squash, OU add and clip, or the PPO
// mean, raw action, log-prob term and value.  The two kinds of warp meet at
// two block barriers a step (observations staged; actions ready); the product
// warps meet among themselves between layers.
//
// K1/K2 hold the whole actor-critic in shared memory for the day, turned
// k-major when the block starts, pi's and vf's rows side by side; the critic
// runs while the env warp steps (see K1 / K2 below).  K9's 400-300 actor
// (534 KB) does not fit: the wrapper packs W1 and W2 k-major
// (ops/ddpg_collect.py) and the env warp, idle while the products run,
// streams them through a kRingStages-stage shared-memory ring in chunks of
// kRingRows k-rows, one bulk copy of the Tensor Memory Accelerator a chunk,
// with a full and an empty mbarrier a stage (see WeightRing).  The stream
// runs on across layers and steps (the weights do not change during the
// day), so each weight leaves L2 once per block-step and a step's first
// chunks arrive while the env warp runs the step body.  Both kernels are
// bound by the FMA-free multiply-adds of their products: 2.4e4 operations
// per env-step for K1/K2, 2.7e5 for K9.

constexpr int kCollectEnvs = 32;  // envs per block: one per lane of the env warp
constexpr int kMaxSmemBytes = 232448;      // dynamic shared memory one H100 block may use
constexpr int kTraceReserveBytes = 16384;  // room kept for the traces (S + P + 2T floats)

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The block barrier (every warp) and the product warps' own barrier, in the
// non-aligned form: the env warp and the product warps reach them from
// different code.
__device__ __forceinline__ void sync_block() { asm volatile("barrier.sync 0;" ::: "memory"); }

template <int THREADS>
__device__ __forceinline__ void sync_products() {
  asm volatile("barrier.sync 1, %0;" ::"n"(THREADS) : "memory");
}

template <int KIND>
__device__ __forceinline__ float activate(float v) {
  return KIND == kPpoActor ? tanhf(v) : (v > 0.0f ? v : 0.0f);
}

// N consecutive floats of shared memory as float4s (N a multiple of 4) or float2s.
template <int N>
__device__ __forceinline__ void load_vec(const float* src, float (&dst)[N]) {
  static_assert(N % 2 == 0, "a tile is read as float4s or float2s");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(src + 4 * q);
      dst[4 * q] = f.x;
      dst[4 * q + 1] = f.y;
      dst[4 * q + 2] = f.z;
      dst[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 f = *reinterpret_cast<const float2*>(src + 2 * q);
      dst[2 * q] = f.x;
      dst[2 * q + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      *reinterpret_cast<float4*>(dst + 4 * q) = make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) *reinterpret_cast<float2*>(dst + 2 * q) = make_float2(src[2 * q], src[2 * q + 1]);
  }
}

// A product thread's R x V register tile.
template <int R, int V>
struct Tile {
  static_assert(R % 4 == 0, "a tile's weights are read as float4s");
  float acc[R][V];

  // n k-rows of the k-major weights w (ldw floats a k-row; w points at the
  // tile's first row) against the feature-major activations x (x points at
  // the tile's first env and its first k-row).  `first`: the first k-row is
  // the sum's first term.
  __device__ __forceinline__ void accumulate(const float* w, int ldw, const float* x, int n, bool first) {
    int k = 0;
    if (first) {
      float wv[R], xv[V];
      load_vec(w, wv);
      load_vec(x, xv);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = wv[r] * xv[v];
      k = 1;
    }
#pragma unroll 4
    for (; k < n; ++k) {
      float wv[R], xv[V];
      load_vec(w + k * ldw, wv);
      load_vec(x + k * kCollectEnvs, xv);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = acc[r][v] + wv[r] * xv[v];
    }
  }

  // y[j][e] = act(acc + b[j]) for the tile's rows below J (y points at the
  // tile's first env, feature-major).
  template <int KIND>
  __device__ __forceinline__ void store(const float* bias, int j0, int J, float* y) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = j0 + r;
      if (j >= J) continue;
      float out[V];
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = activate<KIND>(acc[r][v] + bias[j]);
      store_vec(y + j * kCollectEnvs, out);
    }
  }
};

// The env of an env-warp lane: tail lanes mirror the last env and write nothing.
struct CollectLane {
  int64_t b0, b;
  bool active;
  __device__ CollectLane(int B) {
    b0 = static_cast<int64_t>(blockIdx.x) * kCollectEnvs;
    active = b0 + threadIdx.x < B;
    b = active ? b0 + threadIdx.x : static_cast<int64_t>(B) - 1;
  }
};

// The draws of the collection kernels (and K6's block actor) for the thread
// that stores them: explicit (u (T, 5, N, B), K1's normals (T, A, B)) or
// Philox keyed by (seed, b) (K2, K9 seeded: day 0; K6: its day), for env b.
template <class C, bool SEEDED>
struct CollectSource {
  const float *u, *normals;
  uint32_t seed;
  int64_t B;
  uint32_t day = 0;

  __device__ void draw(int64_t b, int t, int kind, float (&out)[C::N]) const {
    if constexpr (SEEDED) {
      PhiloxDraws<C::N>{make_uint2(seed, static_cast<uint32_t>(b)), day}.draw(t, kind, out);
    } else {
      ExplicitDraws<C::N>{u, B, b}.draw(t, kind, out);
    }
  }
  __device__ void normal(int64_t b, int t, float (&out)[C::A]) const {
    if constexpr (SEEDED) {
      PhiloxNormals<C::A>{make_uint2(seed, static_cast<uint32_t>(b))}.draw(t, out);
    } else {
      ExplicitNormals<C::A>{normals, B, b}.draw(t, out);
    }
  }
};

constexpr int kDrawKinds = 5;  // arrival, SoC, capacity, requested SoC, departure

// A step's generation draws of the block's envs in shared memory, two slots
// of (kDrawKinds, N, kCollectEnvs) by the step's parity: the product warps
// store step t + 1's while the env warp reads step t's.
template <class C>
struct SharedDraws {
  float* base;
  __device__ float* slot(int t) const { return base + (t & 1) * kDrawKinds * C::N * kCollectEnvs; }
  // StepDraws' source on the env warp: lane e reads draws[t & 1][kind][n][e]
  __device__ void draw(int t, int kind, float (&out)[C::N]) const {
    const float* d = slot(t) + kind * C::N * kCollectEnvs + threadIdx.x;
#pragma unroll
    for (int n = 0; n < C::N; ++n) out[n] = d[n * kCollectEnvs];
  }
};

// Step t's draws of the block's envs into shared memory (the slot of step
// `slot`, t by default), one thread a (kind, env) (every kind: StepDraws
// reads the ones it needs); with `normals`, K1/K2's action normals too, one
// thread an env, into normals (A, kCollectEnvs).  Tail envs mirror the last env.
template <class C, bool SEEDED, int THREADS>
__device__ __forceinline__ void store_draws(const SharedDraws<C>& draws, float* normals,
                                            const CollectSource<C, SEEDED>& src, int p, int t, int64_t b0,
                                            int slot = -1) {
  constexpr int E = kCollectEnvs, N = C::N, A = C::A;
  const int tasks = (kDrawKinds + (normals != nullptr ? 1 : 0)) * E;
  for (int i = p; i < tasks; i += THREADS) {
    const int kind = i / E, e = i % E;
    const int64_t b = b0 + e < src.B ? b0 + e : src.B - 1;
    if (kind < kDrawKinds) {
      float out[N];
      src.draw(b, t, kind, out);
      float* d = draws.slot(slot < 0 ? t : slot) + kind * N * E + e;
#pragma unroll
      for (int n = 0; n < N; ++n) d[n * E] = out[n];
    } else {
      float out[A];
      src.normal(b, t, out);
#pragma unroll
      for (int a = 0; a < A; ++a) normals[a * E + e] = out[a];
    }
  }
}

// Shared-memory addresses and asynchronous 4-byte copies (K11a's table
// ring, the rings' bulk copies below).
__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One float copied from device to shared memory asynchronously: 4 bytes, or
// zeros when !valid (`src` must still be a valid address).
__device__ __forceinline__ void async_copy_f32(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_address(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most PENDING of this thread's newest commit groups are in flight.
template <int PENDING>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// The seven day tables of a given state, packed (7, T, N, B) f32 by
// ops/rollout.py::state_tables: column t of table k for charger n of env b.
enum TableKind { kOcc = 0, kCapEff, kReqPrev, kSocCols, kIsArr, kDepObs, kPmask, kTables };

// Step t's rows of the seven tables (plane = T N B floats a table) of the
// block's envs into a shared slot (kTables, N, kCollectEnvs), the tables-in
// counterpart of store_draws: one thread a (table, charger, env), so a
// warp's 32 loads are one coalesced line; every load of a thread is issued
// before its first store.  Tail envs mirror the last env (a valid address).
template <class C, int THREADS>
__device__ __forceinline__ void store_tables(float* slot, const float* __restrict__ tables, int64_t plane, int p,
                                             int t, int64_t b0, int64_t B) {
  constexpr int E = kCollectEnvs, N = C::N, ROWS = kTables * N, WARPS = THREADS / E;
  constexpr int ROUNDS = (ROWS + WARPS - 1) / WARPS;
  const int e = p % E, r0 = p / E;
  const float* src = tables + static_cast<int64_t>(t) * N * B + (b0 + e < B ? b0 + e : B - 1);
  float v[ROUNDS];
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int r = r0 + q * WARPS;  // k * N + n
    v[q] = r < ROWS ? __ldg(src + (r / N) * plane + (r % N) * B) : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int r = r0 + q * WARPS;
    if (r < ROWS) slot[r * E + e] = v[q];
  }
}

// The observation half of a tables-in actor step (pallas_policy_rollout.py:
// 40-183), on the env warp: step t's table rows of the lane's env from its
// slot (`row` points at the slot's first row and the lane's env), the
// observation (F,) at o = max(t-1, 0): the SoC rows from the table's column
// 0 at t = 0 and the carried column after, the departure rows from DepObs at
// o (step t-1's kept in c.prev_depcol); the vehicle penalty of the carried
// mask and column (the state's column L-1 at t = 0) against the requested
// SoC row; the next step's mask; and what the physics needs.  Everything of
// the slot is read here, before the block's first barrier of the step.
template <class C>
__device__ __forceinline__ void observe_tables(int t, const float* row, Carry<C>& c, float batt_soc,
                                               const float* rad_norm, const float* price_norm, float pv_shift,
                                               float (&obs)[C::F], StepState<C>& st, float (&pen)[C::N]) {
  constexpr int N = C::N, E = kCollectEnvs;
  const int base = observe_traces<C>(t > 0 ? t - 1 : 0, rad_norm, price_norm, pv_shift, obs);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const auto tab = [&](int k) { return row[(k * N + n) * E]; };
    const float soc_col = tab(kSocCols), dep_t = tab(kDepObs), cap = tab(kCapEff);
    obs[base + n] = t == 0 ? soc_col : c.prev_col[n];
    obs[base + N + n] = (t == 0 ? dep_t : c.prev_depcol[n]) / 24.0f;
    st.occupied[n] = tab(kOcc) > 0.0f;
    st.soc_eff[n] = tab(kIsArr) > 0.0f ? soc_col : c.prev_col[n];
    st.cap_eff[n] = cap;
    st.safe_cap[n] = cap > 0.0f ? cap : 1.0f;
    st.idle_col[n] = soc_col;
    pen[n] = insufficiency_penalty(c.pmask[n], c.prev_col[n], tab(kReqPrev));
    c.pmask[n] = tab(kPmask);  // the trailing observe's mask for the next step
    c.prev_depcol[n] = dep_t;
  }
  if (C::BATT) obs[base + 2 * N] = batt_soc;
}

// ------------------------------------------------------------- K1 / K2 ---
//
// A step of K1/K2 runs in two windows.  Between the block barriers of step t
// the product warps compute pi's torso and head: the env warp needs only the
// action.  After the second barrier the env warp runs the physics of step t
// and the observation of step t + 1 while the product warps compute vf's
// torso and the value of step t, and the draws of step t + 1 (the generation
// uniforms and the action normals, Philox or explicit) into shared memory.
// The observations, normals and draws are double-buffered by the step's
// parity, so that no window reads what the other writes.

constexpr int kPpoProductThreads = 256;  // 8 product warps
constexpr int kPpoCollectThreads = kCollectEnvs + kPpoProductThreads;
constexpr int kPpoTileRows = 4, kPpoTileEnvs = 2, kPpoHeadEnvs = 2;

// K1/K2's shared memory: the actor-critic k-major (pi's rows at [0, P), vf's
// at [P, 2P), pad rows zero), the head rows (A means, then the value), the
// biases, log_std and the box, then the block's activations and draws.
template <class C>
struct PpoCollectShared {
  static constexpr int E = kCollectEnvs, A = C::A, N = C::N;
  static constexpr int P1 = round_up(C::H1, kPpoTileRows), P2 = round_up(C::H2, kPpoTileRows);
  static constexpr int HEAD_LD = C::H2 + 1;  // odd: a warp's two head rows sit in different banks
  static constexpr int FLOATS = C::F * 2 * P1 + C::H1 * 2 * P2 + (2 * C::F + 2 * P1 + 2 * P2) * E +
                                (A + 1) * HEAD_LD + 2 * P1 + 2 * P2 + (A + 1) + 3 * A + 4 * A * E +
                                2 * kDrawKinds * N * E;
  float *w1, *w2, *xs, *h1, *h2, *head, *b1, *b2, *b3, *log_std, *low, *high, *noise, *term, *act, *draws;

  __device__ explicit PpoCollectShared(float* s) {
    w1 = s;  // (F, 2 P1), then every vector-read array at a multiple of 4 floats
    w2 = w1 + C::F * 2 * P1;
    xs = w2 + C::H1 * 2 * P2;  // two slots of (F, E)
    h1 = xs + 2 * C::F * E;
    h2 = h1 + 2 * P1 * E;
    head = h2 + 2 * P2 * E;
    b1 = head + (A + 1) * HEAD_LD;
    b2 = b1 + 2 * P1;
    b3 = b2 + 2 * P2;
    log_std = b3 + A + 1;
    low = log_std + A;
    high = low + A;
    noise = high + A;  // two slots of (A, E)
    term = noise + 2 * A * E;
    act = term + A * E;
    draws = act + A * E;  // two slots of (kDrawKinds, N, E)
  }

  __device__ float* obs_slot(int t) const { return xs + (t & 1) * C::F * E; }
  __device__ float* noise_slot(int t) const { return noise + (t & 1) * A * E; }

  // The packed block (layout of Cfg::COLLECT_WEIGHTS) into the layout above.
  __device__ void load(const float* weights) const {
    const Actor<C> pi(weights);
    const Critic<C> vf(weights + C::WEIGHTS);
    for (int i = threadIdx.x; i < C::F * 2 * P1; i += blockDim.x) {
      const int k = i / (2 * P1), j = i % (2 * P1), r = j % P1;
      w1[i] = r < C::H1 ? (j < P1 ? pi.w1 : vf.w1)[r * C::F + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < C::H1 * 2 * P2; i += blockDim.x) {
      const int k = i / (2 * P2), j = i % (2 * P2), r = j % P2;
      w2[i] = r < C::H2 ? (j < P2 ? pi.w2 : vf.w2)[r * C::H1 + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < (A + 1) * C::H2; i += blockDim.x) {
      const int a = i / C::H2, k = i % C::H2;
      head[a * HEAD_LD + k] = a < A ? pi.w3[a * C::H2 + k] : vf.w3[k];
    }
    for (int j = threadIdx.x; j < 2 * P1; j += blockDim.x) {
      const int r = j % P1;
      b1[j] = r < C::H1 ? (j < P1 ? pi.b1 : vf.b1)[r] : 0.0f;
    }
    for (int j = threadIdx.x; j < 2 * P2; j += blockDim.x) {
      const int r = j % P2;
      b2[j] = r < C::H2 ? (j < P2 ? pi.b2 : vf.b2)[r] : 0.0f;
    }
    for (int a = threadIdx.x; a < A + 1; a += blockDim.x) b3[a] = a < A ? pi.b3[a] : vf.b3[0];
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      log_std[a] = weights[C::WEIGHTS + C::VF_WEIGHTS + a];
      low[a] = pi.low[a];
      high[a] = pi.high[a];
    }
  }
};

// One torso's hidden layers over the step's observations (side 0: pi,
// side 1: vf), R x V tiles over the product threads.
template <class C>
__device__ __forceinline__ void ppo_torso(const PpoCollectShared<C>& s, int p, int t, int side) {
  using S = PpoCollectShared<C>;
  constexpr int E = kCollectEnvs, R = kPpoTileRows, V = kPpoTileEnvs, EG = E / V;
  for (int i = p; i < (S::P1 / R) * EG; i += kPpoProductThreads) {
    const int j0 = side * S::P1 + (i / EG) * R, e0 = (i % EG) * V;
    Tile<R, V> tile;
    tile.accumulate(s.w1 + j0, 2 * S::P1, s.obs_slot(t) + e0, C::F, true);
    tile.template store<kPpoActor>(s.b1, j0, 2 * S::P1, s.h1 + e0);
  }
  sync_products<kPpoProductThreads>();
  for (int i = p; i < (S::P2 / R) * EG; i += kPpoProductThreads) {
    const int j0 = side * S::P2 + (i / EG) * R, e0 = (i % EG) * V;
    Tile<R, V> tile;
    tile.accumulate(s.w2 + j0, 2 * S::P2, s.h1 + side * S::P1 * E + e0, C::H1, true);
    tile.template store<kPpoActor>(s.b2, j0, 2 * S::P2, s.h2 + e0);
  }
  sync_products<kPpoProductThreads>();
}

// Head row a's sums (a < A: pi's means, a = A: vf's value) for HV envs from e0.
template <class C, int HV>
__device__ __forceinline__ void ppo_head_row(const PpoCollectShared<C>& s, int a, int e0, float (&out)[HV]) {
  using S = PpoCollectShared<C>;
  constexpr int E = kCollectEnvs;
  const float* w = s.head + a * S::HEAD_LD;
  const float* x = s.h2 + (a < C::A ? 0 : S::P2 * E) + e0;
  float acc[HV];
#pragma unroll
  for (int v = 0; v < HV; ++v) acc[v] = w[0] * x[v];
#pragma unroll 16
  for (int k = 1; k < C::H2; ++k)
#pragma unroll
    for (int v = 0; v < HV; ++v) acc[v] = acc[v] + w[k] * x[k * E + v];
#pragma unroll
  for (int v = 0; v < HV; ++v) out[v] = acc[v] + s.b3[a];
}

// The product warps' first window of step t: pi's torso and head.  The
// head's owners write a_raw (T, A, B) and leave the clipped action and each
// action's log-prob term in shared memory for the env warp.
template <class C>
__device__ __forceinline__ void ppo_policy_products(const PpoCollectShared<C>& s, int p, int t, float* act_out,
                                                    int64_t B, int64_t b0) {
  constexpr int E = kCollectEnvs, A = C::A, HV = kPpoHeadEnvs, HG = E / HV;
  ppo_torso<C>(s, p, t, 0);
  const float* noise = s.noise_slot(t);
  for (int i = p; i < A * HG; i += kPpoProductThreads) {
    const int a = i / HG, e0 = (i % HG) * HV;
    float mean[HV];
    ppo_head_row<C, HV>(s, a, e0, mean);
#pragma unroll
    for (int v = 0; v < HV; ++v) {
      const int e = e0 + v;
      const float sd = expf(s.log_std[a]);
      const float a_raw = mean[v] + sd * noise[a * E + e];
      const float diff = a_raw - mean[v];
      const float var = sd * sd;
      s.term[a * E + e] = -0.5f * (diff * diff / var + 2.0f * s.log_std[a] + kLog2Pi);
      s.act[a * E + e] = fminf(fmaxf(a_raw, s.low[a]), s.high[a]);
      if (b0 + e < B) act_out[(static_cast<int64_t>(t) * A + a) * B + b0 + e] = a_raw;
    }
  }
}

// The product warps' second window of step t: vf's torso and the value (T, B).
template <class C>
__device__ __forceinline__ void ppo_value_products(const PpoCollectShared<C>& s, int p, int t, float* val_out,
                                                   int64_t B, int64_t b0) {
  ppo_torso<C>(s, p, t, 1);
  if (p < kCollectEnvs) {
    float value[1];
    ppo_head_row<C, 1>(s, C::A, p, value);
    if (b0 + p < B) val_out[static_cast<int64_t>(t) * B + b0 + p] = value[0];
  }
}

// The env warp's collection day (K1/K2): per step the observation into
// shared memory and obs (T, F, B); after the policy the log-prob (T, B), the
// physics and the reward (T, B).
template <class C>
__device__ __forceinline__ void ppo_env_day(const Dims& d, float pv, float batt, const SharedTraces& tr,
                                            const PpoCollectShared<C>& s, const CollectLane& l, float* obs_out,
                                            float* logp_out, float* rew_out, float* batt_out, int64_t B) {
  constexpr int E = kCollectEnvs;
  const int lane = threadIdx.x;
  const SharedDraws<C> src{s.draws};
  Carry<C> c;
  c.clear();
#pragma unroll 1
  for (int t = 0; t < d.T; ++t) {
    float obs[C::F], pen[C::N];
    StepState<C> st;
    observe_step<C>(t, d, src, c, batt, tr.rad_norm, tr.price_norm, pv, obs, st, pen);
    float* xs = s.obs_slot(t);
#pragma unroll
    for (int f = 0; f < C::F; ++f) xs[f * E + lane] = obs[f];
    if (l.active) {
#pragma unroll
      for (int f = 0; f < C::F; ++f) obs_out[(static_cast<int64_t>(t) * C::F + f) * B + l.b] = obs[f];
    }
    sync_block();  // the observations are staged
    sync_block();  // the policy is done
    float act[C::A], logp = 0.0f;
#pragma unroll
    for (int a = 0; a < C::A; ++a) {
      act[a] = s.act[a * E + lane];
      const float term = s.term[a * E + lane];
      logp = a == 0 ? term : logp + term;
    }
    const PolicyRows r = physics_step<C>(st, act, c, batt, d.dt);
    if (!l.active) continue;
    float pen_sum = pen[0];
#pragma unroll
    for (int n = 1; n < C::N; ++n) pen_sum = pen_sum + pen[n];
    const float cost = policy_cost<C>(r, tr.solar[t], tr.price[t], pv, d.dt) + kWVeh * pen_sum;
    logp_out[static_cast<int64_t>(t) * B + l.b] = logp;
    rew_out[static_cast<int64_t>(t) * B + l.b] = -cost;
  }
  if (l.active) batt_out[l.b] = batt;
}

// K1 (SEEDED false): explicit uniforms u (T, 5, N, B), normals (T, A, B) and
// pv_shift (B,).  K2 (SEEDED true): every draw from Philox keyed by (seed, b).
// Outputs obs (T, F, B), act_raw (T, A, B), logp/value/rewards (T, B), batt (B).
// A block of kPpoCollectThreads threads per kCollectEnvs envs.
template <class C, bool SEEDED>
__global__ void __launch_bounds__(kPpoCollectThreads)
ppo_collect_day_kernel(const float* __restrict__ price, const float* __restrict__ price_norm, int P,
                       const float* __restrict__ rad_norm, int S, const float* __restrict__ solar,
                       const float* __restrict__ u, const float* __restrict__ normals, uint32_t seed,
                       const float* __restrict__ batt_soc, const float* __restrict__ pv_shift,
                       const float* __restrict__ weights, float* __restrict__ obs_out, float* __restrict__ act_out,
                       float* __restrict__ logp_out, float* __restrict__ val_out, float* __restrict__ rew_out,
                       float* __restrict__ batt_out, int B, Dims d) {
  extern __shared__ float4 collect_smem[];
  float* smem = reinterpret_cast<float*>(collect_smem);
  const PpoCollectShared<C> s(smem);
  s.load(weights);
  const SharedTraces tr =
      load_traces(smem + PpoCollectShared<C>::FLOATS, rad_norm, S, price_norm, P, price, solar, d.T);
  const CollectLane l(B);
  const CollectSource<C, SEEDED> src{u, normals, seed, B};
  const SharedDraws<C> draws{s.draws};
  store_draws<C, SEEDED, kPpoCollectThreads>(draws, s.noise_slot(0), src, threadIdx.x, 0, l.b0);
  __syncthreads();
  if (threadIdx.x >= kCollectEnvs) {
    const int p = threadIdx.x - kCollectEnvs;
#pragma unroll 1
    for (int t = 0; t < d.T; ++t) {
      if (t + 1 < d.T) store_draws<C, SEEDED, kPpoProductThreads>(draws, s.noise_slot(t + 1), src, p, t + 1, l.b0);
      if (t > 0) ppo_value_products<C>(s, p, t - 1, val_out, B, l.b0);
      sync_block();
      ppo_policy_products<C>(s, p, t, act_out, B, l.b0);
      sync_block();
    }
    ppo_value_products<C>(s, p, d.T - 1, val_out, B, l.b0);
    return;
  }
  float pv;
  if constexpr (SEEDED) {
    pv = collect_pv_shift(make_uint2(seed, static_cast<uint32_t>(l.b)));
  } else {
    pv = pv_shift[l.b];
  }
  ppo_env_day<C>(d, pv, batt_soc[l.b], tr, s, l, obs_out, logp_out, rew_out, batt_out, B);
}

// ------------------------------------------------------------------ K9 ---

constexpr int kDdpgProductThreads = 352;  // 11 product warps (K9 and K6's block actor)
constexpr int kDdpgCollectThreads = kCollectEnvs + kDdpgProductThreads;
constexpr int kRingStages = 3;  // K9's chunks in shared memory: one summed, two in flight
constexpr int kRingRows = 16;   // k-rows of a chunk of K9

// One bulk copy by the Tensor Memory Accelerator (16-byte aligned, a multiple
// of 16 bytes), completing on `bar` by its bytes.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(smem_address(dst)), "l"(src), "r"(bytes), "r"(smem_address(bar))
               : "memory");
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_address(bar)), "r"(count) : "memory");
}

// Arrive on `bar` and expect `bytes` more of bulk copies in its phase.
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%1], %0;" ::"r"(bytes), "r"(smem_address(bar)) : "memory");
}

__device__ __forceinline__ void mbarrier_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\tmbarrier.arrive.shared.b64 state, [%0];\n\t}"
               ::"r"(smem_address(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\tWAIT:\n\tmbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n\t@!done bra WAIT;\n\t}"
      ::"r"(smem_address(bar)), "r"(parity) : "memory");
}

// Block 0's step record of K6's block actor, kept only in a build with
// -DNGK_K6_CLOCK=1 (tools/profile_k6.py): %globaltimer at the borders of
// each step's parts and the product thread 0's time spent waiting for chunks.
#ifdef NGK_K6_CLOCK
constexpr int kK6ClockSlots = 8, kK6ClockSteps = 64;
__device__ unsigned long long k6_clock[kK6ClockSteps * kK6ClockSlots];
__device__ unsigned long long k6_ring_wait;

__device__ __forceinline__ unsigned long long k6_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}
#endif

__device__ __forceinline__ void k6_stamp(int slot, int step) {
#ifdef NGK_K6_CLOCK
  if (blockIdx.x == 0 && step < kK6ClockSteps) k6_clock[step * kK6ClockSlots + slot] = k6_now();
#endif
}

// The f32 weight stream of a ring actor (K9, K6's block actor).  The packed
// block (ops/gen_policy_rollout.py::ring_block): W1 k-major (F, P1) and W2
// k-major (H1, P2), each k-row padded with zeros to whole tiles of its layer
// (R1 and R2 rows), so that ROWS k-rows are one contiguous bulk copy; then
// b1, b2, W3 (A, H2), b3, low, high.  Chunk c of a step (c < NC1: W1's, else
// W2's) starts at float chunk_offset(c) of the block.  A product thread owns
// R x V register tiles, TILES of a layer over ROUNDS rounds.  The ring has
// STAGES stages; with a stage for every chunk of a step (RESIDENT) the
// weights are copied once.
template <class C, int R1_, int V1_, int R2_, int V2_, int ROWS_, int STAGES_ = kRingStages>
struct F32Ring {
  using Config = C;
  static constexpr int E = kCollectEnvs, A = C::A;
  static constexpr int R1 = R1_, V1 = V1_, R2 = R2_, V2 = V2_, ROWS = ROWS_;
  static constexpr int P1 = round_up(C::H1, R1), P2 = round_up(C::H2, R2);  // a layer's k-row in the ring
  static constexpr int STAGE = ROWS * (P1 > P2 ? P1 : P2);
  static constexpr int NC1 = (C::F + ROWS - 1) / ROWS, NC2 = (C::H1 + ROWS - 1) / ROWS;
  static constexpr int NC = NC1 + NC2;  // chunks a step
  static constexpr int STAGES = STAGES_;
  static constexpr bool RESIDENT = STAGES == NC;
  static constexpr int TILES1 = (P1 / R1) * (E / V1), TILES2 = (P2 / R2) * (E / V2);
  static constexpr int ROUNDS1 = (TILES1 + kDdpgProductThreads - 1) / kDdpgProductThreads;
  static constexpr int ROUNDS2 = (TILES2 + kDdpgProductThreads - 1) / kDdpgProductThreads;
  static constexpr int W2 = C::F * P1, B1 = W2 + C::H1 * P2, B2 = B1 + C::H1, W3 = B2 + C::H2;
  static constexpr int BLOCK = W3 + A * C::H2 + 3 * A;  // the packed block's floats
  static constexpr int XS = C::F * E, H1S = P1 * E, H2S = P2 * E;  // activations, feature-major f32
  static_assert(P1 % 4 == 0 && P2 % 4 == 0, "a chunk and its start are whole 16-byte units");

  __device__ static int chunk_offset(int c) { return c < NC1 ? c * ROWS * P1 : W2 + (c - NC1) * ROWS * P2; }
  __device__ static int chunk_floats(int c) {
    return c < NC1 ? min(ROWS, C::F - c * ROWS) * P1 : min(ROWS, C::H1 - (c - NC1) * ROWS) * P2;
  }
};

// Shared memory of a ring actor before its kernel's own arrays: the ring's
// barriers (a full and an empty mbarrier, 8 bytes each, a stage) and stages,
// the activations, the head, the biases and the actions.
template <class G>
constexpr int ring_shared_floats() {
  using C = typename G::Config;
  return 4 * G::STAGES + G::STAGES * G::STAGE + G::XS + G::H1S + G::H2S + C::A * C::H2 + C::H1 + C::H2 +
         3 * C::A + C::A * kCollectEnvs;
}

// K9's geometry: 400-300: 200 tiles in one round, 600 in two, so that each of
// the 4 schedulers carries at most 5 tile-rounds of 16 outputs in layer 2 (the
// env warp sits on scheduler 0 beside 2 product warps); then the draws.
template <class C>
struct DdpgCollect : F32Ring<C, 8, 8, 4, 4, kRingRows> {
  using G = F32Ring<C, 8, 8, 4, 4, kRingRows>;
  static constexpr int FLOATS = ring_shared_floats<G>() + 2 * kDrawKinds * C::N * kCollectEnvs;
};

// A ring actor's shared memory (layout of ring_shared_floats): the ring's
// barriers and stages, the activations, W3, the biases, the box and the
// actions; `end` is the first float after them.
template <class G>
struct RingShared {
  using C = typename G::Config;
  uint64_t *full, *empty;
  float *ring, *xs, *h1, *h2, *w3, *b1, *b2, *b3, *low, *high, *act;

  __device__ explicit RingShared(float* s) {
    full = reinterpret_cast<uint64_t*>(s);
    empty = full + G::STAGES;
    ring = s + 4 * G::STAGES;
    xs = ring + G::STAGES * G::STAGE;
    h1 = xs + G::XS;
    h2 = h1 + G::H1S;
    w3 = h2 + G::H2S;
    b1 = w3 + C::A * C::H2;
    b2 = b1 + C::H1;
    b3 = b2 + C::H2;
    low = b3 + C::A;
    high = low + C::A;
    act = high + C::A;
  }

  __device__ float* end() const { return act + C::A * kCollectEnvs; }

  __device__ void load(const float* weights) const {
    for (int i = threadIdx.x; i < C::A * C::H2; i += blockDim.x) w3[i] = weights[G::W3 + i];
    for (int i = threadIdx.x; i < C::H1; i += blockDim.x) b1[i] = weights[G::B1 + i];
    for (int i = threadIdx.x; i < C::H2; i += blockDim.x) b2[i] = weights[G::B2 + i];
    for (int i = threadIdx.x; i < C::A; i += blockDim.x) {
      b3[i] = weights[G::W3 + C::A * C::H2 + i];
      low[i] = weights[G::W3 + C::A * C::H2 + C::A + i];
      high[i] = weights[G::W3 + C::A * C::H2 + 2 * C::A + i];
    }
  }
};

// The weight stream of a ring actor (G: its geometry): chunk g of the launch
// (g mod NC: the first NC1 chunks of a step are W1's, the rest W2's) goes to
// stage g mod STAGES.  The env warp fills the ring, while the product
// warps compute: its lane 0 issues one bulk copy a chunk (the Tensor Memory
// Accelerator) completing on the stage's `full` mbarrier by its bytes.  Each
// product warp waits on `full`, sums the chunk and arrives on the stage's
// `empty` mbarrier; the env warp waits on `empty` before it refills the
// stage.  So the product warps never wait for each other inside a layer:
// they drift apart by up to STAGES - 1 chunks.  A RESIDENT ring (a stage
// for every chunk of a step) copies each chunk once: its first use waits on
// `full`, and later uses read the stage without waiting.
template <class G>
struct WeightRing {
  const float* weights;
  float* stages;
  uint64_t *full, *empty;

  // One thread, before the block's first barrier; the fence makes the
  // initialised barriers visible to the bulk copies' completions.
  __device__ void init() const {
    for (int q = 0; q < G::STAGES; ++q) {
      mbarrier_init(full + q, 1);
      mbarrier_init(empty + q, kDdpgProductThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // The env warp: chunk g into its stage, once the stage's previous chunk is summed.
  __device__ __forceinline__ void fill(int g) const {
    if (G::RESIDENT && g >= G::NC) return;
    const int stage = g % G::STAGES, use = g / G::STAGES, c = g % G::NC;
    if (use > 0) mbarrier_wait(empty + stage, (use - 1) & 1);
    if (threadIdx.x != 0) return;
    const unsigned bytes = static_cast<unsigned>(G::chunk_floats(c) * sizeof(float));
    mbarrier_arrive_expect_tx(full + stage, bytes);
    bulk_copy(stages + stage * G::STAGE, weights + G::chunk_offset(c), bytes, full + stage);
  }

  // A product warp: chunk g once it has landed, and the stage handed back.
  // A resident chunk stays in its stage: only its first use waits.
  __device__ __forceinline__ const float* acquire(int g) const {
    if (!G::RESIDENT || g < G::NC) {
#ifdef NGK_K6_CLOCK
      const unsigned long long since = k6_now();
#endif
      mbarrier_wait(full + g % G::STAGES, G::RESIDENT ? 0 : (g / G::STAGES) & 1);
#ifdef NGK_K6_CLOCK
      if (blockIdx.x == 0 && threadIdx.x == kCollectEnvs) k6_ring_wait += k6_now() - since;
#endif
    }
    return stages + (g % G::STAGES) * G::STAGE;
  }
  __device__ __forceinline__ void release(int g) const {
    if (G::RESIDENT) return;
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbarrier_arrive(empty + g % G::STAGES);
  }
};

// One f32 layer through the ring: the J x K product of the k-major weight
// chunks (LD floats a k-row in the ring) against x (K, E), activation KIND,
// into y; p is the product thread's index.
template <int KIND, class G, int R, int V, int ROUNDS, int TILES, int J, int K, int LD>
__device__ __forceinline__ void ring_layer(const WeightRing<G>& ring, int& g, int p, const float* x,
                                           const float* bias, float* y) {
  constexpr int EG = kCollectEnvs / V;
  Tile<R, V> tiles[ROUNDS];
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += G::ROWS, ++g) {
    const float* stage = ring.acquire(g);
    const int n = min(G::ROWS, K - k0);
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) {
      const int i = p + q * kDdpgProductThreads;
      if (i < TILES)
        tiles[q].accumulate(stage + (i / EG) * R, LD, x + k0 * kCollectEnvs + (i % EG) * V, n, k0 == 0);
    }
    ring.release(g);
  }
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int i = p + q * kDdpgProductThreads;
    if (i < TILES) tiles[q].template store<KIND>(bias, (i / EG) * R, J, y + (i % EG) * V);
  }
  sync_products<kDdpgProductThreads>();
}

// The product warps' part of K9's step t (p: the product thread's index):
// both hidden layers through the ring, then the head, whose owners squash it, add the step's OU noise,
// clip, and write the action (T, A, B) and into shared memory.
template <class C>
__device__ __forceinline__ void ddpg_products(const RingShared<DdpgCollect<C>>& s,
                                              const WeightRing<DdpgCollect<C>>& ring, int& g, int p, int t,
                                              const float* ou, float* act_out, int64_t B, int64_t b0) {
  using G = DdpgCollect<C>;
  constexpr int E = kCollectEnvs, A = C::A;
  ring_layer<kDdpgActor, G, G::R1, G::V1, G::ROUNDS1, G::TILES1, C::H1, C::F, G::P1>(ring, g, p, s.xs, s.b1, s.h1);
  ring_layer<kDdpgActor, G, G::R2, G::V2, G::ROUNDS2, G::TILES2, C::H2, C::H1, G::P2>(ring, g, p, s.h1, s.b2, s.h2);
  for (int i = p; i < A * E; i += kDdpgProductThreads) {
    const int a = i / E, e = i % E;
    const float* w = s.w3 + a * C::H2;
    float acc = w[0] * s.h2[e];
#pragma unroll 16
    for (int k = 1; k < C::H2; ++k) acc = acc + w[k] * s.h2[k * E + e];
    const float mu = acc + s.b3[a];
    const float lo = s.low[a], hi = s.high[a];
    const int64_t be = b0 + e < B ? b0 + e : B - 1;
    const float v = lo + ((tanhf(mu) + 1.0f) * 0.5f) * (hi - lo);
    const float clipped = fminf(fmaxf(v + ou[(static_cast<int64_t>(t) * A + a) * B + be], lo), hi);
    s.act[a * E + e] = clipped;
    if (b0 + e < B) act_out[(static_cast<int64_t>(t) * A + a) * B + b0 + e] = clipped;
  }
}

// K9 (SEEDED false): explicit uniforms u (T, 5, N, B) and pv_shift (B,).
// K9 seeded: the day's uniforms and PV shift from Philox keyed by (seed, b),
// with K2's kinds (day 0, kinds 0-4 and 7), so that K2 and K9 generate the
// same days at the same seed.  The OU noise ou (T, A, B) is explicit in both.
// Outputs obs (T, F, B), the clipped action (T, A, B), rewards (T, B),
// next_obs (T, F, B) (next_obs[t] = obs[t+1], the day-end observe at T-1)
// and batt (B).  A block of kDdpgCollectThreads threads per kCollectEnvs envs.
template <class C, bool SEEDED>
__global__ void __launch_bounds__(kDdpgCollectThreads)
ddpg_collect_day_kernel(const float* __restrict__ price, const float* __restrict__ price_norm, int P,
                        const float* __restrict__ rad_norm, int S, const float* __restrict__ solar,
                        const float* __restrict__ u, uint32_t seed, const float* __restrict__ ou,
                        const float* __restrict__ batt_soc, const float* __restrict__ pv_shift,
                        const float* __restrict__ weights, float* __restrict__ obs_out,
                        float* __restrict__ act_out, float* __restrict__ rew_out, float* __restrict__ next_out,
                        float* __restrict__ batt_out, int B, Dims d) {
  using G = DdpgCollect<C>;
  constexpr int E = kCollectEnvs;
  extern __shared__ float4 collect_smem[];
  float* smem = reinterpret_cast<float*>(collect_smem);
  const RingShared<G> s(smem);
  s.load(weights);
  const SharedTraces tr = load_traces(smem + G::FLOATS, rad_norm, S, price_norm, P, price, solar, d.T);
  const CollectLane l(B);
  const SharedDraws<C> draws{s.end()};
  const CollectSource<C, SEEDED> src{u, nullptr, seed, B};
  const WeightRing<G> ring{weights, s.ring, s.full, s.empty};
  if (threadIdx.x == 0) ring.init();
  store_draws<C, SEEDED, kDdpgCollectThreads>(draws, nullptr, src, threadIdx.x, 0, l.b0);
  __syncthreads();
  if (threadIdx.x >= kCollectEnvs) {
    const int p = threadIdx.x - kCollectEnvs;
    int g = 0;
#pragma unroll 1
    for (int t = 0; t < d.T; ++t) {
      if (t + 1 < d.T) store_draws<C, SEEDED, kDdpgProductThreads>(draws, nullptr, src, p, t + 1, l.b0);
      sync_block();
      ddpg_products<C>(s, ring, g, p, t, ou, act_out, B, l.b0);
      sync_block();
    }
    return;
  }
  // the env warp fills the ring ahead of the products: the first chunks now,
  // each step's others (and the next step's first) while the products sum
  int filled = 0;
  for (; filled < G::STAGES - 1; ++filled) ring.fill(filled);
  const int lane = threadIdx.x;
  float pv;
  if constexpr (SEEDED) {
    pv = collect_pv_shift(make_uint2(seed, static_cast<uint32_t>(l.b)));
  } else {
    pv = pv_shift[l.b];
  }
  float batt = batt_soc[l.b];
  Carry<C> c;
  c.clear();
#pragma unroll 1
  for (int t = 0; t < d.T; ++t) {
    float obs[C::F], pen[C::N];
    StepState<C> st;
    observe_step<C>(t, d, draws, c, batt, tr.rad_norm, tr.price_norm, pv, obs, st, pen);
#pragma unroll
    for (int f = 0; f < C::F; ++f) s.xs[f * E + lane] = obs[f];
    if (l.active) {
#pragma unroll
      for (int f = 0; f < C::F; ++f) {
        obs_out[(static_cast<int64_t>(t) * C::F + f) * B + l.b] = obs[f];
        if (t > 0) next_out[(static_cast<int64_t>(t - 1) * C::F + f) * B + l.b] = obs[f];
      }
    }
    sync_block();  // the observations are staged
#pragma unroll 1
    for (; filled < min((t + 1) * G::NC + G::STAGES - 1, d.T * G::NC); ++filled)
      ring.fill(filled);  // no chunk beyond the day
    sync_block();  // the actions are ready
    float act[C::A];
#pragma unroll
    for (int a = 0; a < C::A; ++a) act[a] = s.act[a * E + lane];
    const PolicyRows r = physics_step<C>(st, act, c, batt, d.dt);
    if (!l.active) continue;
    float pen_sum = pen[0];
#pragma unroll
    for (int n = 1; n < C::N; ++n) pen_sum = pen_sum + pen[n];
    const float cost = policy_cost<C>(r, tr.solar[t], tr.price[t], pv, d.dt) + kWVeh * pen_sum;
    rew_out[static_cast<int64_t>(t) * B + l.b] = -cost;
  }
  if (!l.active) return;
  float obs[C::F];
  final_observe<C>(d, c, batt, tr.rad_norm, tr.price_norm, pv, obs);
#pragma unroll
  for (int f = 0; f < C::F; ++f) next_out[(static_cast<int64_t>(d.T - 1) * C::F + f) * B + l.b] = obs[f];
  batt_out[l.b] = batt;
}

// --------------------------------------------------- K6 and K5 block actor ---
//
// K6 (pallas_gen_policy_rollout.py::pallas_gen_policy_multiday) for every
// torso: the PPO actor (the 64x64 torso of the artifacts and the bench's
// 256x256) and the DDPG 400-300 ReLU actor (actor="ddpg"); K5
// (::pallas_gen_policy_day) for the same actors; and K11b
// (pallas_policy_rollout.py::pallas_policy_day_rollout) for every PPO torso.
// One template, block_actor_days, runs all three, its source of the day a
// parameter (DaySource): K6's Philox days and stats, K5's one
// explicit-uniform day and its trajectory, or K11b's day of a given state
// read from its seven tables and its trajectory.  K9's block: 32 envs, warp
// 0 the env warp and the ring's producer, 11 product warps, the weights streamed through the ring (they
// never change within a launch, so the stream runs on across layers, steps
// and days), two block barriers a step.  The env warp runs the step body
// once per env, keeping the carried battery, the penalty sums and the day's
// return in its lanes' registers; K6 writes stats (3, B) once, K5 each step's
// reward (T, B) and action (T, A, B), coalesced across envs, and then
// soc_final (N, B) and batt_final (B).  Its draws (K6: Philox keyed by
// (seed, b), counter (day, t, kind, group); K5: the uniforms u (T, 5, N, B))
// come from shared memory, where the product warps store the next step's
// while the env warp observes, as in K9.  K11b's product warps store the
// next step's rows of the seven tables there instead, 7 N a step of each
// env (coalesced across the block's envs: store_tables), and its env warp
// reads them all before the step's first barrier (observe_tables), keeping
// the carried SoC column, penalty mask and the previous step's departure row
// in registers: the physics then runs K5's body (physics_step), the unoccupied
// chargers taking the table's column.  The table slots are 7/5 of the draw
// slots (day_slot_floats), and the layout's chunk and stages are chosen for
// each instance with its own slots (K6<C, BF16, SOURCE>).  The head's owners
// write the clipped PPO mean or the DDPG squash.
//
// f32: R x V register tiles (Tile) as K9, every output's sum over k in index
// order with the product and the add rounded apart, so the kernels are
// bit-equal to gen_policy_multiday_plain, gen_policy_day_plain and
// policy_day_rollout_plain.  Bound:
// the torso's multiply-adds, 2.6e5 (400-300), 1.5e5 (256x256) or 1.2e4
// (64x64) flops per env-step, at the FMA-free issue rate of its SM
// (bit-equality forbids the FMA); a 64x64 step is short enough that the env
// warp's step body and the barriers take most of it.
//
// bf16 (K6's mlp_dtype): the hidden layers on the tensor cores,
// mma.m16n8k16 with rows the output units, columns 8 envs and k 16 inputs,
// f32 accumulators: W1 and W2 are packed as bf16 A fragments (2 bytes a weight, half the f32
// stream: ops/gen_policy_rollout.py::mma_fragments), the observation, h1 and
// h2 rounded to bf16 as they are stored (as pairs of consecutive inputs, the
// B fragments' words); biases and activations stay f32, and the head is a
// scalar f32 sum of bf16 operands.  Its accumulation order is not the
// twin's, so it states a tolerance (tests/test_torch_cuda.py).  The stream,
// 240 KB a step for the 400-300 W2 from L2 into each of the 128 blocks at
// B = 4096, goes through the same ring, with as many stages as shared memory
// holds (k6_stages_from: 5 for the DDPG actor); the 256x256 torso's bf16 W1
// and W2 (144 KB) and the 64x64 torso's weights, f32 or bf16, stay resident,
// copied once.  The ring's waits and the env warp's step body are timed by
// tools/profile_k6.py (PERF.md §6 has why no thread-block cluster or larger
// block was taken).

// The R x V tiles of an f32 layer of J output rows over the product threads:
// the shape whose busiest warp scheduler issues the fewest instructions a
// k-row (a tile-round is 2 R V FMA-free operations and a vector load for
// each 4 rows and each 4 envs, or part of 4), counted twice when fewer than 8
// product warps have work (too few to hide the loads' latency), among those
// with at most 64 accumulators a thread.  400 rows: 4 x 4; 300: 4 x 4; 256:
// 4 x 8; 64: 4 x 2, so that 256 of the 352 product threads have a tile (4 x
// 4 would leave 224 idle).

struct TileShape {
  int R, V;
};

constexpr int tile_rounds(int J, int R, int V) {
  return ((J + R - 1) / R * (kCollectEnvs / V) + kDdpgProductThreads - 1) / kDdpgProductThreads;
}

constexpr int tile_cost(int J, int R, int V) {
  const int tiles = (J + R - 1) / R * (kCollectEnvs / V);
  int load[4] = {0, 0, 0, 0};
  for (int w = 0; w < kDdpgProductThreads / 32; ++w) {
    int rounds = 0;
    for (int first = 32 * w; first < tiles; first += kDdpgProductThreads) ++rounds;
    load[(w + 1) % 4] += rounds;  // product warp w is warp w + 1 of the block
  }
  int worst = 0;
  for (int q = 0; q < 4; ++q) worst = load[q] > worst ? load[q] : worst;
  const int cost = worst * (2 * R * V + (R + 3) / 4 + (V + 3) / 4);
  return tiles > 7 * 32 ? cost : 2 * cost;
}

constexpr TileShape choose_tiles(int J) {
  const TileShape shapes[5] = {{4, 4}, {4, 8}, {8, 4}, {8, 8}, {4, 2}};
  TileShape best = shapes[0];
  int best_cost = -1;
  for (int i = 0; i < 5; ++i) {
    const TileShape s = shapes[i];
    if (s.R * s.V * tile_rounds(J, s.R, s.V) > 64) continue;
    const int cost = tile_cost(J, s.R, s.V);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

constexpr int kFragFloats = 128;  // a warp's m16 x k16 bf16 A fragment: 32 lanes x 4 words
constexpr int kPairLd = 40;       // words a row of bf16 pairs: 32 envs + 8, so a B fragment hits 32 banks

// The bf16 weight stream of K6's block actor: the packed block holds W1 and
// W2 as mma A fragments, k-step by k-step and within a k-step m-tile by
// m-tile (ops/gen_policy_rollout.py::mma_fragments: KS x MT x 32 lanes x 4
// words, zero-padded to 16 units and 16 inputs), CK k-steps a chunk; then
// b1, b2, W3, b3, low, high as f32.  The activations are bf16 pairs: row kp
// holds inputs 2 kp and 2 kp + 1 of the 32 envs (kPairLd words a row).
template <class C, int CK_, int STAGES_ = kRingStages>
struct Bf16Ring {
  using Config = C;
  static constexpr int E = kCollectEnvs, A = C::A, CK = CK_;
  static constexpr int MT1 = (C::H1 + 15) / 16, MT2 = (C::H2 + 15) / 16;  // m-tiles of 16 units
  static constexpr int KS1 = (C::F + 15) / 16, KS2 = MT1;  // k-steps of 16 inputs (h1's padded units)
  static constexpr int STAGE = CK * (MT1 > MT2 ? MT1 : MT2) * kFragFloats;
  static constexpr int NC1 = (KS1 + CK - 1) / CK, NC2 = (KS2 + CK - 1) / CK;
  static constexpr int NC = NC1 + NC2;
  static constexpr int STAGES = STAGES_;
  static constexpr bool RESIDENT = STAGES == NC;
  static constexpr int W2 = KS1 * MT1 * kFragFloats, B1 = W2 + KS2 * MT2 * kFragFloats, B2 = B1 + C::H1;
  static constexpr int W3 = B2 + C::H2, BLOCK = W3 + A * C::H2 + 3 * A;
  static constexpr int XS = KS1 * 8 * kPairLd, H1S = MT1 * 8 * kPairLd, H2S = MT2 * 8 * kPairLd;

  __device__ static int chunk_offset(int c) {
    return c < NC1 ? c * CK * MT1 * kFragFloats : W2 + (c - NC1) * CK * MT2 * kFragFloats;
  }
  __device__ static int chunk_floats(int c) {
    return c < NC1 ? min(CK, KS1 - c * CK) * MT1 * kFragFloats : min(CK, KS2 - (c - NC1) * CK) * MT2 * kFragFloats;
  }
};

// Where the days of a block-actor launch come from: K6's Philox days, K5's
// explicit uniforms u (T, 5, N, B), or K11b's day tables of a given state.
enum DaySource : int { kPhiloxDays = 0, kExplicitDay, kTablesDay };

// Floats of one step's slot of a source in shared memory: the generation
// draws of the block's envs (kDrawKinds, N, kCollectEnvs) or the state's
// table rows (kTables, N, kCollectEnvs).
template <class C, int SOURCE>
__host__ __device__ constexpr int day_slot_floats() {
  return (SOURCE == kTablesDay ? kTables : kDrawKinds) * C::N * kCollectEnvs;
}

// The block actor's layout for a slot size, a chunk size (f32 k-rows or bf16
// k-steps a chunk) and a stage count: the ring actor's arrays, then two
// slots of a step's draws or table rows.
template <class C, bool BF16, int SLOT, int CHUNK, int STAGES = kRingStages>
struct K6Layout {
  using G = std::conditional_t<BF16, Bf16Ring<C, CHUNK, STAGES>,
                               F32Ring<C, choose_tiles(C::H1).R, choose_tiles(C::H1).V, choose_tiles(C::H2).R,
                                       choose_tiles(C::H2).V, CHUNK, STAGES>>;
  static constexpr int FLOATS = ring_shared_floats<G>() + 2 * SLOT;
};

// The env warp's draws of K6's step `step` in shared memory: the slot goes by
// the launch's step (with an odd T, t's parity would repeat across a day's end).
template <class C>
struct SlotDraws {
  SharedDraws<C> shared;
  int step;
  __device__ void draw(int, int kind, float (&out)[C::N]) const { shared.draw(step, kind, out); }
};

template <class C, bool BF16, int SLOT, int CHUNK, int STAGES = kRingStages>
constexpr bool k6_fits() {
  return 4 * K6Layout<C, BF16, SLOT, CHUNK, STAGES>::FLOATS + kTraceReserveBytes <= kMaxSmemBytes;
}

// The largest chunk whose ring leaves room for the traces: 16 f32 k-rows or
// 2 bf16 k-steps for every torso the JAX kernel takes but the widest.
template <class C, bool BF16, int SLOT>
constexpr int k6_chunk() {
  if constexpr (BF16) {
    return k6_fits<C, true, SLOT, 2>() ? 2 : 1;
  } else {
    return k6_fits<C, false, SLOT, 16>() ? 16
           : k6_fits<C, false, SLOT, 8>() ? 8
           : k6_fits<C, false, SLOT, 4>() ? 4
           : k6_fits<C, false, SLOT, 2>() ? 2
                                          : 1;
  }
}

// Then the most stages that fit, up to a stage for every chunk of a step
// (the weights resident: the bench's 256x256 torso in bf16).
template <class C, bool BF16, int SLOT, int CHUNK, int STAGES>
constexpr int k6_stages_from() {
  constexpr int NC = K6Layout<C, BF16, SLOT, CHUNK>::G::NC;
  if constexpr (STAGES >= NC || !k6_fits<C, BF16, SLOT, CHUNK, STAGES + 1>()) {
    return STAGES < NC ? STAGES : NC;
  } else {
    return k6_stages_from<C, BF16, SLOT, CHUNK, STAGES + 1>();
  }
}

// The layout of a source's instance: K6 and K5 (draw slots) or K11b (table slots).
template <class C, bool BF16, int SOURCE = kPhiloxDays, int SLOT = day_slot_floats<C, SOURCE>()>
using K6 = K6Layout<C, BF16, SLOT, k6_chunk<C, BF16, SLOT>(),
                    k6_stages_from<C, BF16, SLOT, k6_chunk<C, BF16, SLOT>(), kRingStages>()>;

// One bf16 layer on the tensor cores: y = act(W x + b) for the block's 32
// envs, W's fragments from the ring, x and y bf16 pairs.  Product warp w owns
// m-tiles w, w + 11, ...: 16 units x the 4 n-tiles of 8 envs.  Units beyond J
// (zero weights) are stored as 0.
template <int KIND, class G, int MT, int KS, int J>
__device__ __forceinline__ void mma_layer(const WeightRing<G>& ring, int& g, int p, const uint32_t* x,
                                          const float* bias, uint32_t* y) {
  constexpr int WARPS = kDdpgProductThreads / 32, ROUNDS = (MT + WARPS - 1) / WARPS, NT = kCollectEnvs / 8;
  const int warp = p / 32, lane = p % 32, gq = lane >> 2, t = lane & 3;
  float c[ROUNDS][NT][4];
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int f = 0; f < 4; ++f) c[q][nt][f] = 0.0f;
#pragma unroll 1
  for (int ks0 = 0; ks0 < KS; ks0 += G::CK, ++g) {
    const uint4* stage = reinterpret_cast<const uint4*>(ring.acquire(g));
#pragma unroll
    for (int kk = 0; kk < G::CK; ++kk) {
      if (ks0 + kk >= KS) break;
      const uint32_t* xr = x + (8 * (ks0 + kk) + t) * kPairLd + gq;
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = xr[8 * nt];
        b[nt][1] = xr[4 * kPairLd + 8 * nt];
      }
#pragma unroll
      for (int q = 0; q < ROUNDS; ++q) {
        const int mt = warp + q * WARPS;
        if (mt >= MT) continue;
        const uint4 a = stage[(kk * MT + mt) * 32 + lane];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) ngo::mma_bf16(c[q][nt], a.x, a.y, a.z, a.w, b[nt][0], b[nt][1]);
      }
    }
    ring.release(g);
  }
  __nv_bfloat16* yh = reinterpret_cast<__nv_bfloat16*>(y);
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int mt = warp + q * WARPS;
    if (mt >= MT) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = 16 * mt + gq + (f >= 2 ? 8 : 0), e = 8 * nt + 2 * t + (f & 1);
        const float v = j < J ? activate<KIND>(c[q][nt][f] + bias[j]) : 0.0f;
        yh[2 * ((j >> 1) * kPairLd + e) + (j & 1)] = __float2bfloat16_rn(v);
      }
  }
  sync_products<kDdpgProductThreads>();
}

// The product warps' part of a K6 step (p: the product thread's index): both
// hidden layers through the ring, then the head, whose owners write the
// clipped PPO mean (pallas_gen_policy_rollout.py:143-147) or the DDPG action
// low + (tanh(mu) + 1)·0.5·(high − low) (:148-154, no clip) into shared memory.
template <class C, int KIND, bool BF16, class G>
__device__ __forceinline__ void block_actor_products(const RingShared<G>& sh, const WeightRing<G>& ring, int& g,
                                                     int p, int step) {
  constexpr int E = kCollectEnvs;
  if constexpr (BF16) {
    mma_layer<KIND, G, G::MT1, G::KS1, C::H1>(ring, g, p, reinterpret_cast<const uint32_t*>(sh.xs), sh.b1,
                                              reinterpret_cast<uint32_t*>(sh.h1));
    if (p == 0) k6_stamp(2, step);
    mma_layer<KIND, G, G::MT2, G::KS2, C::H2>(ring, g, p, reinterpret_cast<const uint32_t*>(sh.h1), sh.b2,
                                              reinterpret_cast<uint32_t*>(sh.h2));
  } else {
    ring_layer<KIND, G, G::R1, G::V1, G::ROUNDS1, G::TILES1, C::H1, C::F, G::P1>(ring, g, p, sh.xs, sh.b1, sh.h1);
    if (p == 0) k6_stamp(2, step);
    ring_layer<KIND, G, G::R2, G::V2, G::ROUNDS2, G::TILES2, C::H2, C::H1, G::P2>(ring, g, p, sh.h1, sh.b2, sh.h2);
  }
  if (p == 0) k6_stamp(3, step);
  const __nv_bfloat16* h2 = reinterpret_cast<const __nv_bfloat16*>(sh.h2);
  for (int i = p; i < C::A * E; i += kDdpgProductThreads) {
    const int a = i / E, e = i % E;
    const float* w = sh.w3 + a * C::H2;
    float acc;
    if constexpr (BF16) {  // h2[k][e] is half k & 1 of pair row k / 2
      acc = w[0] * __bfloat162float(h2[2 * e]);
#pragma unroll 16
      for (int k = 1; k < C::H2; ++k) acc = acc + w[k] * __bfloat162float(h2[2 * ((k >> 1) * kPairLd + e) + (k & 1)]);
    } else {
      acc = w[0] * sh.h2[e];
#pragma unroll 16
      for (int k = 1; k < C::H2; ++k) acc = acc + w[k] * sh.h2[k * E + e];
    }
    const float mu = acc + sh.b3[a];
    const float lo = sh.low[a], hi = sh.high[a];
    sh.act[a * E + e] = KIND == kPpoActor ? fminf(fmaxf(mu, lo), hi) : lo + ((tanhf(mu) + 1.0f) * 0.5f) * (hi - lo);
  }
}

// The sources and outputs of the block-actor days: K6's Philox days of
// `seed` and its stats (3, B); K5's one explicit-uniform day (u, the starting
// battery, the PV shift) and its trajectory; or K11b's day of a given state
// (its tables (7, T, N, B), SoC column L-1 and penalty mask (N, B), battery
// and PV shift) and its trajectory without the final battery.
struct BlockDays {
  uint32_t seed;
  int num_days;
  const float *u, *batt_soc, *pv_shift;
  float *stats, *rewards, *actions, *soc_final, *batt_final;
  const float *tables, *prev_col, *pmask;
};

// The product threads' store of the launch step `step`'s inputs into its
// slot (step & 1): the draws of day step / T (store_draws) or the table rows
// of step `step` of the one day (store_tables).
template <class C, int SOURCE, int THREADS>
__device__ __forceinline__ void stage_step(float* slots, const BlockDays& io, int p, int step, int T, int64_t b0,
                                           int B) {
  if constexpr (SOURCE == kTablesDay) {
    store_tables<C, THREADS>(slots + (step & 1) * day_slot_floats<C, SOURCE>(), io.tables,
                             static_cast<int64_t>(T) * C::N * B, p, step, b0, B);
  } else {
    constexpr bool SEEDED = SOURCE == kPhiloxDays;
    const CollectSource<C, SEEDED> src{io.u, nullptr, io.seed, B, static_cast<uint32_t>(step / T)};
    store_draws<C, SEEDED, THREADS>(SharedDraws<C>{slots}, nullptr, src, p, step % T, b0, step);
  }
}

// K6 (kPhiloxDays), K5 (kExplicitDay) or K11b (kTablesDay) with the block
// actor, for a block of kDdpgCollectThreads threads per kCollectEnvs envs;
// tail lanes mirror the last env and write nothing.  BF16: K6's mlp_dtype
// option on the tensor cores.
template <class C, int KIND, bool BF16, int SOURCE>
__device__ __forceinline__ void block_actor_days(const float* __restrict__ price,
                                                 const float* __restrict__ price_norm, int P,
                                                 const float* __restrict__ rad_norm, int S,
                                                 const float* __restrict__ solar, const float* __restrict__ weights,
                                                 const BlockDays& io, int B, const Dims& d) {
  constexpr bool SEEDED = SOURCE == kPhiloxDays, TABLES = SOURCE == kTablesDay;
  static_assert(SEEDED || !BF16, "K5 and K11b have no bf16 option");
  using L = K6<C, BF16, SOURCE>;
  using G = typename L::G;
  constexpr int E = kCollectEnvs, N = C::N;
  extern __shared__ float4 collect_smem[];
  float* smem = reinterpret_cast<float*>(collect_smem);
  const RingShared<G> sh(smem);
  sh.load(weights);
  const SharedTraces tr = load_traces(smem + L::FLOATS, rad_norm, S, price_norm, P, price, solar, d.T);
  const WeightRing<G> ring{weights, sh.ring, sh.full, sh.empty};
  if (threadIdx.x == 0) ring.init();
  float* slots = sh.end();
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * E;
  const int steps = io.num_days * d.T, chunks = steps * G::NC;
  if (steps > 0) stage_step<C, SOURCE, kDdpgCollectThreads>(slots, io, threadIdx.x, 0, d.T, b0, B);
  __syncthreads();
  if (threadIdx.x >= kCollectEnvs) {
    // the product warps: the next step's inputs while the env warp observes, then the policy
    const int p = threadIdx.x - kCollectEnvs;
    int g = 0;
#pragma unroll 1
    for (int step = 0; step < steps; ++step) {
      if (step + 1 < steps) stage_step<C, SOURCE, kDdpgProductThreads>(slots, io, p, step + 1, d.T, b0, B);
      if (p == 0) k6_stamp(6, step);
      sync_block();
      block_actor_products<C, KIND, BF16>(sh, ring, g, p, step);
      if (p == 0) k6_stamp(4, step);
#ifdef NGK_K6_CLOCK
      if (blockIdx.x == 0 && p == 0 && step < kK6ClockSteps) k6_clock[step * kK6ClockSlots + 5] = k6_ring_wait;
#endif
      sync_block();
    }
    return;
  }
  // the env warp: the first chunks now, each step's others (and the next
  // step's first) while the products sum
  const CollectLane l(B);
  const int lane = threadIdx.x;
  int filled = 0;
  for (; filled < min(G::STAGES - 1, chunks); ++filled) ring.fill(filled);
  float batt = SEEDED ? kBattInit : io.batt_soc[l.b], rew_total = 0.0f, sq_total = 0.0f;
  Carry<C> c;
#pragma unroll 1
  for (int day = 0; day < io.num_days; ++day) {
    float pv;
    if constexpr (SEEDED) {
      pv = PhiloxDraws<N>{make_uint2(io.seed, static_cast<uint32_t>(l.b)), static_cast<uint32_t>(day)}.pv_shift(d.T);
    } else {
      pv = io.pv_shift[l.b];
    }
    if constexpr (TABLES) {  // the state's carried column and mask
#pragma unroll
      for (int n = 0; n < N; ++n) {
        c.prev_col[n] = io.prev_col[static_cast<int64_t>(n) * B + l.b];
        c.pmask[n] = io.pmask[static_cast<int64_t>(n) * B + l.b];
      }
    } else {
      c.clear();
    }
    float pen_acc[N], day_sum = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) pen_acc[n] = 0.0f;
#pragma unroll 1
    for (int t = 0; t < d.T; ++t) {
      const int step = day * d.T + t;
      if (lane == 0) k6_stamp(0, step);
      float obs[C::F], pen[N];
      StepState<C> st;
      if constexpr (TABLES) {
        observe_tables<C>(t, slots + (step & 1) * day_slot_floats<C, SOURCE>() + lane, c, batt, tr.rad_norm,
                          tr.price_norm, pv, obs, st, pen);
      } else {
        observe_step<C>(t, d, SlotDraws<C>{SharedDraws<C>{slots}, step}, c, batt, tr.rad_norm, tr.price_norm, pv,
                        obs, st, pen);
      }
      if constexpr (BF16) {  // pairs of consecutive inputs, the padded ones zero
        uint32_t* x = reinterpret_cast<uint32_t*>(sh.xs);
#pragma unroll
        for (int kp = 0; kp < G::KS1 * 8; ++kp)
          x[kp * kPairLd + lane] = ngo::pack_bf16(2 * kp < C::F ? obs[2 * kp] : 0.0f,
                                                  2 * kp + 1 < C::F ? obs[2 * kp + 1] : 0.0f);
      } else {
#pragma unroll
        for (int f = 0; f < C::F; ++f) sh.xs[f * E + lane] = obs[f];
      }
      if (lane == 0) k6_stamp(1, step);
      sync_block();  // observations staged
#pragma unroll 1
      for (; filled < min((step + 1) * G::NC + G::STAGES - 1, chunks); ++filled) ring.fill(filled);
      sync_block();  // actions ready
      float act[C::A];
#pragma unroll
      for (int a = 0; a < C::A; ++a) act[a] = sh.act[a * E + lane];
      const PolicyRows r = physics_step<C>(st, act, c, batt, d.dt);
      if constexpr (SEEDED) {
#pragma unroll
        for (int n = 0; n < N; ++n) pen_acc[n] = pen_acc[n] + pen[n];
        const float reward = -policy_cost<C>(r, tr.solar[t], tr.price[t], pv, d.dt);
        day_sum = t == 0 ? reward : day_sum + reward;
      } else if (l.active) {  // the step's reward carries its vehicle penalty
#pragma unroll
        for (int a = 0; a < C::A; ++a) io.actions[(static_cast<int64_t>(t) * C::A + a) * B + l.b] = act[a];
        float pen_sum = pen[0];
#pragma unroll
        for (int n = 1; n < N; ++n) pen_sum = pen_sum + pen[n];
        const float cost = policy_cost<C>(r, tr.solar[t], tr.price[t], pv, d.dt) + kWVeh * pen_sum;
        io.rewards[static_cast<int64_t>(t) * B + l.b] = -cost;
      }
    }
    if constexpr (SEEDED) {
      float pen_total = pen_acc[0];
#pragma unroll
      for (int n = 1; n < N; ++n) pen_total = pen_total + pen_acc[n];
      const float day_return = day_sum - kWVeh * pen_total;
      rew_total = rew_total + day_return;
      sq_total = sq_total + day_return * day_return;
    }
  }
  if (!l.active) return;
  if constexpr (SEEDED) {
    io.stats[l.b] = rew_total;
    io.stats[static_cast<int64_t>(B) + l.b] = sq_total;
    io.stats[2 * static_cast<int64_t>(B) + l.b] = batt;
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) io.soc_final[static_cast<int64_t>(n) * B + l.b] = c.prev_col[n];
    if constexpr (!TABLES) io.batt_final[l.b] = batt;
  }
}

// K6: num_days Philox actor days per env, the battery carried across days;
// stats (3, B) = sum and sum of squares of day returns, final battery SoC.
template <class C, int KIND, bool BF16>
__global__ void __launch_bounds__(kDdpgCollectThreads)
gen_policy_multiday_block_kernel(const float* __restrict__ price, const float* __restrict__ price_norm, int P,
                                 const float* __restrict__ rad_norm, int S, const float* __restrict__ solar,
                                 uint32_t seed, int num_days, const float* __restrict__ weights,
                                 float* __restrict__ stats, int B, Dims d) {
  const BlockDays io{seed, num_days, nullptr, nullptr, nullptr, stats, nullptr, nullptr, nullptr, nullptr};
  block_actor_days<C, KIND, BF16, kPhiloxDays>(price, price_norm, P, rad_norm, S, solar, weights, io, B, d);
}

// K5 for every actor: one explicit-uniform actor day; rewards (T, B),
// actions (T, A, B), soc_final (N, B), batt_final (B).
template <class C, int KIND>
__global__ void __launch_bounds__(kDdpgCollectThreads)
gen_policy_day_block_kernel(const float* __restrict__ price, const float* __restrict__ price_norm, int P,
                            const float* __restrict__ rad_norm, int S, const float* __restrict__ solar,
                            const float* __restrict__ u, const float* __restrict__ batt_soc,
                            const float* __restrict__ pv_shift, const float* __restrict__ weights,
                            float* __restrict__ rewards, float* __restrict__ actions,
                            float* __restrict__ soc_final, float* __restrict__ batt_final, int B, Dims d) {
  const BlockDays io{0u, 1, u, batt_soc, pv_shift, nullptr, rewards, actions, soc_final, batt_final};
  block_actor_days<C, KIND, false, kExplicitDay>(price, price_norm, P, rad_norm, S, solar, weights, io, B, d);
}

// K11b for every PPO torso: one day of the actor's clipped mean from a given
// state, tables in (pallas_policy_rollout.py:40-183); rewards (T, B),
// actions (T, A, B), soc_final (N, B).  tables (7, T, N, B) of
// ops/rollout.py::state_tables, prev_col0 (N, B) the state's SoC column L-1,
// pmask0 (N, B) its trailing-observe mask.  Only d.T and d.dt are read.
template <class C>
__global__ void __launch_bounds__(kDdpgCollectThreads)
policy_day_rollout_tables_kernel(const float* __restrict__ price, const float* __restrict__ price_norm, int P,
                                 const float* __restrict__ rad_norm, int S, const float* __restrict__ solar,
                                 const float* __restrict__ tables, const float* __restrict__ prev_col0,
                                 const float* __restrict__ pmask0, const float* __restrict__ batt_soc,
                                 const float* __restrict__ pv_shift, const float* __restrict__ weights,
                                 float* __restrict__ rewards, float* __restrict__ actions,
                                 float* __restrict__ soc_final, int B, Dims d) {
  const BlockDays io{0u,      1,         nullptr, batt_soc, pv_shift,  nullptr, rewards,
                     actions, soc_final, nullptr, tables,   prev_col0, pmask0};
  block_actor_days<C, kPpoActor, false, kTablesDay>(price, price_norm, P, rad_norm, S, solar, weights, io, B, d);
}

// -------------------------------------------------------- RBC ring days ---

// K7's and K11a's block: kRbcEnvs = 32 envs, one a lane, on one warp a charger
// (at most kRbcMaxWarps; more chargers take several a thread), and a sum warp
// after them.  Thread (w, e) of a charger warp copies its
// chargers' rows of env e for each step, ROWS a charger (K7: the five uniform
// kinds; K11a: the seven tables), into a ring of DEPTH one-step stages in
// shared memory by asynchronous 4-byte copies (`cp.async`, zeros past the
// batch), one commit group a step, and reads back only what it copied.
constexpr int kRbcEnvs = 32;
constexpr int kRbcMaxWarps = 8;
constexpr int kRbcRingBytes = 32 * 1024;  // rows a block keeps in flight: seven blocks fit an SM
constexpr int kRbcMaxDepth = 4;

template <int N, int ROWS_>
struct RbcRing {
  static constexpr int ROWS = ROWS_;
  static constexpr int WARPS = N < kRbcMaxWarps ? N : kRbcMaxWarps;
  static constexpr int SLOTS = (N + WARPS - 1) / WARPS;  // chargers of a thread: w, w + WARPS, ...
  static constexpr int STEP = ROWS * N * kRbcEnvs;       // floats of one step's rows of the block
  static constexpr int FIT = kRbcRingBytes / (4 * STEP);
  static constexpr int DEPTH = FIT < 2 ? 2 : (FIT > kRbcMaxDepth ? kRbcMaxDepth : FIT);  // steps in flight
  static constexpr int SUMS = 2 * 2 * N * kRbcEnvs;      // each charger's power and penalty, two steps
  static constexpr int FLOATS = DEPTH * STEP + SUMS;     // before the traces
  static constexpr int THREADS = 32 * (WARPS + 1);       // the charger warps, then the sum warp
};

// The ring of a day source: K7's uniform kinds (kExplicitDay), K11a's tables (kTablesDay).
template <class C, int SOURCE>
using RbcRingOf = RbcRing<C::N, SOURCE == kTablesDay ? kTables : kDrawKinds>;

// StepDraws' source for K7's thread: its chargers' uniforms of the step from
// its ring stage; `row` points at charger slot 0's kind-0 word of the thread
// (slot i is charger w + i WARPS, a slot past N reads 0).
template <class C, class LC>
struct RingDraws {
  const float* row;
  int w;
  __device__ void draw(int, int kind, float (&out)[LC::N]) const {
    using R = RbcRingOf<C, kExplicitDay>;
#pragma unroll
    for (int i = 0; i < LC::N; ++i)
      out[i] = w + i * R::WARPS < C::N ? row[(kind * C::N + i * R::WARPS) * kRbcEnvs] : 0.0f;
  }
};

// One RBC day of the block's 32 envs: rewards (T, B), soc_final (N, B).  K7
// (kExplicitDay): a fresh day generated from rows = u (T, 5, N, B), the
// carry cleared.  K11a (kTablesDay): a given state's day from rows = its
// tables (7, T, N, B), prev_col0 (N, B) its SoC column L-1 and pmask0 (N, B)
// its trailing-observe mask (pallas_rollout.py:46-141).  A step's charger
// warps write each charger's power and penalty; after the step's barrier the
// sum warp adds them up in index order and writes the reward while the
// charger warps go on to the next step (the sums are double-buffered).
template <class C, int SOURCE>
__device__ __forceinline__ void rbc_ring_day(const float* __restrict__ price, const float* __restrict__ rad_norm,
                                             int S, const float* __restrict__ solar,
                                             const float* __restrict__ rows, const float* __restrict__ prev_col0,
                                             const float* __restrict__ pmask0, const float* __restrict__ batt_soc,
                                             const float* __restrict__ pv_shift, float* __restrict__ rewards,
                                             float* __restrict__ soc_final, int B, const Dims& d) {
  constexpr bool TABLES = SOURCE == kTablesDay;
  using R = RbcRingOf<C, SOURCE>;
  using LC = Cfg<R::SLOTS, C::PV, C::BATT, C::PMODE, C::DIFF_CAPS, C::REQ_SOC, C::H1, C::H2>;  // a thread's chargers
  constexpr int N = C::N;
  const int T = d.T;
  extern __shared__ float smem[];
  float* ring = smem;
  float* sums = ring + R::DEPTH * R::STEP;
  const int e = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool summer = w == R::WARPS;  // the sum warp: no charger of its own
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRbcEnvs + e;
  const bool active = b < B;
  const int64_t bs = active ? b : 0;  // the source address of a zero-filled copy
  // row k of step t for charger n at k * row_stride + (t * STEP_ROWS + n) * B:
  // K11a's table k (a plane of T N B floats) at (t, n), K7's uniforms at (t, k, n)
  const int64_t row_stride = TABLES ? static_cast<int64_t>(T) * N * B : static_cast<int64_t>(N) * B;
  constexpr int STEP_ROWS = TABLES ? N : kDrawKinds * N;

  // step t's rows of this thread's chargers into its ring stage; one commit
  // group a step, empty past the day (and on the sum warp), so that group t
  // is step t.  K7 copies the kinds StepDraws::fill reads: the capacity and
  // the requested SoC when configured, the departure only when its window is open.
  auto stage = [&](int t) {
    if (t < T && !summer) {
      float* slot = ring + (t % R::DEPTH) * R::STEP;
      const bool dep = t + d.k4 < min(t + d.k10, T + d.k1);
#pragma unroll
      for (int i = 0; i < R::SLOTS; ++i) {
        const int n = w + i * R::WARPS;
        if (n >= N) continue;
#pragma unroll
        for (int k = 0; k < R::ROWS; ++k) {
          if (!TABLES && ((k == 2 && !C::DIFF_CAPS) || (k == 3 && !C::REQ_SOC) || (k == 4 && !dep))) continue;
          async_copy_f32(slot + (k * N + n) * kRbcEnvs + e,
                         rows + k * row_stride + (static_cast<int64_t>(t) * STEP_ROWS + n) * B + bs, active);
        }
      }
    }
    async_commit();
  };
#pragma unroll 1
  for (int t = 0; t < R::DEPTH; ++t) stage(t);

  const SharedTraces s = load_traces(sums + R::SUMS, rad_norm, S, nullptr, 0, price, solar, T);
  // the thread's chargers: K7's generation carry; K11a's carried column and
  // mask and the previous step's departure row (prev_col, pmask, prev_depcol)
  Carry<LC> c;
  c.clear();
  if constexpr (TABLES) {
#pragma unroll
    for (int i = 0; i < R::SLOTS; ++i) {
      const int n = w + i * R::WARPS;
      if (active && !summer && n < N) {
        c.prev_col[i] = prev_col0[static_cast<int64_t>(n) * B + b];
        c.pmask[i] = pmask0[static_cast<int64_t>(n) * B + b];
      }
    }
  }
  const float pv = active ? pv_shift[b] : 0.0f;
  const float dod = idle_dod_penalty<C>(active ? batt_soc[b] : kBattInit);  // the RBC idles the BESS
  __syncthreads();

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    float* power = sums + (t & 1) * 2 * N * kRbcEnvs;  // [n][e], then the penalties
    float* pens = power + N * kRbcEnvs;
    if (!summer) {
      async_wait<R::DEPTH - 1>();  // this thread's copies of step t have landed
      // its words: row k of charger n at (k N + n) kRbcEnvs + e, power and
      // penalty at n kRbcEnvs + e
      const float* slot = ring + (t % R::DEPTH) * R::STEP;
      // the RBC acts on the previous step's observation: o = max(t-1, 0)
      const float fallback = rbc_fallback<C>(t > 0 ? t - 1 : 0, s.rad_norm, pv);
      if constexpr (TABLES) {
#pragma unroll
        for (int i = 0; i < R::SLOTS; ++i) {
          const int n = w + i * R::WARPS;
          if (n >= N) continue;
          const float* row = slot + n * kRbcEnvs + e;
          const auto tab = [&](int k) { return row[k * N * kRbcEnvs]; };
          const float dep_t = tab(kDepObs);
          const float a = rbc_action(t == 0 ? dep_t : c.prev_depcol[i], fallback);
          const bool occupied = tab(kOcc) > 0.0f;
          const float soc_col = tab(kSocCols);
          const float soc_eff = tab(kIsArr) > 0.0f ? soc_col : c.prev_col[i];
          const float cap = tab(kCapEff);
          const float safe_cap = cap > 0.0f ? cap : 1.0f;
          const float p_raw = a * kMaxPEff;  // charge branch only: RBC actions are >= 0
          const float calc = soc_eff + (p_raw * d.dt) / safe_cap;
          power[n * kRbcEnvs + e] = (occupied && a > 0.0f) ? p_raw : 0.0f;
          const float soc_new = a > 0.0f ? fminf(calc, 1.0f) : soc_eff;
          pens[n * kRbcEnvs + e] = insufficiency_penalty(c.pmask[i], c.prev_col[i], tab(kReqPrev));
          c.pmask[i] = tab(kPmask);  // the trailing observe's mask for the next step
          c.prev_col[i] = occupied ? soc_new : soc_col;
          c.prev_depcol[i] = dep_t;
        }
      } else {  // generate the thread's columns of step t and run the RBC on them
        StepDraws<LC> u;
        u.fill(RingDraws<C, LC>{slot + w * kRbcEnvs + e, w}, t, d);
#pragma unroll
        for (int i = 0; i < R::SLOTS; ++i) {
          const int n = w + i * R::WARPS;
          if (n >= N) continue;
          float pen;
          power[n * kRbcEnvs + e] = rbc_charger<LC>(t, i, u, c, fallback, d.dt, pen);
          pens[n * kRbcEnvs + e] = pen;
        }
      }
    }
    __syncthreads();  // every charger's power and penalty of step t; stage t read by its copier
    stage(t + R::DEPTH);
    if (summer) {  // the env's sums over its chargers, in index order
      float charging = power[e], pen_sum = pens[e];
#pragma unroll
      for (int n = 1; n < N; ++n) {
        charging = charging + power[n * kRbcEnvs + e];
        pen_sum = pen_sum + pens[n * kRbcEnvs + e];
      }
      const float cost = rbc_reward<C>(charging, s.solar[t], s.price[t], pv, dod, d.dt) + kWVeh * pen_sum;
      if (active) rewards[static_cast<int64_t>(t) * B + b] = -cost;
    }
  }
#pragma unroll
  for (int i = 0; i < R::SLOTS; ++i) {
    const int n = w + i * R::WARPS;
    if (active && !summer && n < N) soc_final[static_cast<int64_t>(n) * B + b] = c.prev_col[i];
  }
}

// K7: one explicit-uniform RBC day (pallas_gen_rollout.py:511-557); u (T, 5,
// N, B), the starting battery and the PV shift (B,); rewards (T, B),
// soc_final (N, B).
template <class C>
__global__ void __launch_bounds__(RbcRingOf<C, kExplicitDay>::THREADS)
    gen_rbc_day_ring_kernel(const float* __restrict__ price, const float* __restrict__ rad_norm, int S,
                            const float* __restrict__ solar, const float* __restrict__ u,
                            const float* __restrict__ batt_soc, const float* __restrict__ pv_shift,
                            float* __restrict__ rewards, float* __restrict__ soc_final, int B, Dims d) {
  rbc_ring_day<C, kExplicitDay>(price, rad_norm, S, solar, u, nullptr, nullptr, batt_soc, pv_shift, rewards,
                                soc_final, B, d);
}

// K11a: one RBC day of a given state; rewards (T, B), soc_final (N, B).
// prev_col0 (N, B) is the state's SoC column L-1, pmask0 (N, B) its
// trailing-observe mask.  Only d.T and d.dt are read.
template <class C>
__global__ void __launch_bounds__(RbcRingOf<C, kTablesDay>::THREADS)
    rbc_day_rollout_kernel(const float* __restrict__ price, const float* __restrict__ rad_norm, int S,
                           const float* __restrict__ solar, const float* __restrict__ tables,
                           const float* __restrict__ prev_col0, const float* __restrict__ pmask0,
                           const float* __restrict__ batt_soc, const float* __restrict__ pv_shift,
                           float* __restrict__ rewards, float* __restrict__ soc_final, int B, Dims d) {
  rbc_ring_day<C, kTablesDay>(price, rad_norm, S, solar, tables, prev_col0, pmask0, batt_soc, pv_shift, rewards,
                              soc_final, B, d);
}

}  // namespace ngk
