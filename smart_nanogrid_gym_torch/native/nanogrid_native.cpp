// nanogrid_native — C++ runtime components for smart_nanogrid_gym_torch (a
// copy of the JAX package's native runtime, built by the port from this file).
//
// Two components, exposed through a plain C ABI (loaded via ctypes):
//
// 1. A bit-exact re-implementation of the reference's day-schedule generation
//    RNG stream (reference: smart_nanogrid_gym/utils/charging_station.py:200-279
//    driving numpy's *legacy global* MT19937).  Given the same integer seed as
//    `np.random.seed(seed)`, ng_generate_schedule produces the identical day —
//    including the unconditionally-discarded requested-SoC draw and the
//    no-draw departure branch (SURVEY.md Q5) — enabling exact trajectory
//    replication from a seed alone, with no Python/numpy in the loop.
//
//    MT19937 details matched to numpy legacy RandomState (verified bitwise in
//    tests/test_torch_native.py):
//      - seeding: init_genrand(seed) for uint32 seeds
//      - random_sample: ((a>>5)*2^26 + (b>>6)) / 2^53
//      - randint(low, high): masked rejection over high-low-1
//      - uniform(a, b): a + (b-a)*random_sample()
//
// 2. A standalone CPU serving engine replicating the environment step
//    semantics exactly (the same math as ../core/transition.py, held against
//    the plain engine to 1e-9 in tests/test_torch_native.py): charger/BESS physics with the
//    reference's quirks (inverted discharge clamp charger.py:122-132, penalty
//    mask lag, (t-1) mod L wraparound), penalties, pricing, observation
//    assembly.  No Python or numpy required at inference time.
//
// Build: smart_nanogrid_gym_torch.native builds it with g++ and the Makefile's
// CXXFLAGS into build/torch_native/ (or: make -C this directory OUT=<path>).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

// ----------------------------------------------------------------- MT19937 --

class MT19937 {
 public:
  explicit MT19937(uint32_t seed) { init_genrand(seed); }

  void init_genrand(uint32_t s) {
    mt_[0] = s;
    for (int i = 1; i < kN; ++i) {
      mt_[i] = 1812433253u * (mt_[i - 1] ^ (mt_[i - 1] >> 30)) + (uint32_t)i;
    }
    idx_ = kN;
  }

  uint32_t genrand() {
    if (idx_ >= kN) {
      for (int i = 0; i < kN; ++i) {
        uint32_t y = (mt_[i] & 0x80000000u) | (mt_[(i + 1) % kN] & 0x7fffffffu);
        mt_[i] = mt_[(i + 397) % kN] ^ (y >> 1);
        if (y & 1u) mt_[i] ^= 0x9908b0dfu;
      }
      idx_ = 0;
    }
    uint32_t y = mt_[idx_++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }

  // numpy legacy random_sample(): 53-bit double in [0, 1)
  double random_sample() {
    uint32_t a = genrand() >> 5, b = genrand() >> 6;
    return (a * 67108864.0 + b) / 9007199254740992.0;
  }

  double uniform(double low, double high) {
    return low + (high - low) * random_sample();
  }

  // numpy legacy randint(low, high): masked rejection over rng = high-low-1.
  // Single-value ranges return immediately WITHOUT consuming a draw (numpy's
  // bounded-integer path special-cases rng == 0) — stream-position critical.
  long randint(long low, long high) {
    unsigned long rng = (unsigned long)(high - low - 1);
    if (rng == 0) return low;
    unsigned long mask = rng;
    mask |= mask >> 1;  mask |= mask >> 2;  mask |= mask >> 4;
    mask |= mask >> 8;  mask |= mask >> 16;
    while (true) {
      unsigned long v = genrand() & mask;
      if (v <= rng) return low + (long)v;
    }
  }

 private:
  static constexpr int kN = 624;
  uint32_t mt_[624];
  int idx_;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- generator --

// Generates one day's schedule for all chargers, replaying the reference's
// exact draw order (charging_station.py:200-279).  All output arrays are
// (n_chargers, table_len) row-major doubles, zero-initialised by the caller.
// Returns 0 on success.
int ng_generate_schedule(
    uint32_t seed,
    int n_chargers,
    double time_interval,
    int table_len,
    int enable_different_capacities,
    int enable_requested_soc,
    double* occupancy,
    double* capacity,
    double* requested_soc,
    double* soc_init,
    double* is_arrival,
    double* dep_obs,
    double* mask_departing,
    double* mask_departing3) {
  MT19937 rng(seed);
  const int T = (int)std::lround(24.0 / time_interval);
  const int L = table_len;
  if (L < T) return -1;
  const int k4 = (int)(4.0 / time_interval);
  const int k10 = (int)(10.0 / time_interval);
  const int k1 = (int)(1.0 / time_interval);

  std::vector<long> departures;  // per-charger scratch, reused
  for (int c = 0; c < n_chargers; ++c) {
    double* occ = occupancy + (size_t)c * L;
    double* cap = capacity + (size_t)c * L;
    double* req = requested_soc + (size_t)c * L;
    double* soc = soc_init + (size_t)c * L;
    double* arr = is_arrival + (size_t)c * L;
    double* dep = dep_obs + (size_t)c * L;
    double* m1 = mask_departing + (size_t)c * L;
    double* m3 = mask_departing3 + (size_t)c * L;

    departures.clear();
    bool present = false;
    long current_dep = 0;
    double current_cap = 0.0;
    bool cap_generated = false;
    double current_req = 0.0;
    bool req_generated = false;

    for (int t = 0; t < T; ++t) {
      if (!present) {
        // arrival = round(rand() - 0.1): half-to-even; equivalent to x > 0.5
        double x = rng.random_sample() - 0.1;
        if (x > 0.5) {
          present = true;
          // arrival SoC ~ uniform(0.1, 0.9) (charging_station.py:257-259)
          double s = rng.uniform(0.1, 0.9);
          soc[t] = s;
          // unconditionally *discarded* requested-SoC draw (:219, SURVEY.md Q5-3)
          double s2 = (s <= 0.9) ? s + 0.1 : 1.0;
          (void)rng.uniform(s2, 1.0);
          if (enable_different_capacities && !cap_generated) {
            current_cap = (double)rng.randint(15, 120);
            cap_generated = true;
          } else if (!enable_different_capacities && !cap_generated) {
            current_cap = 40.0;
            cap_generated = true;
          }
          if (enable_requested_soc && !req_generated) {
            double s3 = (soc[t] <= 0.9) ? soc[t] + 0.1 : 1.0;
            current_req = rng.uniform(s3, 1.0);
            req_generated = true;
          } else if (!enable_requested_soc && !req_generated) {
            current_req = 1.0;
            req_generated = true;
          }
          arr[t] = 1.0;
          // departure window (:271-279): no draw when low >= high
          long low = t + k4;
          long high = std::min((long)(t + k10), (long)(T + k1));
          current_dep = (low >= high) ? low : rng.randint(low, high);
          departures.push_back(current_dep);
        }
      }
      if (present && t < current_dep) {
        occ[t] = 1.0;
        cap[t] = current_cap;
        req[t] = current_req;
      } else {
        present = false;
        occ[t] = 0.0;
        cap[t] = 0.0;
        current_cap = 0.0;
        cap_generated = false;
        req[t] = 0.0;
        current_req = 0.0;
        req_generated = false;
      }
    }

    // lookup tables from the full departure list, replicating the reference's
    // per-step searches (charging_station.py:79-112)
    for (int t = 0; t < T; ++t) {
      if (occ[t] > 0) {
        for (long d : departures) {
          if ((long)t <= d) { dep[t] = (double)(d - t); break; }
        }
        for (long d : departures) {
          if (d == t + 1) { m1[t] = 1.0; }
          if (d >= t + 1 && d <= t + 3) { m3[t] = 1.0; }
        }
      }
    }
  }
  return 0;
}

// ------------------------------------------------------------------- engine --

struct NgEngine {
  // static config
  int n;                 // chargers
  double dt;             // time interval
  int T, L;
  int pv, batt, v2x;
  int penalty_mode;      // 0 none, 1 on_departure, 2 sparse, 3 dense
  // parameter tables (copied in)
  std::vector<double> price, price_norm, rad_norm, solar_power;
  // constants (reference values; settable)
  double charger_max_power = 22.0, charger_eff = 0.95;
  double batt_capacity = 80.0, batt_max_power = 44.0, batt_eff = 0.95,
         batt_dod = 0.15;
  double margin_ratio = 0.05, gain = 10.0, w_batt = 0.8, w_veh = 1.0,
         grid_w = 0.75, sell_coeff = 0.8, marker = 100.0;
  // day state
  std::vector<double> occ, cap, req, soc, is_arr, dep_obs, m1, m3;
  // penalty-check set computed by the previous step's trailing observe
  // (reference _penalty_check_vehicles side effect; carried across day
  // rollovers per SURVEY.md Q8 continuation semantics)
  std::vector<double> pmask;
  double batt_soc = 0.5, batt_init = 0.5, pv_shift = 1.0;
  int t = 0;
  int lookahead = 3;  // obs lookahead timesteps (config.lookahead)
  // penalty-mode -> mask-table dispatch (charging_station.py:50-60)
  const double* mask_table() const {
    switch (penalty_mode) {
      case 1: return m1.data();
      case 2: return m3.data();
      case 3: return occ.data();
      default: return nullptr;
    }
  }
};

void* ng_engine_new(int n_chargers, double time_interval, int pv, int batt,
                    int v2x, int penalty_mode, int lookahead,
                    const double* price, int price_len, const double* rad_norm,
                    const double* solar_power, int solar_len) {
  auto* e = new NgEngine();
  e->n = n_chargers;
  e->lookahead = lookahead;
  e->dt = time_interval;
  e->T = (int)std::lround(24.0 / time_interval);
  e->L = e->T + 1;
  e->pv = pv; e->batt = batt; e->v2x = v2x;
  e->penalty_mode = penalty_mode;
  e->price.assign(price, price + price_len);
  double pmax = 0.0;
  for (double p : e->price) if (p >= 0.0 && p > pmax) pmax = p;
  e->price_norm.resize(e->price.size());
  for (size_t i = 0; i < e->price.size(); ++i) e->price_norm[i] = e->price[i] / pmax;
  if (pv) {
    e->rad_norm.assign(rad_norm, rad_norm + solar_len);
    e->solar_power.assign(solar_power, solar_power + solar_len);
  } else {
    e->rad_norm.assign((size_t)(2 * e->T), 0.0);
    e->solar_power.assign((size_t)(2 * e->T), 0.0);
  }
  size_t sz = (size_t)e->n * e->L;
  e->occ.assign(sz, 0.0); e->cap.assign(sz, 0.0); e->req.assign(sz, 0.0);
  e->soc.assign(sz, 0.0); e->is_arr.assign(sz, 0.0); e->dep_obs.assign(sz, 0.0);
  e->m1.assign(sz, 0.0); e->m3.assign(sz, 0.0);
  e->pmask.assign((size_t)e->n, 0.0);
  return e;
}

void ng_engine_free(void* h) { delete static_cast<NgEngine*>(h); }

int ng_engine_obs_dim(void* h) {
  auto* e = static_cast<NgEngine*>(h);
  // current + `lookahead` predicted timesteps per observed quantity
  // (reference NUMBER_OF_HOURS_AHEAD=3 counts *timesteps*, SURVEY.md Q11;
  // parameterized here like the JAX engine's config.lookahead)
  int base = (1 + (e->pv ? 1 : 0)) * (1 + e->lookahead);
  return base + 2 * e->n + (e->batt ? 1 : 0);
}

static void ng_observe(const NgEngine* e, double* obs) {
  int k = 0;
  int t = e->t;
  if (e->pv) {
    obs[k++] = e->rad_norm[t] * e->pv_shift;
    obs[k++] = e->price_norm[t];
    for (int i = 1; i <= e->lookahead; ++i) obs[k++] = e->rad_norm[t + i] * e->pv_shift;
    for (int i = 1; i <= e->lookahead; ++i) obs[k++] = e->price_norm[t + i];
  } else {
    obs[k++] = e->price_norm[t];
    for (int i = 1; i <= e->lookahead; ++i) obs[k++] = e->price_norm[t + i];
  }
  for (int c = 0; c < e->n; ++c) obs[k++] = e->soc[(size_t)c * e->L + t];
  for (int c = 0; c < e->n; ++c) obs[k++] = e->dep_obs[(size_t)c * e->L + t] / 24.0;
  if (e->batt) obs[k++] = e->batt_soc;
}

// Reset with a day schedule (tables as produced by ng_generate_schedule).
// batt_soc < 0 keeps the current battery state (the reference never resets the
// BESS across episodes).
void ng_engine_reset(void* h, const double* occupancy, const double* capacity,
                     const double* requested_soc, const double* soc_init,
                     const double* is_arrival, const double* dep_obs,
                     const double* mask_departing,
                     const double* mask_departing3, double batt_soc,
                     double pv_shift, double* obs_out) {
  auto* e = static_cast<NgEngine*>(h);
  size_t sz = (size_t)e->n * e->L;
  std::memcpy(e->occ.data(), occupancy, sz * sizeof(double));
  std::memcpy(e->cap.data(), capacity, sz * sizeof(double));
  std::memcpy(e->req.data(), requested_soc, sz * sizeof(double));
  std::memcpy(e->soc.data(), soc_init, sz * sizeof(double));
  std::memcpy(e->is_arr.data(), is_arrival, sz * sizeof(double));
  std::memcpy(e->dep_obs.data(), dep_obs, sz * sizeof(double));
  std::memcpy(e->m1.data(), mask_departing, sz * sizeof(double));
  std::memcpy(e->m3.data(), mask_departing3, sz * sizeof(double));
  if (batt_soc >= 0.0) { e->batt_soc = batt_soc; }
  e->batt_init = e->batt_soc;
  e->pv_shift = pv_shift;
  e->t = 0;
  // reset's observe computes the penalty set at t=0 (SURVEY.md section 3.1)
  {
    const double* mask = e->mask_table();
    for (int c = 0; c < e->n; ++c)
      e->pmask[c] = mask ? mask[(size_t)c * e->L] : 0.0;
  }
  ng_observe(e, obs_out);
}

// One step.  info_out (length 16):
//  [0] total_cost [1] grid_energy_cost [2] grid_energy [3] grid_power
//  [4] utilized_solar [5] total_penalty [6] battery_penalty [7] vehicle_penalty
//  [8] battery_action [9] total_charging [10] total_discharging
//  [11] battery_power [12] battery_calc_power [13] battery_soc
//  [14] initial_battery_soc [15] nonexistent_penalty
// charger_powers_out: length n.  Returns 1 when the day completed (done).
int ng_engine_step(void* h, const double* actions, double* obs_out,
                   double* reward_out, double* info_out,
                   double* charger_powers_out) {
  auto* e = static_cast<NgEngine*>(h);
  const int n = e->n, L = e->L, T = e->T, t = e->t;
  const double dt = e->dt;
  const int tm1 = (t == 0) ? L - 1 : t - 1;  // (t-1) mod L wraparound (Q2)

  double battery_action = e->batt ? actions[n] : 0.0;
  if (t == 0 && e->batt) e->batt_init = e->batt_soc;

  // --- chargers (charger.py:37-144) ---
  double total_charging = 0.0, total_discharging = 0.0, nonexistent = 0.0;
  for (int c = 0; c < n; ++c) {
    const size_t row = (size_t)c * L;
    const double a = actions[c];
    const bool occupied = e->occ[row + t] > 0.0;
    double power = 0.0;
    if (occupied) {
      const bool arrival = e->is_arr[row + t] > 0.0;
      const double cap_eff = arrival ? e->cap[row + t] : e->cap[row + tm1];
      const double soc_eff = arrival ? e->soc[row + t] : e->soc[row + tm1];
      const double safe_cap = (cap_eff > 0.0) ? cap_eff : 1.0;
      if (a == 0.0) {
        e->soc[row + t] = soc_eff;
      } else {
        const double p_raw = a * e->charger_max_power * e->charger_eff;
        const double calc = soc_eff + (p_raw * dt) / safe_cap;
        if (a > 0.0) {
          power = p_raw;
          e->soc[row + t] = std::min(calc, 1.0);
        } else {
          // inverted over-discharge flag (charger.py:122-132): any calc >= 0
          // replaces power with the full drain
          power = (calc >= 0.0) ? -(soc_eff * cap_eff) / dt : p_raw;
          e->soc[row + t] = std::max(0.0, calc);
        }
      }
    } else if (a != 0.0) {
      nonexistent += e->marker;  // charger.py:153-156
    }
    charger_powers_out[c] = power;
    if (power > 0.0) total_charging += power;
    if (power < 0.0) total_discharging += power;
  }

  // --- vehicle penalty: consume the carried trailing-observe set, then
  //     recompute it at the (still old) timestep for the next step ---
  double vehicle_penalty = 0.0;
  const double* mask = e->mask_table();
  for (int c = 0; c < n; ++c) {
    const size_t row = (size_t)c * L;
    if (e->pmask[c] > 0.0) {
      const double soc_p = e->soc[row + tm1];
      const double req_p = e->req[row + tm1];
      const double lower = e->margin_ratio * req_p;
      if (soc_p < req_p - lower) {
        const double d = (req_p - soc_p) * e->gain;
        vehicle_penalty += d * d;
      }
    }
    e->pmask[c] = mask ? mask[row + t] : 0.0;
  }

  // --- PV + energy balance (central_management_system.py:99-185) ---
  const double solar = e->pv ? e->solar_power[t] * e->pv_shift : 0.0;
  const double total_power = total_charging + total_discharging;
  double grid_power = total_power - solar;

  double batt_power = 0.0, batt_calc = 0.0, dod_penalty = 0.0;
  if (e->batt) {
    const double a = battery_action;
    if (a != 0.0) {
      const double p = a * e->batt_max_power * e->batt_eff;
      const double calc = e->batt_soc + (p * dt) / e->batt_capacity;
      batt_calc = p;
      if (a > 0.0) {
        e->batt_soc = std::min(calc, 1.0);
        batt_power = p;
      } else {
        batt_power = (calc < 0.0) ? -(e->batt_soc * e->batt_capacity) / dt : p;
        e->batt_soc = std::max(0.0, calc);
      }
      grid_power += batt_power;
    }
    if (e->batt_soc < e->batt_dod) {
      const double d = (e->batt_dod - e->batt_soc) * e->gain;
      dod_penalty = d * d;
    }
  }

  const double grid_energy = grid_power * dt;
  const double price_t = e->price[t];
  const double grid_cost =
      (grid_energy < 0.0) ? grid_energy * e->sell_coeff * price_t
                          : grid_energy * price_t;

  const double total_penalty = e->w_batt * dod_penalty + e->w_veh * vehicle_penalty;
  const double total_cost = e->grid_w * std::fabs(grid_cost) + total_penalty;
  *reward_out = -total_cost;

  ng_observe(e, obs_out);

  info_out[0] = total_cost;
  info_out[1] = grid_cost;
  info_out[2] = grid_energy;
  info_out[3] = grid_power;
  info_out[4] = solar;
  info_out[5] = total_penalty;
  info_out[6] = dod_penalty;
  info_out[7] = vehicle_penalty;
  info_out[8] = battery_action;
  info_out[9] = total_charging;
  info_out[10] = total_discharging;
  info_out[11] = batt_power;
  info_out[12] = batt_calc;
  info_out[13] = e->batt_soc;
  info_out[14] = e->batt_init;
  info_out[15] = nonexistent;

  e->t += 1;
  if (e->t == T) {
    e->t = 0;  // day rollover keeps schedule + battery (SURVEY.md Q8)
    return 1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batched serving engine: B independent envs stepped in parallel (OpenMP).
// The reference serves one env per process; production serving wants a fleet
// of independent env instances behind one call — envs never communicate, so
// the batch step is an embarrassingly-parallel loop over per-env state.
// ---------------------------------------------------------------------------

struct NgBatch {
  std::vector<NgEngine*> envs;
  int obs_dim = 0;
};

void* ng_batch_new(int n_envs, int n_chargers, double time_interval, int pv,
                   int batt, int v2x, int penalty_mode, int lookahead,
                   const double* price, int price_len, const double* rad_norm,
                   const double* solar_power, int solar_len) {
  auto* b = new NgBatch();
  b->envs.reserve((size_t)n_envs);
  for (int i = 0; i < n_envs; ++i) {
    b->envs.push_back(static_cast<NgEngine*>(ng_engine_new(
        n_chargers, time_interval, pv, batt, v2x, penalty_mode, lookahead,
        price, price_len, rad_norm, solar_power, solar_len)));
  }
  b->obs_dim = ng_engine_obs_dim(b->envs[0]);
  return b;
}

void ng_batch_free(void* h) {
  auto* b = static_cast<NgBatch*>(h);
  for (auto* e : b->envs) ng_engine_free(e);
  delete b;
}

int ng_batch_obs_dim(void* h) { return static_cast<NgBatch*>(h)->obs_dim; }

// Reset env `i` with its own schedule tables (each (n, L) row-major).
void ng_batch_reset_env(void* h, int i, const double* occupancy,
                        const double* capacity, const double* requested_soc,
                        const double* soc_init, const double* is_arrival,
                        const double* dep_obs, const double* mask_departing,
                        const double* mask_departing3, double batt_soc,
                        double pv_shift, double* obs_out) {
  auto* b = static_cast<NgBatch*>(h);
  ng_engine_reset(b->envs[(size_t)i], occupancy, capacity, requested_soc,
                  soc_init, is_arrival, dep_obs, mask_departing,
                  mask_departing3, batt_soc, pv_shift,
                  obs_out + (size_t)i * b->obs_dim);
}

// One lockstep step for the whole batch.  actions (B, A) row-major;
// obs_out (B, obs_dim); rewards/dones (B); infos (B, 16);
// charger_powers (B, n).  Returns 1 when the day completed.
int ng_batch_step(void* h, const double* actions, double* obs_out,
                  double* rewards_out, double* dones_out, double* infos_out,
                  double* charger_powers_out) {
  auto* b = static_cast<NgBatch*>(h);
  const int B = (int)b->envs.size();
  const int D = b->obs_dim;
  const int n = b->envs[0]->n;
  const int A = n + (b->envs[0]->batt ? 1 : 0);
  int done_any = 0;
#pragma omp parallel for schedule(static) reduction(| : done_any)
  for (int i = 0; i < B; ++i) {
    double reward;
    int done = ng_engine_step(
        b->envs[(size_t)i], actions + (size_t)i * A, obs_out + (size_t)i * D,
        &reward, infos_out + (size_t)i * 16,
        charger_powers_out + (size_t)i * n);
    rewards_out[i] = reward;
    dones_out[i] = (double)done;
    done_any |= done;
  }
  return done_any;
}

}  // extern "C"
