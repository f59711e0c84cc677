// The Cemaneige snow step shared by the snow kernels for NVIDIA Hopper
// (sm_90a).
//
// Replaces the per-layer step of rrmpg_tpu/ops/pallas_snow.py
// (_snow_step_layer, with its hysteresis and glacier-melt arms) and what
// the kernels of _make_kernel / _make_state_kernel share around it: one
// member's snow parameters (SnowMember, snow_init), one layer's step
// (snow_layer_step), the arguments every snow kernel is given (SnowArgs),
// and the shared-memory column that holds the layer states of a run-time
// layer count (snow_state_init; its step is column_step of
// snow_staged.cuh, which snow_objective.cu (K8, K9, K11) and snow_fused.cu
// (K10) include beside this header and gr4j_step.cuh).
//
// Exact comparisons decide the snow step's branches (th == 0, g == 0,
// balance >= 0, g > 1, th_max > 0), and one ulp in (0.9*sca + 0.1)*pot_melt
// against g decides whether a pack empties.  Every product of the snow step
// is therefore written with mul_rn (__fmul_rn / __dmul_rn), which the
// compiler never contracts into a fused multiply-add: the snow state is then
// the same IEEE operations as the plain PyTorch version and follows the same
// branches in float32 and float64.  min / max / clip propagate NaN as
// jnp.minimum / jnp.maximum / jnp.clip do.
//
// Everything sits in an anonymous namespace, as in gr4j_step.cuh.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "gr4j_step.cuh"

namespace {

constexpr int kSharedLimit = 48 * 1024;

// Products that are never contracted into a fused multiply-add.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// min / max that propagate NaN from either side.
template <typename Real>
__device__ __forceinline__ Real min_nan(Real x, Real y) {
  return (x < y || x != x) ? x : y;
}

template <typename Real>
__device__ __forceinline__ Real max_nan(Real x, Real y) {
  return (x > y || x != x) ? x : y;
}

// One member's snow parameters; the cold-start levels are the same for
// every member and layer.
template <typename Real>
struct SnowMember {
  Real ctg, one_minus_ctg, kf, ithacc, rsp, ddf;
  Real snow0, th0;
};

template <typename Real>
__device__ __forceinline__ void snow_init(SnowMember<Real>& c,
                                          const Real* __restrict__ params,
                                          int n, int i, Real snow0,
                                          Real th0) {
  const Real* col = params + i;  // row r of this member: col[r * n]
  c.ctg = col[(size_t)6 * n];
  c.one_minus_ctg = Real(1) - c.ctg;
  c.kf = col[(size_t)7 * n];
  c.ithacc = col[(size_t)8 * n];
  c.rsp = col[(size_t)9 * n];
  c.ddf = col[(size_t)10 * n];
  c.snow0 = snow0;
  c.th0 = th0;
}

// One elevation layer, one time step (_snow_step_layer,
// pallas_snow.py:52-112); returns the layer's liquid water (rain + melt) and
// updates the layer state in place.  `layer_const` is the snow-cover
// threshold (plain) or the mean annual solid precipitation (HYST).  `init`
// marks the initialization step of a cold start (t = 0); a warm
// continuation has none.
template <typename Real, bool HYST>
__device__ __forceinline__ Real snow_layer_step(
    const SnowMember<Real>& c, bool init, Real snow, Real rain, Real temp,
    Real layer_const, Real& G, Real& eTG, Real& sca, Real& swe) {
  const Real zero = Real(0);
  Real g = init ? c.snow0 : G + snow;
  Real th = init ? c.th0
                 : mul_rn(c.ctg, eTG) + mul_rn(c.one_minus_ctg, temp);
  th = min_nan(th, zero);
  const bool melting = (th == zero) && (temp > zero);
  const Real pot_melt = melting ? min_nan(mul_rn(c.kf, temp), g) : zero;

  Real melt;
  if (HYST) {
    const Real th_melt = mul_rn(layer_const, c.rsp);
    const Real balance = snow - pot_melt;
    const bool accumulating = balance >= zero;
    const Real sca_prev = init ? zero : sca;
    const Real swe_prev = init ? zero : swe;
    const Real sca_acc = sca_prev + mul_rn(balance, c.ithacc);
    const Real th_max = min_nan(swe_prev, th_melt);
    const Real sca_abl = th_max > zero ? g / th_max : zero;
    sca = clamp01(accumulating ? sca_acc : sca_abl);
    swe = accumulating ? max_nan(swe_prev, g) : swe_prev;
    melt = min_nan(mul_rn(mul_rn(Real(0.9), sca) + Real(0.1), pot_melt), g);
    g = g - melt;
    if (g == zero) swe = zero;  // the pack emptied: forget its maximum
  } else {
    const Real safe = layer_const > zero ? layer_const : Real(1);
    const Real ratio = g < layer_const ? g / safe : Real(1);
    melt = mul_rn(mul_rn(Real(0.9), ratio) + Real(0.1), pot_melt);
    g = g - melt;
  }
  G = g;
  eTG = th;
  return rain + melt;
}

// What every kernel of this file is given.
template <typename Real>
struct SnowArgs {
  const Real* snow;          // (T, L) solid precipitation
  const Real* rain;          // (T, L) liquid precipitation
  const Real* temp;          // (T, L) mean temperature
  const Real* etp;           // (T,)
  const Real* qobs;          // (T,)    objective kernels
  const Real* ndsi;          // (T, L)  SCA statistics
  const Real* params;        // (11, N)
  const Real* layer_consts;  // (L,), or (L, N) with consts_per_member
  const Real* frac_ice;      // (L,)
  const Real* band_counts;   // (L,)    SCA statistics: steps per band
  const Real* state_in;      // (4L, N) warm entry, else null
  const Real* hist;          // (H, N)  warm entry, else null
  int n, t_len, num_layers;
  int stats, masked;
  int consts_per_member;
  int first_step;            // 0: cold start; -1: warm, no step is first
  Real snow0, th0, count;
  Real* out;
  Real* fstate;              // (2 + H + 4L, N)  K10
};

// Rows of one thread's shared-memory column, per layer: the layer states
// [G | eTG] (HYST: [G | eTG | sca | swe]), then the layer constant, then
// with SCA the four band sums.
template <bool HYST>
__host__ __device__ constexpr int layer_state_rows() {
  return HYST ? 4 : 2;
}

template <bool HYST, bool SCA>
__host__ __device__ constexpr int state_rows() {
  return layer_state_rows<HYST>() + 1 + (SCA ? 4 : 0);  // per layer
}

// Before the time loop: zero the column, copy the layer constants in (the
// call's own or the member's carried ones) and, on warm entry, the carried
// layer states.
template <typename Real, bool HYST, bool SCA>
__device__ __forceinline__ void snow_state_init(const SnowArgs<Real>& a,
                                                int i, Real* state,
                                                int stride) {
  const int L = a.num_layers;
  for (int k = 0; k < state_rows<HYST, SCA>() * L; ++k) {
    state[(size_t)k * stride] = Real(0);
  }
  Real* consts = state + (size_t)layer_state_rows<HYST>() * L * stride;
  for (int l = 0; l < L; ++l) {
    consts[(size_t)l * stride] =
        a.consts_per_member ? a.layer_consts[(size_t)l * a.n + i]
                            : a.layer_consts[l];
  }
  if (a.state_in != nullptr) {
    for (int k = 0; k < layer_state_rows<HYST>() * L; ++k) {
      state[(size_t)k * stride] = a.state_in[(size_t)k * a.n + i];
    }
  }
}

// The widest block (128, 64 or 32 threads) whose layer state fits the
// shared memory a block may use without opting in; 0 if none does.
inline int block_for(int rows_per_layer, int num_layers, size_t real_bytes) {
  const size_t per_thread = (size_t)rows_per_layer * num_layers * real_bytes;
  for (int block = kBlock; block >= 32; block /= 2) {
    if (per_thread * block <= (size_t)kSharedLimit) return block;
  }
  return 0;
}

// The arguments of one call, as the C entry points of both sources build
// them.
template <typename Real>
SnowArgs<Real> make_args(const Real* snow, const Real* rain, const Real* temp,
                         const Real* etp, const Real* qobs, const Real* ndsi,
                         const Real* params, const Real* layer_consts,
                         const Real* frac_ice, const Real* band_counts,
                         const Real* state_in, const Real* hist, int n,
                         int t_len, int num_layers, int stats, int masked,
                         int consts_per_member, double snow0, double th0,
                         double count, Real* out, Real* fstate) {
  SnowArgs<Real> a;
  a.snow = snow;
  a.rain = rain;
  a.temp = temp;
  a.etp = etp;
  a.qobs = qobs;
  a.ndsi = ndsi;
  a.params = params;
  a.layer_consts = layer_consts;
  a.frac_ice = frac_ice;
  a.band_counts = band_counts;
  a.state_in = state_in;
  a.hist = hist;
  a.n = n;
  a.t_len = t_len;
  a.num_layers = num_layers;
  a.stats = stats;
  a.masked = masked;
  a.consts_per_member = consts_per_member;
  a.first_step = state_in != nullptr ? -1 : 0;
  a.snow0 = Real(snow0);
  a.th0 = Real(th0);
  a.count = Real(count);
  a.out = out;
  a.fstate = fstate;
  return a;
}

}  // namespace
