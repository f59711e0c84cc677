// The GR4J step shared by the fused kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the shared helpers of rrmpg_tpu/ops/pallas_gr4j.py (_gr4j_step,
// _init_block): one member's parameters and state (Member), the init
// (gr4j_init: cold, or warm from a carried routing-input history) and one
// time step (gr4j_step; gr4j_step_pr also gives the routing input), written
// once as device functions.  gr4j_fused.cu (K1-K5) and, through
// snow_step.cuh, snow_fused.cu and snow_objective.cu (K8-K11) include this
// header.  The step is also split in its two halves, production
// (gr4j_production, one arm a step, from the terms step_forcing computes)
// and routing (gr4j_routing), for the objective kernels K1/K2 (which for
// small ensembles run the two halves in different warps) and K5, and the
// snow trajectories K9.
//
// One thread owns one member.  The UH register lengths are template
// constants, so after unrolling every index into the ordinate and shift
// register arrays is a compile-time constant and they stay in registers.
//
// Everything sits in an anonymous namespace: each source that includes the
// header gets its own copy, and the sources link into one library without
// clashing.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ float dev_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dev_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dev_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double dev_rsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float dev_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double dev_pow(double x, double y) { return pow(x, y); }

// max(x, 0) that propagates NaN, as jnp.maximum / torch.clamp do.
template <typename Real>
__device__ __forceinline__ Real relu_nan(Real x) {
  return (x > Real(0) || x != x) ? x : Real(0);
}

template <typename Real>
__device__ __forceinline__ Real clamp01(Real x) {
  return x < Real(0) ? Real(0) : (x > Real(1) ? Real(1) : x);
}

template <typename Real>
__device__ __forceinline__ Real pow4(Real x) {
  Real x2 = x * x;
  return x2 * x2;
}

// S-curves of the reference (gr4j_model.py:159-192), for t >= 0.
template <typename Real>
__device__ __forceinline__ Real s_curve1(Real t, Real x4) {
  if (t <= Real(0)) return Real(0);
  return dev_pow(clamp01(t / x4), Real(2.5));
}

template <typename Real>
__device__ __forceinline__ Real s_curve2(Real t, Real x4) {
  if (t <= Real(0)) return Real(0);
  Real ratio = t / x4;
  if (t <= x4) return Real(0.5) * dev_pow(clamp01(ratio), Real(2.5));
  return Real(1) - Real(0.5) * dev_pow(clamp01(Real(2) - ratio), Real(2.5));
}

// One member's parameters and state.  Local to the thread; with constant
// indices the arrays live in registers.
template <typename Real, int NUH1, int NUH2>
struct Member {
  Real x1, x2, ix1, ix3;
  Real s, r;
  Real oh1[NUH1], oh2[NUH2];  // UH ordinates
  Real uh1[NUH1], uh2[NUH2];  // UH shift registers
};

// Push one routing input through both UH shift registers.
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ void uh_push(Member<Real, NUH1, NUH2>& m,
                                        Real p_r) {
  const Real pr1 = Real(0.9) * p_r;
  const Real pr2 = Real(0.1) * p_r;
#pragma unroll
  for (int j = 0; j < NUH1 - 1; ++j) m.uh1[j] = m.uh1[j + 1] + m.oh1[j] * pr1;
  m.uh1[NUH1 - 1] = m.oh1[NUH1 - 1] * pr1;
#pragma unroll
  for (int j = 0; j < NUH2 - 1; ++j) m.uh2[j] = m.uh2[j + 1] + m.oh2[j] * pr2;
  m.uh2[NUH2 - 1] = m.oh2[NUH2 - 1] * pr2;
}

// _init_block: stores from the packed absolute levels, UH ordinates from x4,
// shift registers empty (cold start, hist == nullptr) or rebuilt from the
// carried routing inputs (warm entry).  `hist` is (NUH2 - 1, N) row-major,
// oldest input first.  The register invariant is
//   uh[j] = sum_m oh[j + m] * pr[t - 1 - m]
// (each register holds the partial filter sums still owed by past inputs),
// which is what pushing the H carried inputs through empty registers leaves
// behind: the warm entry replays them, oldest first, in a loop that is not
// unrolled.  A run-time pointer decides, the time loop is the same code
// either way, and the replay costs the cold kernels no register (an unrolled
// triangular product of history and ordinates cost K1/K2 up to 11).
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ void gr4j_init(Member<Real, NUH1, NUH2>& m,
                                          const Real* __restrict__ params,
                                          int n, int i,
                                          const Real* __restrict__ hist =
                                              nullptr) {
  const Real x1 = params[i];
  const Real x3 = params[2 * (size_t)n + i];
  const Real x4 = params[3 * (size_t)n + i];
  m.x1 = x1;
  m.x2 = params[(size_t)n + i];
  m.ix1 = Real(1) / x1;
  m.ix3 = Real(1) / x3;
  m.s = params[4 * (size_t)n + i];
  m.r = params[5 * (size_t)n + i];
#pragma unroll
  for (int j = 0; j < NUH1; ++j) {
    m.oh1[j] = s_curve1(Real(j + 1), x4) - s_curve1(Real(j), x4);
    m.uh1[j] = Real(0);
  }
#pragma unroll
  for (int j = 0; j < NUH2; ++j) {
    m.oh2[j] = s_curve2(Real(j + 1), x4) - s_curve2(Real(j), x4);
    m.uh2[j] = Real(0);
  }
  if (hist != nullptr) {
    constexpr int H = NUH2 - 1;
    const Real* col = hist + i;
#pragma unroll 1
    for (int k = 0; k < H; ++k) uh_push(m, col[(size_t)k * n]);
  }
}

// The routing half of a GR4J step: push the routing input p_r through the
// UH registers, then the routing store (eq. 18 + non-linear outflow) and
// the direct flow; returns the discharge.  No production state enters it.
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ Real gr4j_routing(Member<Real, NUH1, NUH2>& m,
                                             Real p_r) {
  const Real one = Real(1);
  // unit hydrograph shift registers
  uh_push(m, p_r);

  // routing store (eq. 18 + non-linear outflow)
  const Real rx = m.r * m.ix3;
  const Real rx2 = rx * rx;
  const Real gw_exchange = m.x2 * (rx2 * rx * dev_sqrt(rx));  // (r/x3)^3.5
  const Real r_interim = relu_nan(m.r + m.uh1[0] + gw_exchange);
  const Real zr = pow4(r_interim * m.ix3);
  const Real q_r = r_interim * (one - dev_rsqrt(dev_sqrt(one + zr)));
  m.r = r_interim - q_r;
  const Real q_d = relu_nan(m.uh2[0] + gw_exchange);
  return q_r + q_d;
}

// The end of a production step from the interim store: percolation;
// returns the routing input p_r.
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ Real gr4j_percolate(Member<Real, NUH1, NUH2>& m,
                                               Real s_interim, Real p_n,
                                               Real p_s) {
  const Real one = Real(1);
  const Real zs = pow4(s_interim * m.ix1 * Real(4.0 / 9.0));
  const Real perc = s_interim * (one - dev_rsqrt(dev_sqrt(one + zs)));
  m.s = s_interim - perc;
  return perc + (p_n - p_s);
}

// One GR4J time step (_gr4j_step, pallas_gr4j.py:56-117); returns the
// discharge and gives the routing input p_r (what the UH filters take in,
// the state kernels' history).  1/x1 and 1/x3 are multiplies; the rain and
// evaporation arms need no branch because the inactive one is exactly zero.
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ Real gr4j_step_pr(Member<Real, NUH1, NUH2>& m,
                                             Real p, Real e, Real& p_r_out) {
  const Real one = Real(1);
  // production store (eq. 3/4 + percolation)
  const Real p_n = relu_nan(p - e);
  const Real pe_n = relu_nan(e - p);
  const Real sr = m.s * m.ix1;
  const Real tanh_pn = dev_tanh(p_n * m.ix1);
  const Real tanh_pen = dev_tanh(pe_n * m.ix1);
  const Real p_s = (m.x1 * (one - sr * sr) * tanh_pn) / (one + sr * tanh_pn);
  const Real e_s =
      (m.s * (Real(2) - sr) * tanh_pen) / (one + (one - sr) * tanh_pen);
  const Real p_r = gr4j_percolate(m, m.s - e_s + p_s, p_n, p_s);
  p_r_out = p_r;
  return gr4j_routing(m, p_r);
}

// The terms of a production step that no state enters (the split K1/K2
// kernel computes them a step ahead of the recurrence): the net rain,
// which arm is active (rain where p > e, else evaporation) and the tanh of
// that arm, tanh(|p - e| / x1).  For p > e, |p - e| is the rain arm's
// argument; otherwise e - p == -(p - e) exactly, so it is the evaporation
// arm's (0 for p == e, NaN for NaN forcing, as relu_nan gives there).
template <typename Real>
struct StepForcing {
  Real p_n, t;
  bool rain;
};

template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ StepForcing<Real> step_forcing(
    const Member<Real, NUH1, NUH2>& m, Real p, Real e) {
  const Real d = p - e;
  StepForcing<Real> f;
  f.p_n = relu_nan(d);
  f.rain = d > Real(0);
  f.t = dev_tanh(fabs(d) * m.ix1);
  return f;
}

// The production half of gr4j_step_pr with one arm a step: one tanh (the
// caller's, in f) and one division instead of two.  The arm's factors are
// those of gr4j_step_pr, A t / (1 + B t) with (A, B) = (x1 (1 - sr^2), sr)
// for rain and (s (2 - sr), 1 - sr) for evaporation, so the active arm is
// the same operations on the same values.  The inactive arm of the
// two-arm step is A' 0 / (1 + B' 0): +-0, or NaN where A' or B' is not
// finite (an inf or NaN store); `idle` is +-0 or NaN in exactly those
// cases, so the interim store s - e_s + p_s and the routing input are the
// two-arm step's values.  Returns p_r.
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ Real gr4j_production(Member<Real, NUH1, NUH2>& m,
                                                const StepForcing<Real>& f) {
  const Real one = Real(1), zero = Real(0);
  const Real sr = m.s * m.ix1;
  const Real a_rain = m.x1 * (one - sr * sr);
  const Real a_evap = m.s * (Real(2) - sr);
  const Real b_evap = one - sr;
  const Real a = f.rain ? a_rain : a_evap;
  const Real b = f.rain ? sr : b_evap;
  const Real arm = (a * f.t) / (one + b * f.t);
  const Real idle =
      (f.rain ? a_evap : a_rain) * zero + (f.rain ? b_evap : sr) * zero;
  const Real p_s = f.rain ? arm : idle;
  const Real e_s = f.rain ? idle : arm;
  return gr4j_percolate(m, m.s - e_s + p_s, f.p_n, p_s);
}

// The step for kernels that do not keep the routing input.
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ Real gr4j_step(Member<Real, NUH1, NUH2>& m,
                                          Real p, Real e) {
  Real p_r;
  return gr4j_step_pr(m, p, e, p_r);
}

}  // namespace
