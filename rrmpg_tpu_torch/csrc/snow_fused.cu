// Fused Cemaneige snow + GR4J ensemble kernels for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas kernel template of rrmpg_tpu/ops/pallas_snow.py
// (_make_kernel, with its per-layer step _snow_step_layer):
//   K8  snowgr4j_ensemble_mse_pallas / cemaneige_ensemble_mse_pallas
//         -> snow_objective_kernel<..., SCA=false>  (MSE, or the four
//            discharge statistics)
//         -> snow_objective_kernel<..., SCA=true>   (discharge statistics
//            plus four statistics of 100*SCA against NDSI per band)
//   K9  snowgr4j_simulate_pallas / cemaneige_simulate_pallas
//         -> snow_traj_kernel
// and its state kernel (_make_state_kernel):
//   K10 snowgr4j_simulate_pallas_state
//         -> snow_traj_state_kernel  (trajectories plus the end-of-series
//            state, entering cold or from a carried state)
// and the `warm` mode of K8 (state=): the objective kernels enter from a
// carried state when they are given its rows, and the regional kernel
//   K11 snowgr4j_regional_mse_pallas (the K8 body over a third, catchment
//       grid axis) -> snow_regional_kernel
// Per member and step: every elevation layer advances its snow pack
// (snow_layer_step; HYST adds the SCA / SWE-maximum hysteresis, ICE the
// degree-day glacier melt under a thin pack), the layer mean of rain + melt
// (plus the ice melt) becomes the precipitation of one gr4j_step
// (gr4j_step.cuh), or is itself the outflow (SNOW_ONLY).
//
// What bounds these kernels on this card: operations, and behind them the
// serial latency of one thread.  A step is L dependent-free layer updates
// followed by one GR4J step, T times in sequence; K8 moves 11 parameters in
// and 1, 4 or 4 + 4L numbers out per member, K9 writes the (N, T)
// trajectory, K10 the trajectory and 2 + H + 4L state rows per member.  The
// layer forcing ((T, L) snow, rain and temperature), etp and the
// observations are the same for every member: one read that the whole warp
// shares.
//
// What the design does about it: one thread owns one member.  The GR4J
// stores and UH registers stay in registers (Member, UH lengths as template
// constants).  The number of layers is a run-time value, so the 2L (4L with
// HYST) layer states and, with SCA, the 4L band sums live in shared memory
// as [row][thread] columns: a run-time layer index into a thread-local
// array would go to local memory, while consecutive threads read
// consecutive shared-memory words.  Any L works that fits a block's 48 KB
// (the block shrinks from 128 to 64 or 32 threads for many layers).  The
// shared reads go through __ldg.  K9's per-step stores stride across members
// (row-major (N, T)); that is left as it is for now.
//
// Exact comparisons decide the snow step's branches (th == 0, g == 0,
// balance >= 0, g > 1, th_max > 0), and one ulp in (0.9*sca + 0.1)*pot_melt
// against g decides whether a pack empties.  Every product of the snow step
// is therefore written with mul_rn (__fmul_rn / __dmul_rn), which the
// compiler never contracts into a fused multiply-add: the snow state is then
// the same IEEE operations as the plain PyTorch version and follows the same
// branches in float32 and float64.  The GR4J step keeps the contraction it
// has in K1-K3, and the compiler flags are those of the other sources.
// min / max / clip propagate NaN as jnp.minimum / jnp.maximum / jnp.clip do.
//
// Warm entry.  A cold start computes each layer's series constant (the
// snow-cover threshold, or with HYST the mean annual solid precipitation)
// from this call's forcing: one (L,) vector for all members.  A continuation
// must use the ORIGINAL series' constant, carried in the state: (L, N) rows,
// one per member.  Each thread copies its constants into its shared-memory
// column before the loop, from either form, so the time loop is one code for
// both.  The layer states enter from (4L, N) rows [G | eTG | sca | swe_max],
// the UH registers from the routing-input history (gr4j_init), and no step
// is the "first" one: `first_step` is 0 for a cold start and -1 for a warm
// one, a run-time value the cold kernels compared t with before.  Nothing is
// instantiated twice for warm entry.
//
// Regional mode (K11).  One launch sweeps C catchments x N members that share
// one parameter set per member.  Block row c = blockIdx.y is catchment c: the
// kernel moves its copy of the arguments to the catchment's rows (layer
// forcing at c * T of the (C * T, L) arrays, etp and qobs at c * T, layer
// constants and glacier fractions at c * L of (C, L) arrays, since each
// catchment's constants come from its own forcing), takes its valid count
// from element c of a (C,) array, and writes its results straight to
// (C, N) or (4, C, N).  The step functions are K8's, untouched; K11 is a
// kernel of its own because run-time catchment offsets inside K8 moved its
// register counts by up to 12.
//
// Unlike the TPU kernel there is no (8, 128) member tile, no time-tile grid,
// no lane-replicated forcing, no padding of N or T and no 8-step chunking;
// K10 reads the final state from the thread's registers and shared-memory
// columns when its loop ends instead of snapshotting it inside the loop, and
// writes the last H routing inputs to their state rows as they are computed
// instead of shifting a history scratch at every step.
//
// C interface (bound with ctypes): every entry returns a cudaError_t as int
// (0 on success) and launches on the stream it is given without
// synchronising.  params is an (11, N) row-major array
// [x1, x2, x3, x4, s0, r0, CTG, Kf, 1/Thacc, Rsp, DDF] (s0/r0 absolute store
// levels; rows a variant does not use are read and ignored); snow, rain,
// temp and ndsi are (T, L) row-major; frac_ice and band_counts are (L,);
// layer_consts is (L,), or (L, N) with `consts_per_member`.  K11: snow, rain
// and temp are (C, T, L), etp and qobs (C, T), layer_consts and frac_ice
// (C, L), counts (C,).  Warm entry:
// state_in is (4L, N) [G | eTG | sca | swe_max] (the last 2L rows are not
// read without HYST), hist the (H, N) routing-input history, oldest first,
// and first_step is -1; a cold start passes null, null and 0.  K10's fstate
// is (2 + H + 4L, N): [s, r, hist(H), G(L), eTG(L), sca(L), swe_max(L)], the
// last 2L rows zero without HYST.

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

// All layers of one member, one time step: returns the GR4J precipitation
// (layer mean of rain + melt, plus the weighted ice melt).  `state` is this
// thread's column of the block's shared memory (layer_state_rows), rows
// `stride` apart.
template <typename Real, bool HYST, bool ICE, bool SCA>
__device__ __forceinline__ Real snow_catchment_step(
    const SnowMember<Real>& c, const SnowArgs<Real>& a, int t, Real* state,
    int stride) {
  const int L = a.num_layers;
  const bool first = t == a.first_step;
  const size_t base = (size_t)t * L;
  Real liquid_sum = Real(0), ice_sum = Real(0);
  for (int l = 0; l < L; ++l) {
    Real* cell = state + (size_t)l * stride;
    const size_t row = (size_t)L * stride;  // distance between state rows
    Real G = cell[0], eTG = cell[row];
    Real sca = Real(0), swe = Real(0);
    if (HYST) {
      sca = cell[2 * row];
      swe = cell[3 * row];
    }
    const Real temp_l = __ldg(a.temp + base + l);
    liquid_sum += snow_layer_step<Real, HYST>(
        c, first, __ldg(a.snow + base + l), __ldg(a.rain + base + l), temp_l,
        cell[layer_state_rows<HYST>() * row], G, eTG, sca, swe);
    cell[0] = G;
    cell[row] = eTG;
    if (HYST) {
      cell[2 * row] = sca;
      cell[3 * row] = swe;
    }
    if (ICE) {
      // Degree-day melt of the layer's glacier share; a pack above 1 mm
      // shields the ice.
      const Real melt = relu_nan(mul_rn(c.ddf, temp_l));
      ice_sum += mul_rn(G > Real(1) ? Real(0) : melt,
                        __ldg(a.frac_ice + l));
    }
    if (SCA) {
      // 100 * SCA of this band against its NDSI series; a NaN in the band
      // is a gap of that band alone.
      const Real s100 = Real(100) * sca;
      const Real nd = __ldg(a.ndsi + base + l);
      if (!(a.masked && nd != nd)) {
        Real* acc = state + ((size_t)(layer_state_rows<HYST>() + 1) * L + (size_t)4 * l) *
                            stride;
        const Real d = s100 - nd;
        acc[0] += d * d;
        acc[stride] += s100;
        acc[2 * stride] += s100 * s100;
        acc[3 * stride] += s100 * nd;
      }
    }
  }
  const Real p = liquid_sum / Real(L);
  return ICE ? p + ice_sum : p;
}

// K9: (N, T) discharge (SNOW_ONLY: outflow) trajectories, row-major.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY>
__global__ void __launch_bounds__(kBlock) snow_traj_kernel(SnowArgs<Real> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  extern __shared__ __align__(16) unsigned char snow_shared[];
  const int stride = blockDim.x;
  Real* state = reinterpret_cast<Real*>(snow_shared) + threadIdx.x;
  snow_state_init<Real, HYST, false>(a, i, state, stride);
  SnowMember<Real> c;
  snow_init(c, a.params, a.n, i, a.snow0, a.th0);
  Member<Real, NUH1, NUH2> m;
  if constexpr (!SNOW_ONLY) gr4j_init(m, a.params, a.n, i);
  Real* row = a.out + (size_t)i * a.t_len;
  for (int t = 0; t < a.t_len; ++t) {
    Real q =
        snow_catchment_step<Real, HYST, ICE, false>(c, a, t, state, stride);
    if constexpr (!SNOW_ONLY) q = gr4j_step(m, q, __ldg(a.etp + t));
    row[t] = q;
  }
}

// K10: trajectories as K9 (never SNOW_ONLY), entering cold or from a carried
// state, plus the end-of-series state rows.  The GR4J part is K4's: s and r
// after the loop, the p_r of the last H steps written to their rows as they
// are computed, the tail of the incoming history kept when T < H.  The layer
// rows come from the shared-memory column after the loop.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE>
__global__ void __launch_bounds__(kBlock)
snow_traj_state_kernel(SnowArgs<Real> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  extern __shared__ __align__(16) unsigned char snow_shared[];
  const int stride = blockDim.x;
  const int L = a.num_layers;
  const size_t n = a.n;
  constexpr int H = NUH2 - 1;
  Real* state = reinterpret_cast<Real*>(snow_shared) + threadIdx.x;
  snow_state_init<Real, HYST, false>(a, i, state, stride);
  SnowMember<Real> c;
  snow_init(c, a.params, a.n, i, a.snow0, a.th0);
  Member<Real, NUH1, NUH2> m;
  gr4j_init(m, a.params, a.n, i, a.hist);
  Real* fstate = a.fstate + i;  // row k of this member: fstate[k * n]
  for (int j = 0; j < H - a.t_len; ++j) {
    fstate[(2 + j) * n] =
        a.hist != nullptr ? a.hist[(size_t)(j + a.t_len) * n + i] : Real(0);
  }
  const int first_kept = a.t_len - H;  // the step whose p_r is history row 0
  Real* row = a.out + (size_t)i * a.t_len;
  for (int t = 0; t < a.t_len; ++t) {
    const Real p =
        snow_catchment_step<Real, HYST, ICE, false>(c, a, t, state, stride);
    Real p_r;
    row[t] = gr4j_step_pr(m, p, __ldg(a.etp + t), p_r);
    if (t >= first_kept) fstate[(size_t)(2 + t - first_kept) * n] = p_r;
  }
  fstate[0] = m.s;
  fstate[n] = m.r;
  Real* layers = fstate + (size_t)(2 + H) * n;
  for (int k = 0; k < 4 * L; ++k) {
    layers[(size_t)k * n] = k < layer_state_rows<HYST>() * L
                                ? state[(size_t)k * stride]
                                : Real(0);
  }
}

// K8.  out[i] = mean squared error; with `stats` (always with SCA) rows
// 1..3 hold the time means of [q, q^2, q*qobs]; with SCA rows 4 + 4l + j
// hold, for band l, the means of [(100 sca - ndsi)^2, 100 sca, (100 sca)^2,
// 100 sca * ndsi].  `masked` skips a NaN observation (the step itself still
// runs), discharge and each band by their own gaps; the discharge sums are
// divided by `count`, band l's by band_counts[l].
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, bool SCA>
__global__ void __launch_bounds__(kBlock)
snow_objective_kernel(SnowArgs<Real> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  extern __shared__ __align__(16) unsigned char snow_shared[];
  const int stride = blockDim.x;
  const int L = a.num_layers;
  Real* state = reinterpret_cast<Real*>(snow_shared) + threadIdx.x;
  snow_state_init<Real, HYST, SCA>(a, i, state, stride);
  SnowMember<Real> c;
  snow_init(c, a.params, a.n, i, a.snow0, a.th0);
  Member<Real, NUH1, NUH2> m;
  if constexpr (!SNOW_ONLY) gr4j_init(m, a.params, a.n, i, a.hist);
  Real sse = Real(0), sum_q = Real(0), sum_q2 = Real(0), sum_qo = Real(0);
  for (int t = 0; t < a.t_len; ++t) {
    Real q =
        snow_catchment_step<Real, HYST, ICE, SCA>(c, a, t, state, stride);
    if constexpr (!SNOW_ONLY) q = gr4j_step(m, q, __ldg(a.etp + t));
    const Real qo = __ldg(a.qobs + t);
    if (a.masked && qo != qo) continue;
    const Real diff = q - qo;
    sse += diff * diff;
    sum_q += q;
    sum_q2 += q * q;
    sum_qo += q * qo;
  }
  const size_t n = a.n;
  a.out[i] = sse / a.count;
  if (a.stats || SCA) {
    a.out[n + i] = sum_q / a.count;
    a.out[2 * n + i] = sum_q2 / a.count;
    a.out[3 * n + i] = sum_qo / a.count;
  }
  if (SCA) {
    for (int l = 0; l < L; ++l) {
      const Real band_count = __ldg(a.band_counts + l);
      for (int j = 0; j < 4; ++j) {
        const size_t k = (size_t)4 * l + j;
        a.out[(4 + k) * n + i] =
            state[((size_t)(layer_state_rows<HYST>() + 1) * L + k) * stride] /
            band_count;
      }
    }
  }
}

// K11: K8 (cold, never SCA or SNOW_ONLY) over gridDim.y = C catchments that
// share the (11, N) parameters.  `a` holds catchment 0's pointers; the
// kernel advances its copy to catchment c = blockIdx.y, and row k of
// catchment c goes to out[(k * C + c) * N + i], divided by counts[c].
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE>
__global__ void __launch_bounds__(kBlock)
snow_regional_kernel(SnowArgs<Real> a, const Real* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int L = a.num_layers;
  const size_t first = (size_t)blockIdx.y * a.t_len;  // catchment's step 0
  a.snow += first * L;
  a.rain += first * L;
  a.temp += first * L;
  a.etp += first;
  a.qobs += first;
  a.layer_consts += (size_t)blockIdx.y * L;
  a.frac_ice += (size_t)blockIdx.y * L;
  extern __shared__ __align__(16) unsigned char snow_shared[];
  const int stride = blockDim.x;
  Real* state = reinterpret_cast<Real*>(snow_shared) + threadIdx.x;
  snow_state_init<Real, HYST, false>(a, i, state, stride);
  SnowMember<Real> c;
  snow_init(c, a.params, a.n, i, a.snow0, a.th0);
  Member<Real, NUH1, NUH2> m;
  gr4j_init(m, a.params, a.n, i);
  Real sse = Real(0), sum_q = Real(0), sum_q2 = Real(0), sum_qo = Real(0);
  for (int t = 0; t < a.t_len; ++t) {
    Real q =
        snow_catchment_step<Real, HYST, ICE, false>(c, a, t, state, stride);
    q = gr4j_step(m, q, __ldg(a.etp + t));
    const Real qo = __ldg(a.qobs + t);
    if (a.masked && qo != qo) continue;
    const Real diff = q - qo;
    sse += diff * diff;
    sum_q += q;
    sum_q2 += q * q;
    sum_qo += q * qo;
  }
  const Real count = counts[blockIdx.y];
  const size_t row = (size_t)gridDim.y * a.n;  // distance between out rows
  Real* o = a.out + (size_t)blockIdx.y * a.n + i;
  o[0] = sse / count;
  if (a.stats) {
    o[row] = sum_q / count;
    o[2 * row] = sum_q2 / count;
    o[3 * row] = sum_qo / count;
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

template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY>
int launch_traj(const SnowArgs<Real>& a, cudaStream_t stream) {
  const int rows = state_rows<HYST, false>();
  const int block = block_for(rows, a.num_layers, sizeof(Real));
  if (block == 0) return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)rows * a.num_layers * sizeof(Real) * block;
  snow_traj_kernel<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY>
      <<<(a.n + block - 1) / block, block, shared, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE>
int launch_traj_state(const SnowArgs<Real>& a, cudaStream_t stream) {
  const int rows = state_rows<HYST, false>();
  const int block = block_for(rows, a.num_layers, sizeof(Real));
  if (block == 0) return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)rows * a.num_layers * sizeof(Real) * block;
  snow_traj_state_kernel<Real, NUH1, NUH2, HYST, ICE>
      <<<(a.n + block - 1) / block, block, shared, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, bool SCA>
int launch_objective(const SnowArgs<Real>& a, cudaStream_t stream) {
  const int rows = state_rows<HYST, SCA>();
  const int block = block_for(rows, a.num_layers, sizeof(Real));
  if (block == 0) return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)rows * a.num_layers * sizeof(Real) * block;
  snow_objective_kernel<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, SCA>
      <<<(a.n + block - 1) / block, block, shared, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE>
int launch_regional(const SnowArgs<Real>& a, const Real* counts,
                    int catchments, cudaStream_t stream) {
  const int rows = state_rows<HYST, false>();
  const int block = block_for(rows, a.num_layers, sizeof(Real));
  if (block == 0) return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)rows * a.num_layers * sizeof(Real) * block;
  const dim3 grid((a.n + block - 1) / block, catchments);
  snow_regional_kernel<Real, NUH1, NUH2, HYST, ICE>
      <<<grid, block, shared, stream>>>(a, counts);
  return (int)cudaGetLastError();
}

// The instantiations: every snow variant (plain, HYST, ICE, HYST + ICE) at
// both UH register pairs of gr4j_fused.cu, the SCA statistics for the two
// HYST variants, and the snow-only routine, which has no GR4J at all.
template <typename Real, int NUH1, int NUH2>
int traj_variant(const SnowArgs<Real>& a, bool hyst, bool ice,
                 cudaStream_t s) {
  if (hyst && ice) return launch_traj<Real, NUH1, NUH2, true, true, false>(a, s);
  if (hyst) return launch_traj<Real, NUH1, NUH2, true, false, false>(a, s);
  if (ice) return launch_traj<Real, NUH1, NUH2, false, true, false>(a, s);
  return launch_traj<Real, NUH1, NUH2, false, false, false>(a, s);
}

template <typename Real, int NUH1, int NUH2>
int traj_state_variant(const SnowArgs<Real>& a, bool hyst, bool ice,
                       cudaStream_t s) {
  if (hyst && ice) return launch_traj_state<Real, NUH1, NUH2, true, true>(a, s);
  if (hyst) return launch_traj_state<Real, NUH1, NUH2, true, false>(a, s);
  if (ice) return launch_traj_state<Real, NUH1, NUH2, false, true>(a, s);
  return launch_traj_state<Real, NUH1, NUH2, false, false>(a, s);
}

template <typename Real, int NUH1, int NUH2>
int objective_variant(const SnowArgs<Real>& a, bool hyst, bool ice, bool sca,
                      cudaStream_t s) {
  if (sca) {
    if (!hyst) return (int)cudaErrorInvalidValue;
    if (ice) {
      return launch_objective<Real, NUH1, NUH2, true, true, false, true>(a, s);
    }
    return launch_objective<Real, NUH1, NUH2, true, false, false, true>(a, s);
  }
  if (hyst && ice) {
    return launch_objective<Real, NUH1, NUH2, true, true, false, false>(a, s);
  }
  if (hyst) {
    return launch_objective<Real, NUH1, NUH2, true, false, false, false>(a, s);
  }
  if (ice) {
    return launch_objective<Real, NUH1, NUH2, false, true, false, false>(a, s);
  }
  return launch_objective<Real, NUH1, NUH2, false, false, false, false>(a, s);
}

template <typename Real, int NUH1, int NUH2>
int regional_variant(const SnowArgs<Real>& a, const Real* counts,
                     int catchments, bool hyst, bool ice, cudaStream_t s) {
  if (hyst && ice) {
    return launch_regional<Real, NUH1, NUH2, true, true>(a, counts,
                                                         catchments, s);
  }
  if (hyst) {
    return launch_regional<Real, NUH1, NUH2, true, false>(a, counts,
                                                          catchments, s);
  }
  if (ice) {
    return launch_regional<Real, NUH1, NUH2, false, true>(a, counts,
                                                          catchments, s);
  }
  return launch_regional<Real, NUH1, NUH2, false, false>(a, counts,
                                                         catchments, s);
}

template <typename Real>
int simulate(const SnowArgs<Real>& a, int nuh1, int nuh2, int hyst, int ice,
             int snow_only, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.n <= 0 || a.t_len <= 0) return (int)cudaSuccess;
  if (a.num_layers <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (snow_only) {
    if (hyst || ice) return (int)cudaErrorInvalidValue;
    return launch_traj<Real, 1, 1, false, false, true>(a, s);
  }
  if (nuh1 == 3 && nuh2 == 7) {
    return traj_variant<Real, 3, 7>(a, hyst != 0, ice != 0, s);
  }
  if (nuh1 == 10 && nuh2 == 21) {
    return traj_variant<Real, 10, 21>(a, hyst != 0, ice != 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Real>
int simulate_state(const SnowArgs<Real>& a, int nuh1, int nuh2, int hyst,
                   int ice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.n <= 0 || a.t_len <= 0 || a.num_layers <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((a.state_in == nullptr) != (a.hist == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nuh1 == 3 && nuh2 == 7) {
    return traj_state_variant<Real, 3, 7>(a, hyst != 0, ice != 0, s);
  }
  if (nuh1 == 10 && nuh2 == 21) {
    return traj_state_variant<Real, 10, 21>(a, hyst != 0, ice != 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Real>
int objective(const SnowArgs<Real>& a, int nuh1, int nuh2, int hyst, int ice,
              int snow_only, int sca, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.n <= 0 || a.t_len <= 0) return (int)cudaSuccess;
  if (a.num_layers <= 0) return (int)cudaErrorInvalidValue;
  if ((a.state_in == nullptr) != (a.hist == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (snow_only) {
    if (hyst || ice || sca || a.hist != nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    return launch_objective<Real, 1, 1, false, false, true, false>(a, s);
  }
  if (nuh1 == 3 && nuh2 == 7) {
    return objective_variant<Real, 3, 7>(a, hyst != 0, ice != 0, sca != 0, s);
  }
  if (nuh1 == 10 && nuh2 == 21) {
    return objective_variant<Real, 10, 21>(a, hyst != 0, ice != 0, sca != 0,
                                           s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Real>
int regional(const SnowArgs<Real>& a, const Real* counts, int catchments,
             int nuh1, int nuh2, int hyst, int ice, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.n <= 0 || a.t_len <= 0 || catchments <= 0) return (int)cudaSuccess;
  if (a.num_layers <= 0 || catchments > 65535) {  // gridDim.y
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nuh1 == 3 && nuh2 == 7) {
    return regional_variant<Real, 3, 7>(a, counts, catchments, hyst != 0,
                                        ice != 0, s);
  }
  if (nuh1 == 10 && nuh2 == 21) {
    return regional_variant<Real, 10, 21>(a, counts, catchments, hyst != 0,
                                          ice != 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

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

extern "C" {

// The largest number of layers a kernel takes: `rows_per_layer` shared
// values per layer and thread (2 layer states, 4 with hysteresis, plus the
// layer constant, plus 4 with the SCA statistics) of `real_bytes` each, in
// the narrowest block.
int rrmpg_snow_max_layers(int rows_per_layer, int real_bytes) {
  return kSharedLimit / (32 * rows_per_layer * real_bytes);
}

int rrmpg_snow_simulate_f32(const float* snow, const float* rain,
                            const float* temp, const float* etp,
                            const float* params, const float* layer_consts,
                            const float* frac_ice, int n, int t_len,
                            int num_layers, int nuh1, int nuh2, int hyst,
                            int ice, int snow_only, double snow0, double th0,
                            float* out, int device, void* stream) {
  return simulate<float>(
      make_args<float>(snow, rain, temp, etp, nullptr, nullptr, params,
                       layer_consts, frac_ice, nullptr, nullptr, nullptr, n,
                       t_len, num_layers, 0, 0, 0, snow0, th0, 1.0, out,
                       nullptr),
      nuh1, nuh2, hyst, ice, snow_only, device, stream);
}

int rrmpg_snow_simulate_state_f32(
    const float* snow, const float* rain, const float* temp, const float* etp,
    const float* params, const float* layer_consts, const float* frac_ice,
    const float* state_in, const float* hist, int n, int t_len,
    int num_layers, int nuh1, int nuh2, int hyst, int ice,
    int consts_per_member, double snow0, double th0, float* out,
    float* fstate, int device, void* stream) {
  return simulate_state<float>(
      make_args<float>(snow, rain, temp, etp, nullptr, nullptr, params,
                       layer_consts, frac_ice, nullptr, state_in, hist, n,
                       t_len, num_layers, 0, 0, consts_per_member, snow0, th0,
                       1.0, out, fstate),
      nuh1, nuh2, hyst, ice, device, stream);
}

int rrmpg_snow_objective_f32(
    const float* snow, const float* rain, const float* temp, const float* etp,
    const float* qobs, const float* ndsi, const float* params,
    const float* layer_consts, const float* frac_ice,
    const float* band_counts, const float* state_in, const float* hist, int n,
    int t_len, int num_layers, int nuh1, int nuh2, int hyst, int ice,
    int snow_only, int stats, int sca, int masked, int consts_per_member,
    double snow0, double th0, double count, float* out, int device,
    void* stream) {
  return objective<float>(
      make_args<float>(snow, rain, temp, etp, qobs, ndsi, params,
                       layer_consts, frac_ice, band_counts, state_in, hist, n,
                       t_len, num_layers, stats, masked, consts_per_member,
                       snow0, th0, count, out, nullptr),
      nuh1, nuh2, hyst, ice, snow_only, sca, device, stream);
}

int rrmpg_snow_simulate_f64(const double* snow, const double* rain,
                            const double* temp, const double* etp,
                            const double* params, const double* layer_consts,
                            const double* frac_ice, int n, int t_len,
                            int num_layers, int nuh1, int nuh2, int hyst,
                            int ice, int snow_only, double snow0, double th0,
                            double* out, int device, void* stream) {
  return simulate<double>(
      make_args<double>(snow, rain, temp, etp, nullptr, nullptr, params,
                       layer_consts, frac_ice, nullptr, nullptr, nullptr, n,
                       t_len, num_layers, 0, 0, 0, snow0, th0, 1.0, out,
                       nullptr),
      nuh1, nuh2, hyst, ice, snow_only, device, stream);
}

int rrmpg_snow_simulate_state_f64(
    const double* snow, const double* rain, const double* temp, const double* etp,
    const double* params, const double* layer_consts, const double* frac_ice,
    const double* state_in, const double* hist, int n, int t_len,
    int num_layers, int nuh1, int nuh2, int hyst, int ice,
    int consts_per_member, double snow0, double th0, double* out,
    double* fstate, int device, void* stream) {
  return simulate_state<double>(
      make_args<double>(snow, rain, temp, etp, nullptr, nullptr, params,
                       layer_consts, frac_ice, nullptr, state_in, hist, n,
                       t_len, num_layers, 0, 0, consts_per_member, snow0, th0,
                       1.0, out, fstate),
      nuh1, nuh2, hyst, ice, device, stream);
}

int rrmpg_snow_objective_f64(
    const double* snow, const double* rain, const double* temp, const double* etp,
    const double* qobs, const double* ndsi, const double* params,
    const double* layer_consts, const double* frac_ice,
    const double* band_counts, const double* state_in, const double* hist, int n,
    int t_len, int num_layers, int nuh1, int nuh2, int hyst, int ice,
    int snow_only, int stats, int sca, int masked, int consts_per_member,
    double snow0, double th0, double count, double* out, int device,
    void* stream) {
  return objective<double>(
      make_args<double>(snow, rain, temp, etp, qobs, ndsi, params,
                       layer_consts, frac_ice, band_counts, state_in, hist, n,
                       t_len, num_layers, stats, masked, consts_per_member,
                       snow0, th0, count, out, nullptr),
      nuh1, nuh2, hyst, ice, snow_only, sca, device, stream);
}

// K11: snow, rain, temp (C, T, L); etp, qobs (C, T); params (11, N) shared
// by every catchment; layer_consts and frac_ice (C, L); counts (C,) the
// steps each catchment averages over; out (C, N), or (4, C, N) with `stats`.
int rrmpg_snow_regional_objective_f32(
    const float* snow, const float* rain, const float* temp, const float* etp,
    const float* qobs, const float* params, const float* layer_consts,
    const float* frac_ice, const float* counts, int n, int t_len,
    int num_layers, int catchments, int nuh1, int nuh2, int hyst, int ice,
    int stats, int masked, double snow0, double th0, float* out, int device,
    void* stream) {
  return regional<float>(
      make_args<float>(snow, rain, temp, etp, qobs, nullptr, params,
                       layer_consts, frac_ice, nullptr, nullptr, nullptr, n,
                       t_len, num_layers, stats, masked, 0, snow0, th0, 1.0,
                       out, nullptr),
      counts, catchments, nuh1, nuh2, hyst, ice, device, stream);
}

int rrmpg_snow_regional_objective_f64(
    const double* snow, const double* rain, const double* temp,
    const double* etp, const double* qobs, const double* params,
    const double* layer_consts, const double* frac_ice, const double* counts,
    int n, int t_len, int num_layers, int catchments, int nuh1, int nuh2,
    int hyst, int ice, int stats, int masked, double snow0, double th0,
    double* out, int device, void* stream) {
  return regional<double>(
      make_args<double>(snow, rain, temp, etp, qobs, nullptr, params,
                        layer_consts, frac_ice, nullptr, nullptr, nullptr, n,
                        t_len, num_layers, stats, masked, 0, snow0, th0, 1.0,
                        out, nullptr),
      counts, catchments, nuh1, nuh2, hyst, ice, device, stream);
}

}  // extern "C"
