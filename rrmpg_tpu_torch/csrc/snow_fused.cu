// Fused Cemaneige snow + GR4J ensemble kernel for NVIDIA Hopper (sm_90a):
// trajectories and state.
//
// Replaces the state kernel of rrmpg_tpu/ops/pallas_snow.py
// (_make_state_kernel, with its per-layer step _snow_step_layer):
//   K10 snowgr4j_simulate_pallas_state
//         -> snow_traj_state_kernel  (trajectories plus the end-of-series
//            state, entering cold or from a carried state)
// K8, K9 and K11 (the objectives and the trajectories without state) live
// in snow_objective.cu; the snow step these kernels share is in
// snow_step.cuh.
// Per member and step: every elevation layer advances its snow pack
// (snow_layer_step; HYST adds the SCA / SWE-maximum hysteresis, ICE the
// degree-day glacier melt under a thin pack), and the layer mean of rain +
// melt (plus the ice melt) becomes the precipitation of one gr4j_step_pr
// (gr4j_step.cuh).
//
// What bounds this kernel on this card: operations, and behind them the
// serial latency of one thread.  A step is L dependent-free layer updates
// followed by one GR4J step, T times in sequence; K10 writes the (N, T)
// trajectory and 2 + H + 4L state rows per member.  The layer forcing
// ((T, L) snow, rain and temperature) and etp are the same for every
// member: one read that the whole warp shares.
//
// What the design does about it: one thread owns one member.  The GR4J
// stores and UH registers stay in registers (Member, UH lengths as template
// constants).  The number of layers is a run-time value, so the 2L (4L with
// HYST) layer states live in shared memory as [row][thread] columns: a
// run-time layer index into a thread-local array would go to local memory,
// while consecutive threads read consecutive shared-memory words.  Any L
// works that fits a block's 48 KB (the block shrinks from 128 to 64 or 32
// threads for many layers).  The forcing reads go through __ldg.  The
// per-step stores stride across members (row-major (N, T)); K9's staged
// stores (snow_objective.cu) are the design this kernel is to take next.
// The snow step's products are written without fused multiply-adds
// (snow_step.cuh); the GR4J step keeps the contraction it has in K1-K4, and
// the compiler flags are those of the other sources.
//
// Warm entry (K10).  A cold start computes each layer's series constant (the
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
// Unlike the TPU kernel there is no (8, 128) member tile, no time-tile grid,
// no lane-replicated forcing, no padding of N or T and no 8-step chunking;
// K10 reads the final state from the thread's registers and shared-memory
// columns when its loop ends instead of snapshotting it inside the loop, and
// writes the last H routing inputs to their state rows as they are computed
// instead of shifting a history scratch at every step.
//
// C interface (bound with ctypes): every entry returns a cudaError_t as int
// (0 on success) and launches on the stream it is given without
// synchronising (K9's entries, rrmpg_snow_simulate_f32/f64, are in
// snow_objective.cu).  params is an (11, N) row-major array
// [x1, x2, x3, x4, s0, r0, CTG, Kf, 1/Thacc, Rsp, DDF] (s0/r0 absolute store
// levels; rows a variant does not use are read and ignored); snow, rain and
// temp are (T, L) row-major; frac_ice is (L,); layer_consts is (L,), or
// (L, N) with `consts_per_member`.  Warm entry: state_in is (4L, N)
// [G | eTG | sca | swe_max] (the last 2L rows are not read without HYST),
// hist the (H, N) routing-input history, oldest first, and first_step is
// -1; a cold start passes null, null and 0.  K10's
// fstate is (2 + H + 4L, N): [s, r, hist(H), G(L), eTG(L), sca(L),
// swe_max(L)], the last 2L rows zero without HYST.

#include <cuda_runtime.h>

#include <cstddef>

#include "snow_step.cuh"

namespace {

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

// The instantiations: every snow variant (plain, HYST, ICE, HYST + ICE) at
// both UH register pairs of gr4j_fused.cu.
template <typename Real, int NUH1, int NUH2>
int traj_state_variant(const SnowArgs<Real>& a, bool hyst, bool ice,
                       cudaStream_t s) {
  if (hyst && ice) return launch_traj_state<Real, NUH1, NUH2, true, true>(a, s);
  if (hyst) return launch_traj_state<Real, NUH1, NUH2, true, false>(a, s);
  if (ice) return launch_traj_state<Real, NUH1, NUH2, false, true>(a, s);
  return launch_traj_state<Real, NUH1, NUH2, false, false>(a, s);
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

}  // namespace

extern "C" {

// The largest number of layers a kernel takes: `rows_per_layer` shared
// values per layer and thread (2 layer states, 4 with hysteresis, plus the
// layer constant, plus 4 with the SCA statistics) of `real_bytes` each, in
// the narrowest block.
int rrmpg_snow_max_layers(int rows_per_layer, int real_bytes) {
  return kSharedLimit / (32 * rows_per_layer * real_bytes);
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

}  // extern "C"
