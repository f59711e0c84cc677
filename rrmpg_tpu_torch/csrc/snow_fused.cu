// K10: the fused Cemaneige snow + GR4J trajectories with the end-of-series
// state, for NVIDIA Hopper (sm_90a).
//
// Replaces the state kernel of rrmpg_tpu/ops/pallas_snow.py
// (_make_state_kernel, with its per-layer step _snow_step_layer):
//   K10 snowgr4j_simulate_pallas_state
//         -> snow_traj_state_kernel  (trajectories plus the end-of-series
//            state, entering cold or from a carried state)
// K8, K9 and K11 (the objectives and the trajectories without state) live
// in snow_objective.cu; the snow step these kernels share is in
// snow_step.cuh, the staged step and the trajectory body in
// snow_staged.cuh.  The kernel is K9's body under its compile-time STATE
// flag (traj_body): this source holds K10's 48 instantiations, so that the
// two snow sources compile in parallel.
//
// What bounds this kernel on this card: operations.  A step is L
// independent layer updates (each with an IEEE division) followed by one
// GR4J step, T times in sequence; K10 writes the (N, T) trajectory and
// 2 + H + 4L state rows per member, and the layer forcing ((T, L) snow,
// rain and temperature) and etp are the same for every member.  Layer
// states at a run-time count, forcing read on the recurrence and one store
// a step T values apart per lane would cost ~814 SASS instructions a
// 5-layer step behind a store stream of 32 sectors per 128 useful bytes.
//
// What the design does about it, all of it K9's (snow_staged.cuh):
// * The layer count is a template constant where the data has one, NL = 5
//   and NL = 1, so the layer states, constants and glacier shares live in
//   registers and the layer chains of a step interleave; any other L runs
//   the same body as NL = 0 on shared-memory columns.
// * The forcing is staged 32 steps a tile with cp.async, double-buffered.
// * The GR4J step takes one production arm (gr4j_production); its routing
//   input also feeds the history rows.
// * The discharge of a tile is gathered in a [member][step] shared-memory
//   tile and leaves as whole member rows after the tile's barrier.
// * The state: the routing inputs of the last H steps are written to their
//   rows as they are computed (consecutive members, one coalesced row a
//   step), the tail of the incoming history where T < H; s, r and the 4L
//   layer rows after the loop, from the registers or the column.
// The snow step's arithmetic is snow_step.cuh's (mul_rn products, IEEE
// divisions, the layer sum in layer order), so the snow rows are the plain
// version's bit for bit, and one production arm gives the two-arm step's
// values.
//
// Warm entry.  A cold start computes each layer's series constant (the
// snow-cover threshold, or with HYST the mean annual solid precipitation)
// from this call's forcing: one (L,) vector for all members.  A
// continuation must use the ORIGINAL series' constant, carried in the
// state: (L, N) rows, one per member (consts_per_member), read into the
// registers or the column before the loop.  The layer states enter from
// (4L, N) rows [G | eTG | sca | swe_max], the UH registers from the
// routing-input history (gr4j_init), and no step is the "first" one:
// `first_step` is 0 for a cold start and -1 for a warm one, a run-time
// value, so nothing is instantiated twice for warm entry.
//
// Unlike the TPU kernel there is no (8, 128) member tile, no time-tile grid,
// no lane-replicated forcing, no padding of N or T and no 8-step chunking;
// K10 reads the final state from the thread's registers or column when its
// loop ends instead of snapshotting it inside the loop, and writes the last
// H routing inputs to their state rows as they are computed instead of
// shifting a history scratch at every step.
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
// -1; a cold start passes null, null and 0.  fstate is (2 + H + 4L, N):
// [s, r, hist(H), G(L), eTG(L), sca(L), swe_max(L)], the last 2L rows zero
// without HYST.

#include <cuda_runtime.h>

#include <cstddef>

#include "snow_staged.cuh"

namespace {

// K10.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE, int NL>
__global__ void __launch_bounds__(kBlock)
snow_traj_state_kernel(SnowArgs<Real> a, int tile_arg) {
  traj_body<Real, NUH1, NUH2, HYST, ICE, false, NL, true>(a, tile_arg);
}

template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE, int NL>
int launch_state_layers(const SnowArgs<Real>& a, cudaStream_t stream) {
  return launch_traj_tiles<Real, HYST, NL>(
      snow_traj_state_kernel<Real, NUH1, NUH2, HYST, ICE, NL>, a, stream);
}

// NL from the call's layer count: 5 and 1 in registers, any other count
// in shared-memory columns.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE>
int launch_traj_state(const SnowArgs<Real>& a, cudaStream_t s) {
  if (a.num_layers == 5) {
    return launch_state_layers<Real, NUH1, NUH2, HYST, ICE, 5>(a, s);
  }
  if (a.num_layers == 1) {
    return launch_state_layers<Real, NUH1, NUH2, HYST, ICE, 1>(a, s);
  }
  return launch_state_layers<Real, NUH1, NUH2, HYST, ICE, 0>(a, s);
}

// The instantiations: every snow variant (plain, HYST, ICE, HYST + ICE) at
// both UH register pairs of gr4j_fused.cu, each at NL = 5, 1 and 0.
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
