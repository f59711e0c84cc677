// K8, K9 and K11: the fused Cemaneige snow + GR4J objectives and
// trajectories for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel template of rrmpg_tpu/ops/pallas_snow.py
// (_make_kernel, with its per-layer step _snow_step_layer):
//   K8  snowgr4j_ensemble_mse_pallas / cemaneige_ensemble_mse_pallas
//         -> snow_objective_kernel<..., SCA=false>  (MSE, or the four
//            discharge statistics)
//         -> snow_objective_kernel<..., SCA=true>   (discharge statistics
//            plus four statistics of 100*SCA against NDSI per band)
// and its `warm` mode (state=): the kernel enters from a carried state when
// it is given its rows (first_step = -1, as in snow_fused.cu); the
// trajectories (_make_kernel(traj=True))
//   K9  snowgr4j_simulate_pallas / cemaneige_simulate_pallas
//         -> snow_traj_kernel  ((N, T) discharge, or the snow-only outflow)
// which runs K8's step and staging and writes its trajectory through a
// tile in shared memory (below); and the regional objective
//   K11 snowgr4j_regional_mse_pallas (the K8 body over a third, catchment
//       grid axis) -> snow_regional_objective_kernel
// which runs K8's body (objective_body, REGIONAL) cold on the catchment
// blockIdx.y: its own (T, L) layer forcing, etp and qobs staged by the
// block, its own layer constants and glacier fractions, its own valid
// count, its results at their place in (C, N) or (4, C, N).  The regional
// flag is a compile-time one, so no K8 instantiation carries catchment
// offsets (run-time offsets inside K8 moved its registers by up to 12).
// K10, the trajectories with the end-of-series state, is in snow_fused.cu
// on K9's body (traj_body under its STATE flag); that body, the staged
// step and the layers in registers are in snow_staged.cuh.
//
// What bounds it on this card: operations.  A step is L independent layer
// updates (each with an IEEE division) followed by one GR4J step, T times
// in sequence; K8 moves 11 parameters in and 1, 4 or 4 + 4L numbers out per
// member, K9 writes the (N, T) trajectory, and the forcing is the same for
// every member.  With the layer
// states in shared-memory columns (the run-time-L kernel) a 5-layer step
// issues ~830 SASS instructions and the kernel is bound by the SMs' issue
// rate from ~67584 members on, by one thread's latency below (PERF.md
// section 6); the register design below issues ~570.
//
// What the design does about it:
// * The layer count is a template constant NL where the data has one:
//   NL = 5 (every snow sheet of the repository, its examples and the bench
//   shape) and NL = 1 (the lumped case).  The layer states, constants and
//   glacier shares (and with SCA the band sums) then live in registers,
//   the layer loop is unrolled, and the NL independent layer chains of a
//   step interleave in the instruction stream: a step costs about one layer
//   chain plus the GR4J chain instead of NL layer chains.  Any other L runs
//   the same kernel as NL = 0 with snow_fused.cu's shared-memory columns
//   (snow_step.cuh), chosen at compile time.
// * The forcing of a step ((T, L) snow, rain and temperature, etp, qobs and
//   with SCA the (T, L) NDSI) is staged: the block copies it tile by tile
//   (64 steps) into shared memory with cp.async, double-buffered, so the
//   next tile lands while this one is computed and no read of device memory
//   sits on the recurrence; a step reads broadcasts from shared memory.
//   Each element is one 4- or 8-byte copy (async_copy.cuh), so a series
//   that a slice starts at any element needs no alignment beyond its
//   type's.  Every thread of a
//   block takes part in the copies and barriers; threads past N run the
//   last member and write nothing.
// * The arithmetic of a step is snow_step.cuh's, unchanged: the same
//   operations in the same order, every mul_rn product and IEEE division,
//   the layer sum in layer order; only where the state lives, how the
//   layers are scheduled and how the forcing arrives differ from the
//   run-time-L kernels.
// * K9's GR4J step takes one production arm (gr4j_production, the values
//   of the two-arm gr4j_step that K8 and K11 keep).
// * K9's stores: a warp's 32 members store one step each at T values
//   apart, 32 sectors for 128 useful bytes, which left K3 (the same store
//   stream beside less arithmetic) bound by its stores.  K9 gathers a
//   tile's discharge in shared memory and writes each member's run of
//   steps as one contiguous segment (snow_traj_kernel); the output stays
//   the row-major (N, T) array every consumer reads.
//
// out[i] = mean squared error; with `stats` (always with SCA) rows 1..3 hold
// the time means of [q, q^2, q*qobs]; with SCA rows 4 + 4l + j hold, for
// band l, the means of [(100 sca - ndsi)^2, 100 sca, (100 sca)^2,
// 100 sca * ndsi].  `masked` skips a NaN observation (the step itself still
// runs), discharge and each band by their own gaps; the discharge sums are
// divided by `count`, band l's by band_counts[l].
//
// K9 writes out (N, T) (SNOW_ONLY: the outflow); it reads no qobs, ndsi,
// state or history.
//
// C interface (bound with ctypes), as snow_fused.cu's: every entry returns
// a cudaError_t as int (0 on success) and launches on the stream it is given
// without synchronising.  params is an (11, N) row-major array
// [x1, x2, x3, x4, s0, r0, CTG, Kf, 1/Thacc, Rsp, DDF]; snow, rain, temp and
// ndsi are (T, L) row-major; frac_ice and band_counts are (L,);
// layer_consts is (L,), or (L, N) with `consts_per_member`; warm entry:
// state_in (4L, N) [G | eTG | sca | swe_max] and hist (H, N), else null.
// K11: snow, rain and temp are (C, T, L), etp and qobs (C, T),
// layer_consts and frac_ice (C, L), counts (C,).

#include <cuda_runtime.h>

#include <cstddef>

#include "snow_staged.cuh"

namespace {

// K8.  NL = 0 takes the layer count from the arguments; `tile_arg` is then
// the staged steps per buffer (NL > 0 stages kTile).  The staged records
// sit at one pointer per step with every value at a fixed offset from it:
// a layout of one block per series (snow of every step, then rain, ...)
// read through two pointers, one of them offset, was miscompiled by the
// CUDA 12.9 ptxas at NL = 5 with SCA and UH (3, 7) (the etp address lost
// the offset; the read left the block's shared memory).
//
// The body is shared with K11 (REGIONAL), which runs it on one catchment's
// series, advanced to by the regional kernel, and writes to that
// catchment's place in (C, N) or (4, C, N), divided by its own count.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, bool SCA, int NL, bool REGIONAL>
__device__ __forceinline__ void objective_body(const SnowArgs<Real>& a,
                                               int tile_arg,
                                               const Real* counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < a.n;
  const int im = active ? i : a.n - 1;  // past N: the last member, unwritten
  const int L = NL > 0 ? NL : a.num_layers;
  const int tile = NL > 0 ? kTile : tile_arg;
  const int record = layer_series<SCA>() * L + 2;  // values per staged step
  const int buffer = tile * record;
  extern __shared__ __align__(16) unsigned char snow_shared[];
  Real* shared = reinterpret_cast<Real*>(snow_shared);
  // [ layer columns (NL = 0) | staging buffer 0 | staging buffer 1 ]
  const int stride = blockDim.x;
  const size_t columns =
      NL > 0 ? 0 : (size_t)state_rows<HYST, SCA>() * L * stride;
  Real* state = shared + threadIdx.x;
  Real* stage = shared + columns;

  SnowMember<Real> c;
  snow_init(c, a.params, a.n, im, a.snow0, a.th0);
  Member<Real, NUH1, NUH2> m;
  if constexpr (!SNOW_ONLY) gr4j_init(m, a.params, a.n, im, a.hist);
  LayerRegs<Real, (NL > 0 ? NL : 1), SCA> ly;
  if constexpr (NL > 0) {
    layer_regs_init<Real, NL, HYST, ICE, SCA>(ly, a, im);
  } else {
    snow_state_init<Real, HYST, SCA>(a, im, state, stride);
  }

  Real sse = Real(0), sum_q = Real(0), sum_q2 = Real(0), sum_qo = Real(0);
  const int tiles = (a.t_len + tile - 1) / tile;
  stage_tile<Real, SNOW_ONLY, SCA>(a, stage, 0, min(tile, a.t_len), L,
                                   record);
  copy_commit();
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * tile;
    if (k + 1 < tiles) {
      stage_tile<Real, SNOW_ONLY, SCA>(a, stage + ((k + 1) & 1) * buffer,
                                       t0 + tile,
                                       min(tile, a.t_len - t0 - tile), L,
                                       record);
    }
    copy_commit();  // possibly empty: the group count stays one per tile
    copy_wait_older();
    __syncthreads();
    const Real* buf = stage + (k & 1) * buffer;
    const int steps = min(tile, a.t_len - t0);
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const bool first = t0 + s == a.first_step;
      const Real* row = buf + s * record;
      const Real* series = row + layer_series<SCA>() * L;  // etp, qobs
      Real q;
      if constexpr (NL > 0) {
        q = layer_regs_step<Real, NL, HYST, ICE, SCA>(c, ly, first, row,
                                                      a.masked);
      } else {
        q = column_step<Real, HYST, ICE, SCA>(c, a, first, row, state,
                                              stride);
      }
      if constexpr (!SNOW_ONLY) q = gr4j_step(m, q, series[0]);
      const Real qo = series[1];
      if (a.masked && qo != qo) continue;
      const Real diff = q - qo;
      sse += diff * diff;
      sum_q += q;
      sum_q2 += q * q;
      sum_qo += q * qo;
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
  if (!active) return;
  const size_t n = a.n;
  if constexpr (REGIONAL) {
    // Row k of catchment c = blockIdx.y at out[(k * C + c) * N + i].
    const size_t row = (size_t)gridDim.y * n;
    Real* o = a.out + (size_t)blockIdx.y * n + i;
    const Real count = __ldg(counts + blockIdx.y);
    o[0] = sse / count;
    if (a.stats) {
      o[row] = sum_q / count;
      o[2 * row] = sum_q2 / count;
      o[3 * row] = sum_qo / count;
    }
    return;
  }
  a.out[i] = sse / a.count;
  if (a.stats || SCA) {
    a.out[n + i] = sum_q / a.count;
    a.out[2 * n + i] = sum_q2 / a.count;
    a.out[3 * n + i] = sum_qo / a.count;
  }
  if constexpr (SCA && NL > 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const Real band_count = __ldg(a.band_counts + l);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a.out[(4 + (size_t)4 * l + j) * n + i] = ly.band[l][j] / band_count;
      }
    }
  } else if constexpr (SCA) {
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

// K8.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, bool SCA, int NL>
__global__ void __launch_bounds__(kBlock)
snow_objective_kernel(SnowArgs<Real> a, int tile_arg) {
  objective_body<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, SCA, NL, false>(
      a, tile_arg, nullptr);
}

// K11: K8 (cold, never SCA or SNOW_ONLY) over gridDim.y = C catchments that
// share the (11, N) parameters.  `a` holds catchment 0's pointers; the
// kernel advances its copy to catchment c = blockIdx.y (layer forcing at
// c * T of the (C * T, L) arrays, etp and qobs at c * T, layer constants
// and glacier fractions at c * L of (C, L) arrays), so the block stages
// its own catchment's forcing; counts[c] is the catchment's valid count.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE, int NL>
__global__ void __launch_bounds__(kBlock)
snow_regional_objective_kernel(SnowArgs<Real> a,
                               const Real* __restrict__ counts,
                               int tile_arg) {
  const int L = NL > 0 ? NL : a.num_layers;
  const size_t first = (size_t)blockIdx.y * a.t_len;  // catchment's step 0
  a.snow += first * L;
  a.rain += first * L;
  a.temp += first * L;
  a.etp += first;
  a.qobs += first;
  a.layer_consts += (size_t)blockIdx.y * L;
  a.frac_ice += (size_t)blockIdx.y * L;
  objective_body<Real, NUH1, NUH2, HYST, ICE, false, false, NL, true>(
      a, tile_arg, counts);
}

// K9: (N, T) discharge (SNOW_ONLY: outflow) trajectories, row-major, cold:
// traj_body (snow_staged.cuh) without state.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, int NL>
__global__ void __launch_bounds__(kBlock)
snow_traj_kernel(SnowArgs<Real> a, int tile_arg) {
  traj_body<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, NL, false>(a, tile_arg);
}

// One launch: 128 threads and two staging buffers for NL > 0; for NL = 0
// the block of snow_fused.cu (layer columns within 48 KB) and the widest
// tile whose buffers fit beside them in what a block may opt in to.  K11
// (REGIONAL) adds the catchments as the grid's second dimension.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, bool SCA, int NL, bool REGIONAL>
int launch_layers(const SnowArgs<Real>& a, const Real* counts,
                  int catchments, cudaStream_t stream) {
  const int L = a.num_layers;
  const int rows = state_rows<HYST, SCA>();
  const int block = NL > 0 ? kBlock : block_for(rows, L, sizeof(Real));
  if (block == 0) return (int)cudaErrorInvalidValue;
  const size_t columns =
      NL > 0 ? 0 : (size_t)rows * L * sizeof(Real) * block;
  const size_t per_step = (size_t)(layer_series<SCA>() * L + 2) * sizeof(Real);
  int tile = kTile;
  while (NL == 0 && tile > 1 && columns + 2 * tile * per_step > kSharedOptIn) {
    tile /= 2;
  }
  const size_t shared = columns + 2 * (size_t)tile * per_step;
  if (shared > kSharedOptIn) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.n + block - 1) / block, catchments);
  if constexpr (REGIONAL) {
    return launch_staged(
        snow_regional_objective_kernel<Real, NUH1, NUH2, HYST, ICE, NL>, grid,
        block, shared, stream, a, counts, tile);
  } else {
    return launch_staged(
        snow_objective_kernel<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, SCA,
                              NL>,
        grid, block, shared, stream, a, tile);
  }
}

// NL from the call's layer count: 5 and 1 in registers, any other count
// in shared-memory columns.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, bool SCA, bool REGIONAL = false>
int launch_objective(const SnowArgs<Real>& a, cudaStream_t s,
                     const Real* counts = nullptr, int catchments = 1) {
  if (a.num_layers == 5) {
    return launch_layers<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, SCA, 5,
                         REGIONAL>(a, counts, catchments, s);
  }
  if (a.num_layers == 1) {
    return launch_layers<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, SCA, 1,
                         REGIONAL>(a, counts, catchments, s);
  }
  return launch_layers<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, SCA, 0,
                       REGIONAL>(a, counts, catchments, s);
}

// The instantiations: every snow variant (plain, HYST, ICE, HYST + ICE) at
// both UH register pairs of gr4j_fused.cu, the SCA statistics for the two
// HYST variants, and the snow-only routine, which has no GR4J at all; each
// at NL = 5, 1 and 0.
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

// K11's instantiations: every snow variant at both UH register pairs, each
// at NL = 5, 1 and 0.
template <typename Real, int NUH1, int NUH2>
int regional_variant(const SnowArgs<Real>& a, const Real* counts,
                     int catchments, bool hyst, bool ice, cudaStream_t s) {
  if (hyst && ice) {
    return launch_objective<Real, NUH1, NUH2, true, true, false, false, true>(
        a, s, counts, catchments);
  }
  if (hyst) {
    return launch_objective<Real, NUH1, NUH2, true, false, false, false,
                            true>(a, s, counts, catchments);
  }
  if (ice) {
    return launch_objective<Real, NUH1, NUH2, false, true, false, false,
                            true>(a, s, counts, catchments);
  }
  return launch_objective<Real, NUH1, NUH2, false, false, false, false, true>(
      a, s, counts, catchments);
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

// K9's launch (launch_traj_tiles).
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, int NL>
int launch_traj_layers(const SnowArgs<Real>& a, cudaStream_t stream) {
  return launch_traj_tiles<Real, HYST, NL>(
      snow_traj_kernel<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, NL>, a,
      stream);
}

// NL from the call's layer count, as launch_objective.
template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY>
int launch_traj(const SnowArgs<Real>& a, cudaStream_t s) {
  if (a.num_layers == 5) {
    return launch_traj_layers<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, 5>(a, s);
  }
  if (a.num_layers == 1) {
    return launch_traj_layers<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, 1>(a, s);
  }
  return launch_traj_layers<Real, NUH1, NUH2, HYST, ICE, SNOW_ONLY, 0>(a, s);
}

// K9's instantiations: every snow variant at both UH register pairs, and
// the snow-only routine, which has no GR4J at all; each at NL = 5, 1 and 0.
template <typename Real, int NUH1, int NUH2>
int traj_variant(const SnowArgs<Real>& a, bool hyst, bool ice,
                 cudaStream_t s) {
  if (hyst && ice) return launch_traj<Real, NUH1, NUH2, true, true, false>(a, s);
  if (hyst) return launch_traj<Real, NUH1, NUH2, true, false, false>(a, s);
  if (ice) return launch_traj<Real, NUH1, NUH2, false, true, false>(a, s);
  return launch_traj<Real, NUH1, NUH2, false, false, false>(a, s);
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

}  // namespace

extern "C" {

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

int rrmpg_snow_objective_f64(
    const double* snow, const double* rain, const double* temp,
    const double* etp, const double* qobs, const double* ndsi,
    const double* params, const double* layer_consts, const double* frac_ice,
    const double* band_counts, const double* state_in, const double* hist,
    int n, int t_len, int num_layers, int nuh1, int nuh2, int hyst, int ice,
    int snow_only, int stats, int sca, int masked, int consts_per_member,
    double snow0, double th0, double count, double* out, int device,
    void* stream) {
  return objective<double>(
      make_args<double>(snow, rain, temp, etp, qobs, ndsi, params,
                        layer_consts, frac_ice, band_counts, state_in, hist,
                        n, t_len, num_layers, stats, masked,
                        consts_per_member, snow0, th0, count, out, nullptr),
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

}  // extern "C"
