// The staged snow step and the trajectory body of the snow kernels for
// NVIDIA Hopper (sm_90a): what snow_objective.cu (K8, K9, K11) and
// snow_fused.cu (K10) share beyond snow_step.cuh.
//
// * The layers of one member with a compile-time count NL (5 or 1) in
//   registers (LayerRegs, layer_regs_init, layer_regs_step), and the step
//   with a run-time count whose layer states stay in the thread's
//   shared-memory column (column_step, NL = 0).
// * The forcing staged tile by tile into shared memory with cp.async
//   (stage_tile), one record of every series per step.
// * The trajectory body (traj_body): K9's kernel, and under the
//   compile-time STATE flag K10's, which also enters from a carried state
//   and writes the end-of-series state rows.  One time loop serves both, so
//   the two sources compile the same step in parallel.
//
// Everything sits in an anonymous namespace, as in gr4j_step.cuh.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "async_copy.cuh"
#include "snow_step.cuh"

namespace {

// Steps of forcing staged per buffer (two buffers); the run-time-L kernel
// halves it where many layers would not fit.
constexpr int kTile = 64;
// Shared memory a block may use after opting in (H100: 227 KB).
constexpr size_t kSharedOptIn = 232448;
// K9 and K10: steps per staged tile and per tile of discharge stores.
constexpr int kTrajTile = 32;

// The layer series of one step of forcing (snow, rain, temperature and
// with SCA the NDSI).  A staging buffer holds one record per step,
// [snow (L) | rain (L) | temp (L) (| ndsi (L)) | etp | qobs], so a step
// reads its forcing at fixed offsets from one pointer.
template <bool SCA>
__host__ __device__ constexpr int layer_series() {
  return SCA ? 4 : 3;
}

// Copy steps [t0, t0 + steps) of the forcing into the records of `buf`
// (`record` values each); consecutive threads read consecutive elements.
// The trajectory kernels (K9, K10) have no observations (QOBS = false).
template <typename Real, bool SNOW_ONLY, bool SCA, bool QOBS = true>
__device__ __forceinline__ void stage_tile(const SnowArgs<Real>& a, Real* buf,
                                           int t0, int steps, int L,
                                           int record) {
  const size_t first = (size_t)t0 * L;
  for (int j = threadIdx.x; j < steps * L; j += blockDim.x) {
    Real* cell = buf + (j / L) * record + j % L;
    copy_async(cell, a.snow + first + j);
    copy_async(cell + L, a.rain + first + j);
    copy_async(cell + 2 * L, a.temp + first + j);
    if (SCA) copy_async(cell + 3 * L, a.ndsi + first + j);
  }
  Real* series = buf + layer_series<SCA>() * L;
  for (int j = threadIdx.x; j < steps; j += blockDim.x) {
    if (!SNOW_ONLY) copy_async(series + j * record, a.etp + t0 + j);
    if (QOBS) copy_async(series + j * record + 1, a.qobs + t0 + j);
  }
}

// The layers of one member with a compile-time count: states, constants,
// glacier shares and band sums in registers.
template <typename Real, int NL, bool SCA>
struct LayerRegs {
  Real G[NL], eTG[NL], sca[NL], swe[NL], cst[NL], fice[NL];
  Real band[SCA ? NL : 1][4];
};

template <typename Real, int NL, bool HYST, bool ICE, bool SCA>
__device__ __forceinline__ void layer_regs_init(LayerRegs<Real, NL, SCA>& ly,
                                                const SnowArgs<Real>& a,
                                                int i) {
  const size_t n = a.n;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    ly.cst[l] = a.consts_per_member ? a.layer_consts[(size_t)l * n + i]
                                    : a.layer_consts[l];
    ly.fice[l] = ICE ? a.frac_ice[l] : Real(0);
    const bool warm = a.state_in != nullptr;
    ly.G[l] = warm ? a.state_in[(size_t)l * n + i] : Real(0);
    ly.eTG[l] = warm ? a.state_in[(size_t)(NL + l) * n + i] : Real(0);
    ly.sca[l] = (HYST && warm) ? a.state_in[(size_t)(2 * NL + l) * n + i]
                               : Real(0);
    ly.swe[l] = (HYST && warm) ? a.state_in[(size_t)(3 * NL + l) * n + i]
                               : Real(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) ly.band[SCA ? l : 0][j] = Real(0);
  }
}

// All NL layers of one member, one time step, from the step's staged
// record `row`: returns the GR4J precipitation (the layer mean of rain +
// melt, plus the weighted ice melt).
template <typename Real, int NL, bool HYST, bool ICE, bool SCA>
__device__ __forceinline__ Real layer_regs_step(const SnowMember<Real>& c,
                                                LayerRegs<Real, NL, SCA>& ly,
                                                bool first, const Real* row,
                                                int masked) {
  Real liquid_sum = Real(0), ice_sum = Real(0);
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const Real temp_l = row[2 * NL + l];
    liquid_sum += snow_layer_step<Real, HYST>(
        c, first, row[l], row[NL + l], temp_l, ly.cst[l], ly.G[l],
        ly.eTG[l], ly.sca[l], ly.swe[l]);
    if constexpr (ICE) {
      const Real melt = relu_nan(mul_rn(c.ddf, temp_l));
      ice_sum += mul_rn(ly.G[l] > Real(1) ? Real(0) : melt, ly.fice[l]);
    }
    if constexpr (SCA) {
      const Real s100 = Real(100) * ly.sca[l];
      const Real nd = row[3 * NL + l];
      if (!(masked && nd != nd)) {
        const Real d = s100 - nd;
        ly.band[l][0] += d * d;
        ly.band[l][1] += s100;
        ly.band[l][2] += s100 * s100;
        ly.band[l][3] += s100 * nd;
      }
    }
  }
  const Real p = liquid_sum / Real(NL);
  return ICE ? p + ice_sum : p;
}

// The run-time-L step: layer_regs_step's arithmetic with the layer states,
// constants and band sums in the thread's shared-memory column (`state`,
// rows `stride` apart, laid out by snow_state_init) and the glacier shares
// read from device memory.
template <typename Real, bool HYST, bool ICE, bool SCA>
__device__ __forceinline__ Real column_step(const SnowMember<Real>& c,
                                            const SnowArgs<Real>& a,
                                            bool first, const Real* row,
                                            Real* state, int stride) {
  const int L = a.num_layers;
  Real liquid_sum = Real(0), ice_sum = Real(0);
  // Not unrolled: a partly unrolled loop spilled a register (float32, ice).
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    Real* cell = state + (size_t)l * stride;
    const size_t rows = (size_t)L * stride;  // distance between state rows
    Real G = cell[0], eTG = cell[rows];
    Real sca = Real(0), swe = Real(0);
    if (HYST) {
      sca = cell[2 * rows];
      swe = cell[3 * rows];
    }
    const Real temp_l = row[2 * L + l];
    liquid_sum += snow_layer_step<Real, HYST>(
        c, first, row[l], row[L + l], temp_l,
        cell[layer_state_rows<HYST>() * rows], G, eTG, sca, swe);
    cell[0] = G;
    cell[rows] = eTG;
    if (HYST) {
      cell[2 * rows] = sca;
      cell[3 * rows] = swe;
    }
    if (ICE) {
      const Real melt = relu_nan(mul_rn(c.ddf, temp_l));
      ice_sum += mul_rn(G > Real(1) ? Real(0) : melt, __ldg(a.frac_ice + l));
    }
    if (SCA) {
      const Real s100 = Real(100) * sca;
      const Real nd = row[3 * L + l];
      if (!(a.masked && nd != nd)) {
        Real* acc = state + ((size_t)(layer_state_rows<HYST>() + 1) * L +
                             (size_t)4 * l) * stride;
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

// Launch a staged kernel, opting in to more than 48 KB of shared memory
// where it needs that.
template <typename Kernel, typename... Args>
int launch_staged(Kernel kernel, dim3 grid, int block, size_t shared,
                  cudaStream_t stream, Args... args) {
  if (shared > (size_t)kSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, block, shared, stream>>>(args...);
  return (int)cudaGetLastError();
}

// K9 and K10: (N, T) discharge (SNOW_ONLY: outflow) trajectories,
// row-major.  The snow step is K8's: layers in registers at NL = 5 and 1,
// in shared-memory columns at any other count (NL = 0), forcing staged
// `tile` steps at a time (kTrajTile for NL > 0; `tile_arg` for NL = 0)
// without observations.  The GR4J step takes one production arm, as
// K1/K2's (gr4j_production: one tanh and one IEEE division fewer, the
// two-arm step's values).  Each thread writes its member's discharge of the
// tile into its row of a block tile in shared memory, [member][step] with
// rows tile + 1 values apart (consecutive members' writes of one step land
// in different banks); after the tile's barrier, each warp copies whole
// member rows of it to device memory, its lanes on consecutive steps, so a
// member's steps of the tile leave as one contiguous run (128 B in float32,
// 256 B in float64) instead of 32 stores T values apart.
//
// STATE (K10, never SNOW_ONLY): the GR4J registers and the layer states
// enter from the carried rows when the call has them (a.hist, a.state_in;
// first_step -1), and a.fstate receives the (2 + H + 4L, N) state rows
// [s, r, hist(H), G, eTG, sca, swe_max]: the routing inputs of the last H
// steps as they are computed (one coalesced row a step across the block's
// members), the tail of the incoming history where T < H, and the stores
// and layer states after the loop, from the registers (NL > 0) or the
// column (NL = 0); without HYST the last 2L rows are zero.  Threads past N
// run the last member, take part in every barrier and write nothing.
//
// K9 takes its arguments by value and K10 by reference (BodyArgs).  By
// value, K9 compiles to the code it has without K10 in the body (by
// reference, 20 of its 48 instantiations compile otherwise, in the same
// time); by reference, K10 runs its 131072 x 365 continuation 10 % faster
// (1.27 against 1.41 ms, PERF.md section 6).
template <typename Real, bool STATE>
using BodyArgs =
    std::conditional_t<STATE, const SnowArgs<Real>&, SnowArgs<Real>>;

template <typename Real, int NUH1, int NUH2, bool HYST, bool ICE,
          bool SNOW_ONLY, int NL, bool STATE>
__device__ __forceinline__ void traj_body(BodyArgs<Real, STATE> a,
                                          int tile_arg) {
  static_assert(!(STATE && SNOW_ONLY), "K10 always runs GR4J");
  const int first_member = blockIdx.x * blockDim.x;
  const int i = first_member + threadIdx.x;
  const int im = min(i, a.n - 1);  // past N: the last member, unwritten
  const int L = NL > 0 ? NL : a.num_layers;
  const int tile = NL > 0 ? kTrajTile : tile_arg;
  // Values per staged step, as K8's (the observation's slot unused).
  const int record = layer_series<false>() * L + 2;
  const int buffer = tile * record;
  const int pitch = tile + 1;  // values between two members' rows of `out`
  extern __shared__ __align__(16) unsigned char snow_shared[];
  Real* shared = reinterpret_cast<Real*>(snow_shared);
  // [ layer columns (NL = 0) | staging 0 | staging 1 | discharge tile ]
  const int stride = blockDim.x;
  const size_t columns =
      NL > 0 ? 0 : (size_t)state_rows<HYST, false>() * L * stride;
  Real* state = shared + threadIdx.x;
  Real* stage = shared + columns;
  Real* q_tile = stage + 2 * buffer;
  Real* q_row = q_tile + threadIdx.x * pitch;

  SnowMember<Real> c;
  snow_init(c, a.params, a.n, im, a.snow0, a.th0);
  Member<Real, NUH1, NUH2> m;
  if constexpr (STATE) {
    gr4j_init(m, a.params, a.n, im, a.hist);
  } else if constexpr (!SNOW_ONLY) {
    gr4j_init(m, a.params, a.n, im);
  }
  LayerRegs<Real, (NL > 0 ? NL : 1), false> ly;
  if constexpr (NL > 0) {
    layer_regs_init<Real, NL, HYST, ICE, false>(ly, a, im);
  } else {
    snow_state_init<Real, HYST, false>(a, im, state, stride);
  }

  // K10: row k of this member's state at fstate[k * n]; the step whose
  // routing input is history row 0.  Every use sits under `if constexpr
  // (STATE)`: K9 compiles to the code of a body without state.
  constexpr int H = NUH2 - 1;
  const size_t n = a.n;
  Real* fstate = nullptr;
  int first_kept = 0;
  if constexpr (STATE) {
    fstate = a.fstate + im;
    first_kept = a.t_len - H;
    if (i < a.n) {
      for (int j = 0; j < H - a.t_len; ++j) {
        fstate[(2 + j) * n] =
            a.hist != nullptr ? a.hist[(size_t)(j + a.t_len) * n + i]
                              : Real(0);
      }
    }
  }

  const int members = min((int)blockDim.x, a.n - first_member);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int tiles = (a.t_len + tile - 1) / tile;
  stage_tile<Real, SNOW_ONLY, false, false>(a, stage, 0, min(tile, a.t_len),
                                            L, record);
  copy_commit();
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * tile;
    if (k + 1 < tiles) {
      stage_tile<Real, SNOW_ONLY, false, false>(
          a, stage + ((k + 1) & 1) * buffer, t0 + tile,
          min(tile, a.t_len - t0 - tile), L, record);
    }
    copy_commit();  // possibly empty: the group count stays one per tile
    copy_wait_older();
    __syncthreads();  // tile k has landed; the last tile's rows have left
    const Real* buf = stage + (k & 1) * buffer;
    const int steps = min(tile, a.t_len - t0);
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const bool first = t0 + s == a.first_step;
      const Real* row = buf + s * record;
      Real q;
      if constexpr (NL > 0) {
        q = layer_regs_step<Real, NL, HYST, ICE, false>(c, ly, first, row, 0);
      } else {
        q = column_step<Real, HYST, ICE, false>(c, a, first, row, state,
                                                stride);
      }
      if constexpr (!SNOW_ONLY) {
        const Real p_r = gr4j_production(
            m, step_forcing(m, q, row[layer_series<false>() * L]));
        q = gr4j_routing(m, p_r);
        if constexpr (STATE) {
          const int t = t0 + s;
          if (i < a.n && t >= first_kept) {
            fstate[(size_t)(2 + t - first_kept) * n] = p_r;
          }
        }
      }
      q_row[s] = q;
    }
    __syncthreads();  // the tile's rows are complete; the buffer is free
#pragma unroll 1
    for (int r = warp; r < members; r += warps) {
      Real* dst = a.out + (size_t)(first_member + r) * a.t_len + t0;
      const Real* src = q_tile + r * pitch;
      for (int s = lane; s < steps; s += 32) dst[s] = src[s];
    }
  }
  if constexpr (STATE) {
    if (i >= a.n) return;
    fstate[0] = m.s;
    fstate[n] = m.r;
    Real* layers = fstate + (2 + H) * n;
    if constexpr (NL > 0) {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        layers[l * n] = ly.G[l];
        layers[(NL + l) * n] = ly.eTG[l];
        layers[(2 * NL + l) * n] = HYST ? ly.sca[l] : Real(0);
        layers[(3 * NL + l) * n] = HYST ? ly.swe[l] : Real(0);
      }
    } else {
      for (int k = 0; k < 4 * L; ++k) {
        layers[k * n] = k < layer_state_rows<HYST>() * L
                            ? state[(size_t)k * stride]
                            : Real(0);
      }
    }
  }
}

// One launch of K9 or K10 (`kernel`, an instantiation of a kernel that
// runs traj_body): 128 threads, two staging buffers and the block's
// discharge tile; for NL = 0 the block of the shared-memory columns (layer
// states within 48 KB) and the widest tile that fits beside them in what a
// block may opt in to.
template <typename Real, bool HYST, int NL, typename Kernel>
int launch_traj_tiles(Kernel kernel, const SnowArgs<Real>& a,
                      cudaStream_t stream) {
  const int L = a.num_layers;
  const int rows = state_rows<HYST, false>();
  const int block = NL > 0 ? kBlock : block_for(rows, L, sizeof(Real));
  if (block == 0) return (int)cudaErrorInvalidValue;
  const size_t columns =
      NL > 0 ? 0 : (size_t)rows * L * sizeof(Real) * block;
  const size_t per_step =
      (size_t)(layer_series<false>() * L + 2) * sizeof(Real);
  const auto shared_for = [&](int tile) {
    return columns + 2 * (size_t)tile * per_step +
           (size_t)block * (tile + 1) * sizeof(Real);
  };
  int tile = kTrajTile;
  while (NL == 0 && tile > 1 && shared_for(tile) > kSharedOptIn) tile /= 2;
  const size_t shared = shared_for(tile);
  if (shared > kSharedOptIn) return (int)cudaErrorInvalidValue;
  return launch_staged(kernel, dim3((a.n + block - 1) / block), block,
                       shared, stream, a, tile);
}

}  // namespace
