// Fused GR4J ensemble kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of rrmpg_tpu/ops/pallas_gr4j.py:
//   K1  _mse_kernel    (gr4j_ensemble_mse_pallas)             -> gr4j_objective_kernel<..., STATS=false>
//   K2  _stats_kernel  (gr4j_ensemble_mse_pallas, stats=True) -> gr4j_objective_kernel<..., STATS=true>
//       (both as gr4j_objective_split_kernel for small ensembles)
//   K3  _traj_kernel   (gr4j_simulate_pallas)                 -> gr4j_traj_kernel
//       (as gr4j_traj_split_kernel for small ensembles)
//   K4  _traj_final_kernel (gr4j_simulate_pallas_state)       -> gr4j_traj_state_kernel
//       (as gr4j_traj_state_split_kernel for small ensembles)
//   K5  gr4j_regional_mse_pallas (the K1/K2 body over a third,
//       catchment grid axis)                                  -> gr4j_regional_kernel
// and the `warm` mode of K1/K2 (state=): the objective kernels enter from a
// carried state when they are given a routing-input history.
// The shared step/init they are built from (_gr4j_step, _init_block) are
// gr4j_step / gr4j_init in gr4j_step.cuh, which the snow kernels include
// too.
//
// What bounds these kernels on this card: per-thread serial latency.  Each
// member is one long recurrence of T dependent steps (tanh, two divides,
// sqrt/rsqrt chains, the routing store), so a thread cannot start step t+1
// before step t ends.  The forcing series (prec, etp, qobs) is the same for
// every member: one read per step that the whole warp shares.  K1/K2 move
// only 6 parameters in and 1 or 4 numbers out per member; K3 writes the
// (N, T) trajectory, K4 the trajectory and 2 + H state rows per member
// (H = NUH2 - 1 routing inputs, the window the UH filters still integrate).
//
// What the design does about it: one thread owns one member, and the
// production/routing stores and both UH shift registers stay in registers
// for the whole time loop (the UH lengths are template constants, so every
// register index is a compile-time constant after unrolling and nothing
// spills to local memory).  Latency is hidden by running many members per
// SM.  The objective accumulates in registers.
//
// K1/K2 were redesigned for this card (PERF.md section 6).  At 131072
// members they are bound by the SMs' issue rate, at a calibration's 60 by
// one warp's dependent chain.  Against both: the forcing is staged in
// shared memory with cp.async (no device read on the recurrence), and a
// step computes one production arm, one tanh and one IEEE division instead
// of two (gr4j_production, the same values as the two-arm step); against
// the chain, small ensembles run the production and the routing halves of
// the step in different warps (gr4j_objective_split_kernel).
//
// Regional mode (K5).  One launch sweeps C catchments x N members that share
// one parameter set per member: block row c = blockIdx.y is catchment c,
// whose series start at c * T of the (C, T) arrays, whose valid count is
// element c of a (C,) device array, and whose results go straight to their
// place in (C, N) or (4, C, N).  K5 runs K1/K2's staged one-arm body
// (objective_body) under a compile-time REGIONAL flag, with the catchment
// offsets applied by its own kernel outside that body: run-time offsets
// inside K1/K2 moved the single-catchment kernels' register counts (float32
// (10, 21) MSE: 80 -> 86) and their time.  Its launches hold C x N threads
// (8 x 131072 on every path), where the SMs' issue binds, so the split
// kernel of small ensembles is not carried over.
//
// K4 and K3 were redesigned for this card too (PERF.md section 6).  The
// first port of both read the forcing through __ldg, took the two-arm step
// and stored one step at a time across members (row-major (N, T)): a
// warp's 32 stores of one step landed T values apart, 32 sectors for 128
// useful bytes, and bound them (~12.6 ms of stores behind ~3 ms of compute
// at 131072 x 3651).  Now both stage their forcing as K1/K2 do, take one
// production arm a step, and gather each 64-step tile of the (N, T)
// trajectory in shared memory, as K14 does: each thread writes its member's
// discharge of the tile into its row of a [member][step] tile (rows
// kTrajTile + 1 values apart, so one step's writes fall in 32 banks), and
// after the tile's barrier each warp copies whole member rows to device
// memory, its lanes on consecutive steps (one 256-byte run a member and
// tile in float32).  They share that time loop, traj_body, under a
// compile-time STATE flag: K4 is STATE=true, K3 STATE=false (no history
// read, no state rows).  Small ensembles (a forecast's one-member spin-up,
// a calibrated member's simulation) run the production and the routing
// halves in different warps, as K1/K2's do (traj_split_body, under the
// same flag: gr4j_traj_state_split_kernel and gr4j_traj_split_kernel).
//
// Unlike the TPU kernels there is no (8, 128) member tiling, no padding of
// N or T and no time-tile grid: the kernel masks i < N itself and loops to
// T exactly.  K4 therefore needs neither the TPU kernel's state snapshot
// inside the loop nor its history scratch shifted at every step: the state
// is what the thread holds when its loop ends, and the last H routing inputs
// go straight to their state rows as they are computed.
//
// C interface (bound with ctypes): every entry returns a cudaError_t as int
// (0 on success) and launches on the stream it is given without
// synchronising.  params is a (6, N) row-major array
// [x1, x2, x3, x4, s0, r0] with s0/r0 the absolute initial store levels.

#include <cuda_runtime.h>

#include <cstddef>

#include "async_copy.cuh"
#include "gr4j_step.cuh"

namespace {

// K1/K2: steps of forcing staged per buffer (two buffers).
constexpr int kTile = 64;
// K1/K2 with production and routing split between warps: ensembles of at
// most kSplitMembers members (measured on the H100: faster up to 33792
// members at T = 3651, 27 % slower at 67584, where the SMs' issue binds;
// PERF.md section 6), and the steps handed over per tile.
constexpr int kSplitMembers = 33792;
constexpr int kSplitTile = 32;

// K4: steps per staged tile of forcing and per tile of discharge stores
// (64 beat 32 by 4 % on the H100, PERF.md section 6).
constexpr int kTrajTile = 64;
// K3 and K4 with production and routing split between warps: ensembles of
// at most kTrajSplitMembers members, one block of 64 a SM (measured on the
// H100 for K4: 0.54-0.63 of the tile kernel's time up to 8448 members at
// T = 3651 and at the one-member spin-up, 1.74 times it at 33792, where
// the split kernel's per-step stores across members bind; PERF.md
// section 6).
constexpr int kTrajSplitMembers = 8448;
// Shared memory a block may use without opting in, and after (H100: 227 KB).
constexpr size_t kSharedLimit = 48 * 1024;
constexpr size_t kSharedOptIn = 232448;

// Copy steps [t0, t0 + steps) of prec and etp into the [p, e] records of
// `buf`, consecutive threads on consecutive steps.
template <typename Real>
__device__ __forceinline__ void stage_records(Real (*buf)[2],
                                              const Real* prec,
                                              const Real* etp, int t0,
                                              int steps) {
  for (int s = threadIdx.x; s < steps; s += blockDim.x) {
    copy_async(&buf[s][0], prec + t0 + s);
    copy_async(&buf[s][1], etp + t0 + s);
  }
}

// The trajectory time loop: (N, T) discharge, row-major.  The forcing
// arrives kTrajTile steps at a time, copied by the whole block into shared
// memory with cp.async, double-buffered, so no device read sits on the
// recurrence; a step takes one production arm (gr4j_production, the two-arm
// step's values).  Each thread writes its member's discharge of the tile
// into its row of the [member][step] tile; after the tile's barrier each
// warp copies whole member rows of it to device memory, its lanes on
// consecutive steps.  Dynamic shared memory: [2][kTrajTile][2] staging,
// then the [kBlock][kTrajTile + 1] discharge tile.  Every thread takes part
// in the copies and barriers; threads past N run the last member and write
// nothing.
//
// STATE (K4): the registers enter cold (hist == nullptr) or from a carried
// routing-input history, and fstate receives the (2 + H, N) state rows
// [s, r, hist(H)].  The final history is the last H values of [incoming
// history or zeros | p_r[0..T)]: the p_r of the last H steps, each written
// to its row as it is computed (one coalesced row a step across the block's
// members); a segment shorter than H keeps the tail of the incoming rows.
// GR4J has no initialization step, so a cold start's first step is an
// ordinary one and the loop carries no first-step test.  Without STATE
// nothing reads hist or writes fstate.
template <typename Real, int NUH1, int NUH2, bool STATE>
__device__ __forceinline__ void traj_body(const Real* __restrict__ prec,
                                          const Real* __restrict__ etp,
                                          const Real* __restrict__ params,
                                          const Real* __restrict__ hist,
                                          int n, int t_len,
                                          Real* __restrict__ out,
                                          Real* __restrict__ fstate) {
  constexpr int kPitch = kTrajTile + 1;  // values between two members' rows
  extern __shared__ __align__(16) unsigned char gr4j_shared[];
  auto stage = reinterpret_cast<Real(*)[kTrajTile][2]>(gr4j_shared);
  Real* q_tile = &stage[2][0][0];
  Real* q_row = q_tile + threadIdx.x * kPitch;
  const int first_member = blockIdx.x * blockDim.x;
  const int i = first_member + threadIdx.x;
  const int im = min(i, n - 1);  // past N: the last member, unwritten
  Member<Real, NUH1, NUH2> m;
  gr4j_init(m, params, n, im, STATE ? hist : nullptr);

  // K4: row k of this member's state at state[k * n]; the step whose
  // routing input is history row 0 (t_len, never reached, past N).
  constexpr int H = NUH2 - 1;
  Real* state = nullptr;
  int first_kept = t_len;
  if constexpr (STATE) {
    state = fstate + im;
    if (i < n) {
      first_kept = t_len - H;
      for (int j = 0; j < H - t_len; ++j) {
        state[(size_t)(2 + j) * n] =
            hist != nullptr ? hist[(size_t)(j + t_len) * n + i] : Real(0);
      }
    }
  }

  const int members = min((int)blockDim.x, n - first_member);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int tiles = (t_len + kTrajTile - 1) / kTrajTile;
  stage_records(stage[0], prec, etp, 0, min(kTrajTile, t_len));
  copy_commit();
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kTrajTile;
    if (k + 1 < tiles) {
      stage_records(stage[(k + 1) & 1], prec, etp, t0 + kTrajTile,
                    min(kTrajTile, t_len - t0 - kTrajTile));
    }
    copy_commit();  // possibly empty: the group count stays one per tile
    copy_wait_older();
    __syncthreads();  // tile k has landed; the last tile's rows have left
    const Real(*buf)[2] = stage[k & 1];
    const int steps = min(kTrajTile, t_len - t0);
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const Real p_r =
          gr4j_production(m, step_forcing(m, buf[s][0], buf[s][1]));
      q_row[s] = gr4j_routing(m, p_r);
      if constexpr (STATE) {
        const int t = t0 + s;
        if (t >= first_kept) state[(size_t)(2 + t - first_kept) * n] = p_r;
      }
    }
    __syncthreads();  // the tile's rows are complete; the buffer is free
#pragma unroll 1
    for (int r = warp; r < members; r += warps) {
      Real* dst = out + (size_t)(first_member + r) * t_len + t0;
      const Real* src = q_tile + r * kPitch;
      for (int j = lane; j < steps; j += 32) dst[j] = src[j];
    }
  }
  if constexpr (STATE) {
    if (i >= n) return;
    state[0] = m.s;
    state[n] = m.r;
  }
}

// K4: trajectories as K3, entering cold (hist == nullptr) or from a carried
// state, plus the end-of-series state as (2 + H, N) rows [s, r, hist(H)]
// (traj_body, STATE).
template <typename Real, int NUH1, int NUH2>
__global__ void __launch_bounds__(kBlock)
gr4j_traj_state_kernel(const Real* __restrict__ prec,
                       const Real* __restrict__ etp,
                       const Real* __restrict__ params,
                       const Real* __restrict__ hist, int n, int t_len,
                       Real* __restrict__ out, Real* __restrict__ fstate) {
  traj_body<Real, NUH1, NUH2, true>(prec, etp, params, hist, n, t_len, out,
                                    fstate);
}

// K3: (N, T) discharge trajectories, row-major, from a cold start: K4's
// time loop without the state (traj_body, STATE=false).
template <typename Real, int NUH1, int NUH2>
__global__ void __launch_bounds__(kBlock)
gr4j_traj_kernel(const Real* __restrict__ prec, const Real* __restrict__ etp,
                 const Real* __restrict__ params, int n, int t_len,
                 Real* __restrict__ out) {
  traj_body<Real, NUH1, NUH2, false>(prec, etp, params, nullptr, n, t_len,
                                     out, nullptr);
}

// The trajectory time loop for small ensembles (n <= kTrajSplitMembers: a
// forecast's one-member spin-up, a calibrated member's simulation), where
// one warp's dependent chain decides the time.  As in
// gr4j_objective_split_kernel, threads 0..63 run the production store of
// members 0..63 of the block (the forcing terms a step ahead of the chain)
// and hand each p_r through shared memory to threads 64..127, which run the
// UH registers and the routing store one tile behind and store q straight
// to the member's row (few members: the strided stores do not bind).  The
// forcing is staged kSplitTile steps at a time in two buffers (only
// production reads it).  Each member runs the same operations on the same
// values as in traj_body.  STATE (K4): the routing thread enters from the
// carried history and writes the history rows as the p_r arrive; the
// production thread writes s, the routing thread r.  Without STATE nothing
// reads hist or writes fstate.
template <typename Real, int NUH1, int NUH2, bool STATE>
__device__ __forceinline__ void traj_split_body(
    const Real* __restrict__ prec, const Real* __restrict__ etp,
    const Real* __restrict__ params, const Real* __restrict__ hist, int n,
    int t_len, Real* __restrict__ out, Real* __restrict__ fstate) {
  constexpr int kMembers = kBlock / 2;
  constexpr int H = NUH2 - 1;
  __shared__ __align__(16) Real stage[2][kSplitTile][2];
  __shared__ Real routed[2][kSplitTile][kMembers];
  const bool routing = threadIdx.x >= kMembers;
  const int lane = threadIdx.x - (routing ? kMembers : 0);
  const int i = blockIdx.x * kMembers + lane;
  const int im = min(i, n - 1);  // past N: the last member, unwritten
  Member<Real, NUH1, NUH2> m;
  gr4j_init(m, params, n, im, STATE && routing ? hist : nullptr);
  Real* state = nullptr;  // row k of this member: state[k * n]
  if constexpr (STATE) state = fstate + im;
  Real* row = out + (size_t)im * t_len;
  const bool writes = routing && i < n;
  int first_kept = t_len;  // the step whose p_r is history row 0
  if constexpr (STATE) {
    if (writes) {
      first_kept = t_len - H;
      for (int j = 0; j < H - t_len; ++j) {
        state[(size_t)(2 + j) * n] =
            hist != nullptr ? hist[(size_t)(j + t_len) * n + i] : Real(0);
      }
    }
  }
  const int tiles = (t_len + kSplitTile - 1) / kSplitTile;
  stage_records(stage[0], prec, etp, 0, min(kSplitTile, t_len));
  copy_commit();
#pragma unroll 1
  for (int k = 0; k <= tiles; ++k) {
    if (k + 1 < tiles) {
      const int t1 = (k + 1) * kSplitTile;
      stage_records(stage[(k + 1) & 1], prec, etp, t1,
                    min(kSplitTile, t_len - t1));
    }
    copy_commit();  // possibly empty: the group count stays one per tile
    copy_wait_older();
    __syncthreads();  // tile k has landed; routed[(k - 1) & 1] is complete
    if (!routing && k < tiles) {
      const Real(*buf)[2] = stage[k & 1];
      Real(*pr)[kMembers] = routed[k & 1];
      const int last = min(kSplitTile, t_len - k * kSplitTile) - 1;
      StepForcing<Real> f = step_forcing(m, buf[0][0], buf[0][1]);
#pragma unroll 1
      for (int s = 0; s <= last; ++s) {
        const int ahead = min(s + 1, last);  // past the tile: unused
        const StepForcing<Real> f_ahead =
            step_forcing(m, buf[ahead][0], buf[ahead][1]);
        pr[s][lane] = gr4j_production(m, f);
        f = f_ahead;
      }
    } else if (routing && k > 0) {
      const Real(*pr)[kMembers] = routed[(k - 1) & 1];
      const int t0 = (k - 1) * kSplitTile;
      const int steps = min(kSplitTile, t_len - t0);
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        const Real p_r = pr[s][lane];
        const Real q = gr4j_routing(m, p_r);
        const int t = t0 + s;
        if (writes) row[t] = q;
        if constexpr (STATE) {
          if (t >= first_kept) state[(size_t)(2 + t - first_kept) * n] = p_r;
        }
      }
    }
    __syncthreads();  // a buffer is refilled, a hand-over rewritten, after
  }
  if constexpr (STATE) {
    if (i >= n) return;
    if (routing) {
      state[n] = m.r;
    } else {
      state[0] = m.s;
    }
  }
}

// K4 for small ensembles (traj_split_body, STATE).
template <typename Real, int NUH1, int NUH2>
__global__ void __launch_bounds__(kBlock)
gr4j_traj_state_split_kernel(const Real* __restrict__ prec,
                             const Real* __restrict__ etp,
                             const Real* __restrict__ params,
                             const Real* __restrict__ hist, int n, int t_len,
                             Real* __restrict__ out,
                             Real* __restrict__ fstate) {
  traj_split_body<Real, NUH1, NUH2, true>(prec, etp, params, hist, n, t_len,
                                          out, fstate);
}

// K3 for small ensembles (traj_split_body without the state).
template <typename Real, int NUH1, int NUH2>
__global__ void __launch_bounds__(kBlock)
gr4j_traj_split_kernel(const Real* __restrict__ prec,
                       const Real* __restrict__ etp,
                       const Real* __restrict__ params, int n, int t_len,
                       Real* __restrict__ out) {
  traj_split_body<Real, NUH1, NUH2, false>(prec, etp, params, nullptr, n,
                                           t_len, out, nullptr);
}

// The sums of the objective kernels for one step: squared error and, with
// STATS, q, q^2 and q * qobs; MASKED leaves out a NaN observation.
template <typename Real, bool STATS, bool MASKED>
__device__ __forceinline__ void accumulate(Real q, Real qo, Real& sse,
                                           Real& sum_q, Real& sum_q2,
                                           Real& sum_qo) {
  if (MASKED && qo != qo) return;
  const Real diff = q - qo;
  sse += diff * diff;
  if (STATS) {
    sum_q += q;
    sum_q2 += q * q;
    sum_qo += q * qo;
  }
}

// Copy steps [t0, t0 + steps) of prec, etp and qobs into the records of
// `buf`, one [p, e, qobs, unused] record per step.
template <typename Real>
__device__ __forceinline__ void stage_forcing(Real (*buf)[4],
                                              const Real* prec,
                                              const Real* etp,
                                              const Real* qobs, int t0,
                                              int steps) {
  for (int s = threadIdx.x; s < steps; s += blockDim.x) {
    copy_async(&buf[s][0], prec + t0 + s);
    copy_async(&buf[s][1], etp + t0 + s);
    copy_async(&buf[s][2], qobs + t0 + s);
  }
}

// K1 (STATS=false): out[i] = mean squared error.
// K2 (STATS=true): out[k*N + i] = time means of [err^2, q, q^2, q*qobs].
// MASKED skips steps whose observation is NaN (the step itself still runs);
// `count` is the number of steps averaged over (T, or the valid count).
// With `hist` the objective is that of a warm continuation.
//
// The forcing arrives 64 steps at a time: the block copies a tile of
// records into shared memory with cp.async, double-buffered, so no read of
// device memory sits on the recurrence.  A step computes one production
// arm (gr4j_production).  Every thread of a block takes part in the copies
// and barriers; threads past N run the last member and write nothing.
//
// The body is shared with K5 (REGIONAL), which runs it cold on one
// catchment's series, advanced to by the regional kernel, and writes to
// that catchment's place in (C, N) or (4, C, N), divided by its own count.
// The flag is a compile-time one, so no K1/K2 instantiation carries the
// catchment offsets.
template <typename Real, int NUH1, int NUH2, bool STATS, bool MASKED,
          bool REGIONAL>
__device__ __forceinline__ void objective_body(
    const Real* __restrict__ prec, const Real* __restrict__ etp,
    const Real* __restrict__ qobs, const Real* __restrict__ params,
    const Real* __restrict__ hist, int n, int t_len, Real count,
    const Real* __restrict__ counts, Real* __restrict__ out) {
  __shared__ __align__(16) Real stage[2][kTile][4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Member<Real, NUH1, NUH2> m;
  gr4j_init(m, params, n, min(i, n - 1), hist);
  Real sse = Real(0), sum_q = Real(0), sum_q2 = Real(0), sum_qo = Real(0);
  const int tiles = (t_len + kTile - 1) / kTile;
  stage_forcing(stage[0], prec, etp, qobs, 0, min(kTile, t_len));
  copy_commit();
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kTile;
    if (k + 1 < tiles) {
      stage_forcing(stage[(k + 1) & 1], prec, etp, qobs, t0 + kTile,
                    min(kTile, t_len - t0 - kTile));
    }
    copy_commit();  // possibly empty: the group count stays one per tile
    copy_wait_older();
    __syncthreads();
    const Real(*buf)[4] = stage[k & 1];
    const int steps = min(kTile, t_len - t0);
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
      const Real p_r =
          gr4j_production(m, step_forcing(m, buf[s][0], buf[s][1]));
      accumulate<Real, STATS, MASKED>(gr4j_routing(m, p_r), buf[s][2], sse,
                                      sum_q, sum_q2, sum_qo);
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
  if (i >= n) return;
  if constexpr (REGIONAL) {
    // Row k of catchment c = blockIdx.y at out[(k * C + c) * N + i].
    const Real c_count = counts[blockIdx.y];
    const size_t row = (size_t)gridDim.y * n;
    Real* o = out + (size_t)blockIdx.y * n + i;
    o[0] = sse / c_count;
    if (STATS) {
      o[row] = sum_q / c_count;
      o[2 * row] = sum_q2 / c_count;
      o[3 * row] = sum_qo / c_count;
    }
    return;
  }
  out[i] = sse / count;
  if (STATS) {
    out[(size_t)n + i] = sum_q / count;
    out[2 * (size_t)n + i] = sum_q2 / count;
    out[3 * (size_t)n + i] = sum_qo / count;
  }
}

template <typename Real, int NUH1, int NUH2, bool STATS, bool MASKED>
__global__ void __launch_bounds__(kBlock)
gr4j_objective_kernel(const Real* __restrict__ prec,
                      const Real* __restrict__ etp,
                      const Real* __restrict__ qobs,
                      const Real* __restrict__ params,
                      const Real* __restrict__ hist, int n, int t_len,
                      Real count, Real* __restrict__ out) {
  objective_body<Real, NUH1, NUH2, STATS, MASKED, false>(
      prec, etp, qobs, params, hist, n, t_len, count, nullptr, out);
}

// K1/K2 for small ensembles (n <= kSplitMembers, a calibration's
// population), where each warp's dependent chain, not the SMs' issue,
// decides the time.  The step's two halves share only the routing input
// p_r, so a block splits them between its warps: threads 0..63 run the
// production store of members 0..63 of the block (the forcing terms a step
// ahead of the chain) and hand each p_r through shared memory to threads
// 64..127, which run the UH registers, the routing store and the sums of
// the same members one tile behind.  Each warp issues one chain, on a
// scheduler of its own, so a step costs about the longer chain instead of
// both.  The forcing is staged kSplitTile steps at a time in a ring of
// three buffers (production reads tile k while routing reads tile k - 1
// and tile k + 1 lands); two barriers a tile order the hand-over.  Each
// member runs the same operations on the same values as in
// gr4j_objective_kernel.
template <typename Real, int NUH1, int NUH2, bool STATS, bool MASKED>
__global__ void __launch_bounds__(kBlock)
gr4j_objective_split_kernel(const Real* __restrict__ prec,
                            const Real* __restrict__ etp,
                            const Real* __restrict__ qobs,
                            const Real* __restrict__ params,
                            const Real* __restrict__ hist, int n, int t_len,
                            Real count, Real* __restrict__ out) {
  constexpr int kMembers = kBlock / 2;
  __shared__ __align__(16) Real stage[3][kSplitTile][4];
  __shared__ Real routed[2][kSplitTile][kMembers];
  const bool routing = threadIdx.x >= kMembers;
  const int lane = threadIdx.x - (routing ? kMembers : 0);
  const int i = blockIdx.x * kMembers + lane;
  Member<Real, NUH1, NUH2> m;
  gr4j_init(m, params, n, min(i, n - 1), routing ? hist : nullptr);
  Real sse = Real(0), sum_q = Real(0), sum_q2 = Real(0), sum_qo = Real(0);
  const int tiles = (t_len + kSplitTile - 1) / kSplitTile;
  stage_forcing(stage[0], prec, etp, qobs, 0, min(kSplitTile, t_len));
  copy_commit();
#pragma unroll 1
  for (int k = 0; k <= tiles; ++k) {
    if (k + 1 < tiles) {
      const int t1 = (k + 1) * kSplitTile;
      stage_forcing(stage[(k + 1) % 3], prec, etp, qobs, t1,
                    min(kSplitTile, t_len - t1));
    }
    copy_commit();  // possibly empty: the group count stays one per tile
    copy_wait_older();
    __syncthreads();  // tile k has landed; routed[(k - 1) & 1] is complete
    if (!routing && k < tiles) {
      const Real(*buf)[4] = stage[k % 3];
      Real(*pr)[kMembers] = routed[k & 1];
      const int last = min(kSplitTile, t_len - k * kSplitTile) - 1;
      StepForcing<Real> f = step_forcing(m, buf[0][0], buf[0][1]);
#pragma unroll 1
      for (int s = 0; s <= last; ++s) {
        const int ahead = min(s + 1, last);  // past the tile: unused
        const StepForcing<Real> f_ahead =
            step_forcing(m, buf[ahead][0], buf[ahead][1]);
        pr[s][lane] = gr4j_production(m, f);
        f = f_ahead;
      }
    } else if (routing && k > 0) {
      const Real(*buf)[4] = stage[(k - 1) % 3];
      const Real(*pr)[kMembers] = routed[(k - 1) & 1];
      const int steps = min(kSplitTile, t_len - (k - 1) * kSplitTile);
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        accumulate<Real, STATS, MASKED>(gr4j_routing(m, pr[s][lane]),
                                        buf[s][2], sse, sum_q, sum_q2,
                                        sum_qo);
      }
    }
    __syncthreads();  // a buffer is refilled, a hand-over rewritten, after
  }
  if (!routing || i >= n) return;
  out[i] = sse / count;
  if (STATS) {
    out[(size_t)n + i] = sum_q / count;
    out[2 * (size_t)n + i] = sum_q2 / count;
    out[3 * (size_t)n + i] = sum_qo / count;
  }
}

// K5: K1/K2 over gridDim.y = C catchments.  prec, etp and qobs are (C, T),
// the (6, N) parameters are shared by every catchment, counts[c] is the
// number of steps catchment c averages over, and row k of catchment c goes
// to out[(k * C + c) * N + i]: (C, N), or (4, C, N) with STATS.  The kernel
// advances the series to catchment c = blockIdx.y, whose block stages them
// as K1/K2's does, and runs their body cold (objective_body, REGIONAL).
template <typename Real, int NUH1, int NUH2, bool STATS, bool MASKED>
__global__ void __launch_bounds__(kBlock)
gr4j_regional_kernel(const Real* __restrict__ prec,
                     const Real* __restrict__ etp,
                     const Real* __restrict__ qobs,
                     const Real* __restrict__ params,
                     const Real* __restrict__ counts, int n, int t_len,
                     Real* __restrict__ out) {
  const size_t first = (size_t)blockIdx.y * t_len;  // catchment's step 0
  objective_body<Real, NUH1, NUH2, STATS, MASKED, true>(
      prec + first, etp + first, qobs + first, params, nullptr, n, t_len,
      Real(1), counts, out);
}

inline dim3 grid_for(int n) { return dim3((n + kBlock - 1) / kBlock); }

// The dynamic shared memory of a traj_body kernel (float64: 68 KB a
// block), opting the kernel in above 48 KB.
template <typename Real, typename Kernel>
cudaError_t traj_shared(Kernel kernel, size_t& shared) {
  shared =
      (2 * 2 * kTrajTile + (size_t)kBlock * (kTrajTile + 1)) * sizeof(Real);
  if (shared > kSharedOptIn) return cudaErrorInvalidValue;
  if (shared <= kSharedLimit) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
}

// K3 and K4: the split kernel (64 members a block) for at most
// kTrajSplitMembers members, else traj_body's kernel.
template <typename Real, int NUH1, int NUH2>
cudaError_t launch_traj(const Real* prec, const Real* etp, const Real* params,
                        int n, int t_len, Real* out, cudaStream_t stream) {
  if (n <= kTrajSplitMembers) {
    gr4j_traj_split_kernel<Real, NUH1, NUH2>
        <<<(n + kBlock / 2 - 1) / (kBlock / 2), kBlock, 0, stream>>>(
            prec, etp, params, n, t_len, out);
    return cudaGetLastError();
  }
  const auto kernel = gr4j_traj_kernel<Real, NUH1, NUH2>;
  size_t shared = 0;
  const cudaError_t err = traj_shared<Real>(kernel, shared);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(n), kBlock, shared, stream>>>(prec, etp, params, n,
                                                  t_len, out);
  return cudaGetLastError();
}

template <typename Real, int NUH1, int NUH2>
cudaError_t launch_traj_state(const Real* prec, const Real* etp,
                              const Real* params, const Real* hist, int n,
                              int t_len, Real* out, Real* fstate,
                              cudaStream_t stream) {
  if (n <= kTrajSplitMembers) {
    gr4j_traj_state_split_kernel<Real, NUH1, NUH2>
        <<<(n + kBlock / 2 - 1) / (kBlock / 2), kBlock, 0, stream>>>(
            prec, etp, params, hist, n, t_len, out, fstate);
    return cudaGetLastError();
  }
  const auto kernel = gr4j_traj_state_kernel<Real, NUH1, NUH2>;
  size_t shared = 0;
  const cudaError_t err = traj_shared<Real>(kernel, shared);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(n), kBlock, shared, stream>>>(prec, etp, params, hist, n,
                                                  t_len, out, fstate);
  return cudaGetLastError();
}

// K1/K2 in one mode: the split kernel (64 members a block) for at most
// kSplitMembers members, else one member a thread.
template <typename Real, int NUH1, int NUH2, bool STATS, bool MASKED>
void launch_objective_mode(const Real* prec, const Real* etp,
                           const Real* qobs, const Real* params,
                           const Real* hist, int n, int t_len, Real count,
                           Real* out, cudaStream_t stream) {
  if (n <= kSplitMembers) {
    gr4j_objective_split_kernel<Real, NUH1, NUH2, STATS, MASKED>
        <<<(n + kBlock / 2 - 1) / (kBlock / 2), kBlock, 0, stream>>>(
            prec, etp, qobs, params, hist, n, t_len, count, out);
  } else {
    gr4j_objective_kernel<Real, NUH1, NUH2, STATS, MASKED>
        <<<grid_for(n), kBlock, 0, stream>>>(prec, etp, qobs, params, hist,
                                             n, t_len, count, out);
  }
}

template <typename Real, int NUH1, int NUH2>
void launch_objective(const Real* prec, const Real* etp, const Real* qobs,
                      const Real* params, const Real* hist, int n, int t_len,
                      bool stats, bool masked, Real count, Real* out,
                      cudaStream_t stream) {
  if (stats && masked) {
    launch_objective_mode<Real, NUH1, NUH2, true, true>(
        prec, etp, qobs, params, hist, n, t_len, count, out, stream);
  } else if (stats) {
    launch_objective_mode<Real, NUH1, NUH2, true, false>(
        prec, etp, qobs, params, hist, n, t_len, count, out, stream);
  } else if (masked) {
    launch_objective_mode<Real, NUH1, NUH2, false, true>(
        prec, etp, qobs, params, hist, n, t_len, count, out, stream);
  } else {
    launch_objective_mode<Real, NUH1, NUH2, false, false>(
        prec, etp, qobs, params, hist, n, t_len, count, out, stream);
  }
}

template <typename Real, int NUH1, int NUH2>
void launch_regional(const Real* prec, const Real* etp, const Real* qobs,
                     const Real* params, const Real* counts, int n, int t_len,
                     int catchments, bool stats, bool masked, Real* out,
                     cudaStream_t stream) {
  const dim3 grid((n + kBlock - 1) / kBlock, catchments);
  if (stats && masked) {
    gr4j_regional_kernel<Real, NUH1, NUH2, true, true>
        <<<grid, kBlock, 0, stream>>>(prec, etp, qobs, params, counts, n,
                                      t_len, out);
  } else if (stats) {
    gr4j_regional_kernel<Real, NUH1, NUH2, true, false>
        <<<grid, kBlock, 0, stream>>>(prec, etp, qobs, params, counts, n,
                                      t_len, out);
  } else if (masked) {
    gr4j_regional_kernel<Real, NUH1, NUH2, false, true>
        <<<grid, kBlock, 0, stream>>>(prec, etp, qobs, params, counts, n,
                                      t_len, out);
  } else {
    gr4j_regional_kernel<Real, NUH1, NUH2, false, false>
        <<<grid, kBlock, 0, stream>>>(prec, etp, qobs, params, counts, n,
                                      t_len, out);
  }
}

// The UH register lengths the library is instantiated for: (3, 7) covers
// plain-GR4J bounds (x4 <= 2.9, the fit path), (10, 21) the widest
// published bound (x4 <= 10, simulate and Monte-Carlo).
template <typename Real>
int simulate(const Real* prec, const Real* etp, const Real* params, int n,
             int t_len, int nuh1, int nuh2, Real* out, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nuh1 == 3 && nuh2 == 7) {
    return (int)launch_traj<Real, 3, 7>(prec, etp, params, n, t_len, out, s);
  }
  if (nuh1 == 10 && nuh2 == 21) {
    return (int)launch_traj<Real, 10, 21>(prec, etp, params, n, t_len, out,
                                          s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Real>
int simulate_state(const Real* prec, const Real* etp, const Real* params,
                   const Real* hist, int n, int t_len, int nuh1, int nuh2,
                   Real* out, Real* fstate, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nuh1 == 3 && nuh2 == 7) {
    return (int)launch_traj_state<Real, 3, 7>(prec, etp, params, hist, n,
                                              t_len, out, fstate, s);
  }
  if (nuh1 == 10 && nuh2 == 21) {
    return (int)launch_traj_state<Real, 10, 21>(prec, etp, params, hist, n,
                                                t_len, out, fstate, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Real>
int objective(const Real* prec, const Real* etp, const Real* qobs,
              const Real* params, const Real* hist, int n, int t_len,
              int nuh1, int nuh2,
              int stats, int masked, double count, Real* out, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nuh1 == 3 && nuh2 == 7) {
    launch_objective<Real, 3, 7>(prec, etp, qobs, params, hist, n, t_len,
                                 stats != 0, masked != 0, Real(count), out,
                                 s);
  } else if (nuh1 == 10 && nuh2 == 21) {
    launch_objective<Real, 10, 21>(prec, etp, qobs, params, hist, n, t_len,
                                   stats != 0, masked != 0, Real(count), out,
                                   s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Real>
int regional(const Real* prec, const Real* etp, const Real* qobs,
             const Real* params, const Real* counts, int n, int t_len,
             int catchments, int nuh1, int nuh2, int stats, int masked,
             Real* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0 || catchments <= 0) return (int)cudaSuccess;
  if (catchments > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nuh1 == 3 && nuh2 == 7) {
    launch_regional<Real, 3, 7>(prec, etp, qobs, params, counts, n, t_len,
                                catchments, stats != 0, masked != 0, out, s);
  } else if (nuh1 == 10 && nuh2 == 21) {
    launch_regional<Real, 10, 21>(prec, etp, qobs, params, counts, n, t_len,
                                  catchments, stats != 0, masked != 0, out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest ensemble K1/K2 run with production and routing in separate
// warps (gr4j_objective_split_kernel).
int rrmpg_gr4j_split_members() { return kSplitMembers; }

// The largest ensemble K3 and K4 run with production and routing in
// separate warps (traj_split_body).
int rrmpg_gr4j_traj_split_members() { return kTrajSplitMembers; }

int rrmpg_gr4j_simulate_f32(const float* prec, const float* etp,
                            const float* params, int n, int t_len, int nuh1,
                            int nuh2, float* out, int device, void* stream) {
  return simulate<float>(prec, etp, params, n, t_len, nuh1, nuh2, out,
                         device, stream);
}

int rrmpg_gr4j_simulate_f64(const double* prec, const double* etp,
                            const double* params, int n, int t_len, int nuh1,
                            int nuh2, double* out, int device, void* stream) {
  return simulate<double>(prec, etp, params, n, t_len, nuh1, nuh2, out,
                          device, stream);
}

int rrmpg_gr4j_simulate_state_f32(const float* prec, const float* etp,
                                  const float* params, const float* hist,
                                  int n, int t_len, int nuh1, int nuh2,
                                  float* out, float* fstate, int device,
                                  void* stream) {
  return simulate_state<float>(prec, etp, params, hist, n, t_len, nuh1, nuh2,
                               out, fstate, device, stream);
}

int rrmpg_gr4j_simulate_state_f64(const double* prec, const double* etp,
                                  const double* params, const double* hist,
                                  int n, int t_len, int nuh1, int nuh2,
                                  double* out, double* fstate, int device,
                                  void* stream) {
  return simulate_state<double>(prec, etp, params, hist, n, t_len, nuh1, nuh2,
                                out, fstate, device, stream);
}

int rrmpg_gr4j_objective_f32(const float* prec, const float* etp,
                             const float* qobs, const float* params,
                             const float* hist, int n, int t_len, int nuh1,
                             int nuh2, int stats, int masked, double count,
                             float* out, int device, void* stream) {
  return objective<float>(prec, etp, qobs, params, hist, n, t_len, nuh1, nuh2,
                          stats, masked, count, out, device, stream);
}

int rrmpg_gr4j_objective_f64(const double* prec, const double* etp,
                             const double* qobs, const double* params,
                             const double* hist, int n, int t_len, int nuh1,
                             int nuh2, int stats, int masked, double count,
                             double* out, int device, void* stream) {
  return objective<double>(prec, etp, qobs, params, hist, n, t_len, nuh1,
                           nuh2, stats, masked, count, out, device, stream);
}

// K5: prec, etp, qobs (C, T); params (6, N) shared by every catchment;
// counts (C,) the steps each catchment averages over; out (C, N), or
// (4, C, N) with `stats`.
int rrmpg_gr4j_regional_objective_f32(const float* prec, const float* etp,
                                      const float* qobs, const float* params,
                                      const float* counts, int n, int t_len,
                                      int catchments, int nuh1, int nuh2,
                                      int stats, int masked, float* out,
                                      int device, void* stream) {
  return regional<float>(prec, etp, qobs, params, counts, n, t_len,
                         catchments, nuh1, nuh2, stats, masked, out, device,
                         stream);
}

int rrmpg_gr4j_regional_objective_f64(const double* prec, const double* etp,
                                      const double* qobs,
                                      const double* params,
                                      const double* counts, int n, int t_len,
                                      int catchments, int nuh1, int nuh2,
                                      int stats, int masked, double* out,
                                      int device, void* stream) {
  return regional<double>(prec, etp, qobs, params, counts, n, t_len,
                          catchments, nuh1, nuh2, stats, masked, out, device,
                          stream);
}

}  // extern "C"
