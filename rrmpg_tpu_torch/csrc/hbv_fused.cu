// Fused HBV-Edu ensemble kernels for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas kernels of rrmpg_tpu/ops/pallas_hbv.py:
//   K12 _kernel        (hbv_ensemble_mse_pallas)             -> hbv_objective_kernel<..., STATS=false>
//       _stats_kernel  (hbv_ensemble_mse_pallas, stats=True) -> hbv_objective_kernel<..., STATS=true>
//   K13 _traj_kernel   (hbv_simulate_pallas)                 -> hbv_traj_kernel
//   K14 _traj_state_kernel (hbv_simulate_pallas_state)       -> hbv_traj_state_kernel
// and the `warm` mode of K12 (state=), with the step they share (_hbv_step)
// written once here as hbv_step.
//
// What bounds these kernels on this card: operations, and behind them the
// serial latency of one thread.  Each member is a recurrence of T dependent
// steps over four stores (snow, soil, near-surface, base flow) with one
// pow() per step; K12 moves 17 numbers in and 1 or 4 out per member, K13
// writes the (N, T) trajectory, K14 the trajectory and the four final
// stores.  The four forcing series are the same for
// every member: one read per step that the whole warp shares.
//
// What the design does about it: one thread owns one member; the stores and
// the 13 constants stay in registers for the whole time loop, the objective
// accumulates in registers, and latency is hidden by running many members
// per SM.  K12 at 131072 members is bound by the SMs' issue rate (its time
// grows with N from ~34k members on, PERF.md section 6), and float32 powf is
// ~94 SASS instructions of a ~160-instruction step: K12 stages its forcing
// in shared memory with cp.async (no device read on the recurrence) and
// takes the soil power in float32 as exp2(Beta * log2(x)) (~34
// instructions) where that is pow on the model's domain (soil_pow).
// K13 and K14 run one time loop (traj_body; K14 is its STATE=true, which
// enters warm and writes the final stores).  It stages the four series as
// K12 does (stage_series) and gathers a tile's discharge in shared memory,
// as the snow trajectories (K9, K10) do: each thread writes its member's
// steps of the tile into its row of a [member][step] tile (rows
// kTrajTile + 1 values apart, so one step's writes fall in 32 banks), and
// after the tile's barrier each warp copies whole member rows to device
// memory, its lanes on consecutive steps: one 256-byte run (float32) per
// member and 64-step tile, where one store a step across members would
// land T values apart (32 sectors for 128 useful bytes).
//
// pow() is IEEE pow (no fast-math): a negative soil store gives NaN through
// (soil/FC)^Beta, as the reference's np.power does, and that NaN reaches the
// member's loss and trajectory; soil_pow keeps powf for it.  The soil store
// is not clamped.
//
// A cold start freezes the stores at t = 0 and gives q = 0 there (the
// reference's initialization step); a warm continuation advances the carried
// stores at every step.  That step sits before the time loop, not inside it:
// a cold kernel writes (or scores) q = 0 for t = 0 and starts its loop at
// t = 1, a warm one starts at t = 0.  `warm` is a run-time argument, so no
// kernel is instantiated twice and the loop carries no first-step test.  The
// initial stores are rows 11-14 of params either way.
//
// Unlike the TPU kernels there is no (8, 128) member tiling, no padding of
// N or T and no time-tile grid; K14 reads the final stores from the thread's
// registers when its loop ends instead of snapshotting them inside it.
// Every thread of a staged block takes part in the copies and barriers;
// threads past N run the last member and write nothing.
//
// C interface (bound with ctypes): every entry returns a cudaError_t as int
// (0 on success) and launches on the stream it is given without
// synchronising.  params is a (17, N) row-major array
// [T_t, DD, FC, Beta, C, PWP, K_0, K_1, K_2, K_p, L,
//  snow0, soil0, s1_0, s2_0, 1/FC, 1/PWP]; pe and tm are the monthly
// climatologies already gathered to one value per step.

#include <cuda_runtime.h>

#include <cstddef>

#include "async_copy.cuh"

namespace {

constexpr int kBlock = 128;
// K12: steps of forcing staged per buffer (two buffers).
constexpr int kTile = 64;
// K13 and K14: steps per staged tile and per tile of discharge stores (64
// beat 32 by 12-15 % and 128 by 6-14 % on the H100, PERF.md section 6).
constexpr int kTrajTile = 64;
// Shared memory a block may use without opting in, and after (H100: 227 KB).
constexpr size_t kSharedLimit = 48 * 1024;
constexpr size_t kSharedOptIn = 232448;

// The soil power (soil / FC)^Beta of every kernel here.  float32:
// exp2(Beta * log2(x)) where x >= 0 and Beta != 0 (0 for x = 0 and
// Beta > 0), IEEE powf elsewhere, so a negative soil store gives powf's NaN
// and Beta = 0 gives 1: the NaN members are powf's.  float64 keeps pow.
__device__ __forceinline__ float soil_pow(float x, float beta) {
  return (x >= 0.0f && beta != 0.0f) ? exp2f(beta * log2f(x))
                                     : powf(x, beta);
}
__device__ __forceinline__ double soil_pow(double x, double beta) {
  return pow(x, beta);
}

// max(x, 0) and min(x, y) that propagate NaN, as jnp.maximum / jnp.minimum
// and torch.clamp / torch.minimum do.
template <typename Real>
__device__ __forceinline__ Real relu_nan(Real x) {
  return (x > Real(0) || x != x) ? x : Real(0);
}

template <typename Real>
__device__ __forceinline__ Real min_nan(Real x, Real y) {
  return (x < y || x != x) ? x : y;
}

// One member's parameters and state, in registers.
template <typename Real>
struct Member {
  Real T_t, DD, Beta, C, PWP, K_0, K_1, K_2, K_p, L, iFC, iPWP;
  Real snow, soil, s1, s2;
};

template <typename Real>
__device__ __forceinline__ void hbv_init(Member<Real>& m,
                                         const Real* __restrict__ params,
                                         int n, int i) {
  const Real* col = params + i;  // row r of this member: col[r * n]
  m.T_t = col[(size_t)0 * n];
  m.DD = col[(size_t)1 * n];
  m.Beta = col[(size_t)3 * n];
  m.C = col[(size_t)4 * n];
  m.PWP = col[(size_t)5 * n];
  m.K_0 = col[(size_t)6 * n];
  m.K_1 = col[(size_t)7 * n];
  m.K_2 = col[(size_t)8 * n];
  m.K_p = col[(size_t)9 * n];
  m.L = col[(size_t)10 * n];
  m.snow = col[(size_t)11 * n];
  m.soil = col[(size_t)12 * n];
  m.s1 = col[(size_t)13 * n];
  m.s2 = col[(size_t)14 * n];
  m.iFC = col[(size_t)15 * n];
  m.iPWP = col[(size_t)16 * n];
}

// One HBV-Edu time step (_hbv_step, pallas_hbv.py:48-106); returns the
// discharge.  Division by FC and PWP is a multiply by the packed
// reciprocals; the soil power is soil_pow.
template <typename Real>
__device__ __forceinline__ Real hbv_step(Member<Real>& m, Real temp,
                                         Real prec, Real pe_month,
                                         Real t_month) {
  const bool freezing = temp < m.T_t;
  const Real melt_pot = m.DD * (temp - m.T_t);
  const Real snow =
      freezing ? m.snow + prec : relu_nan(m.snow - melt_pot);
  const Real liquid =
      freezing ? Real(0) : prec + min_nan(m.snow, melt_pot);

  const Real prec_eff = liquid * soil_pow(m.soil * m.iFC, m.Beta);
  const Real pe = (Real(1) + m.C * (temp - t_month)) * pe_month;
  const Real ea = m.soil > m.PWP ? pe : pe * (m.soil * m.iPWP);
  const Real soil = m.soil + liquid - prec_eff - ea;

  const Real overflow = relu_nan(m.s1 - m.L) * m.K_0;
  const Real s1 = m.s1 + prec_eff - overflow - m.s1 * m.K_1 - m.s1 * m.K_p;
  const Real s2 = m.s2 + m.s1 * m.K_p - m.s2 * m.K_2;

  m.snow = snow;
  m.soil = soil;
  m.s1 = s1;
  m.s2 = s2;
  return overflow + s1 * m.K_1 + s2 * m.K_2;
}

// Copy tile `tile` of S series, which starts at step t0 (at most TILE
// steps, none past t_len), into its buffer stage[tile & 1][c][0, ...),
// consecutive threads on consecutive steps (K12: five series, K14: four).
// The buffer index is formed inside the loop and K12 passes the start step
// in a variable of its own: in that form K12 compiles to the code of the
// loop written out in the kernel (two other forms moved an instruction).
template <int S, int TILE, typename Real>
__device__ __forceinline__ void stage_series(Real (*stage)[S][TILE], int tile,
                                             const Real* const* series,
                                             int t0, int t_len) {
  for (int s = threadIdx.x; s < min(TILE, t_len - t0); s += blockDim.x) {
#pragma unroll
    for (int c = 0; c < S; ++c) {
      copy_async(&stage[tile & 1][c][s], series[c] + t0 + s);
    }
  }
}

// K13 and K14: (N, T) discharge trajectories, row-major.  A member whose
// soil store went negative is NaN from there on.  The four series are
// staged kTrajTile steps a tile (dynamic shared memory: [2][4][kTrajTile]
// staging, then the [kBlock][kTrajTile + 1] discharge tile); a cold start's
// q = 0 at t = 0 is the first value of tile 0.  The soil power is K12's
// soil_pow (float32: exp2 / log2: 0.81-0.82 of powf's time here; float64
// pow).  STATE (K14): cold or from carried stores (`warm`), and fstate
// receives the end-of-series stores as (4, N) rows [snow, soil, s1, s2]
// (NaN for a NaN member); without STATE nothing reads `warm` or writes
// fstate.
template <typename Real, bool STATE>
__device__ __forceinline__ void traj_body(const Real* __restrict__ temp,
                                          const Real* __restrict__ prec,
                                          const Real* __restrict__ pe,
                                          const Real* __restrict__ tm,
                                          const Real* __restrict__ params,
                                          int n, int t_len, bool warm,
                                          Real* __restrict__ out,
                                          Real* __restrict__ fstate) {
  constexpr int kSeries = 4;
  constexpr int kPitch = kTrajTile + 1;  // values between two members' rows
  extern __shared__ __align__(16) unsigned char hbv_shared[];
  auto stage = reinterpret_cast<Real(*)[kSeries][kTrajTile]>(hbv_shared);
  Real* q_tile = &stage[2][0][0];
  Real* q_row = q_tile + threadIdx.x * kPitch;
  const Real* series[kSeries] = {temp, prec, pe, tm};
  const int first_member = blockIdx.x * blockDim.x;
  const int i = first_member + threadIdx.x;
  Member<Real> m;
  hbv_init(m, params, n, min(i, n - 1));
  const bool cold = !(STATE && warm);
  const int members = min((int)blockDim.x, n - first_member);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int tiles = (t_len + kTrajTile - 1) / kTrajTile;
  stage_series(stage, 0, series, 0, t_len);
  copy_commit();
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kTrajTile;
    if (k + 1 < tiles) {
      stage_series(stage, k + 1, series, t0 + kTrajTile, t_len);
    }
    copy_commit();  // possibly empty: the group count stays one per tile
    copy_wait_older();
    __syncthreads();  // tile k has landed; the last tile's rows have left
    const Real(*buf)[kTrajTile] = stage[k & 1];
    const int steps = min(kTrajTile, t_len - t0);
    int s = 0;
    if (k == 0 && cold) q_row[s++] = Real(0);  // the initialization step
#pragma unroll 1
    for (; s < steps; ++s) {
      q_row[s] = hbv_step<Real>(m, buf[0][s], buf[1][s], buf[2][s], buf[3][s]);
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
    fstate[i] = m.snow;
    fstate[(size_t)n + i] = m.soil;
    fstate[2 * (size_t)n + i] = m.s1;
    fstate[3 * (size_t)n + i] = m.s2;
  }
}

// K13: trajectories from a cold start (traj_body without state).
template <typename Real>
__global__ void __launch_bounds__(kBlock)
hbv_traj_kernel(const Real* __restrict__ temp, const Real* __restrict__ prec,
                const Real* __restrict__ pe, const Real* __restrict__ tm,
                const Real* __restrict__ params, int n, int t_len,
                Real* __restrict__ out) {
  traj_body<Real, false>(temp, prec, pe, tm, params, n, t_len, false, out,
                         nullptr);
}

// K14: trajectories as K13, cold or from carried stores (`warm`), plus the
// end-of-series stores (traj_body, STATE).
template <typename Real>
__global__ void __launch_bounds__(kBlock)
hbv_traj_state_kernel(const Real* __restrict__ temp,
                      const Real* __restrict__ prec,
                      const Real* __restrict__ pe, const Real* __restrict__ tm,
                      const Real* __restrict__ params, int n, int t_len,
                      bool warm, Real* __restrict__ out,
                      Real* __restrict__ fstate) {
  traj_body<Real, true>(temp, prec, pe, tm, params, n, t_len, warm, out,
                        fstate);
}

// K12.  STATS=false: out[i] = mean squared error.  STATS=true:
// out[k*N + i] = time means of [err^2, q, q^2, q*qobs].  MASKED skips steps
// whose observation is NaN (the step itself still runs); `count` is the
// number of steps averaged over (T, or the valid count).  A NaN discharge
// at a step with an observation makes the member's result NaN.
// A cold start scores q = 0 against the first observation.
//
// The five series (temp, prec, pe, tm, qobs) are staged: the block copies
// them tile by tile (kTile steps) into shared memory with cp.async,
// double-buffered, so no read of device memory sits on the recurrence.
// Every thread takes part in the copies and barriers; threads past N run
// the last member and write nothing.
template <typename Real, bool STATS, bool MASKED>
__global__ void __launch_bounds__(kBlock)
hbv_objective_kernel(const Real* __restrict__ temp,
                     const Real* __restrict__ prec,
                     const Real* __restrict__ pe, const Real* __restrict__ tm,
                     const Real* __restrict__ qobs,
                     const Real* __restrict__ params, int n, int t_len,
                     bool warm, Real count, Real* __restrict__ out) {
  constexpr int kSeries = 5;
  __shared__ Real stage[2][kSeries][kTile];
  const Real* series[kSeries] = {temp, prec, pe, tm, qobs};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Member<Real> m;
  hbv_init(m, params, n, min(i, n - 1));
  Real sse = Real(0), sum_q = Real(0), sum_q2 = Real(0), sum_qo = Real(0);
  if (!warm) {
    // The initialization step: q = 0, so only the squared error moves.
    const Real qo = __ldg(qobs);
    if (!(MASKED && qo != qo)) {
      sse = qo * qo;
      if (STATS) sum_qo = Real(0) * qo;  // NaN if the observation is
    }
  }
  const int tiles = (t_len + kTile - 1) / kTile;
  stage_series(stage, 0, series, 0, t_len);
  copy_commit();
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kTile;
    if (k + 1 < tiles) {
      const int next = t0 + kTile;
      stage_series(stage, k + 1, series, next, t_len);
    }
    copy_commit();  // possibly empty: the group count stays one per tile
    copy_wait_older();
    __syncthreads();
    const Real(*buf)[kTile] = stage[k & 1];
    const int steps = min(kTile, t_len - t0);
#pragma unroll 1
    for (int s = (k == 0 && !warm) ? 1 : 0; s < steps; ++s) {
      const Real q = hbv_step<Real>(m, buf[0][s], buf[1][s], buf[2][s],
                                    buf[3][s]);
      const Real qo = buf[4][s];
      if (MASKED && qo != qo) continue;
      const Real diff = q - qo;
      sse += diff * diff;
      if (STATS) {
        sum_q += q;
        sum_q2 += q * q;
        sum_qo += q * qo;
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
  if (i >= n) return;
  out[i] = sse / count;
  if (STATS) {
    out[(size_t)n + i] = sum_q / count;
    out[2 * (size_t)n + i] = sum_q2 / count;
    out[3 * (size_t)n + i] = sum_qo / count;
  }
}

inline dim3 grid_for(int n) { return dim3((n + kBlock - 1) / kBlock); }

// The dynamic shared memory of K13 and K14 (traj_body), opting the kernel
// in above 48 KB (float64: 70 KB a block).
template <typename Real, typename Kernel>
cudaError_t traj_shared(Kernel kernel, size_t& shared) {
  shared =
      (2 * 4 * kTrajTile + (size_t)kBlock * (kTrajTile + 1)) * sizeof(Real);
  if (shared > kSharedOptIn) return cudaErrorInvalidValue;
  if (shared <= kSharedLimit) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
}

template <typename Real>
int simulate(const Real* temp, const Real* prec, const Real* pe,
             const Real* tm, const Real* params, int n, int t_len, Real* out,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = hbv_traj_kernel<Real>;
  size_t shared;
  err = traj_shared<Real>(kernel, shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(n), kBlock, shared, s>>>(temp, prec, pe, tm, params, n,
                                             t_len, out);
  return (int)cudaGetLastError();
}

template <typename Real>
int simulate_state(const Real* temp, const Real* prec, const Real* pe,
                   const Real* tm, const Real* params, int n, int t_len,
                   int warm, Real* out, Real* fstate, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = hbv_traj_state_kernel<Real>;
  size_t shared;
  err = traj_shared<Real>(kernel, shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(n), kBlock, shared, s>>>(temp, prec, pe, tm, params, n,
                                             t_len, warm != 0, out, fstate);
  return (int)cudaGetLastError();
}

template <typename Real, bool STATS, bool MASKED>
void launch_objective(const Real* temp, const Real* prec, const Real* pe,
                      const Real* tm, const Real* qobs, const Real* params,
                      int n, int t_len, bool warm, Real count, Real* out,
                      cudaStream_t s) {
  hbv_objective_kernel<Real, STATS, MASKED>
      <<<grid_for(n), kBlock, 0, s>>>(temp, prec, pe, tm, qobs, params, n,
                                      t_len, warm, count, out);
}

template <typename Real>
int objective(const Real* temp, const Real* prec, const Real* pe,
              const Real* tm, const Real* qobs, const Real* params, int n,
              int t_len, int stats, int masked, int warm, double count,
              Real* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Real cnt = Real(count);
  const bool is_warm = warm != 0;
  if (stats && masked) {
    launch_objective<Real, true, true>(temp, prec, pe, tm, qobs, params, n,
                                       t_len, is_warm, cnt, out, s);
  } else if (stats) {
    launch_objective<Real, true, false>(temp, prec, pe, tm, qobs, params, n,
                                        t_len, is_warm, cnt, out, s);
  } else if (masked) {
    launch_objective<Real, false, true>(temp, prec, pe, tm, qobs, params, n,
                                        t_len, is_warm, cnt, out, s);
  } else {
    launch_objective<Real, false, false>(temp, prec, pe, tm, qobs, params, n,
                                         t_len, is_warm, cnt, out, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rrmpg_hbv_simulate_f32(const float* temp, const float* prec,
                           const float* pe, const float* tm,
                           const float* params, int n, int t_len, float* out,
                           int device, void* stream) {
  return simulate<float>(temp, prec, pe, tm, params, n, t_len, out, device,
                         stream);
}

int rrmpg_hbv_simulate_f64(const double* temp, const double* prec,
                           const double* pe, const double* tm,
                           const double* params, int n, int t_len,
                           double* out, int device, void* stream) {
  return simulate<double>(temp, prec, pe, tm, params, n, t_len, out, device,
                          stream);
}

int rrmpg_hbv_simulate_state_f32(const float* temp, const float* prec,
                                 const float* pe, const float* tm,
                                 const float* params, int n, int t_len,
                                 int warm, float* out, float* fstate,
                                 int device, void* stream) {
  return simulate_state<float>(temp, prec, pe, tm, params, n, t_len, warm,
                               out, fstate, device, stream);
}

int rrmpg_hbv_simulate_state_f64(const double* temp, const double* prec,
                                 const double* pe, const double* tm,
                                 const double* params, int n, int t_len,
                                 int warm, double* out, double* fstate,
                                 int device, void* stream) {
  return simulate_state<double>(temp, prec, pe, tm, params, n, t_len, warm,
                                out, fstate, device, stream);
}

int rrmpg_hbv_objective_f32(const float* temp, const float* prec,
                            const float* pe, const float* tm,
                            const float* qobs, const float* params, int n,
                            int t_len, int stats, int masked, int warm,
                            double count, float* out, int device,
                            void* stream) {
  return objective<float>(temp, prec, pe, tm, qobs, params, n, t_len, stats,
                          masked, warm, count, out, device, stream);
}

int rrmpg_hbv_objective_f64(const double* temp, const double* prec,
                            const double* pe, const double* tm,
                            const double* qobs, const double* params, int n,
                            int t_len, int stats, int masked, int warm,
                            double count, double* out, int device,
                            void* stream) {
  return objective<double>(temp, prec, pe, tm, qobs, params, n, t_len, stats,
                           masked, warm, count, out, device, stream);
}

}  // extern "C"
