// Fused GR4J ensemble kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of rrmpg_tpu/ops/pallas_gr4j.py:
//   K1  _mse_kernel    (gr4j_ensemble_mse_pallas)             -> gr4j_objective_kernel<..., STATS=false>
//   K2  _stats_kernel  (gr4j_ensemble_mse_pallas, stats=True) -> gr4j_objective_kernel<..., STATS=true>
//   K3  _traj_kernel   (gr4j_simulate_pallas)                 -> gr4j_traj_kernel
// and the shared step/init they are built from (_gr4j_step, _init_block),
// written once here as gr4j_step / gr4j_init so the snow and regional
// kernels can reuse them.
//
// What bounds these kernels on this card: per-thread serial latency.  Each
// member is one long recurrence of T dependent steps (tanh, two divides,
// sqrt/rsqrt chains, the routing store), so a thread cannot start step t+1
// before step t ends.  The forcing series (prec, etp, qobs) is the same for
// every member: one read per step that the whole warp shares.  K1/K2 move
// only 6 parameters in and 1 or 4 numbers out per member; K3 writes the
// (N, T) trajectory.
//
// What the design does about it: one thread owns one member, and the
// production/routing stores and both UH shift registers stay in registers
// for the whole time loop (the UH lengths are template constants, so every
// register index is a compile-time constant after unrolling and nothing
// spills to local memory).  Latency is hidden by running many members per
// SM; the forcing reads go through __ldg, which the warp serves as one
// broadcast.  The objective accumulates in registers.  K3's per-step stores
// stride across members (row-major (N, T)); that is left as it is for now.
//
// Unlike the TPU kernels there is no (8, 128) member tiling, no padding of
// N or T and no time-tile grid: the kernel masks i < N itself and loops to
// T exactly.
//
// C interface (bound with ctypes): every entry returns a cudaError_t as int
// (0 on success) and launches on the stream it is given without
// synchronising.  params is a (6, N) row-major array
// [x1, x2, x3, x4, s0, r0] with s0/r0 the absolute initial store levels.

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

// Cold start (_init_block without history): stores from the packed
// absolute levels, UH ordinates from x4, empty shift registers.
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ void gr4j_init(Member<Real, NUH1, NUH2>& m,
                                          const Real* __restrict__ params,
                                          int n, int i) {
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
}

// One GR4J time step (_gr4j_step, pallas_gr4j.py:56-117); returns the
// discharge.  1/x1 and 1/x3 are multiplies; the rain and evaporation arms
// need no branch because the inactive one is exactly zero.
template <typename Real, int NUH1, int NUH2>
__device__ __forceinline__ Real gr4j_step(Member<Real, NUH1, NUH2>& m,
                                          Real p, Real e) {
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
  const Real s_interim = m.s - e_s + p_s;
  const Real zs = pow4(s_interim * m.ix1 * Real(4.0 / 9.0));
  const Real perc = s_interim * (one - dev_rsqrt(dev_sqrt(one + zs)));
  m.s = s_interim - perc;
  const Real p_r = perc + (p_n - p_s);

  // unit hydrograph shift registers
  const Real pr1 = Real(0.9) * p_r;
  const Real pr2 = Real(0.1) * p_r;
#pragma unroll
  for (int j = 0; j < NUH1 - 1; ++j) m.uh1[j] = m.uh1[j + 1] + m.oh1[j] * pr1;
  m.uh1[NUH1 - 1] = m.oh1[NUH1 - 1] * pr1;
#pragma unroll
  for (int j = 0; j < NUH2 - 1; ++j) m.uh2[j] = m.uh2[j + 1] + m.oh2[j] * pr2;
  m.uh2[NUH2 - 1] = m.oh2[NUH2 - 1] * pr2;

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

// K3: (N, T) discharge trajectories, row-major.
template <typename Real, int NUH1, int NUH2>
__global__ void __launch_bounds__(kBlock)
gr4j_traj_kernel(const Real* __restrict__ prec, const Real* __restrict__ etp,
                 const Real* __restrict__ params, int n, int t_len,
                 Real* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Member<Real, NUH1, NUH2> m;
  gr4j_init(m, params, n, i);
  Real* row = out + (size_t)i * t_len;
  for (int t = 0; t < t_len; ++t) {
    row[t] = gr4j_step(m, __ldg(prec + t), __ldg(etp + t));
  }
}

// K1 (STATS=false): out[i] = mean squared error.
// K2 (STATS=true): out[k*N + i] = time means of [err^2, q, q^2, q*qobs].
// MASKED skips steps whose observation is NaN (the step itself still runs);
// `count` is the number of steps averaged over (T, or the valid count).
template <typename Real, int NUH1, int NUH2, bool STATS, bool MASKED>
__global__ void __launch_bounds__(kBlock)
gr4j_objective_kernel(const Real* __restrict__ prec,
                      const Real* __restrict__ etp,
                      const Real* __restrict__ qobs,
                      const Real* __restrict__ params, int n, int t_len,
                      Real count, Real* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Member<Real, NUH1, NUH2> m;
  gr4j_init(m, params, n, i);
  Real sse = Real(0), sum_q = Real(0), sum_q2 = Real(0), sum_qo = Real(0);
  for (int t = 0; t < t_len; ++t) {
    const Real q = gr4j_step(m, __ldg(prec + t), __ldg(etp + t));
    const Real qo = __ldg(qobs + t);
    if (MASKED && qo != qo) continue;
    const Real diff = q - qo;
    sse += diff * diff;
    if (STATS) {
      sum_q += q;
      sum_q2 += q * q;
      sum_qo += q * qo;
    }
  }
  out[i] = sse / count;
  if (STATS) {
    out[(size_t)n + i] = sum_q / count;
    out[2 * (size_t)n + i] = sum_q2 / count;
    out[3 * (size_t)n + i] = sum_qo / count;
  }
}

inline dim3 grid_for(int n) { return dim3((n + kBlock - 1) / kBlock); }

template <typename Real, int NUH1, int NUH2>
void launch_traj(const Real* prec, const Real* etp, const Real* params, int n,
                 int t_len, Real* out, cudaStream_t stream) {
  gr4j_traj_kernel<Real, NUH1, NUH2>
      <<<grid_for(n), kBlock, 0, stream>>>(prec, etp, params, n, t_len, out);
}

template <typename Real, int NUH1, int NUH2>
void launch_objective(const Real* prec, const Real* etp, const Real* qobs,
                      const Real* params, int n, int t_len, bool stats,
                      bool masked, Real count, Real* out,
                      cudaStream_t stream) {
  const dim3 grid = grid_for(n);
  if (stats && masked) {
    gr4j_objective_kernel<Real, NUH1, NUH2, true, true>
        <<<grid, kBlock, 0, stream>>>(prec, etp, qobs, params, n, t_len,
                                      count, out);
  } else if (stats) {
    gr4j_objective_kernel<Real, NUH1, NUH2, true, false>
        <<<grid, kBlock, 0, stream>>>(prec, etp, qobs, params, n, t_len,
                                      count, out);
  } else if (masked) {
    gr4j_objective_kernel<Real, NUH1, NUH2, false, true>
        <<<grid, kBlock, 0, stream>>>(prec, etp, qobs, params, n, t_len,
                                      count, out);
  } else {
    gr4j_objective_kernel<Real, NUH1, NUH2, false, false>
        <<<grid, kBlock, 0, stream>>>(prec, etp, qobs, params, n, t_len,
                                      count, out);
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
    launch_traj<Real, 3, 7>(prec, etp, params, n, t_len, out, s);
  } else if (nuh1 == 10 && nuh2 == 21) {
    launch_traj<Real, 10, 21>(prec, etp, params, n, t_len, out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Real>
int objective(const Real* prec, const Real* etp, const Real* qobs,
              const Real* params, int n, int t_len, int nuh1, int nuh2,
              int stats, int masked, double count, Real* out, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nuh1 == 3 && nuh2 == 7) {
    launch_objective<Real, 3, 7>(prec, etp, qobs, params, n, t_len,
                                 stats != 0, masked != 0, Real(count), out,
                                 s);
  } else if (nuh1 == 10 && nuh2 == 21) {
    launch_objective<Real, 10, 21>(prec, etp, qobs, params, n, t_len,
                                   stats != 0, masked != 0, Real(count), out,
                                   s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

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

int rrmpg_gr4j_objective_f32(const float* prec, const float* etp,
                             const float* qobs, const float* params, int n,
                             int t_len, int nuh1, int nuh2, int stats,
                             int masked, double count, float* out, int device,
                             void* stream) {
  return objective<float>(prec, etp, qobs, params, n, t_len, nuh1, nuh2,
                          stats, masked, count, out, device, stream);
}

int rrmpg_gr4j_objective_f64(const double* prec, const double* etp,
                             const double* qobs, const double* params, int n,
                             int t_len, int nuh1, int nuh2, int stats,
                             int masked, double count, double* out,
                             int device, void* stream) {
  return objective<double>(prec, etp, qobs, params, n, t_len, nuh1, nuh2,
                           stats, masked, count, out, device, stream);
}

}  // extern "C"
