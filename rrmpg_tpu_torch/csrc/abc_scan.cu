// Fused ABC-model kernels for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas kernels of rrmpg_tpu/ops/pallas_linear_scan.py:
//   K6  _single_kernel (abc_fused_single_pallas) -> abc_single_kernel:
//       one launch, the series read once, both outputs written once;
//   K7  _kernel        (abc_fused_pallas)        -> abc_reduce_kernel,
//       abc_carry_kernel, abc_apply_kernel: three launches, the series
//       read twice, with the carries between chunks in global memory.
//
// The function, per member (a, b, c, s0) and a shared series P of T steps:
//   S[0] = s0,  q[0] = 0,
//   S[t] = (1-c) S[t-1] + a P[t],   q[t] = (1-a-b) P[t] + c S[t-1].
//
// What bounds these kernels on this card: bytes.  A step is six
// floating-point operations against 4 bytes read and 8 written (float32),
// so the least time is the 12 T bytes over the memory rate.
//
// What the design does about it: the recurrence is linear, so the maps
// S -> A S + B compose associatively and a chunk can be scanned without
// knowing the state it starts from.  A block owns one chunk of
// 256 x kItems consecutive steps.  Pairs are only ever composed by
// multiply-add, never built from powers of (1-c), so c = 0 and c = 1 need
// no special case.  Step 0 is the map S -> 0 S + s0, which makes
// S[0] == s0 exact and cuts off everything before it.
//
// K7 scans a chunk in rounds: each warp walks its part of the chunk in
// rounds of 32 consecutive steps (one coalesced 128-byte load, and later
// store, per round), scans a round with shuffles and chains the rounds
// through one running pair; the eight warp totals meet in shared memory.
// The composed pairs stay in registers (three values a step) until the
// state at the chunk's start is known, then S and q are computed and
// written once.
//
// K6 scans a chunk in runs: the block copies its chunk of the series into
// shared memory with coalesced loads, each thread's kItems consecutive
// steps kItems + 1 values apart (so a warp's reads of one step of every
// run fall in 32 banks); each thread composes its run in order (a multiply
// and a multiply-add a step) and one warp scan and the eight warp totals
// give the map before every run.  Once the state at the chunk's start is
// known, each thread runs its steps from the state before its run, reading
// P again from shared memory and writing S over it and q beside it, and
// the block stores both with coalesced writes.  No step's values stay in
// registers, and a thread shuffles once a run, not once a step: 40
// registers in float32 (K7: 94), so six blocks stay resident on an SM to
// cover the wait for a chunk's incoming state (PERF.md section 6).
//
// K6 gets that state in the same launch, from pairs that earlier chunks
// publish in global memory, composed in an order that the chunk's index
// alone fixes, so that every run gives the same bits (the TPU kernel's
// sequential grid does too).  A member's chunks form groups of 32.  Chunk
// k publishes its own pair, unless it is the last of its group: that one
// composes the pairs of its group (its own and the 31 before it) in one
// warp scan and publishes the group's pair in its place.  The state before
// chunk k is the composition of the pairs of the groups before k's, in
// order, 32 groups a warp scan, then of the pairs of the chunks before k
// in its group, one warp scan.  One warp does it, a lane a pair.  A block
// waits only on published pairs of earlier chunks, never on another
// block's state, and publishes before it waits for anything but the pairs
// its publication is made of, so no chain is more than two publications
// deep.  Two other orders were built and were slower: a Fenwick tree over
// the chunks (log2(chunks) pairs a chunk, but its pairs chain log2 of the
// blocks in flight deep) and composing the groups before publishing (which
// chains every group to the one before it).  The first design walked back
// one pair at a time from a single thread until it met a published state,
// so how far it got, and so the order of composition, depended on timing.
//
// Blocks run in no order, so a block takes its chunk from an atomic ticket:
// whoever holds an earlier chunk has already started and cannot be starved
// by a block that waits for it.  A published pair is 64-bit words, each
// holding 32 bits of the pair beside a nonzero tag, written and read as
// single relaxed device-scope accesses (st.relaxed.gpu / ld.relaxed.gpu).
// Every word is written once per launch, after the words are zeroed on the
// launch's stream, so a reader that sees every tag of a pair sees the
// pair: no flag, no fence and no second round trip to L2 (a flag with
// st.release / ld.acquire was slower).  A waiting lane sleeps 100 ns
// between polls.  The ticket and the words are zeroed before every launch.

// Unlike the TPU kernels there is no padded copy of the series, no power
// matrices and no matrix unit: T is masked at the tail, and T = 1 works.
//
// C interface (bound with ctypes): every entry returns a cudaError_t as int
// (0 on success) and launches on the stream it is given without
// synchronising.  `scal` is a (4, N) row-major array [1-a-b, c, a, s0];
// outputs are (N, T) row-major.  Scratch is allocated by the caller:
// rrmpg_abc_chunk_size() says how many steps one chunk holds.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Steps per thread (in K7 the composed pairs and the series values of a
// chunk live in registers, 3 x kItems values a thread).
template <typename Real> struct Items;
template <> struct Items<float> { static constexpr int value = 16; };
template <> struct Items<double> { static constexpr int value = 8; };

template <typename Real>
__host__ __device__ constexpr int chunk_size() {
  return kThreads * Items<Real>::value;
}

// The affine map S -> A S + B.
template <typename Real>
struct Affine {
  Real A, B;
};

template <typename Real>
__device__ __forceinline__ Affine<Real> identity() {
  return {Real(1), Real(0)};
}

// The map "f, then g".
template <typename Real>
__device__ __forceinline__ Affine<Real> then(Affine<Real> f, Affine<Real> g) {
  return {g.A * f.A, g.A * f.B + g.B};
}

// Inclusive scan of one map per lane across the warp.
template <typename Real>
__device__ __forceinline__ Affine<Real> warp_scan(Affine<Real> x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Affine<Real> left;
    left.A = __shfl_up_sync(kFull, x.A, d);
    left.B = __shfl_up_sync(kFull, x.B, d);
    if (lane >= d) x = then(left, x);
  }
  return x;
}

template <typename Real>
__device__ __forceinline__ Affine<Real> lane_value(Affine<Real> x, int lane) {
  return {__shfl_sync(kFull, x.A, lane), __shfl_sync(kFull, x.B, lane)};
}

// One member's constants.
template <typename Real>
struct Member {
  Real coeff_q, c, a, s0;
};

template <typename Real>
__device__ __forceinline__ Member<Real> load_member(const Real* scal,
                                                    size_t n, size_t member) {
  const Real* col = scal + member;
  return {col[0], col[n], col[2 * n], col[3 * n]};
}

// A thread's share of a chunk in K7: kItems series values and, for each,
// the map from the state before the warp's first step to the state after
// this step.
template <typename Real>
struct Chunk {
  Real p[Items<Real>::value];
  Affine<Real> pre[Items<Real>::value];
};

// Index of the step that round r of this thread's warp gives this lane.
template <typename Real>
__device__ __forceinline__ size_t step_index(size_t chunk, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return chunk * chunk_size<Real>() +
         (size_t)warp * 32 * Items<Real>::value + (size_t)r * 32 + lane;
}

// Loads a chunk and scans it: inside each warp, then across the warps
// through `warp_total` (kWarps entries of shared memory).  Gives the map
// over the warps before this thread's (`warp_in`) and over the whole chunk
// (`total`).  Steps at or beyond t_len are identities.
template <typename Real>
__device__ __forceinline__ void scan_chunk(
    const Real* __restrict__ prec, size_t t_len, size_t chunk,
    const Member<Real>& m, Chunk<Real>& ch, Affine<Real>* warp_total,
    Affine<Real>& warp_in, Affine<Real>& total) {
  constexpr int kItems = Items<Real>::value;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Real alpha = Real(1) - m.c;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const size_t idx = step_index<Real>(chunk, r);
    ch.p[r] = idx < t_len ? __ldg(prec + idx) : Real(0);
  }
  Affine<Real> run = identity<Real>();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const size_t idx = step_index<Real>(chunk, r);
    Affine<Real> x = {alpha, m.a * ch.p[r]};
    if (idx >= t_len) x = identity<Real>();
    if (idx == 0) x = {Real(0), m.s0};
    x = then(run, warp_scan(x, lane));
    ch.pre[r] = x;
    run = lane_value(x, 31);
  }
  if (lane == 0) warp_total[warp] = run;
  __syncthreads();
  warp_in = identity<Real>();
  total = identity<Real>();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) warp_in = total;
    total = then(total, warp_total[w]);
  }
}

// Computes and writes S and q of a scanned chunk, given the state before
// the chunk's first step.
template <typename Real>
__device__ __forceinline__ void write_chunk(
    const Chunk<Real>& ch, size_t t_len, size_t chunk, const Member<Real>& m,
    Affine<Real> warp_in, Real s_in, Real* __restrict__ qsim,
    Real* __restrict__ storage) {
  constexpr int kItems = Items<Real>::value;
  const int lane = threadIdx.x & 31;
  const Real s_warp = warp_in.A * s_in + warp_in.B;
  Real s_before = s_warp;  // the state before this round's first step
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const size_t idx = step_index<Real>(chunk, r);
    const Real s = ch.pre[r].A * s_warp + ch.pre[r].B;
    Real s_prev = __shfl_up_sync(kFull, s, 1);
    if (lane == 0) s_prev = s_before;
    s_before = __shfl_sync(kFull, s, 31);
    if (idx < t_len) {
      storage[idx] = s;
      qsim[idx] = idx == 0 ? Real(0) : m.coeff_q * ch.p[r] + m.c * s_prev;
    }
  }
}

// A published pair of K6: each 32-bit piece of it beside a nonzero tag in
// one 64-bit word.
template <typename Real>
constexpr int kPieces = 2 * (int)sizeof(Real) / 4;

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Publishes `pair` in slot k of `slots`.
template <typename Real>
__device__ __forceinline__ void publish(unsigned long long* slots,
                                        unsigned k, Affine<Real> pair) {
  unsigned piece[kPieces<Real>];
  memcpy(piece, &pair, sizeof(pair));
  unsigned long long* slot = slots + (size_t)k * kPieces<Real>;
#pragma unroll
  for (int i = 0; i < kPieces<Real>; ++i) {
    store_word(slot + i, (unsigned long long)piece[i] << 32 | 1u);
  }
}

// Waits until slot k of `slots` holds a published pair and returns it.
template <typename Real>
__device__ __forceinline__ Affine<Real> wait_slot(
    const unsigned long long* slots, unsigned k) {
  const unsigned long long* slot = slots + (size_t)k * kPieces<Real>;
  unsigned piece[kPieces<Real>];
  bool ready;
  for (;;) {
    ready = true;
#pragma unroll
    for (int i = 0; i < kPieces<Real>; ++i) {
      const unsigned long long w = load_word(slot + i);
      piece[i] = (unsigned)(w >> 32);
      ready = ready && (unsigned)w != 0u;
    }
    if (ready) break;
    __nanosleep(100);  // spare L2 the polling of every waiting warp
  }
  Affine<Real> pair;
  memcpy(&pair, piece, sizeof(pair));
  return pair;
}

constexpr unsigned kGroup = 32;  // chunks whose pairs K6 composes into one

// K6's look-back, run by the 32 lanes of one warp for chunk `chunk` of a
// member whose slots start at `slots`, once the chunk's own pair `total`
// is known: publishes it (or its group's, for a group's last chunk), then
// composes the pairs of the groups before the chunk's and of the chunks
// before it in its group, and returns the state before the chunk.  Nothing
// is waited for before a publication but the pairs it is made of: a wait
// there would chain every group to the one before it.
template <typename Real>
__device__ __forceinline__ Real look_back(unsigned chunk, Affine<Real> total,
                                          unsigned long long* slots) {
  const int lane = threadIdx.x & 31;
  const unsigned group = chunk / kGroup, pos = chunk % kGroup;
  const bool last = pos == kGroup - 1;
  if (!last && lane == 0) publish(slots, chunk, total);
  Affine<Real> x = identity<Real>();
  if (lane < (int)pos) x = wait_slot<Real>(slots, chunk - pos + lane);
  if (last && lane == kGroup - 1) x = total;
  __syncwarp();
  const Affine<Real> scan = warp_scan(x, lane);
  const Affine<Real> in_group = lane_value(scan, pos > 0 ? pos - 1 : 0);
  const Affine<Real> group_pair = lane_value(scan, kGroup - 1);
  if (last && lane == 0) publish(slots, chunk, group_pair);
  Affine<Real> before = identity<Real>();  // over the groups before k's
  for (unsigned g0 = 0; g0 < group; g0 += 32) {
    Affine<Real> y = identity<Real>();
    if (g0 + lane < group) {
      y = wait_slot<Real>(slots, (g0 + lane) * kGroup + kGroup - 1);
    }
    __syncwarp();
    before = then(before, lane_value(warp_scan(y, lane), 31));
  }
  // The map over chunks 0 .. chunk - 1 starts with step 0's, which
  // discards the state before it: its value at 0.
  return then(before, in_group).B;
}

// K6: the whole simulation in one launch.  Block `ticket` owns chunk
// ticket % num_chunks of member ticket / num_chunks; slot i of `slots`
// (kPieces words) is where block i publishes.
template <typename Real>
__global__ void __launch_bounds__(kThreads)
abc_single_kernel(const Real* __restrict__ prec, const Real* __restrict__ scal,
                  int n, size_t t_len, unsigned num_chunks, unsigned* ticket,
                  unsigned long long* slots, Real* __restrict__ qsim,
                  Real* __restrict__ storage) {
  constexpr int kItems = Items<Real>::value;
  constexpr int kPitch = kItems + 1;  // values between two threads' runs
  __shared__ Real series[kThreads * kPitch];
  __shared__ Real flows[kThreads * kPitch];
  __shared__ Affine<Real> warp_total[kWarps];
  __shared__ unsigned block_ticket;
  __shared__ Real block_s_in;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) block_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const unsigned id = block_ticket;
  const size_t member = id / num_chunks, chunk = id % num_chunks;
  const Member<Real> m = load_member(scal, n, member);
  const size_t first = chunk * chunk_size<Real>();  // the chunk's step 0
  const size_t mine = first + (size_t)tid * kItems;  // this run's step 0

  // Step s of the chunk is step s % kItems of run s / kItems.
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int s = r * kThreads + tid;
    if (first + s < t_len) {
      series[s / kItems * kPitch + s % kItems] = __ldg(prec + first + s);
    }
  }
  __syncthreads();
  const Real alpha = Real(1) - m.c;
  Real* own = series + tid * kPitch;  // this thread's run
  Affine<Real> run = identity<Real>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    Affine<Real> x = {alpha, m.a * own[i]};
    if (mine + i >= t_len) x = identity<Real>();
    if (mine + i == 0) x = {Real(0), m.s0};
    run = then(run, x);
  }
  const Affine<Real> incl = warp_scan(run, lane);
  Affine<Real> excl = {__shfl_up_sync(kFull, incl.A, 1),
                       __shfl_up_sync(kFull, incl.B, 1)};
  if (lane == 0) excl = identity<Real>();
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  Affine<Real> warp_in = identity<Real>(), total = identity<Real>();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) warp_in = total;
    total = then(total, warp_total[w]);
  }
  if (tid < 32) {
    const Real s_in = look_back((unsigned)chunk, total,
                                slots + (id - chunk) * kPieces<Real>);
    if (tid == 0) block_s_in = s_in;
  }
  __syncthreads();
  // The run's P is read again from shared memory rather than kept in
  // registers through the look-back: fewer registers, more blocks resident.
  const Affine<Real> entry = then(warp_in, excl);
  Real s = entry.A * block_s_in + entry.B;  // the state before this run
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const Real p = own[i], s_prev = s;
    s = mine + i == 0 ? m.s0 : alpha * s + m.a * p;
    own[i] = s;
    flows[tid * kPitch + i] =
        mine + i == 0 ? Real(0) : m.coeff_q * p + m.c * s_prev;
  }
  __syncthreads();
  Real* q_row = qsim + member * t_len;
  Real* s_row = storage + member * t_len;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int k = r * kThreads + tid;
    if (first + k < t_len) {
      s_row[first + k] = series[k / kItems * kPitch + k % kItems];
      q_row[first + k] = flows[k / kItems * kPitch + k % kItems];
    }
  }
}

// K7, first launch: the pair of every chunk.
template <typename Real>
__global__ void __launch_bounds__(kThreads)
abc_reduce_kernel(const Real* __restrict__ prec, const Real* __restrict__ scal,
                  int n, size_t t_len, unsigned num_chunks,
                  Real* __restrict__ agg_a,
                  Real* __restrict__ agg_b) {
  __shared__ Affine<Real> warp_total[kWarps];
  const unsigned id = blockIdx.x;
  const Member<Real> m = load_member(scal, n, id / num_chunks);
  Chunk<Real> ch;
  Affine<Real> warp_in, total;
  scan_chunk(prec, t_len, id % num_chunks, m, ch, warp_total, warp_in, total);
  if (threadIdx.x == 0) {
    agg_a[id] = total.A;
    agg_b[id] = total.B;
  }
}

// K7, second launch: one block per member scans that member's chunk pairs
// and writes the state before every chunk.  A thread takes a run of
// consecutive chunks.
template <typename Real>
__global__ void __launch_bounds__(kThreads)
abc_carry_kernel(const Real* __restrict__ agg_a, const Real* __restrict__ agg_b,
                 unsigned num_chunks, Real* __restrict__ carry) {
  __shared__ Affine<Real> warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)blockIdx.x * num_chunks;
  const unsigned per = (num_chunks + kThreads - 1) / kThreads;
  const unsigned lo = min(threadIdx.x * per, num_chunks);
  const unsigned hi = min(lo + per, num_chunks);
  Affine<Real> mine = identity<Real>();
  for (unsigned k = lo; k < hi; ++k) {
    const Affine<Real> pair = {agg_a[base + k], agg_b[base + k]};
    mine = then(mine, pair);
  }
  const Affine<Real> incl = warp_scan(mine, lane);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  Affine<Real> before = identity<Real>();  // over the warps before this one
  for (int w = 0; w < warp; ++w) before = then(before, warp_total[w]);
  Affine<Real> left = lane_value(incl, lane > 0 ? lane - 1 : 0);
  if (lane > 0) before = then(before, left);
  // The state before step 0 is discarded by step 0's map: start from 0.
  Real s = before.B;
  for (unsigned k = lo; k < hi; ++k) {
    carry[base + k] = s;
    s = agg_a[base + k] * s + agg_b[base + k];
  }
}

// K7, third launch: scan every chunk again, now from its known state.
template <typename Real>
__global__ void __launch_bounds__(kThreads)
abc_apply_kernel(const Real* __restrict__ prec, const Real* __restrict__ scal,
                 int n, size_t t_len, unsigned num_chunks,
                 const Real* __restrict__ carry, Real* __restrict__ qsim,
                 Real* __restrict__ storage) {
  __shared__ Affine<Real> warp_total[kWarps];
  const unsigned id = blockIdx.x;
  const size_t member = id / num_chunks, chunk = id % num_chunks;
  const Member<Real> m = load_member(scal, n, member);
  Chunk<Real> ch;
  Affine<Real> warp_in, total;
  scan_chunk(prec, t_len, chunk, m, ch, warp_total, warp_in, total);
  write_chunk(ch, t_len, chunk, m, warp_in, carry[id], qsim + member * t_len,
              storage + member * t_len);
}

// Chunks of one member, or 0 if the (member, chunk) grid does not fit.
template <typename Real>
unsigned chunks_of(int n, long long t_len) {
  const long long chunks = (t_len + chunk_size<Real>() - 1) / chunk_size<Real>();
  if (chunks * n > 0x7fffffffLL) return 0;
  return (unsigned)chunks;
}

template <typename Real>
int single(const Real* prec, const Real* scal, int n, long long t_len,
           void* scratch_int, Real* qsim, Real* storage, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  const unsigned num_chunks = chunks_of<Real>(n, t_len);
  if (num_chunks == 0) return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)n * num_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned long long*>(scratch_int);
  err = cudaMemsetAsync(words, 0,
                        (1 + kPieces<Real> * blocks) * sizeof(*words), s);
  if (err != cudaSuccess) return (int)err;
  abc_single_kernel<Real><<<(unsigned)blocks, kThreads, 0, s>>>(
      prec, scal, n, (size_t)t_len, num_chunks,
      reinterpret_cast<unsigned*>(words), words + 1, qsim, storage);
  return (int)cudaGetLastError();
}

template <typename Real>
int chunked(const Real* prec, const Real* scal, int n, long long t_len,
            Real* scratch_real, Real* qsim, Real* storage, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || t_len <= 0) return (int)cudaSuccess;
  const unsigned num_chunks = chunks_of<Real>(n, t_len);
  if (num_chunks == 0) return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)n * num_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Real* agg_a = scratch_real;
  Real* agg_b = scratch_real + blocks;
  Real* carry = scratch_real + 2 * blocks;
  abc_reduce_kernel<Real><<<(unsigned)blocks, kThreads, 0, s>>>(
      prec, scal, n, (size_t)t_len, num_chunks, agg_a, agg_b);
  abc_carry_kernel<Real><<<(unsigned)n, kThreads, 0, s>>>(agg_a, agg_b,
                                                         num_chunks, carry);
  abc_apply_kernel<Real><<<(unsigned)blocks, kThreads, 0, s>>>(
      prec, scal, n, (size_t)t_len, num_chunks, carry, qsim, storage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Steps in one chunk (one block's share of a series).
int rrmpg_abc_chunk_size(int is_double) {
  return is_double ? chunk_size<double>() : chunk_size<float>();
}

// scratch_int: 1 + kPieces * N * chunks 64-bit words (kPieces: 2 in
// float32, 4 in float64).  scratch_real is not read: K6 takes K7's scratch
// arguments, so that builds of its earlier design, which used both, take
// the same call (chip_smoke.py --compare).
int rrmpg_abc_single_f32(const float* prec, const float* scal, int n,
                         long long t_len, void* scratch_int,
                         float* /*scratch_real*/, float* qsim, float* storage,
                         int device, void* stream) {
  return single<float>(prec, scal, n, t_len, scratch_int, qsim, storage,
                       device, stream);
}

int rrmpg_abc_single_f64(const double* prec, const double* scal, int n,
                         long long t_len, void* scratch_int,
                         double* /*scratch_real*/, double* qsim,
                         double* storage, int device, void* stream) {
  return single<double>(prec, scal, n, t_len, scratch_int, qsim, storage,
                        device, stream);
}

// scratch_real: 3 * N * chunks.
int rrmpg_abc_chunked_f32(const float* prec, const float* scal, int n,
                          long long t_len, float* scratch_real, float* qsim,
                          float* storage, int device, void* stream) {
  return chunked<float>(prec, scal, n, t_len, scratch_real, qsim, storage,
                        device, stream);
}

int rrmpg_abc_chunked_f64(const double* prec, const double* scal, int n,
                          long long t_len, double* scratch_real, double* qsim,
                          double* storage, int device, void* stream) {
  return chunked<double>(prec, scal, n, t_len, scratch_real, qsim, storage,
                         device, stream);
}

}  // extern "C"
