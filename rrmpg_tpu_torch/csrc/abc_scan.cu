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
// A map is kept as (D, B) with D = 1 - A, and a step as (c, a P[t]): no
// (1 - c) is ever rounded.  In float32, (1 - c) rounded carries up to 4e-4
// of a small c's value (c = 7e-5), and every full run of a member repeats
// the same rounded A, so the runs' errors add up over the thousands of
// steps such a store remembers: with A kept, the float32 S of both kernels
// strayed from the float64 result by more than 1e-4 of its largest value
// at 4096 members x 131072 steps, where the doubling scan stays within it.
// chip_smoke.py (phase 3) holds both kernels to the float64 result there.
//
// K6 and K7 scan a chunk in runs: the block copies its chunk of the series
// into shared memory with coalesced loads, each thread's kItems consecutive
// steps kItems + 1 values apart (so a warp's reads of one step of every run
// fall in 32 banks); each thread composes its run in order (an add and two
// multiply-adds a step) and one warp scan and the eight warp totals give
// the map before every run.  Once the state at the chunk's start is known,
// each thread runs its steps from the state before its run, reading P
// again from shared memory and writing S over it and q beside it, and the
// block stores both with coalesced writes.  No step's values stay in
// registers, and a thread shuffles once a run, not once a step, so few
// registers are live and several blocks stay resident on an SM (PERF.md
// section 6).  K7's kernels are built from these pieces (stage_chunk,
// compose_run, block_scan, replay_run, store_chunk); K6 keeps its own
// inline copy of them, since calling them moved its code (40 registers to
// 46 in float32, and slower).  The two differ in how a chunk learns its
// incoming state.
//
// K7 learns it in three launches.  The first stages and composes every
// chunk and writes the chunk's pair.  The second scans each member's
// pairs: a team of threads per member, sized to the member's chunks (one
// warp up to 256 chunks, up to 256 threads beyond), each thread composing
// a run of consecutive pairs, then one scan over the team; it writes the
// state before every chunk.  The third stages the chunk again, composes
// and scans its runs, and replays them from that state.  The series is read
// twice (the design's floor is 4 + 4 + 8 bytes a float32 step); the third
// launch takes the chunks in reverse order, so that at 10M float32 steps
// (40 MB) its first reads find what the first launch read last in the 50
// MB L2.  Register caps keep eight blocks of the first launch and six of
// the third on an SM.
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

// Steps per thread: one run, composed serially.
template <typename Real> struct Items;
template <> struct Items<float> { static constexpr int value = 16; };
template <> struct Items<double> { static constexpr int value = 8; };

template <typename Real>
__host__ __device__ constexpr int chunk_size() {
  return kThreads * Items<Real>::value;
}

// The affine map S -> (1 - D) S + B, kept as D = 1 - A rather than A (see
// the note at the top): a step is (c, a P[t]).
template <typename Real>
struct Affine {
  Real D, B;
};

template <typename Real>
__device__ __forceinline__ Affine<Real> identity() {
  return {Real(0), Real(0)};
}

// The map "f, then g": 1 - (1 - f.D)(1 - g.D) and (1 - g.D) f.B + g.B, with
// no (1 - x) ever rounded.
template <typename Real>
__device__ __forceinline__ Affine<Real> then(Affine<Real> f, Affine<Real> g) {
  return {fma(-f.D, g.D, f.D + g.D), fma(-g.D, f.B, f.B) + g.B};
}

// The map f applied to the state s.
template <typename Real>
__device__ __forceinline__ Real apply(Affine<Real> f, Real s) {
  return fma(-f.D, s, s) + f.B;
}

// One step of the recurrence, S[t] = (1 - c) S[t-1] + a P[t].
template <typename Real>
__device__ __forceinline__ Real step(Real c, Real a, Real p, Real s) {
  return fma(-c, s, s + a * p);
}

// Inclusive scan of one map per lane across the warp.
template <typename Real>
__device__ __forceinline__ Affine<Real> warp_scan(Affine<Real> x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Affine<Real> left;
    left.D = __shfl_up_sync(kFull, x.D, d);
    left.B = __shfl_up_sync(kFull, x.B, d);
    if (lane >= d) x = then(left, x);
  }
  return x;
}

template <typename Real>
__device__ __forceinline__ Affine<Real> lane_value(Affine<Real> x, int lane) {
  return {__shfl_sync(kFull, x.D, lane), __shfl_sync(kFull, x.B, lane)};
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

// Values between two threads' runs in K7's shared copy of a chunk.
template <typename Real>
constexpr int kRunPitch = Items<Real>::value + 1;

// Copies the chunk whose step 0 is `first` into `series` with coalesced
// loads: step s of the chunk is step s % kItems of run s / kItems.  Steps
// at or beyond t_len are not written.
template <typename Real>
__device__ __forceinline__ void stage_chunk(const Real* prec, size_t t_len,
                                            size_t first, Real* series) {
  constexpr int kItems = Items<Real>::value;
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int s = r * kThreads + tid;
    if (first + s < t_len) {
      series[s / kItems * kRunPitch<Real> + s % kItems] =
          __ldg(prec + first + s);
    }
  }
}

// The map over this thread's run `own`, whose step 0 is step `mine` of the
// series; steps at or beyond t_len are identities.
template <typename Real>
__device__ __forceinline__ Affine<Real> compose_run(const Real* own,
                                                    size_t mine, size_t t_len,
                                                    const Member<Real>& m) {
  constexpr int kItems = Items<Real>::value;
  Affine<Real> run = identity<Real>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    Affine<Real> x = {m.c, m.a * own[i]};
    if (mine + i >= t_len) x = identity<Real>();
    if (mine + i == 0) x = {Real(1), m.s0};
    run = then(run, x);
  }
  return run;
}

// Scans the runs' maps across the block through `warp_total` (kWarps
// entries of shared memory): the map over the runs before this thread's in
// its warp (`excl`), over the warps before its warp (`warp_in`) and over
// the whole chunk (`total`).
template <typename Real>
__device__ __forceinline__ void block_scan(Affine<Real> run,
                                           Affine<Real>* warp_total,
                                           Affine<Real>& excl,
                                           Affine<Real>& warp_in,
                                           Affine<Real>& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Affine<Real> incl = warp_scan(run, lane);
  excl = {__shfl_up_sync(kFull, incl.D, 1), __shfl_up_sync(kFull, incl.B, 1)};
  if (lane == 0) excl = identity<Real>();
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  warp_in = identity<Real>();
  total = identity<Real>();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) warp_in = total;
    total = then(total, warp_total[w]);
  }
}

// Runs this thread's steps from `s`, the state before its run: S over the
// run's P in `own`, q in `flow`.
template <typename Real>
__device__ __forceinline__ void replay_run(Real* own, Real* flow, size_t mine,
                                           const Member<Real>& m, Real s) {
  constexpr int kItems = Items<Real>::value;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const Real p = own[i], s_prev = s;
    s = mine + i == 0 ? m.s0 : step(m.c, m.a, p, s);
    own[i] = s;
    flow[i] = mine + i == 0 ? Real(0) : m.coeff_q * p + m.c * s_prev;
  }
}

// Stores a replayed chunk (S in `series`, q in `flows`) with coalesced
// writes into a member's rows.
template <typename Real>
__device__ __forceinline__ void store_chunk(const Real* series,
                                            const Real* flows, size_t first,
                                            size_t t_len, Real* q_row,
                                            Real* s_row) {
  constexpr int kItems = Items<Real>::value;
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int k = r * kThreads + tid;
    if (first + k < t_len) {
      s_row[first + k] = series[k / kItems * kRunPitch<Real> + k % kItems];
      q_row[first + k] = flows[k / kItems * kRunPitch<Real> + k % kItems];
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
  Real* own = series + tid * kPitch;  // this thread's run
  Affine<Real> run = identity<Real>();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    Affine<Real> x = {m.c, m.a * own[i]};
    if (mine + i >= t_len) x = identity<Real>();
    if (mine + i == 0) x = {Real(1), m.s0};
    run = then(run, x);
  }
  const Affine<Real> incl = warp_scan(run, lane);
  Affine<Real> excl = {__shfl_up_sync(kFull, incl.D, 1),
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
  Real s = apply(entry, block_s_in);  // the state before this run
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const Real p = own[i], s_prev = s;
    s = mine + i == 0 ? m.s0 : step(m.c, m.a, p, s);
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

// K7, first launch: the pair of every chunk.  At most 32 registers, so
// that eight blocks fit an SM.
template <typename Real>
__global__ void __launch_bounds__(kThreads, 8)
abc_reduce_kernel(const Real* __restrict__ prec, const Real* __restrict__ scal,
                  int n, size_t t_len, unsigned num_chunks,
                  Real* __restrict__ agg_d, Real* __restrict__ agg_b) {
  constexpr int kItems = Items<Real>::value;
  __shared__ Real series[kThreads * kRunPitch<Real>];
  __shared__ Affine<Real> warp_total[kWarps];
  const int tid = threadIdx.x;
  const unsigned id = blockIdx.x;
  const size_t chunk = id % num_chunks;
  const Member<Real> m = load_member(scal, n, id / num_chunks);
  const size_t first = chunk * chunk_size<Real>();
  stage_chunk(prec, t_len, first, series);
  __syncthreads();
  Affine<Real> excl, warp_in, total;
  block_scan(compose_run(series + tid * kRunPitch<Real>,
                         first + (size_t)tid * kItems, t_len, m),
             warp_total, excl, warp_in, total);
  if (tid == 0) {
    agg_d[id] = total.D;
    agg_b[id] = total.B;
  }
}

// Threads that scan one member's chunk pairs in K7's second launch: a warp,
// or more where each would take more than kCarryRun pairs, up to a block.
constexpr unsigned kCarryRun = 8;

unsigned carry_team(unsigned num_chunks) {
  unsigned team = 32;
  while (team < kThreads && team * kCarryRun < num_chunks) team *= 2;
  return team;
}

// K7, second launch: each team of `team` threads (a power of two from 32
// to kThreads) scans one member's chunk pairs and writes the state before
// every chunk.  A thread takes a run of consecutive chunks.
template <typename Real>
__global__ void __launch_bounds__(kThreads)
abc_carry_kernel(const Real* __restrict__ agg_d, const Real* __restrict__ agg_b,
                 int n, unsigned num_chunks, unsigned team,
                 Real* __restrict__ carry) {
  __shared__ Affine<Real> warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned rank = threadIdx.x % team;  // place in the member's team
  const unsigned member = blockIdx.x * (kThreads / team) + threadIdx.x / team;
  const bool live = member < (unsigned)n;
  const size_t base = (size_t)member * num_chunks;
  const unsigned per = (num_chunks + team - 1) / team;
  const unsigned lo = min(rank * per, num_chunks);
  const unsigned hi = live ? min(lo + per, num_chunks) : lo;
  Affine<Real> mine = identity<Real>();
  for (unsigned k = lo; k < hi; ++k) {
    const Affine<Real> pair = {agg_d[base + k], agg_b[base + k]};
    mine = then(mine, pair);
  }
  const Affine<Real> incl = warp_scan(mine, lane);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  // Over the team's warps before this one, then its lanes before this one.
  Affine<Real> before = identity<Real>();
  for (int w = warp - (int)(rank / 32); w < warp; ++w) {
    before = then(before, warp_total[w]);
  }
  const Affine<Real> left = lane_value(incl, lane > 0 ? lane - 1 : 0);
  if (lane > 0) before = then(before, left);
  // The state before step 0 is discarded by step 0's map: start from 0.
  Real s = before.B;
  for (unsigned k = lo; k < hi; ++k) {
    carry[base + k] = s;
    s = apply(Affine<Real>{agg_d[base + k], agg_b[base + k]}, s);
  }
}

// K7, third launch: stage, compose and scan every chunk again, then replay
// it from its known incoming state.  At most 40 registers, so that six
// blocks fit an SM, as K6's do.  Block b takes the chunk the first launch's
// block (blocks - 1 - b) took: the chunks the first launch read last are
// read again first, while they are still in L2.
template <typename Real>
__global__ void __launch_bounds__(kThreads, 6)
abc_apply_kernel(const Real* __restrict__ prec, const Real* __restrict__ scal,
                 int n, size_t t_len, unsigned num_chunks,
                 const Real* __restrict__ carry, Real* __restrict__ qsim,
                 Real* __restrict__ storage) {
  constexpr int kItems = Items<Real>::value;
  __shared__ Real series[kThreads * kRunPitch<Real>];
  __shared__ Real flows[kThreads * kRunPitch<Real>];
  __shared__ Affine<Real> warp_total[kWarps];
  const int tid = threadIdx.x;
  const unsigned id = gridDim.x - 1 - blockIdx.x;
  const size_t member = id / num_chunks, chunk = id % num_chunks;
  const Real s_in = carry[id];
  const Member<Real> m = load_member(scal, n, member);
  const size_t first = chunk * chunk_size<Real>();
  const size_t mine = first + (size_t)tid * kItems;
  stage_chunk(prec, t_len, first, series);
  __syncthreads();
  Real* own = series + tid * kRunPitch<Real>;
  Affine<Real> excl, warp_in, total;
  block_scan(compose_run(own, mine, t_len, m), warp_total, excl, warp_in,
             total);
  const Affine<Real> entry = then(warp_in, excl);
  replay_run(own, flows + tid * kRunPitch<Real>, mine, m,
             apply(entry, s_in));
  __syncthreads();
  store_chunk(series, flows, first, t_len, qsim + member * t_len,
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
  Real* agg_d = scratch_real;
  Real* agg_b = scratch_real + blocks;
  Real* carry = scratch_real + 2 * blocks;
  abc_reduce_kernel<Real><<<(unsigned)blocks, kThreads, 0, s>>>(
      prec, scal, n, (size_t)t_len, num_chunks, agg_d, agg_b);
  const unsigned team = carry_team(num_chunks);
  const unsigned per_block = kThreads / team;
  abc_carry_kernel<Real><<<((unsigned)n + per_block - 1) / per_block, kThreads,
                           0, s>>>(agg_d, agg_b, n, num_chunks, team, carry);
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
