// folds.cu — the invariant fold kernels of the set, cockroach-set,
// total-queue, unique-ids, counter, queue and FIFO-queue checkers, for
// Hopper (sm_90a).
//
// Replaces the seven TPU device programs of jepsen_tpu/ops/folds.py,
// which compute two algorithms:
//   * fold_counts (K7a): _set_kernel (:151), _crdb_set_kernel (:233),
//     _tq_kernel (:309) and _ids_kernel (:365). Each is a masked
//     scatter-add of a row's lines into one count vector per (type, f)
//     code (_counts, :137), then the family's combination of the counts
//     into bool or int32 planes over the value vocabulary.
//   * three per-row scans: counter_scan (K7b, _counter_kernel :410),
//     queue_scan (K7c, _queue_kernel :517) and fifo_scan (K7d,
//     _fifo_kernel :574), each the reference's lax.scan over a row's
//     lines with its carry.
// The outputs are the same, bit for bit: the plain PyTorch versions in
// ops/folds.py (plain_fold_counts, plain_counter_scan, plain_queue_scan,
// plain_fifo_scan) are the yardstick. Bools leave every kernel as uint8.
//
// Inputs are the encoder's line tensors, int32 [B, N] row-major: typ
// (PAD = -1, invoke 0, ok 1, fail 2, info 3), f (the family's f code),
// val (a vocabulary id, or a raw value for the counter; NONE_SENTINEL =
// INT_MIN for none) and, for the counter, proc (a process densified per
// row into [0, P)).
//
// Design.
//   * fold_counts: S blocks a row, each owning a slice of Vs values of
//     the vocabulary (the wrapper's plan, ops/cuda_folds.py count_plan:
//     a slice's C histograms fit in COUNT_SLICE_BYTES of shared memory,
//     and a row takes more slices, up to one per COUNT_MIN_SLICE values,
//     until the batch has about two blocks an SM). Every block of a row reads
//     all the row's lines (from L2 after the first), 16 bytes a load
//     where the row is aligned, and adds 1 to histogram c at
//     min(val, V-1) for each line whose (type, f) is code c, whose
//     val >= 0 (the reference's mask and clip) and whose clipped value
//     falls in its slice, with a shared-memory atomicAdd. After a
//     barrier it writes its slice of the family's planes: the
//     combination is the kernel's epilogue, not torch ops after it. No
//     block merges with another, and no histogram leaves shared memory.
//     The first design ran one block a row over the whole
//     vocabulary, with histograms past shared memory in device-memory
//     scratch: 32 rows left most SMs idle, and a cockroach set at V
//     16,384 fell to global atomics.
//   * queue_scan: S blocks a row, each owning a slice of Vs values (the
//     wrapper's plan, ops/cuda_folds.py queue_plan: eight warps' (sum,
//     lowest prefix) pairs and lane tags of a slice fit in
//     QUEUE_SLICE_BYTES of shared memory), because the unordered
//     queue's values are independent walks whose (sum, lowest prefix)
//     compose by chunks of lines. Each warp of a block walks an eighth
//     of the row's lines for its slice's values; the block folds the
//     eight chunks of each value in order; the first chunk in which a
//     value's prefix reaches -1 is cut in seven parts, summarised and
//     folded the same way, and one warp walks the first part that
//     reaches -1 again, for the line. A second launch takes each row's
//     first such line over its slices. The first design gave each row one
//     thread walking every line in order, with the multiset in shared
//     memory or in the output: 32 rows ran on 11 SMs, a line every few
//     hundred cycles.
//   * counter_scan and fifo_scan cut each row into segments of `seg`
//     lines, a warp each, eight warps a block (ops/cuda_folds.py
//     scan_plan: segments of whole 32-line tiles, at least 256 lines,
//     until the batch has about two blocks an SM), because what each
//     line needs of the lines before it is a prefix sum, a count or the
//     last occurrence of something, all of which compose by segments.
//     The counter: a summary pass (each warp's segment summarised from an
//     empty carry, then each block's eight folded in order), and a fill
//     pass in which each warp folds the summaries before it, the row's
//     earlier blocks' and then its block's earlier warps', into the
//     reference's carry at its first line, and walks its segment again,
//     writing every line, pad lines included. The FIFO: a count pass, a
//     compaction (the enqueued values by rank, the ok dequeues with
//     their lines, values and enqueue counts), and a walk of each row's
//     dequeue list by one block in alternating success and failure
//     runs. The segments' summaries are combined by the fill launch
//     itself rather than by a launch of their own or a decoupled
//     look-back: a warp's fold is at most blocks_per_row + 7 steps of
//     independent loads, no block waits on another, and the result
//     does not depend on the order blocks run in. Arithmetic on the
//     counter's bounds is done in uint32 so that it wraps as the
//     reference's int32 does; the host detours rows whose sums could
//     leave int32, so no wrap happens on the path.
//
// What bounds it on this card. fold_counts reads 12 bytes a line and
// writes P planes of V elements a row, a few int32 operations a line and
// a plane element: at the full-width batch (32 rows of 40,000 lines, V
// 16,384) about 15 MB in and 2–12 MB out, 0.008 ms at 3.35 TB/s, so it
// is bound by bytes; the slices read the lines S times, from L2. The
// counter and FIFO scans move 16 + 13 and 12 bytes a line (0.005 ms at
// the full-width batches), so they too are bound by bytes; what holds
// them back is latency, not bandwidth: the counter reads its lines
// twice (the second time mostly from L2), each 32-line tile is a chain
// of shuffles, a match and ballots, and the fill's fold of earlier
// summaries is a short serial chain before the first tile; the FIFO
// makes three launches, writes 16 bytes a line of scratch, and its walk
// is one block a row whose every run ends at a block barrier (one run a
// tile on a healthy row, two more a wrong dequeue). queue_scan reads 12
// bytes a line and writes V words a row (0.005 ms at the full-width
// batch, bytes); each of a row's S blocks reads all its lines (from L2
// after the first) and spends a match, a group minimum and a few
// popcounts on each 32-line tile, so its instructions grow with S and
// a row's time with its longest chunk.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInvoke = 0, kOk = 1, kInfo = 3;
constexpr int32_t kNone = INT_MIN;
// Dynamic shared memory one block may use on an H100, less what the
// kernels keep statically.
constexpr int kSmemLimit = 232448 - 64;
constexpr int kCountThreads = 256;
// The counter keeps its per-process carry in shared memory to P words.
constexpr int kCounterSmemP = 64;

enum Family { kSet = 0, kCrdb = 1, kTq = 2, kIds = 3 };

// Histograms and planes of each family.
template <int F> struct Fam;
template <> struct Fam<kSet> { static constexpr int C = 2, L = 5; };
template <> struct Fam<kCrdb> { static constexpr int C = 4, L = 7; };
template <> struct Fam<kTq> { static constexpr int C = 3, L = 6; };
template <> struct Fam<kIds> { static constexpr int C = 1, L = 1; };

// The histogram a line adds to, -1 for none. set and crdb count add
// lines (f 0) by type (set: invoke, ok; crdb: invoke, ok, fail, info);
// the total queue counts invoked and ok enqueues (f 0) and ok dequeues
// (f 1); ids count ok generates (f 0).
template <int F>
__device__ __forceinline__ int code_of(int t, int fc) {
  if (F == kTq) {
    if (fc == 0) return (t == kInvoke || t == kOk) ? t : -1;
    return (fc == 1 && t == kOk) ? 2 : -1;
  }
  if (fc != 0) return -1;
  if (F == kSet) return (t == kInvoke || t == kOk) ? t : -1;
  if (F == kCrdb) return (t >= kInvoke && t <= kInfo) ? t : -1;
  return t == kOk ? 0 : -1;  // kIds
}

// Block b takes row b / S and the values lo .. lo + w - 1 of its slice
// (lo = (b % S)·Vs, w = min(Vs, V - lo)); its C histograms of w words
// each are in shared memory. `planes` is [B, L, V] (uint8 for set and
// crdb, int32 for tq and ids); `attempted` [B] int32 for ids, written by
// each row's first slice. `vec` says the three line tensors' rows start
// on 16-byte boundaries (N a multiple of 4).
template <int F>
__device__ __forceinline__ void count_line(int32_t* hist, int t, int fc,
                                           int v, int V, int lo, int w) {
  const int c = code_of<F>(t, fc);
  if (c < 0 || v < 0) return;
  const int x = min(v, V - 1) - lo;
  if (static_cast<unsigned>(x) < static_cast<unsigned>(w))
    atomicAdd(&hist[c * w + x], 1);
}

template <int F>
__global__ void __launch_bounds__(kCountThreads)
fold_counts_kernel(const int32_t* __restrict__ typ,
                   const int32_t* __restrict__ fcol,
                   const int32_t* __restrict__ val,
                   const uint8_t* __restrict__ final_read, int N, int V,
                   int S, int Vs, int vec, void* planes,
                   int32_t* attempted) {
  constexpr int C = Fam<F>::C, L = Fam<F>::L;
  extern __shared__ int32_t hist[];
  __shared__ int att_count;
  const long long r = blockIdx.x / S;
  const int lo = (blockIdx.x - static_cast<int>(r) * S) * Vs;
  const int w = min(Vs, V - lo);
  for (int i = threadIdx.x; i < C * w; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x == 0) att_count = 0;
  __syncthreads();

  const int32_t* t_row = typ + r * N;
  const int32_t* f_row = fcol + r * N;
  const int32_t* v_row = val + r * N;
  int att = 0;
  if (vec) {
    const int4* t4 = reinterpret_cast<const int4*>(t_row);
    const int4* f4 = reinterpret_cast<const int4*>(f_row);
    const int4* v4 = reinterpret_cast<const int4*>(v_row);
    for (int j = threadIdx.x; j < N / 4; j += blockDim.x) {
      const int4 a = t4[j], b = f4[j], c = v4[j];
      count_line<F>(hist, a.x, b.x, c.x, V, lo, w);
      count_line<F>(hist, a.y, b.y, c.y, V, lo, w);
      count_line<F>(hist, a.z, b.z, c.z, V, lo, w);
      count_line<F>(hist, a.w, b.w, c.w, V, lo, w);
      if (F == kIds)
        att += (a.x == kInvoke && b.x == 0) + (a.y == kInvoke && b.y == 0)
               + (a.z == kInvoke && b.z == 0) + (a.w == kInvoke && b.w == 0);
    }
  } else {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const int t = t_row[j], fc = f_row[j];
      count_line<F>(hist, t, fc, v_row[j], V, lo, w);
      if (F == kIds) att += (t == kInvoke && fc == 0);
    }
  }
  if (F == kIds && att) atomicAdd(&att_count, att);
  __syncthreads();

  const uint8_t* fr = final_read ? final_read + r * V + lo : nullptr;
  for (int v = threadIdx.x; v < w; v += blockDim.x) {
    const long long at = r * L * V + lo + v;
    if (F == kSet) {
      uint8_t* out = static_cast<uint8_t*>(planes) + at;
      const bool a = hist[v] > 0, add = hist[w + v] > 0, f = fr[v] != 0;
      const bool ok = f && a;
      out[0] = a;
      out[V] = ok;
      out[2 * V] = f && !a;      // unexpected
      out[3 * V] = add && !f;    // lost
      out[4 * V] = ok && !add;   // recovered
    } else if (F == kCrdb) {
      uint8_t* out = static_cast<uint8_t*>(planes) + at;
      const bool a = hist[v] > 0, add = hist[w + v] > 0;
      const bool failed = hist[2 * w + v] > 0, unsure = hist[3 * w + v] > 0;
      const bool f = fr[v] != 0;
      out[0] = a;
      out[V] = failed;
      out[2 * V] = f && add;     // ok
      out[3 * V] = f && !a;      // unexpected
      out[4 * V] = f && failed;  // revived
      out[5 * V] = add && !f;    // lost
      out[6 * V] = f && unsure;  // recovered
    } else if (F == kTq) {
      int32_t* out = static_cast<int32_t*>(planes) + at;
      const int a = hist[v], enq = hist[w + v], deq = hist[2 * w + v];
      const int ok = min(deq, a);
      out[0] = a;
      out[V] = ok;
      out[2 * V] = a == 0 ? deq : 0;              // unexpected
      out[3 * V] = a > 0 ? max(deq - a, 0) : 0;   // duplicated
      out[4 * V] = max(enq - deq, 0);             // lost
      out[5 * V] = max(ok - enq, 0);              // recovered
    } else {
      static_cast<int32_t*>(planes)[at] = hist[v];  // acks
    }
  }
  if (F == kIds && lo == 0 && threadIdx.x == 0) attempted[r] = att_count;
}

// ---- counter_scan (K7b): segments of a row, summarised, then filled.
//
// Warp w of block b takes segment s = b·kScanWarps + w of its row, the
// lines [s·seg, min(N, (s+1)·seg)), and walks it in tiles of 32 lines,
// a line a lane (counter_walk). A lane finds the nearest earlier
// invoke-read and read of its process inside the tile from
// __match_any_sync on the process and two ballots; before the tile they
// come from the warp's carry, three words a process: a state word
// (bit 0: the process's last read is an invoke-read; bit 1: a read
// occurred; bit 2: an invoke-read occurred), and the low bound and raw
// value of its last invoke-read. An inclusive shuffle scan gives the
// two sums (uint32, wrapping as the reference's int32). After the tile
// the last lane of each process updates its carry.
//
// A summary is kSumHead + 3·P words: the segment's sums of invoke-add
// and ok-add values, then the carry after a walk from an empty one
// (low bounds relative to the segment's first line).

constexpr int kScanWarps = 8;
constexpr int kScanThreads = 32 * kScanWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumHead = 2;

__device__ __forceinline__ long long seg_start(int s, int seg, int N) {
  return min(static_cast<long long>(s) * seg, static_cast<long long>(N));
}

// One warp's walk over a row's lines [start, end): with kFill, writes
// lows, vals, ups and emits of each line. st, lo_c and va_c are the
// carry's three P-word arrays; lower and upper, the sums before the
// segment, leave as the sums after it.
template <bool kFill>
__device__ __forceinline__ void counter_walk(
    const int32_t* __restrict__ typ, const int32_t* __restrict__ fcol,
    const int32_t* __restrict__ val, const int32_t* __restrict__ proc,
    long long start, long long end, int P, int32_t* st, int32_t* lo_c,
    int32_t* va_c, uint32_t& lower, uint32_t& upper, int32_t* lows,
    int32_t* vals, int32_t* ups, uint8_t* emits) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = lane == 31 ? 0u : kFull << (lane + 1);
  for (long long j0 = start; j0 < end; j0 += 32) {
    const long long j = j0 + lane;
    const bool in = j < end;
    int t = -1, fc = 0, p = 0;
    int32_t v = 0;
    if (in) {
      t = typ[j];
      fc = fcol[j];
      v = val[j];
      // The encoder gives 0 <= p < P; the clamp only keeps an index
      // that breaks that contract inside the carry.
      p = min(max(proc[j], 0), P - 1);
    }
    const bool inv_read = t == kInvoke && fc == 1;
    const bool ok_read = t == kOk && fc == 1;
    const bool read = inv_read || ok_read;
    const uint32_t add = v == kNone ? 0u : static_cast<uint32_t>(v);
    const uint32_t a_up = t == kInvoke && fc == 0 ? add : 0u;
    const uint32_t a_lo = t == kOk && fc == 0 ? add : 0u;
    uint32_t x_up = a_up, x_lo = a_lo;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t u = __shfl_up_sync(kFull, x_up, d);
      const uint32_t l = __shfl_up_sync(kFull, x_lo, d);
      if (lane >= d) {
        x_up += u;
        x_lo += l;
      }
    }
    const uint32_t my_low = lower + (x_lo - a_lo);
    const unsigned same = __match_any_sync(kFull, p);
    const unsigned rm = __ballot_sync(kFull, read);
    const unsigned im = __ballot_sync(kFull, inv_read);
    const unsigned ri = same & im & below, rr = same & rm & below;
    const int ki = ri ? 31 - __clz(ri) : lane;
    const uint32_t low_k = __shfl_sync(kFull, my_low, ki);
    const int32_t val_k = __shfl_sync(kFull, v, ki);
    const int32_t old_st = in ? st[p] : 0;
    if (kFill && in) {
      const bool act = rr ? (im >> (31 - __clz(rr))) & 1u : old_st & 1;
      lows[j] = ri ? static_cast<int32_t>(low_k) : lo_c[p];
      vals[j] = ri ? val_k : va_c[p];
      ups[j] = static_cast<int32_t>(upper + (x_up - a_up));
      emits[j] = ok_read && act;
    }
    __syncwarp();
    if (inv_read && !(same & im & above)) {
      lo_c[p] = static_cast<int32_t>(my_low);
      va_c[p] = v;
    }
    if (read && !(same & rm & above))
      st[p] = (old_st & 4) | (same & im ? 4 : 0) | 2 | (inv_read ? 1 : 0);
    __syncwarp();
    upper += __shfl_sync(kFull, x_up, 31);
    lower += __shfl_sync(kFull, x_lo, 31);
  }
}

// Pass 1: every segment's summary into ws [B, S, kSumHead + 3P], then
// each block's (its kScanWarps segments folded in order, low bounds
// relative to the block's first line) into bs [B, blocks_per_row, ...].
// The walk's carry is in shared memory (3P words a warp), or, with
// `global_carry`, the summary's own words in ws.
__global__ void __launch_bounds__(kScanThreads)
counter_summary_kernel(const int32_t* __restrict__ typ,
                       const int32_t* __restrict__ fcol,
                       const int32_t* __restrict__ val,
                       const int32_t* __restrict__ proc, int N, int P,
                       int seg, int blocks_per_row, bool global_carry,
                       int32_t* ws, int32_t* bs) {
  extern __shared__ int32_t smem_carry[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = blockIdx.x / blocks_per_row;
  const int b = blockIdx.x - static_cast<int>(r) * blocks_per_row;
  const int S = blocks_per_row * kScanWarps;
  const int s = b * kScanWarps + warp;
  const long long W = kSumHead + 3LL * P;
  int32_t* mine = ws + (r * S + s) * W;
  int32_t* c = global_carry ? mine + kSumHead : smem_carry + warp * 3 * P;
  for (int p = lane; p < P; p += 32) {
    c[p] = 0;
    c[P + p] = 0;
    c[2 * P + p] = kNone;
  }
  __syncwarp();
  const long long base = r * N;
  const long long start = seg_start(s, seg, N);
  const long long end = seg_start(s + 1, seg, N);
  uint32_t lower = 0, upper = 0;
  counter_walk<false>(typ + base, fcol + base, val + base, proc + base,
                      start, end, P, c, c + P, c + 2 * P, lower, upper,
                      nullptr, nullptr, nullptr, nullptr);
  if (!global_carry)
    for (int i = lane; i < 3 * P; i += 32) mine[kSumHead + i] = c[i];
  if (lane == 0) {
    mine[0] = static_cast<int32_t>(upper);
    mine[1] = static_cast<int32_t>(lower);
  }
  __syncthreads();
  const int32_t* first = ws + (r * S + b * kScanWarps) * W;
  int32_t* out = bs + (r * blocks_per_row + b) * W;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int32_t acc = 0, low = 0, v = kNone;
    uint32_t lo = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      const int32_t* x = first + w * W;
      const int32_t xs = x[kSumHead + p];
      if (xs & 4) {
        low = static_cast<int32_t>(lo + static_cast<uint32_t>(
                                            x[kSumHead + P + p]));
        v = x[kSumHead + 2 * P + p];
      }
      if (xs & 2) acc = (acc & 4) | (xs & 3);
      acc |= xs & 4;
      lo += static_cast<uint32_t>(x[1]);
    }
    out[kSumHead + p] = acc;
    out[kSumHead + P + p] = low;
    out[kSumHead + 2 * P + p] = v;
  }
  if (threadIdx.x == 0) {
    uint32_t up = 0, lo = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      up += static_cast<uint32_t>(first[w * W]);
      lo += static_cast<uint32_t>(first[w * W + 1]);
    }
    out[0] = static_cast<int32_t>(up);
    out[1] = static_cast<int32_t>(lo);
  }
}

// Pass 2: each warp folds the summaries before its segment (the row's
// earlier blocks', then its block's earlier warps') into its incoming
// carry and sums, the reference's carry at the segment's first line,
// and walks the segment again, writing every line. The carry is in
// shared memory, or in `gcarry` (3P words a segment).
__global__ void __launch_bounds__(kScanThreads)
counter_fill_kernel(const int32_t* __restrict__ typ,
                    const int32_t* __restrict__ fcol,
                    const int32_t* __restrict__ val,
                    const int32_t* __restrict__ proc, int N, int P, int seg,
                    int blocks_per_row, const int32_t* __restrict__ ws,
                    const int32_t* __restrict__ bs, int32_t* gcarry,
                    int32_t* __restrict__ lows, int32_t* __restrict__ vals,
                    int32_t* __restrict__ ups,
                    uint8_t* __restrict__ emits) {
  extern __shared__ int32_t smem_carry[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = blockIdx.x / blocks_per_row;
  const int b = blockIdx.x - static_cast<int>(r) * blocks_per_row;
  const int S = blocks_per_row * kScanWarps;
  const int s = b * kScanWarps + warp;
  const long long start = seg_start(s, seg, N);
  const long long end = seg_start(s + 1, seg, N);
  if (start >= end) return;
  const long long W = kSumHead + 3LL * P;
  int32_t* c = gcarry ? gcarry + (r * S + s) * 3LL * P
                      : smem_carry + warp * 3 * P;
  const int32_t* bs_row = bs + r * blocks_per_row * W;
  const int32_t* ws_blk = ws + (r * S + b * kScanWarps) * W;
  const int n = b + warp;
  const auto summary = [&](int i) {
    return i < b ? bs_row + i * W : ws_blk + (i - b) * W;
  };
  uint32_t lower = 0, upper = 0;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const int32_t* x = summary(i);
    upper += static_cast<uint32_t>(x[0]);
    lower += static_cast<uint32_t>(x[1]);
  }
  for (int p = lane; p < P; p += 32) {
    int32_t act = 0, low = 0, v = kNone;
    uint32_t lo = 0;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int32_t* x = summary(i);
      const int32_t xs = x[kSumHead + p];
      if (xs & 4) {
        low = static_cast<int32_t>(lo + static_cast<uint32_t>(
                                            x[kSumHead + P + p]));
        v = x[kSumHead + 2 * P + p];
      }
      if (xs & 2) act = xs & 1;
      lo += static_cast<uint32_t>(x[1]);
    }
    c[p] = act;
    c[P + p] = low;
    c[2 * P + p] = v;
  }
  __syncwarp();
  const long long base = r * N;
  counter_walk<true>(typ + base, fcol + base, val + base, proc + base,
                     start, end, P, c, c + P, c + 2 * P, lower, upper,
                     lows + base, vals + base, ups + base, emits + base);
}

// ---- queue_scan (K7c): value slices, a block each, walked by warp
// chunks.
//
// The values are independent walks: with S_v the running sum over the
// row's lines of clipped value v (+1 an invoke-enqueue, -1 an ok
// dequeue), the reference's count is S_v - min(0, lowest prefix of
// S_v), and a dequeue is missing exactly where S_v first reaches a new
// low below 0. So the row's first missing dequeue is the first line at
// which some S_v equals -1 (the first new low below 0 is -1).
//
// Block (r, s) owns the values [s·Vs, s·Vs + Vs) of row r. Its warp w
// walks the row's lines [w·chunk, (w+1)·chunk) in order, 32 a tile, and
// keeps for each value of the slice the chunk's (sum, lowest prefix),
// the lowest prefix counted from the chunk's start with the empty
// prefix 0 included. A tile whose lines of the slice have distinct
// values (found by tagging each value with a lane) folds each line's
// step into its value's pair: (sum, low) then (sum + step, min(low,
// sum + step)). A tile with twins groups the lanes of each value with
// __match_any_sync; the group's inclusive prefixes come from two
// popcounts and its lowest from its highest lane's walk over the group,
// and that lane folds both into the pair. After a barrier each thread
// folds the pairs of every 256th value of the slice over the warps in
// chunk order into S_v and the row's lowest prefix (count = S_v - low),
// writes the count and keeps each chunk's incoming prefix; the first
// chunk at which a value's prefix reaches -1 is the block-wide minimum
// w* of the threads' least over their values. The row's first
// missing dequeue is then the first line of chunk w* at which a dequeue
// takes a value's prefix to -1; to find it without one warp walking the
// whole chunk again, the other seven warps summarise a seventh of chunk
// w* each, the block folds those from chunk w*'s incoming prefixes into
// h*, the first part that reaches -1, and warp h* walks its part again
// from its incoming prefixes to the line: the slice's first missing
// dequeue, stored per (row, slice). queue_finish_kernel takes each row's
// minimum over its slices. (A first version grouped every tile's lanes
// by __match_any_sync and took each group's lowest prefix with a
// __reduce_min_sync over the group: several times slower on an H100,
// where most tiles have no two lines of one value.)

constexpr int kQueueWarps = 8;
constexpr int kQueueThreads = 32 * kQueueWarps;
constexpr int kQueueFinishThreads = 256;
// Tiles whose lines a warp of queue_walk_kernel loads at once.
constexpr int kQueueAhead = 8;

// A lane's line of a tile, for the slice [lo, lo + vs) of a vocabulary
// of V values: whether it is an active line of the slice (`mine`), a
// dequeue, its clipped value's offset in the slice and its step.
struct QueueLane {
  bool mine, deq;
  int c, step;
};

__device__ __forceinline__ QueueLane queue_lane(int t, int fc, int32_t val,
                                                bool in, int V, int lo,
                                                int vs) {
  QueueLane q;
  const bool enq = in && t == kInvoke && fc == 0;
  q.deq = in && t == kOk && fc == 1;
  q.c = min(max(val, 0), V - 1) - lo;
  q.mine = (enq || q.deq) && static_cast<unsigned>(q.c) <
                                 static_cast<unsigned>(vs);
  q.step = enq ? 1 : -1;
  return q;
}

// Whether two of a tile's lanes share a value: each lane of the slice
// writes its lane into its value's tag, and a lane that reads back
// another's has a twin. Ends with the warp's tags settled.
__device__ __forceinline__ bool queue_twins(const QueueLane& q,
                                            uint8_t* tag) {
  const int lane = threadIdx.x & 31;
  if (q.mine) tag[q.c] = static_cast<uint8_t>(lane);
  __syncwarp();
  return __ballot_sync(kFull, q.mine && tag[q.c] != lane) != 0u;
}

// A tile with twins: the lanes of one value (a __match_any_sync group)
// in lane order. Returns the group's inclusive prefix at the lane;
// `leader` is the group's highest lane, `g_low` (the leader's only) the
// group's lowest inclusive prefix.
__device__ __forceinline__ int queue_group(const QueueLane& q, bool& leader,
                                           int& g_low) {
  const int lane = threadIdx.x & 31;
  const unsigned em = __ballot_sync(kFull, q.mine && q.step > 0);
  // Lanes outside the slice key on a negative number of their own, so
  // that each is a group of one.
  const unsigned peers = __match_any_sync(kFull, q.mine ? q.c : -1 - lane);
  const unsigned upto = peers & (kFull >> (31 - lane));
  leader = q.mine && (peers >> lane) == 1u;
  g_low = INT_MAX;
  if (leader) {
    int run = 0;
    for (unsigned m = peers; m; m &= m - 1u) {
      run += (em >> (__ffs(m) - 1)) & 1u ? 1 : -1;
      g_low = min(g_low, run);
    }
  }
  return 2 * __popc(upto & em) - __popc(upto);
}

// The lines of kQueueAhead tiles from g0 (< end), a line a lane each,
// loaded at once, so that a warp waits on memory once a group of tiles
// rather than once a tile; lines past `end` read as PAD.
__device__ __forceinline__ void queue_load(
    const int32_t* __restrict__ typ, const int32_t* __restrict__ fcol,
    const int32_t* __restrict__ val, long long base, long long g0,
    long long end, int* tq, int* fq, int32_t* vq) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < kQueueAhead; ++a) {
    const long long j = g0 + 32 * a + lane;
    tq[a] = -1;
    fq[a] = vq[a] = 0;
    if (j < end) {
      tq[a] = typ[base + j];
      fq[a] = fcol[base + j];
      vq[a] = val[base + j];
    }
  }
}

// One warp's walk over a row's lines [start, end) (`base` the row's
// first line) folding each line of the slice into its value's (sum,
// low) pair.
__device__ __forceinline__ void queue_summarise(
    const int32_t* __restrict__ typ, const int32_t* __restrict__ fcol,
    const int32_t* __restrict__ val, long long base, long long start,
    long long end, int V, int lo, int vs, int2* pair, uint8_t* tag) {
  const int lane = threadIdx.x & 31;
  for (long long g0 = start; g0 < end; g0 += 32 * kQueueAhead) {
    int tq[kQueueAhead], fq[kQueueAhead];
    int32_t vq[kQueueAhead];
    queue_load(typ, fcol, val, base, g0, end, tq, fq, vq);
#pragma unroll
    for (int a = 0; a < kQueueAhead; ++a) {
      const long long j0 = g0 + 32 * a;
      if (j0 >= end) break;
      const QueueLane q =
          queue_lane(tq[a], fq[a], vq[a], j0 + lane < end, V, lo, vs);
      if (__ballot_sync(kFull, q.mine) == 0u) continue;
      if (!queue_twins(q, tag)) {
        if (q.mine) {
          const int2 p = pair[q.c];
          pair[q.c] = make_int2(p.x + q.step, min(p.y, p.x + q.step));
        }
      } else {
        bool leader;
        int g_low;
        const int pre = queue_group(q, leader, g_low);
        if (leader) {
          const int2 p = pair[q.c];
          pair[q.c] = make_int2(p.x + pre, min(p.y, p.x + g_low));
        }
      }
      __syncwarp();
    }
  }
}

// One warp's walk over lines [start, end) from the incoming prefixes
// held in its pairs' sums, to the first dequeue that takes a value's
// prefix to -1: its line, INT_MAX for none.
__device__ __forceinline__ int queue_find(
    const int32_t* __restrict__ typ, const int32_t* __restrict__ fcol,
    const int32_t* __restrict__ val, long long base, long long start,
    long long end, int V, int lo, int vs, int2* pair, uint8_t* tag) {
  const int lane = threadIdx.x & 31;
  for (long long g0 = start; g0 < end; g0 += 32 * kQueueAhead) {
    int tq[kQueueAhead], fq[kQueueAhead];
    int32_t vq[kQueueAhead];
    queue_load(typ, fcol, val, base, g0, end, tq, fq, vq);
#pragma unroll
    for (int a = 0; a < kQueueAhead; ++a) {
      const long long j0 = g0 + 32 * a;
      if (j0 >= end) break;
      const QueueLane q =
          queue_lane(tq[a], fq[a], vq[a], j0 + lane < end, V, lo, vs);
      const int before = q.mine ? pair[q.c].x : 0;
      bool leader = q.mine;
      int pre = q.step, g_low;
      if (queue_twins(q, tag)) pre = queue_group(q, leader, g_low);
      const unsigned hit =
          __ballot_sync(kFull, q.deq && q.mine && before + pre == -1);
      if (hit) return static_cast<int>(j0) + __ffs(hit) - 1;
      if (leader) pair[q.c].x = before + pre;
      __syncwarp();
    }
  }
  return INT_MAX;
}

// Part w of lines [from, N) cut in parts of len lines: [from + w·len,
// from + w·len + len), clipped to N.
__device__ __forceinline__ longlong2 queue_span(int w, long long len,
                                                long long from, int N) {
  const long long a = min(from + static_cast<long long>(w) * len,
                          static_cast<long long>(N));
  return make_longlong2(a, min(a + len, static_cast<long long>(N)));
}

// Fold the (sum, low) pairs of `parts` consecutive parts of a row's
// lines, part k's pairs at pairs + at(k)·Vs, value by value in part
// order from the incoming prefixes `in` (0 where null): each part's
// pair sum becomes its incoming prefix, and the result is the first
// part at which some value's prefix reaches -1 (`parts` for none).
// With `counts`, writes each value's count, its sum less its lowest
// prefix. Ends with a block barrier.
template <typename At>
__device__ __forceinline__ int queue_fold(int2* pairs, int Vs, int vs,
                                          int parts, At at, const int2* in,
                                          int32_t* counts, int* first) {
  if (threadIdx.x == 0) *first = parts;
  __syncthreads();
  // The least part, over this thread's values, at which one reaches -1.
  int first_k = parts;
  for (int c = threadIdx.x; c < vs; c += kQueueThreads) {
    int sum = in ? in[c].x : 0, low = 0;
    for (int k = 0; k < parts; ++k) {
      int2& p = pairs[at(k) * Vs + c];
      if (sum + p.y <= -1 && k < first_k) first_k = k;
      low = min(low, sum + p.y);
      const int in_sum = sum;
      sum += p.x;
      p.x = in_sum;
    }
    if (counts) counts[c] = sum - low;
  }
  if (first_k < parts) atomicMin(first, first_k);
  __syncthreads();
  return *first;
}

__global__ void __launch_bounds__(kQueueThreads)
queue_walk_kernel(const int32_t* __restrict__ typ,
                  const int32_t* __restrict__ fcol,
                  const int32_t* __restrict__ val, int N, int V, int S,
                  int Vs, int chunk, int32_t* __restrict__ counts,
                  int32_t* __restrict__ first_bad) {
  // [kQueueWarps][Vs] (sum, low) pairs, then [kQueueWarps][Vs] tags.
  extern __shared__ int2 qstate[];
  __shared__ int first;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long r = blockIdx.x / S;
  const int s = blockIdx.x - static_cast<int>(r) * S;
  const int lo = s * Vs;
  const int vs = min(Vs, V - lo);
  const long long base = r * N;
  for (int i = tid; i < kQueueWarps * Vs; i += kQueueThreads)
    qstate[i] = make_int2(0, 0);
  __syncthreads();

  int2* pair = qstate + warp * Vs;
  uint8_t* tag = reinterpret_cast<uint8_t*>(qstate + kQueueWarps * Vs) +
                 warp * Vs;
  const longlong2 mine_c = queue_span(warp, chunk, 0, N);
  queue_summarise(typ, fcol, val, base, mine_c.x, mine_c.y, V, lo, vs,
                  pair, tag);
  __syncthreads();
  // The chunks in order: the counts, each chunk's incoming prefixes, and
  // w*, the first chunk at which a value's prefix reaches -1.
  const int ws = queue_fold(qstate, Vs, vs, kQueueWarps,
                            [](int k) { return k; }, nullptr,
                            counts + r * V + lo, &first);
  if (ws == kQueueWarps) {
    if (tid == 0) first_bad[blockIdx.x] = INT_MAX;
    return;
  }
  // The other warps (helper h = warp, less one past w*) summarise
  // sub-chunks of chunk w* in their own pairs; the fold from chunk w*'s
  // incoming prefixes gives h*, whose warp walks its sub-chunk again.
  constexpr int kHelpers = kQueueWarps - 1;
  const longlong2 cw = queue_span(ws, chunk, 0, N);
  const long long sub =
      ((cw.y - cw.x + kHelpers - 1) / kHelpers + 31) / 32 * 32;
  const auto helper_warp = [ws](int h) { return h < ws ? h : h + 1; };
  const int h = warp < ws ? warp : warp - 1;
  longlong2 mine_s = make_longlong2(0, 0);
  if (warp != ws) {
    for (int c = lane; c < Vs; c += 32) pair[c] = make_int2(0, 0);
    __syncwarp();
    mine_s = queue_span(h, sub, cw.x, N);
    mine_s.y = min(mine_s.y, cw.y);
    mine_s.x = min(mine_s.x, mine_s.y);
    queue_summarise(typ, fcol, val, base, mine_s.x, mine_s.y, V, lo, vs,
                    pair, tag);
  }
  __syncthreads();
  const int hs = queue_fold(qstate, Vs, vs, kHelpers, helper_warp,
                            qstate + ws * Vs, nullptr, &first);
  if (warp != helper_warp(hs)) return;
  const int found = queue_find(typ, fcol, val, base, mine_s.x, mine_s.y,
                               V, lo, vs, pair, tag);
  if (lane == 0) first_bad[blockIdx.x] = found;
}

// Each row's first missing dequeue: the minimum over its slices.
__global__ void __launch_bounds__(kQueueFinishThreads)
queue_finish_kernel(const int32_t* __restrict__ first_bad, int B, int S,
                    uint8_t* __restrict__ valid_out,
                    int32_t* __restrict__ bad_out) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kQueueFinishThreads + threadIdx.x;
  if (r >= B) return;
  int bad = INT_MAX;
  for (int s = 0; s < S; ++s) bad = min(bad, first_bad[r * S + s]);
  valid_out[r] = bad == INT_MAX;
  bad_out[r] = bad == INT_MAX ? -1 : bad;
}

// ---- fifo_scan (K7d): compaction, then a run-length walk of the
// dequeues.
//
// The tail only grows, so slot k < Nmax - 1 of the reference's ring
// holds the k-th invoke-enqueue's value from its enqueue on, and the
// clipped last slot, read at any head >= Nmax - 1, holds the latest
// enqueue's: an ok dequeue seeing head h with tail T (the enqueues
// before it) succeeds iff h < T and v == (h < Nmax - 1 ? E[h] :
// E[T - 1]), E the row's enqueued values in order. Pass A lists E and
// the ok dequeues (line, value, T) by segments as the counter cuts a
// row (fifo_count_kernel, fifo_compact_kernel); pass B (fifo_walk_kernel)
// walks the dequeue list.

// Tiles whose lines the compaction loads at once, so that a warp waits
// on memory once a group rather than once a tile (the counter's walk,
// whose tiles are longer chains, ran slower with it on an H100). Threads
// of a walk block, dequeues a thread takes in a tile, and the shared
// memory the walk keeps beside the staged ring (the two reduction
// buffers).
constexpr int kAhead = 8;
constexpr int kWalkThreads = 1024;
constexpr int kWalkPer = 4;
constexpr int kWalkTile = kWalkThreads * kWalkPer;
constexpr int kWalkRedBytes = 2 * (kWalkThreads / 32) * 4;

// Each warp's segment's invoke-enqueues and ok dequeues into counts
// [B, S, 2].
__global__ void __launch_bounds__(kScanThreads)
fifo_count_kernel(const int32_t* __restrict__ typ,
                  const int32_t* __restrict__ fcol, int N, int seg,
                  int blocks_per_row, int32_t* __restrict__ counts) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = blockIdx.x / blocks_per_row;
  const int b = blockIdx.x - static_cast<int>(r) * blocks_per_row;
  const int S = blocks_per_row * kScanWarps;
  const int s = b * kScanWarps + warp;
  const long long base = r * N;
  const long long end = seg_start(s + 1, seg, N);
  int e = 0, d = 0;
#pragma unroll 8
  for (long long j = seg_start(s, seg, N) + lane; j < end; j += 32) {
    const int t = typ[base + j], fc = fcol[base + j];
    e += t == kInvoke && fc == 0;
    d += t == kOk && fc == 1;
  }
  e = __reduce_add_sync(kFull, e);
  d = __reduce_add_sync(kFull, d);
  if (lane == 0) {
    counts[(r * S + s) * 2] = e;
    counts[(r * S + s) * 2 + 1] = d;
  }
}

// Each warp's segment: the earlier segments' counts give its first
// enqueue and dequeue ranks; ballots rank the tile's lines. Writes
// E[rank] = v of each invoke-enqueue, and of each ok dequeue its line,
// value and enqueue count (dj, dv, dt at its rank), all [B, N]; the
// row's last warp writes the row's enqueues (tail) and dequeues (deqs).
__global__ void __launch_bounds__(kScanThreads)
fifo_compact_kernel(const int32_t* __restrict__ typ,
                    const int32_t* __restrict__ fcol,
                    const int32_t* __restrict__ val, int N, int seg,
                    int blocks_per_row, const int32_t* __restrict__ counts,
                    int32_t* __restrict__ E, int32_t* __restrict__ dj,
                    int32_t* __restrict__ dv, int32_t* __restrict__ dt,
                    int32_t* __restrict__ deqs,
                    int32_t* __restrict__ tail_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = blockIdx.x / blocks_per_row;
  const int b = blockIdx.x - static_cast<int>(r) * blocks_per_row;
  const int S = blocks_per_row * kScanWarps;
  const int s = b * kScanWarps + warp;
  const long long start = seg_start(s, seg, N);
  const long long end = seg_start(s + 1, seg, N);
  if (start >= end && s != S - 1) return;
  int e = 0, d = 0;
  for (int i = lane; i < s; i += 32) {
    e += counts[(r * S + i) * 2];
    d += counts[(r * S + i) * 2 + 1];
  }
  int be = __reduce_add_sync(kFull, e), bd = __reduce_add_sync(kFull, d);
  const long long base = r * N;
  const unsigned below = (1u << lane) - 1u;
  for (long long g0 = start; g0 < end; g0 += 32 * kAhead) {
    int tq[kAhead], fq[kAhead];
    int32_t vq[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long j = g0 + 32 * q + lane;
      tq[q] = -1;
      fq[q] = vq[q] = 0;
      if (j < end) {
        tq[q] = typ[base + j];
        fq[q] = fcol[base + j];
        vq[q] = val[base + j];
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long j0 = g0 + 32 * q;
      if (j0 >= end) break;
      const long long j = j0 + lane;
      const int32_t v = vq[q];
      const bool enq = tq[q] == kInvoke && fq[q] == 0;
      const bool deq = tq[q] == kOk && fq[q] == 1;
      const unsigned em = __ballot_sync(kFull, enq);
      const unsigned dm = __ballot_sync(kFull, deq);
      const int re = be + __popc(em & below);
      if (enq) E[base + re] = v;
      if (deq) {
        const long long at = base + bd + __popc(dm & below);
        dj[at] = static_cast<int32_t>(j);
        dv[at] = v;
        dt[at] = re;
      }
      be += __popc(em);
      bd += __popc(dm);
    }
  }
  if (s == S - 1 && lane == 0) {
    tail_out[r] = be;
    deqs[r] = bd;
  }
}

// A block a row walks its dequeue list from head 0 in tiles of
// kWalkTile, in runs. In a success run from dequeue i0 at head h,
// dequeue i is taken to see head h + (i - i0); the first that fails (a
// block-wide minimum) ends the run, with the head advanced by the
// successes before it. In a failure run at head h, the first dequeue
// that succeeds at h ends it. The first failure gives valid, bad and
// bad_head; the walk goes on to the end for the final head. With
// `stage`, the ring's unclipped slots E[0 .. min(Nmax - 1, tail)) are
// copied to shared memory first.
__global__ void __launch_bounds__(kWalkThreads)
fifo_walk_kernel(const int32_t* __restrict__ E,
                 const int32_t* __restrict__ dj,
                 const int32_t* __restrict__ dv,
                 const int32_t* __restrict__ dt,
                 const int32_t* __restrict__ deqs,
                 const int32_t* __restrict__ tail_out, int N, int Nmax,
                 bool stage, uint8_t* __restrict__ valid_out,
                 int32_t* __restrict__ bad_out,
                 int32_t* __restrict__ bad_head_out,
                 int32_t* __restrict__ head_out) {
  extern __shared__ int32_t smem_ring[];
  __shared__ int red[2][kWalkThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = blockIdx.x, base = r * N;
  const int m = deqs[r];
  const int32_t* e_row = E + base;
  const int32_t* ring = e_row;
  if (stage) {
    const int n = min(Nmax - 1, tail_out[r]);
    for (int i = tid; i < n; i += kWalkThreads) smem_ring[i] = e_row[i];
    __syncthreads();
    ring = smem_ring;
  }
  int h = 0, bad_i = -1, bad_head = -1, parity = 0;
  bool succ = true;
  // Each tile's dequeues are loaded while the tile before is walked.
  int v[kWalkPer] = {}, tl[kWalkPer] = {}, nv[kWalkPer], ntl[kWalkPer];
  const auto load = [&](int i0, int* lv, int* lt) {
#pragma unroll
    for (int q = 0; q < kWalkPer; ++q) {
      const int i = i0 + q * kWalkThreads + tid;
      if (i < m) {
        lv[q] = dv[base + i];
        lt[q] = dt[base + i];
      }
    }
  };
  load(0, v, tl);
  for (int i0 = 0; i0 < m; i0 += kWalkTile) {
    const int n = min(kWalkTile, m - i0);
    load(i0 + kWalkTile, nv, ntl);
    int pos = 0;
    while (pos < n) {
      int first = n;
#pragma unroll
      for (int q = 0; q < kWalkPer; ++q) {
        const int i = q * kWalkThreads + tid;
        if (first == n && i >= pos && i < n) {
          const int hh = succ ? h + (i - pos) : h;
          const bool ok =
              hh < tl[q] && (hh < Nmax - 1 ? ring[hh] : e_row[tl[q] - 1])
                                == v[q];
          if (ok != succ) first = i;
        }
      }
      first = __reduce_min_sync(kFull, first);
      if (lane == 0) red[parity][warp] = first;
      __syncthreads();
#pragma unroll 8
      for (int w = 0; w < kWalkThreads / 32; ++w)
        first = min(first, red[parity][w]);
      parity ^= 1;
      if (succ) {
        h += first - pos;
        if (first < n) {
          if (bad_i < 0) {
            bad_i = i0 + first;
            bad_head = h;
          }
          succ = false;
          pos = first + 1;
        } else {
          pos = n;
        }
      } else if (first < n) {
        succ = true;
        pos = first;
      } else {
        pos = n;
      }
    }
#pragma unroll
    for (int q = 0; q < kWalkPer; ++q) {
      v[q] = nv[q];
      tl[q] = ntl[q];
    }
  }
  if (tid == 0) {
    valid_out[r] = bad_i < 0;
    bad_out[r] = bad_i < 0 ? -1 : dj[base + bad_i];
    bad_head_out[r] = bad_head;
    head_out[r] = h;
  }
}

// Opt a kernel in to `bytes` of dynamic shared memory (needed above
// 48 KB).
template <typename K>
int set_smem(K kernel, long long bytes) {
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int F>
int launch_counts(const void* typ, const void* f, const void* val,
                  const void* final_read, int B, int N, int V, int S,
                  int Vs, void* planes, void* attempted, cudaStream_t s) {
  const long long smem = static_cast<long long>(Fam<F>::C) * Vs * 4;
  if (S < 1 || Vs < 1 || static_cast<long long>(S) * Vs < V
      || static_cast<long long>(S - 1) * Vs >= V
      || static_cast<long long>(B) * S > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = set_smem(fold_counts_kernel<F>, smem)) return e;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const int vec = N % 4 == 0 && aligned(typ) && aligned(f) && aligned(val);
  fold_counts_kernel<F><<<B * S, kCountThreads, static_cast<size_t>(smem),
                          s>>>(
      static_cast<const int32_t*>(typ), static_cast<const int32_t*>(f),
      static_cast<const int32_t*>(val),
      static_cast<const uint8_t*>(final_read), N, V, S, Vs, vec, planes,
      static_cast<int32_t*>(attempted));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fold_counts: family 0 set, 1 crdb, 2 total queue, 3 ids. typ, f, val
// int32 [B, N]; final_read uint8 [B, V] for set and crdb (null
// otherwise); S slices of Vs values a row (S·Vs >= V > (S-1)·Vs, the
// C histograms of a slice within shared memory); planes [B, L, V]
// (uint8 for set and crdb, int32 otherwise); attempted int32 [B] for
// ids (null otherwise).
extern "C" int fold_counts(int family, const void* typ, const void* f,
                           const void* val, const void* final_read, int B,
                           int N, int V, int S, int Vs, void* planes,
                           void* attempted, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (family) {
    case kSet:
      return launch_counts<kSet>(typ, f, val, final_read, B, N, V, S, Vs,
                                 planes, attempted, s);
    case kCrdb:
      return launch_counts<kCrdb>(typ, f, val, final_read, B, N, V, S, Vs,
                                  planes, attempted, s);
    case kTq:
      return launch_counts<kTq>(typ, f, val, final_read, B, N, V, S, Vs,
                                planes, attempted, s);
    case kIds:
      return launch_counts<kIds>(typ, f, val, final_read, B, N, V, S, Vs,
                                 planes, attempted, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// counter_scan: typ, f, val, proc int32 [B, N] (proc in [0, P)) ->
// lows, vals, ups int32 [B, N], emits uint8 [B, N]. seg lines a warp;
// scratch of scratch_words int32 words: the segments' summaries, the
// blocks' and, past P = kCounterSmemP, each segment's carry.
extern "C" int counter_scan(const void* typ, const void* f, const void* val,
                            const void* proc, int B, int N, int P, int seg,
                            void* scratch, long long scratch_words,
                            void* lows, void* vals, void* ups, void* emits,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (N < 1 || P < 1 || seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long segs = (static_cast<long long>(N) + seg - 1) / seg;
  const long long bpr = (segs + kScanWarps - 1) / kScanWarps;
  const long long S = bpr * kScanWarps, W = kSumHead + 3LL * P;
  const bool global_carry = P > kCounterSmemP;
  const long long words =
      B * (S + bpr) * W + (global_carry ? B * S * 3LL * P : 0);
  if (B * bpr > INT_MAX || words > scratch_words || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* ws = static_cast<int32_t*>(scratch);
  int32_t* bs = ws + B * S * W;
  int32_t* gcarry = global_carry ? bs + B * bpr * W : nullptr;
  const size_t smem =
      global_carry ? 0 : static_cast<size_t>(kScanWarps) * 3 * P * 4;
  const auto* t = static_cast<const int32_t*>(typ);
  const auto* fc = static_cast<const int32_t*>(f);
  const auto* v = static_cast<const int32_t*>(val);
  const auto* pr = static_cast<const int32_t*>(proc);
  const int grid = static_cast<int>(B * bpr);
  counter_summary_kernel<<<grid, kScanThreads, smem, s>>>(
      t, fc, v, pr, N, P, seg, static_cast<int>(bpr), global_carry, ws, bs);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  counter_fill_kernel<<<grid, kScanThreads, smem, s>>>(
      t, fc, v, pr, N, P, seg, static_cast<int>(bpr), ws, bs, gcarry,
      static_cast<int32_t*>(lows), static_cast<int32_t*>(vals),
      static_cast<int32_t*>(ups), static_cast<uint8_t*>(emits));
  return static_cast<int>(cudaGetLastError());
}

// queue_scan: typ, f, val int32 [B, N] -> valid uint8 [B], bad int32
// [B], counts int32 [B, V]. S slices of Vs values a row (S·Vs >= V >
// (S-1)·Vs, 9·kQueueWarps·Vs bytes of shared memory), chunk lines a
// warp (kQueueWarps·chunk >= N); scratch of B·S int32 words, each
// (row, slice)'s first missing dequeue.
extern "C" int queue_scan(const void* typ, const void* f, const void* val,
                          int B, int N, int V, int S, int Vs, int chunk,
                          void* scratch, void* valid, void* bad,
                          void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (N < 1 || V < 1 || S < 1 || Vs < 1 || chunk < 1
      || static_cast<long long>(S) * Vs < V
      || static_cast<long long>(S - 1) * Vs >= V
      || static_cast<long long>(chunk) * kQueueWarps < N
      || static_cast<long long>(B) * S > INT_MAX || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(kQueueWarps) * Vs * 9;
  if (const int e = set_smem(queue_walk_kernel, smem)) return e;
  int32_t* first_bad = static_cast<int32_t*>(scratch);
  queue_walk_kernel<<<B * S, kQueueThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const int32_t*>(typ), static_cast<const int32_t*>(f),
      static_cast<const int32_t*>(val), N, V, S, Vs, chunk,
      static_cast<int32_t*>(counts), first_bad);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  queue_finish_kernel<<<(B + kQueueFinishThreads - 1) / kQueueFinishThreads,
                        kQueueFinishThreads, 0, s>>>(
      first_bad, B, S, static_cast<uint8_t*>(valid),
      static_cast<int32_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// fifo_scan: typ, f, val int32 [B, N] -> valid uint8 [B], bad, bad_head,
// head, tail int32 [B]. seg lines a warp; scratch of scratch_words int32
// words: E, dj, dv, dt (B·N each), the segments' counts and the rows'
// dequeue counts.
extern "C" int fifo_scan(const void* typ, const void* f, const void* val,
                         int B, int N, int Nmax, int seg, void* scratch,
                         long long scratch_words, void* valid, void* bad,
                         void* bad_head, void* head, void* tail,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (N < 1 || Nmax < 1 || seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long segs = (static_cast<long long>(N) + seg - 1) / seg;
  const long long bpr = (segs + kScanWarps - 1) / kScanWarps;
  const long long S = bpr * kScanWarps, BN = static_cast<long long>(B) * N;
  if (B * bpr > INT_MAX || B * (4LL * N + 2 * S + 1) > scratch_words
      || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* E = static_cast<int32_t*>(scratch);
  int32_t* dj = E + BN;
  int32_t* dv = dj + BN;
  int32_t* dt = dv + BN;
  int32_t* counts = dt + BN;
  int32_t* deqs = counts + B * S * 2;
  // The ring's unclipped slots are staged where they fit beside the
  // walk's own shared memory (cuda_folds.tier's "smem").
  const bool stage = 4LL * (Nmax - 1) + kWalkRedBytes <= kSmemLimit;
  const long long ring = stage ? 4LL * std::max(std::min(Nmax - 1, N), 1)
                               : 0;
  if (const int e = set_smem(fifo_walk_kernel, ring)) return e;
  const auto* t = static_cast<const int32_t*>(typ);
  const auto* fc = static_cast<const int32_t*>(f);
  const int grid = static_cast<int>(B * bpr);
  fifo_count_kernel<<<grid, kScanThreads, 0, s>>>(
      t, fc, N, seg, static_cast<int>(bpr), counts);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  fifo_compact_kernel<<<grid, kScanThreads, 0, s>>>(
      t, fc, static_cast<const int32_t*>(val), N, seg,
      static_cast<int>(bpr), counts, E, dj, dv, dt, deqs,
      static_cast<int32_t*>(tail));
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  fifo_walk_kernel<<<B, kWalkThreads, static_cast<size_t>(ring), s>>>(
      E, dj, dv, dt, deqs, static_cast<const int32_t*>(tail), N, Nmax,
      stage, static_cast<uint8_t*>(valid), static_cast<int32_t*>(bad),
      static_cast<int32_t*>(bad_head), static_cast<int32_t*>(head));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* folds_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
