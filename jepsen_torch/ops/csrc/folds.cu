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
//   * the scans: one thread a row, walking its lines in order, as the
//     reference's scan does; a row is a dependent walk. The carry lives
//     in shared memory where it fits (the counter's per-process pending
//     reads to P = 64, the queue's multiset to V words a row, the FIFO's
//     ring to Nmax words a row), laid out thread-interleaved (word i of
//     thread t at i·R + t) so that the block's threads never share a
//     bank; otherwise in device memory (the queue's in its `counts`
//     output, the others in a scratch slice the wrapper allocates).
//     Arithmetic on the counter's bounds is done in uint32 so that it
//     wraps as the reference's int32 does; the host detours rows whose
//     sums could leave int32, so no wrap happens on the path.
//
// What bounds it on this card. fold_counts reads 12 bytes a line and
// writes P planes of V elements a row, a few int32 operations a line and
// a plane element: at the full-width batch (32 rows of 40,000 lines, V
// 16,384) about 15 MB in and 2–12 MB out, 0.008 ms at 3.35 TB/s, so it
// is bound by bytes; the slices read the lines S times, from L2. The
// scans are bound by each row's chain of dependent
// shared-memory or device-memory accesses (a line every few hundred
// cycles at best), not by bytes or operations: one thread a row leaves
// the card nearly empty at B = 64. A later version would cut a row into
// segments and combine them (the counter's bounds are prefix sums, the
// queue's counts a multiset sum), or run a warp a row.

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
// Rows (threads) of a scan block, at most.
constexpr int kScanRows = 32;
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

// One thread a row: the counter's bounds. Per line, before the update:
// lows = p_low[p], vals = p_val[p], ups = upper, emits = (ok read) and
// p_act[p]. The per-process carry (p_low, p_val, p_act, P words each)
// is in shared memory, word i of thread t at i·R + t, or, with
// `scratch`, in the row's 3·P words there.
__global__ void counter_scan_kernel(const int32_t* __restrict__ typ,
                                    const int32_t* __restrict__ fcol,
                                    const int32_t* __restrict__ val,
                                    const int32_t* __restrict__ proc,
                                    int B, int N, int P, int32_t* scratch,
                                    int32_t* __restrict__ lows,
                                    int32_t* __restrict__ vals,
                                    int32_t* __restrict__ ups,
                                    uint8_t* __restrict__ emits) {
  extern __shared__ int32_t smem_carry[];
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= B) return;
  int32_t* carry;
  int stride;
  if (scratch) {
    carry = scratch + r * 3 * P;
    stride = 1;
  } else {
    carry = smem_carry + threadIdx.x;
    stride = blockDim.x;
  }
  int32_t* p_low = carry;
  int32_t* p_val = carry + P * stride;
  int32_t* p_act = carry + 2 * P * stride;
  for (int p = 0; p < P; ++p) {
    p_low[p * stride] = 0;
    p_val[p * stride] = kNone;
    p_act[p * stride] = 0;
  }
  uint32_t lower = 0, upper = 0;
  const long long base = r * N;
  for (int j = 0; j < N; ++j) {
    const int t = typ[base + j], fc = fcol[base + j];
    const int32_t v = val[base + j];
    // The encoder gives 0 <= p < P; the clamp only keeps an index that
    // breaks that contract inside the row's carry.
    const int p = min(max(proc[base + j], 0), P - 1) * stride;
    const bool inv_read = t == kInvoke && fc == 1;
    const bool ok_read = t == kOk && fc == 1;
    const int32_t act = p_act[p];
    lows[base + j] = p_low[p];
    vals[base + j] = p_val[p];
    ups[base + j] = static_cast<int32_t>(upper);
    emits[base + j] = ok_read && act;
    if (inv_read) {
      p_low[p] = static_cast<int32_t>(lower);
      p_val[p] = v;
      p_act[p] = 1;
    } else if (ok_read) {
      p_act[p] = 0;
    }
    const uint32_t add = v == kNone ? 0u : static_cast<uint32_t>(v);
    if (t == kInvoke && fc == 0) upper += add;
    if (t == kOk && fc == 0) lower += add;
  }
}

// One thread a row: the unordered queue's multiset. counts [B, V] is the
// output; the walk keeps it in shared memory (word v of thread t at
// v·R + t) and copies it out at the end, or, when `in_place`, updates
// the output row itself.
__global__ void queue_scan_kernel(const int32_t* __restrict__ typ,
                                  const int32_t* __restrict__ fcol,
                                  const int32_t* __restrict__ val, int B,
                                  int N, int V, bool in_place,
                                  uint8_t* __restrict__ valid_out,
                                  int32_t* __restrict__ bad_out,
                                  int32_t* counts) {
  extern __shared__ int32_t smem_counts[];
  const int R = blockDim.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R), B - row0));
  const long long r = row0 + threadIdx.x;
  int32_t* c;
  int stride;
  if (in_place) {
    c = counts + r * V;
    stride = 1;
    if (threadIdx.x < rows)
      for (int v = 0; v < V; ++v) c[v] = 0;
  } else {
    c = smem_counts + threadIdx.x;
    stride = R;
    for (int i = threadIdx.x; i < R * V; i += R) smem_counts[i] = 0;
    __syncthreads();
  }
  if (threadIdx.x < rows) {
    bool valid = true;
    int32_t bad = -1;
    const long long base = r * N;
    for (int j = 0; j < N; ++j) {
      const int t = typ[base + j], fc = fcol[base + j];
      const int k = min(max(val[base + j], 0), V - 1) * stride;
      if (t == kInvoke && fc == 0) c[k] += 1;
      if (t == kOk && fc == 1) {
        if (c[k] == 0) {
          if (valid) bad = j;
          valid = false;
        } else {
          c[k] -= 1;
        }
      }
    }
    valid_out[r] = valid;
    bad_out[r] = bad;
  }
  if (!in_place) {
    __syncthreads();
    for (long long i = threadIdx.x; i < static_cast<long long>(rows) * V;
         i += R) {
      const int t = static_cast<int>(i / V), v = static_cast<int>(i % V);
      counts[(row0 + t) * V + v] = smem_counts[v * R + t];
    }
  }
}

// One thread a row: the FIFO queue's ring of enqueued values (Nmax words
// a row, in shared memory with word i of thread t at i·R + t, or in the
// row's slice of `scratch`), with head and tail. A wrong dequeue (empty,
// or not the value at the head) leaves head where it is; the first one
// records its line and the head.
__global__ void fifo_scan_kernel(const int32_t* __restrict__ typ,
                                 const int32_t* __restrict__ fcol,
                                 const int32_t* __restrict__ val, int B,
                                 int N, int Nmax, int32_t* scratch,
                                 uint8_t* __restrict__ valid_out,
                                 int32_t* __restrict__ bad_out,
                                 int32_t* __restrict__ bad_head_out,
                                 int32_t* __restrict__ head_out,
                                 int32_t* __restrict__ tail_out) {
  extern __shared__ int32_t smem_ring[];
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= B) return;
  int32_t* buf;
  int stride;
  if (scratch) {
    buf = scratch + r * Nmax;
    stride = 1;
  } else {
    buf = smem_ring + threadIdx.x;
    stride = blockDim.x;
  }
  int32_t head = 0, tail = 0, bad = -1, bad_head = -1;
  bool valid = true;
  const long long base = r * N;
  for (int j = 0; j < N; ++j) {
    const int t = typ[base + j], fc = fcol[base + j];
    const int32_t v = val[base + j];
    if (t == kInvoke && fc == 0) {
      buf[min(max(tail, 0), Nmax - 1) * stride] = v;
      tail += 1;
    }
    if (t == kOk && fc == 1) {
      const bool wrong =
          head >= tail || buf[min(max(head, 0), Nmax - 1) * stride] != v;
      if (wrong) {
        if (valid) {
          bad = j;
          bad_head = head;
        }
        valid = false;
      } else {
        head += 1;
      }
    }
  }
  valid_out[r] = valid;
  bad_out[r] = bad;
  bad_head_out[r] = bad_head;
  head_out[r] = head;
  tail_out[r] = tail;
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

// Rows a shared-memory scan block takes when each keeps `words` words of
// carry: up to kScanRows, 0 when not even one row fits.
int scan_rows(long long words) {
  const long long fit = kSmemLimit / (words * 4);
  return static_cast<int>(fit < kScanRows ? fit : kScanRows);
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
// lows, vals, ups int32 [B, N], emits uint8 [B, N]. scratch null when
// P <= 64 (the carry in shared memory), else B·3·P int32 words.
extern "C" int counter_scan(const void* typ, const void* f, const void* val,
                            const void* proc, int B, int N, int P,
                            void* scratch, void* lows, void* vals,
                            void* ups, void* emits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (N < 1 || P < 1 || (scratch == nullptr && P > kCounterSmemP))
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = kScanRows;
  const long long smem = scratch ? 0 : 3LL * P * R * 4;
  counter_scan_kernel<<<(B + R - 1) / R, R, static_cast<size_t>(smem), s>>>(
      static_cast<const int32_t*>(typ), static_cast<const int32_t*>(f),
      static_cast<const int32_t*>(val), static_cast<const int32_t*>(proc), B,
      N, P, static_cast<int32_t*>(scratch), static_cast<int32_t*>(lows),
      static_cast<int32_t*>(vals), static_cast<int32_t*>(ups),
      static_cast<uint8_t*>(emits));
  return static_cast<int>(cudaGetLastError());
}

// queue_scan: typ, f, val int32 [B, N] -> valid uint8 [B], bad int32
// [B], counts int32 [B, V]. The multiset is kept in shared memory when a
// row's V words fit, else in `counts` itself.
extern "C" int queue_scan(const void* typ, const void* f, const void* val,
                          int B, int N, int V, void* valid, void* bad,
                          void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = scan_rows(V);
  const bool in_place = fit == 0;
  const int R = in_place ? kScanRows : fit;
  const long long smem = in_place ? 0 : static_cast<long long>(R) * V * 4;
  if (const int e = set_smem(queue_scan_kernel, smem)) return e;
  queue_scan_kernel<<<(B + R - 1) / R, R, static_cast<size_t>(smem), s>>>(
      static_cast<const int32_t*>(typ), static_cast<const int32_t*>(f),
      static_cast<const int32_t*>(val), B, N, V, in_place,
      static_cast<uint8_t*>(valid), static_cast<int32_t*>(bad),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// fifo_scan: typ, f, val int32 [B, N] -> valid uint8 [B], bad, bad_head,
// head, tail int32 [B]. scratch null when a row's Nmax-word ring fits in
// shared memory, else B·Nmax int32 words.
extern "C" int fifo_scan(const void* typ, const void* f, const void* val,
                         int B, int N, int Nmax, void* scratch, void* valid,
                         void* bad, void* bad_head, void* head, void* tail,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (N < 1 || Nmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = scan_rows(Nmax);
  if (scratch == nullptr && fit == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = scratch ? kScanRows : fit;
  const long long smem = scratch ? 0 : static_cast<long long>(R) * Nmax * 4;
  if (const int e = set_smem(fifo_scan_kernel, smem)) return e;
  fifo_scan_kernel<<<(B + R - 1) / R, R, static_cast<size_t>(smem), s>>>(
      static_cast<const int32_t*>(typ), static_cast<const int32_t*>(f),
      static_cast<const int32_t*>(val), B, N, Nmax,
      static_cast<int32_t*>(scratch), static_cast<uint8_t*>(valid),
      static_cast<int32_t*>(bad), static_cast<int32_t*>(bad_head),
      static_cast<int32_t*>(head), static_cast<int32_t*>(tail));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* folds_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
