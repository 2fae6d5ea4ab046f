// synth_device.cu — seeded CAS/register, list-append and wide-window
// history generators, emitting batches in the prepared columnar layout, for
// Hopper (sm_90a).
//
// Replaces the TPU device programs jepsen_tpu/ops/synth_device.py::_cas_core
// (jitted by _jitted), ::_la_core and ::_wide_core. The arrays are the same,
// bit for bit: the plain PyTorch versions plain_cas_core / plain_la_core /
// plain_wide_core in jepsen_torch/ops/synth_device.py are the yardstick.
//
// What it computes. Every draw is fold_in(key, counter) =
// mix(key + (counter + 1) * GOLD), a splitmix32 finalizer in wrapping
// uint32 arithmetic, with one key per (row, stream) computed on the host.
// For the CAS family, op i of a row draws its schedule step, op kind,
// values, key and fault bits; a clipped ±1 lag walk d (over
// [0, min(i, P-1)]) and a per-key register (start -1; writes set it, a
// cas sets it iff it matches, reads observe it) run in op order; timeouts,
// crashes, drops and one corrupted read per hit row follow. The schedule
// is closed form: op i invokes at line i + j_i (j_i = i - d_i) and
// completes at comp_line(i) = 2i + 1 + #{l in 1..P-1 : d_{i+l} >= l}, and
// each line t of the [0, 2n) grid finds its op by counting completions in
// a P/2-wide window, the reference's _line_decode formula exactly.
//
// Design: right and simple first.
//   * cas_ops_kernel: one thread per history row walks its n ops in order
//     (the scan is sequential in the op index), writes each op's packed
//     payload (kind+1 | drop<<24 | crash<<25 | info<<26 | key<<27) and lag
//     to per-op scratch [B, n], applies the corruption pick, then walks
//     the row again to turn each lag into the op's completion line (in
//     place) and to count pending invokes for peak_w and the per-key
//     windows (two counters instead of the reference's packed cumsum).
//   * cas_lines_kernel: one thread per (row, line) decodes its line from
//     the row's completion lines and payloads, and stores type, process,
//     kind and key; neighbouring threads hold neighbouring lines, so the
//     stores coalesce.
//   * la_ops_kernel / la_lines_kernel: the list-append family in the same
//     two passes (below).
//   * wide_kernel: one thread per (row, line), elementwise.
//
// What bounds it on this card. The outputs: 7 bytes per line (int8 type,
// int16 process, int32 kind), 11 with the key column, so the north-star
// batch (10,000 rows of 2,000 lines) writes 140 MB, about 0.04 ms at
// 3.35 TB/s; the scratch adds 8 bytes per op written and read back. The
// op walk is a dependent chain of about a hundred integer instructions
// per op over 1,000 ops, run by only B threads, so at this batch size the
// row walk's latency, not the bytes, is the likely limit; its per-thread
// scratch stores are strided by n (one row per thread), which a later
// version can transpose.
//
// The list-append family (la). Op i appends a fresh element (row-unique
// ids 1, 2, ...) to one of K keys with probability 0.55, else reads one;
// every op completes ok, so the line grid has no PAD lines. An ok read
// observes its key's append count at op i (obs_len); the corruption (one
// stale read per hit row, the eligible read with the largest draw, first
// index on ties) makes it observe only the first db % len_inv elements,
// where len_inv is the key's append count at op j_i - 1, the last op
// completed before the read's invoke. la_ops_kernel: one thread per row
// walks the ops once, keeping per-key counts (in a local array up to
// kLaLocalKeys keys, past that in a [B, K] device scratch); len_inv of a
// read is its count minus the appends to its key among ops j_i..i-1, at
// most P-1 ops back, read from the row's own scratch. It writes each op's
// key and append bit, its value (element id or observed length) and its
// lag, patches the picked read at the end, then turns lags into
// completion lines as the CAS kernel does. la_lines_kernel: one thread per
// (row, line), the CAS line decode. Bound on this card: the outputs, 12
// bytes a line (int8 type and fn, int16 process, int32 key and val); the
// row walk's dependent chain is the likely limit, as for CAS.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM1 = 0x21F0AAADu;
constexpr uint32_t kM2 = 0x735A2D97u;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr int kMaxKeys = 16;

constexpr int8_t kPad = -1;
constexpr int8_t kInvoke = 0;
constexpr int8_t kOk = 1;
constexpr int8_t kInfo = 2;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x = (x ^ (x >> 16)) * kM1;
  x = (x ^ (x >> 15)) * kM2;
  return x ^ (x >> 15);
}

__device__ __forceinline__ uint32_t fold_in(uint32_t key, uint32_t data) {
  return mix(key + (data + 1u) * kGold);
}

// Payload fields.
__device__ __forceinline__ bool pay_drop(uint32_t p) { return (p >> 24) & 1u; }
__device__ __forceinline__ bool pay_crash(uint32_t p) { return (p >> 25) & 1u; }
__device__ __forceinline__ bool pay_info(uint32_t p) { return (p >> 26) & 1u; }
__device__ __forceinline__ int pay_key(uint32_t p) {
  return static_cast<int>((p >> 27) & 0xFu);
}
// ok completion: neither dropped, crashed nor timed out.
__device__ __forceinline__ bool pay_ok(uint32_t p) {
  return ((p >> 24) & 7u) == 0u;
}

// One step of the lag walk: d clipped to [0, min(i, P-1)].
__device__ __forceinline__ int walk_step(int d, uint32_t bits_s, int i,
                                         int P) {
  const int step = static_cast<int>(bits_s % 3u) - 1;
  return min(max(d + step, 0), min(i, P - 1));
}

// Op i's completion line from the row's lags (crow[i + off] for off >= 1
// must still hold lags): 2i + 1 + #{off in 1..P-1 : d_{i+off} >= off}.
__device__ __forceinline__ int comp_line_at(const int32_t* crow, int i, int n,
                                            int P) {
  int ahead = 0;
  for (int off = 1; off < P && i + off < n; ++off)
    ahead += crow[i + off] >= off ? 1 : 0;
  return 2 * i + 1 + ahead;
}

// Line t's op from the row's completion lines, and whether t is the op's
// completion line. base = clip(floor((t - P + 1) / 2), 0, n): every op
// below it surely completed before line t; count the P/2-wide window above
// it. The closed form keeps op in [0, n); the clamp only guards memory.
__device__ __forceinline__ int line_op(const int32_t* crow, int t, int n,
                                       int P, bool* is_comp) {
  const int x = t - P + 1;
  const int floor_half = x >= 0 ? x / 2 : -((1 - x) / 2);
  const int base = min(max(floor_half, 0), n);
  int n_comp = base;
  for (int off = 0; off < P / 2; ++off) {
    const int cand = base + off;
    if (cand < n && crow[cand] < t) ++n_comp;
  }
  *is_comp = n_comp < n && crow[n_comp] == t;
  return min(max(*is_comp ? n_comp : t - n_comp, 0), n - 1);
}

__global__ void cas_ops_kernel(
    const uint32_t* __restrict__ k_sched, const uint32_t* __restrict__ k_vals,
    const uint32_t* __restrict__ k_fault, const uint32_t* __restrict__ k_corr,
    const int32_t* __restrict__ crash_lo, const int32_t* __restrict__ crash_hi,
    uint32_t p_info_t, uint32_t corrupt_t, uint32_t p_crash_t, int B, int n,
    int P, int V, int K, int with_info, int with_crash, int with_corrupt,
    uint32_t* __restrict__ pay, int32_t* __restrict__ comp,
    int32_t* __restrict__ peak_w, int32_t* __restrict__ key_peak_w,
    uint8_t* __restrict__ key_present) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t ks = k_sched[b], kv = k_vals[b], kf = k_fault[b],
                 kc = k_corr[b];
  const int clo = crash_lo[b], chi = crash_hi[b];
  uint32_t* prow = pay + static_cast<size_t>(b) * n;
  int32_t* crow = comp + static_cast<size_t>(b) * n;
  const uint32_t uV = static_cast<uint32_t>(V);
  const bool corr_on = with_corrupt && V > 1;

  // Pass 1: draws, the lag walk and the register, in op order.
  int reg[kMaxKeys];
  for (int k = 0; k < kMaxKeys; ++k) reg[k] = -1;
  int d = 0;
  uint32_t best = 0u;          // corruption pick: first index of the max
  int pick = 0, pick_kind = 0;
  bool any_eligible = false;
  for (int i = 0; i < n; ++i) {
    const uint32_t ui = static_cast<uint32_t>(i);
    const uint32_t bs = fold_in(ks, ui), bv = fold_in(kv, ui);
    const int f = static_cast<int>((bv >> 2) % 3u);
    const int a = static_cast<int>((bv >> 4) % uV);
    const int b2 = static_cast<int>((bv >> 12) % uV);
    const int k = K > 1 ? static_cast<int>((bv >> 20) % static_cast<uint32_t>(K))
                        : 0;
    bool info = false, crash = false, applies = false;
    if (with_info || with_crash) {
      const uint32_t bf = fold_in(kf, ui);
      applies = (bf & 1u) == 1u;
      info = with_info && ((bf >> 2) & 0x3FFFu) < p_info_t;
      if (with_crash) {
        crash = i >= clo && i < chi && ((bf >> 16) & 0x3FFFu) < p_crash_t;
        info = info && !crash;
      }
    }
    const bool ok = !info && !crash;
    const bool is_r = f == 0, is_w = f == 1, is_c = f == 2;
    const bool eff_w = is_w && (ok || applies);
    const bool eff_c = is_c && (ok || applies);

    d = walk_step(d, bs, i, P);
    const int cur = reg[k];
    const bool match = cur == a;
    reg[k] = eff_w ? a : ((eff_c && match) ? b2 : cur);

    const int kind_inv = is_r ? (cur < 0 ? 0 : 1 + cur)
                              : (is_w ? 1 + V + a : 1 + 2 * V + a * V + b2);
    const bool drop = (is_r && !ok) || (is_c && ok && !match);
    if (corr_on && is_r && !drop) {
      any_eligible = true;
      const uint32_t m = (fold_in(kc, ui + 1u) >> 1) + 1u;
      if (m > best) {
        best = m;
        pick = i;
        pick_kind = kind_inv;
      }
    }
    prow[i] = static_cast<uint32_t>(kind_inv + 1) |
              (static_cast<uint32_t>(drop) << 24) |
              (static_cast<uint32_t>(crash) << 25) |
              (static_cast<uint32_t>(info) << 26) |
              (static_cast<uint32_t>(k) << 27);
    crow[i] = d;
  }
  if (corr_on && any_eligible) {
    const uint32_t hb = fold_in(kc, 0u);
    if ((hb >> 8) < corrupt_t) {
      const int delta = 1 + static_cast<int>((hb & 0xFFu) % (uV - 1u));
      const int newk = 1 + (pick_kind - 1 + delta) % V;   // operand >= 0
      prow[pick] = (prow[pick] & ~0xFFFFFFu) | static_cast<uint32_t>(newk + 1);
    }
  }

  // Pass 2: completion lines (in place over the lags) and pending counts.
  // Pending right after op i's invoke = real invokes <= i minus ok
  // completions of ops < j_i; j is nondecreasing, so one pointer q walks
  // the ok completions.
  const bool meta = key_peak_w != nullptr;
  int inv_k[kMaxKeys], ok_k[kMaxKeys], peak_k[kMaxKeys];
  bool seen_k[kMaxKeys];
  for (int k = 0; k < kMaxKeys; ++k) {
    inv_k[k] = ok_k[k] = 0;
    peak_k[k] = 1;
    seen_k[k] = false;
  }
  int q = 0, inv_all = 0, ok_all = 0, peak = 1;
  for (int i = 0; i < n; ++i) {
    const int di = crow[i];
    crow[i] = comp_line_at(crow, i, n, P);
    const int j = i - di;
    for (; q < j; ++q) {
      const uint32_t pq = prow[q];
      if (pay_ok(pq)) {
        ++ok_all;
        if (meta) ++ok_k[pay_key(pq)];
      }
    }
    const uint32_t pi = prow[i];
    if (!pay_drop(pi)) {
      ++inv_all;
      peak = max(peak, inv_all - ok_all);
      if (meta) {
        const int k = pay_key(pi);
        ++inv_k[k];
        peak_k[k] = max(peak_k[k], inv_k[k] - ok_k[k]);
        seen_k[k] = true;
      }
    }
  }
  peak_w[b] = peak;
  if (meta) {
    for (int k = 0; k < K; ++k) {
      key_peak_w[static_cast<size_t>(b) * K + k] = peak_k[k];
      key_present[static_cast<size_t>(b) * K + k] = seen_k[k] ? 1 : 0;
    }
  }
}

__global__ void cas_lines_kernel(const uint32_t* __restrict__ pay,
                                 const int32_t* __restrict__ comp, int B,
                                 int n, int P, int8_t* __restrict__ type,
                                 int16_t* __restrict__ proc,
                                 int32_t* __restrict__ kind,
                                 int32_t* __restrict__ key) {
  const long long N2 = 2LL * n;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * N2) return;
  const int b = static_cast<int>(idx / N2);
  const int t = static_cast<int>(idx - b * N2);
  const int32_t* crow = comp + static_cast<size_t>(b) * n;
  bool is_comp;
  const int op = line_op(crow, t, n, P, &is_comp);
  const uint32_t p = pay[static_cast<size_t>(b) * n + op];
  const bool dead = pay_drop(p) || (is_comp && pay_crash(p));
  type[idx] = dead ? kPad : (!is_comp ? kInvoke : (pay_info(p) ? kInfo : kOk));
  proc[idx] = dead ? int16_t{0} : static_cast<int16_t>(op % P);
  kind[idx] = (!dead && !is_comp)
                  ? static_cast<int32_t>(p & 0xFFFFFFu) - 1 : -1;
  if (key != nullptr) key[idx] = dead ? -1 : pay_key(p);
}

__global__ void wide_kernel(const uint32_t* __restrict__ k_vals, int B,
                            int width, int V, int invalid,
                            int8_t* __restrict__ type,
                            int16_t* __restrict__ proc,
                            int32_t* __restrict__ kind,
                            int32_t* __restrict__ peak_w) {
  const int N = width + 1, w1 = width - 1;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * N) return;
  const int b = static_cast<int>(idx / N);
  const int t = static_cast<int>(idx - static_cast<long long>(b) * N);
  type[idx] = t == N - 1 ? kOk : kInvoke;
  proc[idx] = static_cast<int16_t>(min(t, w1));
  int32_t k;
  if (t < w1) {
    k = 1 + V + static_cast<int32_t>(
                    fold_in(k_vals[b], static_cast<uint32_t>(t)) %
                    static_cast<uint32_t>(V));
  } else if (t == w1) {
    k = invalid ? 1 + 2 * V + V * V : 0;
  } else {
    k = -1;
  }
  kind[idx] = k;
  if (t == 0) peak_w[b] = width;
}

// ------------------------------------------------------------ list-append

constexpr uint32_t kLaAppendT = 9227468u;   // int(0.55 * 2^24)
constexpr uint32_t kLaDropCtr = 0xD00Du;
constexpr int kLaLocalKeys = 16;
constexpr uint32_t kLaAppendBit = 0x80000000u;

__global__ void la_ops_kernel(
    const uint32_t* __restrict__ k_sched, const uint32_t* __restrict__ k_vals,
    const uint32_t* __restrict__ k_corr, uint32_t corrupt_t, int B, int n,
    int P, int K, uint32_t* __restrict__ opk, int32_t* __restrict__ opv,
    int32_t* __restrict__ comp, int32_t* __restrict__ key_counts,
    uint8_t* __restrict__ corrupted) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t ks = k_sched[b], kv = k_vals[b], kc = k_corr[b];
  uint32_t* krow = opk + static_cast<size_t>(b) * n;
  int32_t* vrow = opv + static_cast<size_t>(b) * n;
  int32_t* crow = comp + static_cast<size_t>(b) * n;
  int local[kLaLocalKeys];
  int* cnt = K <= kLaLocalKeys ? local
                               : key_counts + static_cast<size_t>(b) * K;
  for (int k = 0; k < K; ++k) cnt[k] = 0;
  const bool corr_on = corrupt_t > 0u;

  int d = 0, elem = 0, pick = 0, pick_len = 0;
  uint32_t best = 0u;          // 0: no eligible read yet
  for (int i = 0; i < n; ++i) {
    const uint32_t ui = static_cast<uint32_t>(i);
    const uint32_t bs = fold_in(ks, ui), bv = fold_in(kv, ui);
    d = walk_step(d, bs, i, P);
    const bool app = (bv >> 8) < kLaAppendT;
    const int k = K > 1 ? static_cast<int>((bv >> 4) % static_cast<uint32_t>(K))
                        : 0;
    int v;
    if (app) {
      ++cnt[k];
      v = ++elem;
    } else {
      v = cnt[k];
      if (corr_on) {
        // The key's count at op j - 1: this read's count less the
        // appends to the key among ops j..i-1.
        int len_inv = v;
        for (int q = i - d; q < i; ++q)
          len_inv -= krow[q] == (kLaAppendBit | static_cast<uint32_t>(k));
        if (len_inv >= 1) {
          const uint32_t m = (fold_in(kc, ui + 1u) >> 1) + 1u;
          if (m > best) {
            best = m;
            pick = i;
            pick_len = len_inv;
          }
        }
      }
    }
    krow[i] = (app ? kLaAppendBit : 0u) | static_cast<uint32_t>(k);
    vrow[i] = v;
    crow[i] = d;
  }
  bool hit = false;
  if (best > 0u && (fold_in(kc, 0u) >> 8) < corrupt_t) {
    hit = true;
    vrow[pick] = static_cast<int32_t>(
        fold_in(kc, kLaDropCtr) % static_cast<uint32_t>(max(pick_len, 1)));
  }
  corrupted[b] = hit ? 1 : 0;
  for (int i = 0; i < n; ++i) crow[i] = comp_line_at(crow, i, n, P);
}

__global__ void la_lines_kernel(const uint32_t* __restrict__ opk,
                                const int32_t* __restrict__ opv,
                                const int32_t* __restrict__ comp, int B,
                                int n, int P, int8_t* __restrict__ type,
                                int16_t* __restrict__ proc,
                                int8_t* __restrict__ fn,
                                int32_t* __restrict__ key,
                                int32_t* __restrict__ val) {
  const long long N2 = 2LL * n;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * N2) return;
  const int b = static_cast<int>(idx / N2);
  const int t = static_cast<int>(idx - b * N2);
  bool is_comp;
  const int op = line_op(comp + static_cast<size_t>(b) * n, t, n, P,
                         &is_comp);
  const size_t at = static_cast<size_t>(b) * n + op;
  const uint32_t kp = opk[at];
  const bool app = (kp & kLaAppendBit) != 0u;
  type[idx] = is_comp ? kOk : kInvoke;
  proc[idx] = static_cast<int16_t>(op % P);
  fn[idx] = app ? int8_t{0} : int8_t{1};
  key[idx] = static_cast<int32_t>(kp & ~kLaAppendBit);
  val[idx] = (app || is_comp) ? opv[at] : -1;
}

inline unsigned blocks_for(long long threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" int synth_cas_launch(
    const void* k_sched, const void* k_vals, const void* k_fault,
    const void* k_corr, const void* crash_lo, const void* crash_hi,
    unsigned p_info_t, unsigned corrupt_t, unsigned p_crash_t, int B, int n,
    int P, int V, int K, int with_info, int with_crash, int with_corrupt,
    void* pay, void* comp, void* peak_w, void* key_peak_w, void* key_present,
    void* type, void* proc, void* kind, void* key, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Small blocks for the row walk: B threads in all, spread over the SMs.
  constexpr int kRowThreads = 64;
  cas_ops_kernel<<<blocks_for(B, kRowThreads), kRowThreads, 0, s>>>(
      static_cast<const uint32_t*>(k_sched),
      static_cast<const uint32_t*>(k_vals),
      static_cast<const uint32_t*>(k_fault),
      static_cast<const uint32_t*>(k_corr),
      static_cast<const int32_t*>(crash_lo),
      static_cast<const int32_t*>(crash_hi), p_info_t, corrupt_t, p_crash_t,
      B, n, P, V, K, with_info, with_crash, with_corrupt,
      static_cast<uint32_t*>(pay), static_cast<int32_t*>(comp),
      static_cast<int32_t*>(peak_w), static_cast<int32_t*>(key_peak_w),
      static_cast<uint8_t*>(key_present));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int kLineThreads = 256;
  cas_lines_kernel<<<blocks_for(2LL * n * B, kLineThreads), kLineThreads, 0,
                     s>>>(
      static_cast<const uint32_t*>(pay), static_cast<const int32_t*>(comp), B,
      n, P, static_cast<int8_t*>(type), static_cast<int16_t*>(proc),
      static_cast<int32_t*>(kind), static_cast<int32_t*>(key));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int synth_la_launch(const void* k_sched, const void* k_vals,
                               const void* k_corr, unsigned corrupt_t, int B,
                               int n, int P, int K, void* opk, void* opv,
                               void* comp, void* key_counts, void* type,
                               void* proc, void* fn, void* key, void* val,
                               void* corrupted, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kRowThreads = 64;
  la_ops_kernel<<<blocks_for(B, kRowThreads), kRowThreads, 0, s>>>(
      static_cast<const uint32_t*>(k_sched),
      static_cast<const uint32_t*>(k_vals),
      static_cast<const uint32_t*>(k_corr), corrupt_t, B, n, P, K,
      static_cast<uint32_t*>(opk), static_cast<int32_t*>(opv),
      static_cast<int32_t*>(comp), static_cast<int32_t*>(key_counts),
      static_cast<uint8_t*>(corrupted));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int kLineThreads = 256;
  la_lines_kernel<<<blocks_for(2LL * n * B, kLineThreads), kLineThreads, 0,
                    s>>>(
      static_cast<const uint32_t*>(opk), static_cast<const int32_t*>(opv),
      static_cast<const int32_t*>(comp), B, n, P, static_cast<int8_t*>(type),
      static_cast<int16_t*>(proc), static_cast<int8_t*>(fn),
      static_cast<int32_t*>(key), static_cast<int32_t*>(val));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int synth_wide_launch(const void* k_vals, int B, int width, int V,
                                 int invalid, void* type, void* proc,
                                 void* kind, void* peak_w, void* stream) {
  constexpr int kThreads = 256;
  wide_kernel<<<blocks_for(static_cast<long long>(width + 1) * B, kThreads),
                kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k_vals), B, width, V, invalid,
      static_cast<int8_t*>(type), static_cast<int16_t*>(proc),
      static_cast<int32_t*>(kind), static_cast<int32_t*>(peak_w));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* synth_device_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
