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
// is closed form: op i invokes at line i + j_i (j_i = i - d_i, which never
// decreases) and completes at line i + #{m : j_m <= i}; so the completions
// that fall between the invokes of ops m - 1 and m are those of the ops in
// [j_{m-1}, j_m) (at most two), op q of them at line q + m, and the ops in
// [j_{n-1}, n) complete after the last invoke, op q at line q + n.
//
// Design: one warp a history row, walking its ops in tiles of 32, lane l
// holding op 32t + l (cas_rows_kernel, la_rows_kernel; four rows a block).
//   * Draws across lanes: every draw is counter-based, so each lane draws
//     its own op's schedule step, kind, values, key, fault bits and
//     corruption score.
//   * The lag walk as a scan: a step d -> min(max(d + s, 0), c) is a
//     clamp-add map (a, lo, hi), and such maps compose into the same form,
//     so a five-step shuffle scan gives every lane its d from the tile's
//     incoming d.
//   * The register by rounds: lanes of one key form a chain (grouped by
//     __match_any_sync); a write, or a key's first op in the tile (which
//     reads the key's register from shared memory), is a root whose value
//     is known, and each round every other lane applies its op to the
//     value of the key's previous lane. Rounds = the longest run of
//     non-roots in the tile (about seven for one key).
//   * Counts by ballots: live invokes, ok completions, element ids and
//     per-key counts are prefix popcounts of ballots (masked by the key's
//     group) over running totals. The ok completions of ops < j_i are
//     those stored by lanes <= i (below); a per-key count at j_i, at most
//     P - 1 ops back (cas's per-key windows, la's len_inv), is the count
//     at i less a walk over ops [j_i, i) of a per-warp ring of op words.
//   * Lines straight from ops: lane m puts its op's invoke line and the
//     completions of ops [j_{m-1}, j_m), read from the ring; the warp puts
//     the last completions after the walk. No [B, n] scratch, no second
//     launch. The lines go to a per-warp shared buffer (the last
//     pow2 >= min(P, n) + 67 lines) and, after each tile, the lines below
//     the next op's invoke block (all stored by then) are flushed in line
//     order, four lines a lane when n is even, so a warp's stores cover
//     consecutive lines: stored one by one, the lines' bytes scatter over
//     partial sectors. The
//     corruption's pick (the largest score, first index on ties) is a
//     warp max-reduce carried across tiles, taken only in tiles that
//     beat it; its line is patched with one store after the walk.
//   * The ring (one word an op for cas, two for la, the last
//     pow2 >= min(P, n) + 32 ops), la's per-key counts and the line
//     buffer live in shared memory, 12 KB a warp at most (four warps a
//     block, 48 KB); past that the wrapper passes a device scratch row per
//     warp for the ring or the counts, and lines are stored straight to
//     the outputs (cuda_synth.synth_plan).
//   * wide_kernel: one warp a row, lanes over its lines; `% V` by Lemire's
//     multiply, no divide. The wide path's 256 rows of 18 lines write
//     34 KB: its bound is a few nanoseconds, and its time on the card is
//     an empty kernel's on the same grid, the launch floor (PERF.md).
//
// What bounds it on this card. The outputs: 7 bytes per line (int8 type,
// int16 process, int32 kind), 11 with the key column, so the north-star
// batch (10,000 rows of 2,000 lines) writes 140 MB, about 0.042 ms at
// 3.35 TB/s. But a tile costs several hundred warp instructions (draws
// and remainders, the scan, the register rounds, ballots, puts and the
// flush), spread over every stage, and instruction issue is the limit
// (PERF.md: the time grows with the rows, not with the bytes).
//
// The list-append family (la). Op i appends a fresh element (row-unique
// ids 1, 2, ...) to one of K keys with probability 0.55, else reads one;
// every op completes ok, so the line grid has no PAD lines. An ok read
// observes its key's append count at op i (obs_len); the corruption (one
// stale read per hit row, the eligible read with the largest draw, first
// index on ties) makes it observe only the first db % len_inv elements,
// where len_inv is the key's append count at op j_i - 1, the last op
// completed before the read's invoke. Bound on this card: the outputs, 12
// bytes a line (int8 type and fn, int16 process, int32 key and val).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM1 = 0x21F0AAADu;
constexpr uint32_t kM2 = 0x735A2D97u;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxKeys = 16;
// Warps (history rows) a block.
constexpr int kRowWarps = 4;
// Per-warp shared words of the cas kernel before its ring: the registers,
// live invokes, ok completions and peak window of each key.
constexpr int kCasKeyWords = 4 * kMaxKeys;
// A clamp bound that no lag reaches.
constexpr int kBig = 1 << 29;

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

// x % d for any uint32 x by Lemire's multiply (m = 2^64 / d rounded up,
// 0 for d = 1), from the host's make_fastmod.
struct FastMod {
  unsigned long long m;
  uint32_t d;
};

__device__ __forceinline__ uint32_t fmod32(uint32_t x, FastMod f) {
  return static_cast<uint32_t>(__umul64hi(f.m * x, f.d));
}

// The clamp-add map x -> min(max(x + a, lo), hi).
struct Clamp {
  int a, lo, hi;
};

// g2 after g1: min(max(min(max(x + a1, lo1), hi1) + a2, lo2), hi2), in the
// same form (lattice identities, whatever the order of lo and hi).
__device__ __forceinline__ Clamp clamp_then(Clamp g1, Clamp g2) {
  return {g1.a + g2.a, max(g1.lo + g2.a, g2.lo),
          min(max(g1.hi + g2.a, g2.lo), g2.hi)};
}

// The lag walk over one tile: lane l's op takes step s (its clamp is
// [0, min(i, P-1)]); returns its d from the tile's incoming d_in. Lanes
// past the row's end carry the identity.
__device__ __forceinline__ int lag_scan(int s, int i, bool act, int P,
                                        int d_in, int lane) {
  Clamp g = act ? Clamp{s, 0, min(i, P - 1)} : Clamp{0, -kBig, kBig};
  for (int o = 1; o < 32; o <<= 1) {
    const Clamp e{__shfl_up_sync(kFull, g.a, o),
                  __shfl_up_sync(kFull, g.lo, o),
                  __shfl_up_sync(kFull, g.hi, o)};
    if (lane >= o) g = clamp_then(e, g);
  }
  return min(max(d_in + g.a, g.lo), g.hi);
}

// Ring word of a cas op: process (15 bits), completion dead (dropped or
// crashed), timed out, ok completion, key.
__device__ __forceinline__ uint32_t cas_word(int proc, bool dead, bool info,
                                             bool okc, int k) {
  return static_cast<uint32_t>(proc) | (static_cast<uint32_t>(dead) << 15) |
         (static_cast<uint32_t>(info) << 16) |
         (static_cast<uint32_t>(okc) << 17) |
         (static_cast<uint32_t>(k) << 20);
}

// Four consecutive lines of a column in one vector move (the addresses
// aligned to four elements).
__device__ __forceinline__ void move4(int8_t* to, const int8_t* from) {
  *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(from);
}
__device__ __forceinline__ void move4(int16_t* to, const int16_t* from) {
  *reinterpret_cast<uint2*>(to) = *reinterpret_cast<const uint2*>(from);
}
__device__ __forceinline__ void move4(int32_t* to, const int32_t* from) {
  *reinterpret_cast<int4*>(to) = *reinterpret_cast<const int4*>(from);
}

// A row's cas line columns (row offset applied): stored straight to the
// outputs, or (kStage) into the warp's shared buffer at slot line & mask
// and flushed to the outputs in line order, so that each warp store
// covers consecutive lines. With n even (vec) every row's columns start
// on a 16-byte boundary, flushes stop at multiples of four lines, and a
// lane moves four lines in vector loads and stores.
template <bool kStage>
struct CasLines {
  int8_t* type;
  int16_t* proc;
  int32_t* kind;
  int32_t* key;   // null when unkeyed
  int8_t* s_type;
  int16_t* s_proc;
  int32_t* s_kind;
  int32_t* s_key;
  int mask;
  bool vec;

  // Where a flush up to line l (every line below it stored) may stop.
  __device__ __forceinline__ int flush_end(int l) const {
    return vec ? l & ~3 : l;
  }

  __device__ __forceinline__ void put(int line, int8_t t, int16_t p,
                                      int32_t k, int32_t ky) const {
    if (kStage) {
      const int s = line & mask;
      s_type[s] = t;
      s_proc[s] = p;
      s_kind[s] = k;
      if (key != nullptr) s_key[s] = ky;
    } else {
      type[line] = t;
      proc[line] = p;
      kind[line] = k;
      if (key != nullptr) key[line] = ky;
    }
  }

  // The completion of the op with ring word w.
  __device__ __forceinline__ void completion(int line, uint32_t w) const {
    const bool dead = (w >> 15) & 1u;
    put(line, dead ? kPad : (((w >> 16) & 1u) ? kInfo : kOk),
        dead ? int16_t{0} : static_cast<int16_t>(w & 0x7FFFu), -1,
        dead ? -1 : static_cast<int32_t>((w >> 20) & 0xFu));
  }

  // Lines [lo, hi), complete, to the outputs.
  __device__ __forceinline__ void flush(int lo, int hi, int lane) const {
    if (!kStage) return;
    if (vec) {
      for (int l = lo + 4 * lane; l < hi; l += 128) {
        const int s = l & mask;
        move4(type + l, s_type + s);
        move4(proc + l, s_proc + s);
        move4(kind + l, s_kind + s);
        if (key != nullptr) move4(key + l, s_key + s);
      }
      return;
    }
    for (int l = lo + lane; l < hi; l += 32) {
      const int s = l & mask;
      type[l] = s_type[s];
      proc[l] = s_proc[s];
      kind[l] = s_kind[s];
      if (key != nullptr) key[l] = s_key[s];
    }
  }
};

template <bool kStage>
__global__ void __launch_bounds__(32 * kRowWarps) cas_rows_kernel(
    const uint32_t* __restrict__ k_sched, const uint32_t* __restrict__ k_vals,
    const uint32_t* __restrict__ k_fault, const uint32_t* __restrict__ k_corr,
    const int32_t* __restrict__ crash_lo, const int32_t* __restrict__ crash_hi,
    uint32_t p_info_t, uint32_t corrupt_t, uint32_t p_crash_t, int B, int n,
    int P, int V, int K, FastMod mod_p, FastMod mod_v, FastMod mod_k,
    int with_info, int with_crash, int with_corrupt, int ring,
    uint32_t* __restrict__ ring_scratch, int lines,
    int32_t* __restrict__ peak_w, int32_t* __restrict__ key_peak_w,
    uint8_t* __restrict__ key_present, int8_t* __restrict__ type,
    int16_t* __restrict__ proc, int32_t* __restrict__ kind,
    int32_t* __restrict__ key) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowWarps + warp;
  if (b >= B) return;
  const int ring_words = ring_scratch != nullptr ? 0 : ring;
  const int line_words =
      kStage ? lines * (4 + (key != nullptr ? 4 : 0) + 2 + 1) / 4 : 0;
  uint32_t* mine = smem + warp * (kCasKeyWords + ring_words + line_words);
  int* regs = reinterpret_cast<int*>(mine);
  int* inv_k = regs + kMaxKeys;
  int* ok_k = regs + 2 * kMaxKeys;
  int* peak_k = regs + 3 * kMaxKeys;
  uint32_t* rw = ring_scratch != nullptr
                     ? ring_scratch + static_cast<size_t>(b) * ring
                     : mine + kCasKeyWords;
  const int rmask = ring - 1;
  const size_t row = static_cast<size_t>(b) * 2 * n;
  CasLines<kStage> out;
  out.type = type + row;
  out.proc = proc + row;
  out.kind = kind + row;
  out.key = key != nullptr ? key + row : nullptr;
  {
    uint32_t* buf = mine + kCasKeyWords + ring_words;
    out.s_kind = reinterpret_cast<int32_t*>(buf);
    out.s_key = out.s_kind + (key != nullptr ? lines : 0);
    out.s_proc = reinterpret_cast<int16_t*>(out.s_key + lines);
    out.s_type = reinterpret_cast<int8_t*>(out.s_proc + lines);
    out.mask = lines - 1;
    out.vec = (n & 1) == 0;
  }
  if (lane < kMaxKeys) {
    regs[lane] = -1;
    inv_k[lane] = ok_k[lane] = 0;
    peak_k[lane] = 1;
  }
  __syncwarp();

  const uint32_t ks = k_sched[b], kv = k_vals[b], kf = k_fault[b],
                 kc = k_corr[b];
  const int clo = crash_lo[b], chi = crash_hi[b];
  const bool corr_on = with_corrupt && V > 1;
  const bool meta = key_peak_w != nullptr;
  const uint32_t lt = (1u << lane) - 1u, le = lt | (1u << lane);

  // Carried across tiles: the lag and j of the last op, the lines below
  // l_done (all stored), live invokes, ok completions stored, the peak
  // window, and the corruption's pick (the largest score so far).
  int d_in = 0, j_last = 0, l_done = 0, live_tot = 0, okw_tot = 0, peak = 1;
  uint32_t best = 0u;
  int pick_line = 0, pick_kind = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int i = t0 + lane;
    const bool act = i < n;
    const int last = min(31, n - 1 - t0);
    const uint32_t ui = static_cast<uint32_t>(i);
    const uint32_t bs = fold_in(ks, ui), bv = fold_in(kv, ui);
    const int f = static_cast<int>((bv >> 2) % 3u);
    const int a = static_cast<int>(fmod32(bv >> 4, mod_v));
    const int b2 = static_cast<int>(fmod32(bv >> 12, mod_v));
    const int k = K > 1 ? static_cast<int>(fmod32(bv >> 20, mod_k)) : 0;
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

    // The lag walk; j of the previous op (the previous tile's last for
    // lane 0).
    const int d = lag_scan(static_cast<int>(bs % 3u) - 1, i, act, P, d_in,
                           lane);
    const int j = i - d;
    int j_prev = __shfl_up_sync(kFull, j, 1);
    if (lane == 0) j_prev = j_last;
    d_in = __shfl_sync(kFull, d, last);
    j_last = __shfl_sync(kFull, j, last);

    // The register: a chain per key through the tile. Lanes past the end
    // are singleton groups.
    const unsigned act_mask = __ballot_sync(kFull, act);
    const unsigned grp =
        K > 1 ? __match_any_sync(kFull, act ? k : kMaxKeys + lane)
              : (act ? act_mask : (1u << lane));
    const int prev = 31 - __clz(grp & lt);   // -1: the key's first op here
    const int init = act ? regs[k] : -1;
    const bool root = !act || eff_w || prev < 0;
    int v = eff_w ? a : ((eff_c && init == a) ? b2 : init);
    const unsigned roots = __ballot_sync(kFull, root);
    const int last_root = 31 - __clz(roots & grp & le);
    const int depth = __popc(grp & le & ~((2u << last_root) - 1u));
    const int src = prev < 0 ? lane : prev;
    const int rounds = __reduce_max_sync(kFull, depth);
    for (int r = 0; r < rounds; ++r) {
      const int y = __shfl_sync(kFull, v, src);
      if (!root) v = (eff_c && y == a) ? b2 : y;
    }
    const int from_prev = __shfl_sync(kFull, v, src);
    const int cur = prev < 0 ? init : from_prev;
    __syncwarp();
    if (act && (grp & ~le) == 0u) regs[k] = v;   // the key's last op here

    const bool match = cur == a;
    const int kind_inv = is_r ? (cur < 0 ? 0 : 1 + cur)
                              : (is_w ? 1 + V + a : 1 + 2 * V + a * V + b2);
    const bool drop = (is_r && !ok) || (is_c && ok && !match);
    const bool live = act && !drop;
    const bool okc = live && ok;
    const int pr = static_cast<int>(fmod32(ui, mod_p));
    if (act) rw[i & rmask] = cas_word(pr, drop || crash, info, okc, k);
    __syncwarp();

    // Lines: this op's invoke, then the completions that precede it,
    // counting the ok ones.
    int okw = 0;
    if (act) {
      out.put(i + j, drop ? kPad : kInvoke,
              drop ? int16_t{0} : static_cast<int16_t>(pr),
              drop ? -1 : kind_inv, drop ? -1 : k);
      for (int q = j_prev; q < j; ++q) {
        const uint32_t w = rw[q & rmask];
        out.completion(q + i, w);
        okw += static_cast<int>((w >> 17) & 1u);
      }
    }

    // Pending right after op i's invoke: live invokes <= i less ok
    // completions of ops < j_i, which are those stored by lanes <= i (at
    // most two a lane).
    const unsigned live_m = __ballot_sync(kFull, live);
    const unsigned ok1 = __ballot_sync(kFull, okw >= 1);
    const unsigned ok2 = __ballot_sync(kFull, okw >= 2);
    const int pend = live_tot + __popc(live_m & le) -
                     (okw_tot + __popc(ok1 & le) + __popc(ok2 & le));
    peak = max(peak, __reduce_max_sync(kFull, live ? pend : 0));
    live_tot += __popc(live_m);
    okw_tot += __popc(ok1) + __popc(ok2);
    if (meta) {
      // Per key: ok ops of the key < i, less those in [j_i, i) from the
      // ring.
      const unsigned ok_m = __ballot_sync(kFull, okc);
      int c_key = 0;
      if (live) {
        for (int q = j; q < i; ++q) {
          const uint32_t w = rw[q & rmask];
          c_key += static_cast<int>(((w >> 17) & 1u) &&
                                    ((w >> 20) & 0xFu) ==
                                        static_cast<uint32_t>(k));
        }
      }
      const int pend_k = (act ? inv_k[k] : 0) + __popc(grp & live_m & le) -
                         ((act ? ok_k[k] : 0) + __popc(grp & ok_m & lt) -
                          c_key);
      const int mk = __reduce_max_sync(grp, live ? pend_k : 0);
      __syncwarp();
      if (act && (grp & lt) == 0u) {   // the key's first op here
        peak_k[k] = max(peak_k[k], mk);
        inv_k[k] += __popc(grp & live_m);
        ok_k[k] += __popc(grp & ok_m);
      }
    }

    if (corr_on) {
      const bool elig = act && is_r && !drop;
      const uint32_t m = elig ? (fold_in(kc, ui + 1u) >> 1) + 1u : 0u;
      if (__any_sync(kFull, m > best)) {
        const uint32_t mx = __reduce_max_sync(kFull, m);
        const int first = __ffs(__ballot_sync(kFull, m == mx)) - 1;
        best = mx;
        pick_kind = __shfl_sync(kFull, kind_inv, first);
        pick_line = __shfl_sync(kFull, i + j, first);
      }
    }

    // Every line below the next op's invoke block is now stored.
    __syncwarp();
    const int l_new = out.flush_end(t0 + last + 1 + j_last);
    out.flush(l_done, l_new, lane);
    l_done = l_new;
    __syncwarp();
  }
  // The completions after the last invoke.
  for (int q = j_last + lane; q < n; q += 32)
    out.completion(q + n, rw[q & rmask]);
  __syncwarp();
  out.flush(l_done, 2 * n, lane);
  __syncwarp();
  if (lane == 0) {
    if (corr_on && best > 0u) {
      const uint32_t hb = fold_in(kc, 0u);
      if ((hb >> 8) < corrupt_t) {
        const int delta = 1 + static_cast<int>((hb & 0xFFu) %
                                               static_cast<uint32_t>(V - 1));
        out.kind[pick_line] = 1 + (pick_kind - 1 + delta) % V;
      }
    }
    peak_w[b] = peak;
  }
  if (meta && lane < K) {
    key_peak_w[static_cast<size_t>(b) * K + lane] = peak_k[lane];
    key_present[static_cast<size_t>(b) * K + lane] = inv_k[lane] > 0 ? 1 : 0;
  }
}

// The wide family: one warp a row, kWideWarps rows a block; lane l writes
// lines l, l + 32, ... of its row (widths past 32 loop), so a warp's
// stores of a column cover consecutive bytes. Line t < width - 1 is a
// crashed write of a seeded value (each lane's draw is its own line's),
// line width - 1 the read that completes at line width; peak_w by lane 0.
constexpr int kWideWarps = 8;

__global__ void __launch_bounds__(32 * kWideWarps)
    wide_kernel(const uint32_t* __restrict__ k_vals, int B, int width,
                FastMod fv, int32_t read_kind, int8_t* __restrict__ type,
                int16_t* __restrict__ proc, int32_t* __restrict__ kind,
                int32_t* __restrict__ peak_w) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWideWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const int N = width + 1, w1 = width - 1;
  const int32_t write0 = 1 + static_cast<int32_t>(fv.d);
  const uint32_t key = k_vals[b];
  const size_t off = static_cast<size_t>(b) * N;
  for (int t = lane; t < N; t += 32) {
    type[off + t] = t == N - 1 ? kOk : kInvoke;
    proc[off + t] = static_cast<int16_t>(min(t, w1));
    kind[off + t] =
        t < w1 ? write0 + static_cast<int32_t>(fmod32(
                              fold_in(key, static_cast<uint32_t>(t)), fv))
               : (t == w1 ? read_kind : -1);
  }
  if (lane == 0) peak_w[b] = width;
}

// ------------------------------------------------------------ list-append

constexpr uint32_t kLaAppendT = 9227468u;   // int(0.55 * 2^24)
constexpr uint32_t kLaDropCtr = 0xD00Du;
constexpr uint32_t kLaAppendBit = 0x80000000u;

// A row's la line columns, as CasLines.
template <bool kStage>
struct LaLines {
  int8_t* type;
  int16_t* proc;
  int8_t* fn;
  int32_t* key;
  int32_t* val;
  int8_t* s_type;
  int16_t* s_proc;
  int8_t* s_fn;
  int32_t* s_key;
  int32_t* s_val;
  int mask;
  bool vec;

  __device__ __forceinline__ int flush_end(int l) const {
    return vec ? l & ~3 : l;
  }

  __device__ __forceinline__ void put(int line, int8_t t, int16_t p,
                                      int8_t f, int32_t k, int32_t v) const {
    if (kStage) {
      const int s = line & mask;
      s_type[s] = t;
      s_proc[s] = p;
      s_fn[s] = f;
      s_key[s] = k;
      s_val[s] = v;
    } else {
      type[line] = t;
      proc[line] = p;
      fn[line] = f;
      key[line] = k;
      val[line] = v;
    }
  }

  __device__ __forceinline__ void flush(int lo, int hi, int lane) const {
    if (!kStage) return;
    if (vec) {
      for (int l = lo + 4 * lane; l < hi; l += 128) {
        const int s = l & mask;
        move4(type + l, s_type + s);
        move4(proc + l, s_proc + s);
        move4(fn + l, s_fn + s);
        move4(key + l, s_key + s);
        move4(val + l, s_val + s);
      }
      return;
    }
    for (int l = lo + lane; l < hi; l += 32) {
      const int s = l & mask;
      type[l] = s_type[s];
      proc[l] = s_proc[s];
      fn[l] = s_fn[s];
      key[l] = s_key[s];
      val[l] = s_val[s];
    }
  }
};

// The completion of op q, from its ring words (key with the append bit,
// value).
template <bool kStage>
__device__ __forceinline__ void la_completion(const LaLines<kStage>& out,
                                              int line, int q, uint32_t w,
                                              int32_t v, FastMod mod_p) {
  out.put(line, kOk,
          static_cast<int16_t>(fmod32(static_cast<uint32_t>(q), mod_p)),
          (w & kLaAppendBit) != 0u ? int8_t{0} : int8_t{1},
          static_cast<int32_t>(w & ~kLaAppendBit), v);
}

// The la row walk. The ring holds two words an op: its key with the
// append bit, and its value (element id or observed length); the per-key
// append counts are K words. Either lives in shared memory or, when the
// wrapper passes a scratch, in a device row of the warp's own.
template <bool kStage>
__global__ void __launch_bounds__(32 * kRowWarps) la_rows_kernel(
    const uint32_t* __restrict__ k_sched, const uint32_t* __restrict__ k_vals,
    const uint32_t* __restrict__ k_corr, uint32_t corrupt_t, int B, int n,
    int P, int K, FastMod mod_p, FastMod mod_k, int ring,
    uint32_t* __restrict__ ring_scratch, int32_t* __restrict__ count_scratch,
    int lines, int8_t* __restrict__ type, int16_t* __restrict__ proc,
    int8_t* __restrict__ fn, int32_t* __restrict__ key,
    int32_t* __restrict__ val, uint8_t* __restrict__ corrupted) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowWarps + warp;
  if (b >= B) return;
  const int ring_words = ring_scratch != nullptr ? 0 : 2 * ring;
  const int count_words = count_scratch != nullptr ? 0 : (K + 3) & ~3;
  const int line_words = kStage ? 3 * lines : 0;
  uint32_t* mine = smem + warp * (ring_words + count_words + line_words);
  uint32_t* rk = ring_scratch != nullptr
                     ? ring_scratch + static_cast<size_t>(b) * 2 * ring
                     : mine;
  int32_t* rv = reinterpret_cast<int32_t*>(rk + ring);
  int32_t* cnt = count_scratch != nullptr
                     ? count_scratch + static_cast<size_t>(b) * K
                     : reinterpret_cast<int32_t*>(mine + ring_words);
  const int rmask = ring - 1;
  const size_t row = static_cast<size_t>(b) * 2 * n;
  LaLines<kStage> out;
  out.type = type + row;
  out.proc = proc + row;
  out.fn = fn + row;
  out.key = key + row;
  out.val = val + row;
  {
    uint32_t* buf = mine + ring_words + count_words;
    out.s_key = reinterpret_cast<int32_t*>(buf);
    out.s_val = out.s_key + lines;
    out.s_proc = reinterpret_cast<int16_t*>(out.s_val + lines);
    out.s_type = reinterpret_cast<int8_t*>(out.s_proc + lines);
    out.s_fn = out.s_type + lines;
    out.mask = lines - 1;
    out.vec = (n & 1) == 0;
  }
  for (int kk = lane; kk < K; kk += 32) cnt[kk] = 0;
  __syncwarp();

  const uint32_t ks = k_sched[b], kv = k_vals[b], kc = k_corr[b];
  const bool corr_on = corrupt_t > 0u;
  const uint32_t lt = (1u << lane) - 1u, le = lt | (1u << lane);

  int d_in = 0, j_last = 0, l_done = 0, elem_tot = 0;
  uint32_t best = 0u;          // 0: no eligible read yet
  int pick = -1, pick_len = 0, pick_line = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int i = t0 + lane;
    const bool act = i < n;
    const int last = min(31, n - 1 - t0);
    const uint32_t ui = static_cast<uint32_t>(i);
    const uint32_t bs = fold_in(ks, ui), bv = fold_in(kv, ui);
    const bool app = (bv >> 8) < kLaAppendT;
    const int k = K > 1 ? static_cast<int>(fmod32(bv >> 4, mod_k)) : 0;

    const int d = lag_scan(static_cast<int>(bs % 3u) - 1, i, act, P, d_in,
                           lane);
    const int j = i - d;
    int j_prev = __shfl_up_sync(kFull, j, 1);
    if (lane == 0) j_prev = j_last;
    d_in = __shfl_sync(kFull, d, last);
    j_last = __shfl_sync(kFull, j, last);

    // Element ids and per-key append counts by ballots over running
    // totals; a read's count is the appends to its key up to it.
    const unsigned act_mask = __ballot_sync(kFull, act);
    const unsigned app_m = __ballot_sync(kFull, act && app);
    const unsigned grp = K > 1 ? __match_any_sync(kFull, act ? k : -1 - lane)
                               : (act ? act_mask : (1u << lane));
    const int base = act ? cnt[k] : 0;
    const int elem = elem_tot + __popc(app_m & le);
    const int v = app ? elem : base + __popc(grp & app_m & le);
    __syncwarp();
    if (act && (grp & lt) == 0u) cnt[k] = base + __popc(grp & app_m);
    elem_tot += __popc(app_m);
    const uint32_t w = (app ? kLaAppendBit : 0u) | static_cast<uint32_t>(k);
    if (act) {
      rk[i & rmask] = w;
      rv[i & rmask] = v;
    }
    __syncwarp();

    if (corr_on) {
      // The key's count at op j - 1: this read's count less the appends
      // to the key among ops j..i-1.
      int len_inv = 0;
      if (act && !app) {
        const uint32_t appended = w | kLaAppendBit;   // an append to k
        len_inv = v;
        for (int q = j; q < i; ++q) len_inv -= rk[q & rmask] == appended;
      }
      const uint32_t m = (act && !app && len_inv >= 1)
                             ? (fold_in(kc, ui + 1u) >> 1) + 1u : 0u;
      if (__any_sync(kFull, m > best)) {
        const uint32_t mx = __reduce_max_sync(kFull, m);
        const int first = __ffs(__ballot_sync(kFull, m == mx)) - 1;
        best = mx;
        pick = t0 + first;
        pick_len = __shfl_sync(kFull, len_inv, first);
      }
    }

    // Lines: this op's invoke, then the completions that precede it; the
    // pick's completion line is noted when it is stored.
    int at_pick = -1;
    if (act) {
      out.put(i + j, kInvoke, static_cast<int16_t>(fmod32(ui, mod_p)),
              app ? int8_t{0} : int8_t{1}, k, app ? elem : -1);
      for (int q = j_prev; q < j; ++q) {
        la_completion(out, q + i, q, rk[q & rmask], rv[q & rmask], mod_p);
        if (q == pick) at_pick = q + i;
      }
    }
    const unsigned got = __ballot_sync(kFull, at_pick >= 0);
    if (got) pick_line = __shfl_sync(kFull, at_pick, __ffs(got) - 1);
    __syncwarp();
    const int l_new = out.flush_end(t0 + last + 1 + j_last);
    out.flush(l_done, l_new, lane);
    l_done = l_new;
    __syncwarp();
  }
  for (int q0 = j_last; q0 < n; q0 += 32) {
    const int q = q0 + lane;
    int at_pick = -1;
    if (q < n) {
      la_completion(out, q + n, q, rk[q & rmask], rv[q & rmask], mod_p);
      if (q == pick) at_pick = q + n;
    }
    const unsigned got = __ballot_sync(kFull, at_pick >= 0);
    if (got) pick_line = __shfl_sync(kFull, at_pick, __ffs(got) - 1);
  }
  __syncwarp();
  out.flush(l_done, 2 * n, lane);
  __syncwarp();
  if (lane == 0) {
    const bool hit = best > 0u && (fold_in(kc, 0u) >> 8) < corrupt_t;
    if (hit)
      out.val[pick_line] = static_cast<int32_t>(
          fold_in(kc, kLaDropCtr) % static_cast<uint32_t>(max(pick_len, 1)));
    corrupted[b] = hit ? 1 : 0;
  }
}

inline unsigned blocks_for(long long threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

FastMod make_fastmod(int d) {
  const uint32_t u = static_cast<uint32_t>(d);
  return {~0ull / u + 1ull, u};
}

}  // namespace

// ring: the ring's length in ops (a power of two); ring_scratch: null for
// the ring in shared memory, else a [B, ring] int32 device scratch;
// lines: the staged line buffer's length (a power of two), 0 to store
// lines straight to the outputs.
extern "C" int synth_cas_launch(
    const void* k_sched, const void* k_vals, const void* k_fault,
    const void* k_corr, const void* crash_lo, const void* crash_hi,
    unsigned p_info_t, unsigned corrupt_t, unsigned p_crash_t, int B, int n,
    int P, int V, int K, int with_info, int with_crash, int with_corrupt,
    int ring, void* ring_scratch, int lines, void* peak_w, void* key_peak_w,
    void* key_present, void* type, void* proc, void* kind, void* key,
    void* stream) {
  const size_t words =
      kCasKeyWords + (ring_scratch != nullptr ? 0 : ring) +
      static_cast<size_t>(lines) * (4 + (key != nullptr ? 4 : 0) + 2 + 1) / 4;
  auto kernel = lines > 0 ? cas_rows_kernel<true> : cas_rows_kernel<false>;
  kernel<<<blocks_for(B, kRowWarps), 32 * kRowWarps,
           sizeof(uint32_t) * kRowWarps * words,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k_sched),
      static_cast<const uint32_t*>(k_vals),
      static_cast<const uint32_t*>(k_fault),
      static_cast<const uint32_t*>(k_corr),
      static_cast<const int32_t*>(crash_lo),
      static_cast<const int32_t*>(crash_hi), p_info_t, corrupt_t, p_crash_t,
      B, n, P, V, K, make_fastmod(P), make_fastmod(V), make_fastmod(K),
      with_info, with_crash, with_corrupt, ring,
      static_cast<uint32_t*>(ring_scratch), lines,
      static_cast<int32_t*>(peak_w), static_cast<int32_t*>(key_peak_w),
      static_cast<uint8_t*>(key_present), static_cast<int8_t*>(type),
      static_cast<int16_t*>(proc), static_cast<int32_t*>(kind),
      static_cast<int32_t*>(key));
  return static_cast<int>(cudaGetLastError());
}

// ring_scratch: null for the ring in shared memory, else [B, 2 * ring];
// count_scratch: null for the counts in shared memory, else [B, K];
// lines as for synth_cas_launch.
extern "C" int synth_la_launch(const void* k_sched, const void* k_vals,
                               const void* k_corr, unsigned corrupt_t, int B,
                               int n, int P, int K, int ring,
                               void* ring_scratch, void* count_scratch,
                               int lines, void* type, void* proc, void* fn,
                               void* key, void* val, void* corrupted,
                               void* stream) {
  const size_t words =
      (ring_scratch != nullptr ? 0 : 2 * static_cast<size_t>(ring)) +
      (count_scratch != nullptr ? 0 : (static_cast<size_t>(K) + 3) & ~3ull) +
      3 * static_cast<size_t>(lines);
  auto kernel = lines > 0 ? la_rows_kernel<true> : la_rows_kernel<false>;
  kernel<<<blocks_for(B, kRowWarps), 32 * kRowWarps,
           sizeof(uint32_t) * kRowWarps * words,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k_sched),
      static_cast<const uint32_t*>(k_vals),
      static_cast<const uint32_t*>(k_corr), corrupt_t, B, n, P, K,
      make_fastmod(P), make_fastmod(K), ring,
      static_cast<uint32_t*>(ring_scratch),
      static_cast<int32_t*>(count_scratch), lines,
      static_cast<int8_t*>(type), static_cast<int16_t*>(proc),
      static_cast<int8_t*>(fn), static_cast<int32_t*>(key),
      static_cast<int32_t*>(val), static_cast<uint8_t*>(corrupted));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int synth_wide_launch(const void* k_vals, int B, int width, int V,
                                 int invalid, void* type, void* proc,
                                 void* kind, void* peak_w, void* stream) {
  wide_kernel<<<blocks_for(B, kWideWarps), 32 * kWideWarps, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k_vals), B, width, make_fastmod(V),
      invalid ? 1 + 2 * V + V * V : 0, static_cast<int8_t*>(type),
      static_cast<int16_t*>(proc), static_cast<int32_t*>(kind),
      static_cast<int32_t*>(peak_w));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* synth_device_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
