// wgl_shard.cu — the frontier-sharded step of the packed-frontier WGL
// search for Hopper (sm_90a): one shard's part of an event.
//
// Replaces jepsen_tpu/parallel/frontier.py::make_frontier_kernel (with its
// _top_apply, _top_complete and _pbool), the reference's multi-device
// program: K1's step inside shard_map, with ppermute and psum between
// devices. It computes what that program computes, not its steps: the
// host (jepsen_torch/parallel/frontier.py) drives the events and the
// exchanges, and these three entries run one shard's part. The plain
// PyTorch versions beside the wrappers (jepsen_torch/ops/cuda_shard.py:
// plain_shard_close, plain_shard_image, plain_shard_commit) are their
// yardstick, bit for bit.
//
// The layout. A row's frontier is split over D = 2^k shards by its top k
// mask bits: shard d holds F_d[w][m] for the WL = W - k low mask bits m,
// global mask d * 2^WL + m, as int32 bit patterns [rows][NW][2^WL] in
// device memory. Slots 0..WL-1 are local; slot WL + b is top slot b,
// whose bit is bit b of the shard index.
//
// One event, per shard, for every row that is still valid and whose event
// is not padding:
//   * shard_close: OR the images received from partners into F (the
//     "changed" flag says whether that added a config), then close F
//     under the live local slots to its local fixpoint, and set "kept":
//     whether a config of this shard survives the event's completion (a
//     local slot q: a config at a mask with bit q; top slot b: any
//     config, on a shard with bit b set). The first round of an event
//     always closes; later rounds close only a row that received
//     something new;
//   * shard_image: on a shard with top bit b clear, T_b of every local
//     mask into a send buffer, which the host copies to the partner
//     d | 2^b (Tensor.copy_) and the partner's next shard_close ORs in.
//     Rounds of close -> images -> copies go on until no shard of any row
//     gains a config (one host read of the flags a round): the least
//     fixpoint does not depend on the order of the steps, so the closure
//     is K1's, bit for bit;
//   * shard_commit: with "nonempty" the OR of every shard's "kept" (the
//     host's reduction over the frontier axis), an OK or FUSED event
//     completes: a first empty completion latches the closure into Fbad,
//     clears F and sets valid = 0, bad = idx; else F takes the survivors
//     (a local slot q: F[m] = F[m | 1<<q], F[m | 1<<q] = 0; top slot b:
//     the bit-set partner's closure, copied here by the host, on a shard
//     with bit b clear, and 0 on one with it set). EV_CLOSE keeps the
//     closure; padding (EV_PAD) and invalid rows are left as they are.
// Every shard keeps its own copy of valid and bad; they stay equal.
//
// shard_close, the one that does the closure's work. A row's slice is
// held on chip: in one CTA's shared memory (the block tier), or split by
// its top `clog` local mask bits over the 2^clog CTAs of a thread-block
// cluster (the cluster tier: CTA `rank` holds the local masks
// rank * Ml .. rank * Ml + Ml - 1, Ml = 2^(WL - clog), as [NW][Ml]
// words), or, where no cluster of 8 holds it (two words at WL 18), left
// in device memory (the device tier). The wrapper's plan
// (cuda_shard.close_plan) picks the tier from (WL, NW, rows): the fewest
// CTAs whose shared memory holds the slice, then twice as many while the
// launch has fewer than four CTAs for each of the card's SMs and each CTA
// keeps at least 2^13 masks (the wide W 17 specs' 64 rows at W_local 16 take clusters
// of 8: 512 CTAs, all resident at once). Beside the slice each CTA keeps
// a flag byte a mask: its words are not empty; they changed in this
// launch (dirty).
//
// A launch loads the slice once, coalesced, ORs the received images in
// on the way (a mask the merge changed is dirty, and written back at
// once), and takes the cluster's votes on "changed" and "not empty".
// Then, if anything merged or (some slot is fresh and the slice is not
// empty), one sweep closes the slice. The closure only adds mask bits,
// so a mask's words are final once every mask with one bit fewer has
// pushed into it: the sweep takes the masks layer by layer in order of
// their bit count (rank bits counted; a barrier between layers, a
// cluster barrier on the cluster tier; `order` lists the local masks by
// bit count), a thread a mask, and each mask pulls from the masks of the
// layer before, final by then: for each live slot i it holds, T_i of the
// source without bit i (in the rank-bit-clear partner CTA's shared
// memory, through distributed shared memory, for a rank bit) where that
// source is dirty, or not empty and i is fresh. The fresh slots, on an
// event's first round: every slot at the row's first live event, else
// those whose kind changed since the row's previous live event, and the
// slot that event's completion freed (the kernel finds that event by
// scanning back over the row's event types). The slice is closed under
// every other slot already, because the previous event's closure, the
// exchange's merges and closes, and its completion all keep it so (K1's
// rule, wgl_frontier.cu's wide tiers); so a clean source adds nothing
// through them, and where every slot is fresh or half a CTA's masks are
// dirty the pull skips the flag tests and takes every source. Each mask
// is expanded once, from final words: no second pass, no confirming
// sweep, no atomics on the slice (a thread owns its mask), and an empty
// or clean slice costs its load. This replaces an in-order slot sweep
// (slot i seeing slot i - 1's writes), which took three passes over the
// slice where the sweep takes one, on the wide W 17 specs. A mask that
// gains is written to the slice in device memory at once. "kept" is read
// from the flags.
//
// What bounds it. The work is K1's (the configurations the closure
// expands, each once), as chains of dependent shared-memory lookups: a
// source's flag, its words, then one nibble-table lookup a nibble of its
// state set (a slot's 16 images of each nibble's values, staged a
// launch). The bytes (the slice in and out once a launch) take
// microseconds. The sweep is latency-bound, a layer at a time; the design
// keeps every CTA of a launch resident, four sources of a mask in flight,
// and no work on clean or empty masks (PERF.md §6 has the measured gap).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kEvOk = 2;
constexpr int kEvClose = 3;
constexpr int kEvFused = 4;
// Widest local window, most top bits (log2 of the frontier devices) and
// most states (two packed words).
constexpr int kMaxWLocal = 18;
constexpr int kMaxTop = 8;
constexpr int kMaxV = 64;
constexpr int kMaxThreads = 1024;
// shard_close: most CTAs a row (log2), most warps a CTA, and its tiers.
constexpr int kCloseMaxClusterLog = 3;
constexpr int kCloseMaxWarps = 8;
constexpr int kCloseMinBlocks = 5;
// Groups of 32 masks a warp loads at once.
constexpr int kLoadBatch = 4;
constexpr int kTierBlock = 0;
constexpr int kTierCluster = 1;
constexpr int kTierDevice = 2;
constexpr uint32_t kFullMask = 0xffffffffu;

}  // namespace

// One launch's arguments, field for field the ShardArgs structure of
// jepsen_torch/ops/cuda_shard.py.
struct ShardArgs {
  int32_t* F;             // [rows][NW][M]: this shard's frontier
  int32_t* Fbad;          // [rows][NW][M]: its latched closure (commit)
  int32_t* send;          // [rows][NW][M]: the image (image)
  const int32_t* recv[kMaxTop];  // close: images received per top bit;
                                 // commit: the top completion's source
  const int8_t* ev_type;  // [rows][N]
  const int8_t* ev_slot;  // [rows][N]
  const void* ev_slots;   // [rows][N][Wt], int8 or int32
  const int32_t* target;  // [K1][V] shared, or [rows][K1][V]
  const int32_t* order;   // close: a CTA's local masks by bit count
  uint8_t* flags;         // close, device tier: [rows][M] flag bytes
  long long target_row_stride;  // 0 when shared, else K1 * V
  uint8_t* valid;         // [rows] bool
  int32_t* bad;           // [rows]
  const int32_t* nonempty;  // [rows]: OR of the shards' kept (commit)
  int32_t* changed;       // [rows] (close)
  int32_t* kept;          // [rows] (close)
  int slots_i32, N, Wt, K1, V, NW, W, WL, e, d, b, first_round, idx, rows;
};

namespace {

__device__ __forceinline__ bool live_event(int typ) {
  return typ == kEvOk || typ == kEvFused || typ == kEvClose;
}

// Slot `slot`'s kind at event `ev`, wrapped (a negative int8 kind counts
// from K1) and clamped, as K1 reads it.
__device__ __forceinline__ int kind_at(const ShardArgs& a, int row, int ev,
                                       int slot) {
  const long long off = ((long long)row * a.N + ev) * a.Wt + slot;
  int k = a.slots_i32 ? static_cast<const int32_t*>(a.ev_slots)[off]
                      : static_cast<const int8_t*>(a.ev_slots)[off];
  if (k < 0) k += a.K1;
  return min(max(k, 0), a.K1 - 1);
}

// Stage slot `slot`'s packed one-hot transition row into tab[V][NW];
// returns, block-uniform, whether it reaches any state.
__device__ bool stage_row(const ShardArgs& a, int row, int slot,
                          uint32_t* tab) {
  const int k = kind_at(a, row, a.e, slot);
  const int32_t* t = a.target + row * a.target_row_stride + (long long)k * a.V;
  int any = 0;
  for (int s = threadIdx.x; s < a.V; s += blockDim.x) {
    const int to = t[s];
    any |= to >= 0;
    for (int w = 0; w < a.NW; ++w) {
      const int r = to - 32 * w;
      tab[s * a.NW + w] = (r >= 0 && r < 32) ? (1u << r) : 0u;
    }
  }
  return __syncthreads_or(any) != 0;
}

// T(src): the OR of the packed rows of src's set states.
__device__ __forceinline__ void image_of(const uint32_t* src, int NW,
                                         const uint32_t* tab, uint32_t* img) {
  img[0] = 0;
  img[1] = 0;
  for (int w = 0; w < NW; ++w) {
    uint32_t x = src[w];
    while (x) {
      const int s = 32 * w + __ffs(x) - 1;
      x &= x - 1;
      for (int v = 0; v < NW; ++v) img[v] |= tab[s * NW + v];
    }
  }
}

// ---- shard_close

// A pointer into CTA `rank`'s shared memory at the same offset as `p` in
// this CTA's (a cluster launch only).
template <typename T>
__device__ __forceinline__ T* on_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

__device__ __forceinline__ void cta_sync(int clog) {
  if (clog > 0) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// The local slots the row's closure at this event must apply from every
// configuration (warp 0, every lane gets the mask): all of them at the
// row's first live event; else those whose kind differs from the row's
// previous live event, and the slot that event's OK or FUSED freed.
__device__ uint32_t fresh_slots(const ShardArgs& a, int row, int lane) {
  const int8_t* et = a.ev_type + (long long)row * a.N;
  int p = -1;
  for (int base = a.e - 1; base >= 0 && p < 0; base -= 32) {
    const int j = base - lane;
    const uint32_t b = __ballot_sync(kFullMask, j >= 0 && live_event(et[j]));
    if (b) p = base - (__ffs(b) - 1);
  }
  if (p < 0) return (1u << a.WL) - 1u;
  const int pt = et[p];
  int q = -1;
  if (pt == kEvOk || pt == kEvFused)
    q = min(max(static_cast<int>(a.ev_slot[(long long)row * a.N + p]), 0),
            a.W - 1);
  const bool f = lane < a.WL && (lane == q || kind_at(a, row, a.e, lane)
                                 != kind_at(a, row, p, lane));
  return __ballot_sync(kFullMask, f);
}

// Cluster-wide ORs of two warp-uniform flags: each warp whose flag f is
// set stamps vote[stamp & 1][f] in every CTA; one barrier; every CTA
// reads its own. Two parities: a CTA cannot stamp a slot again before
// every CTA has read it, since a barrier lies between. Returns the first
// OR, the second into *second.
__device__ __forceinline__ bool cluster_vote2(int (*vote)[2], bool f0,
                                              bool f1, int stamp, int clog,
                                              int lane, bool* second) {
  if (lane == 0 && (f0 || f1)) {
    int* slot = vote[stamp & 1];
    for (int c = 0; c < (1 << clog); ++c) {
      volatile int* to = clog > 0 ? on_rank(slot, c) : slot;
      if (f0) to[0] = stamp;
      if (f1) to[1] = stamp;
    }
  }
  cta_sync(clog);
  const volatile int* seen = vote[stamp & 1];
  *second = seen[1] == stamp;
  return seen[0] == stamp;
}

// Words of one slot's nibble table (for each nibble of a state set, the
// image of each of its 16 values: 16 * ceil(V / 4) entries of NW words),
// made odd so that the slots' tables start in different banks: the
// lanes of a warp look up different slots at once.
__host__ __device__ __forceinline__ int slot_table_words(int V, int NW) {
  return 16 * ((V + 3) / 4) * NW | 1;
}

// Words of dynamic shared memory a shard_close CTA takes: on the block
// and cluster tiers its part of the slice and a flag byte a mask (whole
// groups of 32), which the device tier keeps in device memory; and the
// WL local slots' nibble tables.
__host__ __device__ __forceinline__ long long close_smem_words(
    int WL, int clog, int NW, int V, int in_smem) {
  const long long Ml = 1LL << (WL - clog);
  const long long Gl = Ml >= 32 ? Ml >> 5 : 1;
  return (in_smem ? NW * Ml + 8 * Gl : 0)
         + (long long)WL * slot_table_words(V, NW);
}

// T(x) from a slot's nibble table (NQ nibbles of NW words each): one
// independent lookup a nibble.
template <int NW>
__device__ __forceinline__ void nibble_image(const uint32_t* x,
                                             const uint32_t* t, int NQ,
                                             uint32_t* img) {
#pragma unroll
  for (int w = 0; w < NW; ++w) img[w] = 0u;
#pragma unroll 2
  for (int q = 0; q < NQ; ++q) {
    const uint32_t n = (x[q >> 3] >> (4 * (q & 7))) & 15u;
#pragma unroll
    for (int w = 0; w < NW; ++w) img[w] |= t[(q * 16 + n) * NW + w];
  }
}

// A mask's flag byte: its words are not empty, and they changed in this
// launch (the merge or the sweep).
constexpr uint8_t kNonEmpty = 1;
constexpr uint8_t kDirty = 2;

// Where slot i's source for local mask m lies: its words (plane stride
// as F's) and its flag byte (this CTA's, or the rank-bit-clear partner's
// for a rank bit).
struct Source {
  const uint32_t* F;
  const uint8_t* FL;
  uint32_t m;
};

__device__ __forceinline__ Source source_of(int i, uint32_t m, uint32_t* Fl,
                                            uint8_t* FL, int Wl, int rank) {
  if (i < Wl) return Source{Fl, FL, m ^ (1u << i)};
  const int pr = rank ^ (1 << (i - Wl));
  return Source{on_rank(Fl, pr), on_rank(FL, pr), m};
}

// T_i of one source's words into acc: in the full mode from any source
// (one whose words are empty adds nothing), else only from a dirty
// source, or a non-empty one when i is fresh.
template <int NW>
__device__ __forceinline__ void pull_from(const Source& s, int i,
                                          bool full, uint32_t fresh,
                                          uint32_t fs, const uint32_t* t,
                                          int NQ, uint32_t* acc) {
  if (!full) {
    const uint8_t f = s.FL[s.m];
    if (!(f & kDirty) && !(((fresh >> i) & 1u) && (f & kNonEmpty))) return;
  }
  uint32_t y[NW], img[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) y[w] = s.F[w * fs + s.m];
  if (!(y[0] | y[NW - 1])) return;
  nibble_image<NW>(y, t, NQ, img);
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] |= img[w];
}

// One destination mask's pull, by one thread: for each live slot i the
// mask holds (bit i of m below Wl, a rank bit above), T_i of the source's
// words (m without bit i here, or m in the rank-bit-clear partner CTA),
// as pull_from allows. Every source lies in the layer before and is
// final. Four sources at a time, so that their loads overlap. The gain is
// written to F (and to the slice in device memory, when it is on chip)
// and the mask flagged dirty and non-empty.
template <int NW>
__device__ __forceinline__ void pull_mask(
    uint32_t m, uint32_t sl, bool full, uint32_t fresh, uint32_t* Fl,
    uint32_t fs, uint8_t* FL, uint32_t* Fg, long long M, uint32_t off,
    int in_smem, const uint32_t* tab, int NQ, int TS, int Wl, int rank) {
  uint32_t acc[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] = 0u;
  while (sl) {
    int ids[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ids[u] = sl ? __ffs(sl) - 1 : -1;
      sl &= sl - 1u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ids[u] >= 0)
        pull_from<NW>(source_of(ids[u], m, Fl, FL, Wl, rank), ids[u], full,
                      fresh, fs, tab + ids[u] * TS, NQ, acc);
  }
  bool gain = false;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const uint32_t x = Fl[w * fs + m];
    if (acc[w] & ~x) {
      gain = true;
      Fl[w * fs + m] = x | acc[w];
      if (in_smem) Fg[w * M + off + m] = x | acc[w];
    }
  }
  if (gain) FL[m] = kNonEmpty | kDirty;
}

// One row's shard_close by one CTA of 2^clog (this one `rank`), the
// slice in shared memory (in_smem) or in F.
template <int NW>
__global__ void __launch_bounds__(kCloseMaxWarps * 32, kCloseMinBlocks)
shard_close_kernel(const ShardArgs a, int clog, int in_smem) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_kind[kMaxWLocal];
  __shared__ uint32_t s_live, s_fresh;
  __shared__ int s_dirty;
  __shared__ int s_vote[2][2];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int rank =
      clog > 0 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int row = static_cast<int>(blockIdx.x >> clog);
  const int typ = a.ev_type[(long long)row * a.N + a.e];
  if (!a.valid[row] || !live_event(typ)) {
    if (rank == 0 && tid == 0) {
      a.changed[row] = 0;
      a.kept[row] = 0;
    }
    return;   // every CTA of the row's cluster returns here
  }
  const int WL = a.WL;
  const int V = a.V;
  const int Wl = WL - clog;
  const uint32_t Ml = 1u << Wl;
  const int Gl = Ml >= 32u ? static_cast<int>(Ml >> 5) : 1;
  const uint32_t lanes = Ml >= 32u ? kFullMask : (1u << Ml) - 1u;
  const long long M = 1LL << WL;
  const uint32_t off = static_cast<uint32_t>(rank) * Ml;
  uint32_t* Fg = reinterpret_cast<uint32_t*>(a.F) + (long long)row * NW * M;
  uint32_t* cur = smem;
  uint32_t* Fl = in_smem ? cur : Fg + off;   // [NW][fs]
  const uint32_t fs = in_smem ? Ml : static_cast<uint32_t>(M);
  uint8_t* FL = in_smem ? reinterpret_cast<uint8_t*>(cur + NW * Ml)
                        : a.flags + (long long)row * M;   // [Gl * 32]
  if (in_smem) cur += NW * Ml + 8 * Gl;
  uint32_t* tab = cur;                       // [WL][TS]: [NQ][16][NW]
  const int NQ = (V + 3) / 4;
  const int TS = slot_table_words(V, NW);

  if (warp == 0) {
    if (lane < WL) s_kind[lane] = kind_at(a, row, a.e, lane);
    const uint32_t f = a.first_round ? fresh_slots(a, row, lane) : 0u;
    if (lane == 0) {
      s_fresh = f;
      s_live = 0u;
      s_dirty = 0;
      s_vote[0][0] = s_vote[0][1] = s_vote[1][0] = s_vote[1][1] = -1;
    }
  }
  __syncthreads();
  // The nibble tables: entry (i, q, n) is T_i of the states 4q + b for
  // the set bits b of n; a slot is live if a state's row reaches one.
  const int32_t* tg = a.target + row * a.target_row_stride;
  for (int x = tid; x < WL * NQ * 16; x += nt) {
    const int i = x / (NQ * 16);
    const int q = (x >> 4) - i * NQ;
    const int n = x & 15;
    uint32_t img[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) img[w] = 0u;
    for (int b = 0; b < 4; ++b) {
      const int st = 4 * q + b;
      if (!((n >> b) & 1) || st >= V) continue;
      const int to = tg[(long long)s_kind[i] * V + st];
      if (to < 0) continue;
      if (n == (1 << b)) atomicOr(&s_live, 1u << i);
#pragma unroll
      for (int w = 0; w < NW; ++w)
        if ((to >> 5) == w) img[w] |= 1u << (to & 31);
    }
    uint32_t* te = tab + i * TS + (x - i * NQ * 16) * NW;
#pragma unroll
    for (int w = 0; w < NW; ++w) te[w] = img[w];
  }
  // Load the slice, merging the received images: each mask's flag byte
  // (non-empty; dirty where the merge changed it, written back to F at
  // once). A warp takes kLoadBatch groups at a time, their loads issued
  // together.
  bool merged = false, nonempty = false;
  int dirty = 0;
  const bool act = (lanes >> lane) & 1u;
  bool any_recv = false;
#pragma unroll
  for (int b = 0; b < kMaxTop; ++b) any_recv |= a.recv[b] != nullptr;
  for (int g0 = warp * kLoadBatch; g0 < Gl; g0 += nwarps * kLoadBatch) {
    uint32_t v[kLoadBatch][NW], x[kLoadBatch][NW];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u)
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const long long at =
            w * M + off + static_cast<uint32_t>(g0 + u) * 32u + lane;
        v[u][w] = act && g0 + u < Gl ? Fg[at] : 0u;
        x[u][w] = v[u][w];
      }
    if (any_recv) {
#pragma unroll
      for (int b = 0; b < kMaxTop; ++b) {
        if (a.recv[b] == nullptr) continue;
        const uint32_t* R = reinterpret_cast<const uint32_t*>(a.recv[b])
                            + (long long)row * NW * M;
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u)
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const long long at =
                w * M + off + static_cast<uint32_t>(g0 + u) * 32u + lane;
            if (act && g0 + u < Gl) x[u][w] |= R[at];
          }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int g = g0 + u;
      if (g >= Gl) break;
      const uint32_t m = static_cast<uint32_t>(g) * 32u + lane;
      bool gain = false, nz = false;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (act && in_smem) Fl[w * Ml + m] = x[u][w];
        if (act && x[u][w] != v[u][w]) Fg[w * M + off + m] = x[u][w];
        gain |= x[u][w] != v[u][w];
        nz |= x[u][w] != 0u;
      }
      FL[m] = (nz ? kNonEmpty : 0) | (gain ? kDirty : 0);
      const uint32_t gb = __ballot_sync(kFullMask, gain);
      merged |= gb != 0u;
      nonempty |= __any_sync(kFullMask, nz);
      dirty += __popc(gb);
    }
  }
  if (lane == 0 && dirty) atomicAdd(&s_dirty, dirty);
  cta_sync(clog);   // s_vote set in every CTA before the first stamp
  int stamp = 0;
  bool any_nz;
  const bool added = cluster_vote2(
      s_vote, __any_sync(kFullMask, merged),
      __any_sync(kFullMask, nonempty), ++stamp, clog, lane, &any_nz);
  const uint32_t live = s_live;
  const uint32_t fresh = s_fresh & live;
  if ((fresh && any_nz) || added) {
    // The full mode pulls from every source: on a slice closed under the
    // slots that are not fresh, a clean source adds nothing through
    // them, so it only spares the flag tests where most sources count.
    const bool full = fresh == live || 2u * s_dirty >= Ml;
    // The sweep: global layer k (masks of k bits) is local layer
    // k - popc(rank) here, the masks a.order[first .. first + C(Wl, j)),
    // a thread each.
    const int pr = __popc(rank);
    const uint32_t held = static_cast<uint32_t>(rank) << Wl;
    int first = 0;
    int count = 1;     // C(Wl, j)
    for (int k = 0; k <= WL; ++k) {
      const int j = k - pr;
      if (j >= 0 && j <= Wl) {
        const int end = first + count;
        int next = first + tid < end ? a.order[first + tid] : 0;
        for (int x = first + tid; x < end; x += nt) {
          const uint32_t m = static_cast<uint32_t>(next);
          if (x + nt < end) next = a.order[x + nt];
          pull_mask<NW>(m, (m | held) & live, full, fresh, Fl, fs, FL, Fg,
                        M, off, in_smem, tab, NQ, TS, Wl, rank);
        }
        first += count;
        count = count * (Wl - j) / (j + 1);
      }
      // Layer k is final before layer k + 1 reads it.
      cta_sync(clog);
    }
  }
  // kept, from the flags: a config at a mask with bit q (a local slot),
  // or any config on a shard with top bit q - WL set.
  bool k = false;
  if (typ != kEvClose) {
    const int q = min(max(static_cast<int>(a.ev_slot[(long long)row * a.N
                                                     + a.e]), 0), a.W - 1);
    const bool every = q < Wl ? false
                       : q < WL ? ((rank >> (q - Wl)) & 1) != 0
                                : ((a.d >> (q - WL)) & 1) != 0;
    if (q < Wl || every)
      for (uint32_t m = tid; m < Ml && !k; m += nt)
        k = (FL[m] & kNonEmpty) && (every || ((m >> q) & 1u));
  }
  bool unused;
  k = cluster_vote2(s_vote, __any_sync(kFullMask, k), false, ++stamp, clog,
                    lane, &unused);
  if (rank == 0 && tid == 0) {
    a.changed[row] = added;
    a.kept[row] = k;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
shard_image_kernel(const ShardArgs a) {
  __shared__ uint32_t tab[kMaxV * 2];
  const int row = blockIdx.x;
  const int typ = a.ev_type[(long long)row * a.N + a.e];
  const int M = 1 << a.WL;
  const long long NM = (long long)a.NW * M;
  const uint32_t* F = reinterpret_cast<const uint32_t*>(a.F) + row * NM;
  uint32_t* S = reinterpret_cast<uint32_t*>(a.send) + row * NM;
  const bool active = a.valid[row] && live_event(typ);
  const bool reach = active && stage_row(a, row, a.WL + a.b, tab);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    uint32_t img[2] = {0u, 0u};
    if (reach) {
      const uint32_t src[2] = {F[m], a.NW > 1 ? F[M + m] : 0u};
      image_of(src, a.NW, tab, img);
    }
    for (int w = 0; w < a.NW; ++w) S[(long long)w * M + m] = img[w];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
shard_commit_kernel(const ShardArgs a) {
  const int row = blockIdx.x;
  const int typ = a.ev_type[(long long)row * a.N + a.e];
  if (!a.valid[row] || !(typ == kEvOk || typ == kEvFused)) return;
  const int M = 1 << a.WL;
  const long long NM = (long long)a.NW * M;
  uint32_t* F = reinterpret_cast<uint32_t*>(a.F) + row * NM;
  if (!a.nonempty[row]) {
    // The first impossible completion: latch the closure, clear F.
    uint32_t* Fb = reinterpret_cast<uint32_t*>(a.Fbad) + row * NM;
    for (long long j = threadIdx.x; j < NM; j += blockDim.x) {
      Fb[j] = F[j];
      F[j] = 0u;
    }
    // Every thread has read valid[row] before it changes.
    __syncthreads();
    if (threadIdx.x == 0) {
      a.valid[row] = 0;
      a.bad[row] = min(a.bad[row], a.idx);
    }
    return;
  }
  const int q = min(max(static_cast<int>(a.ev_slot[(long long)row * a.N
                                                   + a.e]), 0), a.W - 1);
  if (q < a.WL) {
    const int bit = 1 << q;
    const int half = M >> 1;
    for (int w = 0; w < a.NW; ++w) {
      uint32_t* Fw = F + (long long)w * M;
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int m = ((p & ~(bit - 1)) << 1) | (p & (bit - 1));
        Fw[m] = Fw[m | bit];
        Fw[m | bit] = 0u;
      }
    }
    return;
  }
  const int b = q - a.WL;
  const uint32_t* src = ((a.d >> b) & 1) || a.recv[b] == nullptr
      ? nullptr
      : reinterpret_cast<const uint32_t*>(a.recv[b]) + row * NM;
  for (long long j = threadIdx.x; j < NM; j += blockDim.x)
    F[j] = src ? src[j] : 0u;
}

// Let shard_close take `smem_bytes` of dynamic shared memory, with the
// SM's whole carveout for shared memory, so that as many CTAs share an
// SM as its shared memory holds.
cudaError_t close_attributes(void (*kernel)(const ShardArgs, int, int),
                             int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool args_ok(const ShardArgs& a) {
  return a.F != nullptr && a.rows >= 0 && a.N >= 1 && a.e >= 0
      && a.e < a.N && a.WL >= 1 && a.WL <= kMaxWLocal && a.W >= a.WL
      && a.W - a.WL <= kMaxTop && a.Wt >= a.W && a.V >= 1 && a.V <= kMaxV
      && a.NW == (a.V + 31) / 32 && a.K1 >= 1;
}

bool threads_ok(int threads, int most) {
  return threads >= 32 && threads <= most && threads % 32 == 0;
}

}  // namespace

// shard_close over a.rows rows: 2^clog CTAs a row (a cluster when clog
// > 0) of `threads` each, `smem_bytes` of dynamic shared memory each,
// the slice in it but in the device tier. A launch CUDA refuses returns
// its error; nothing drops to another tier.
extern "C" int wgl_shard_close_launch(const void* args, int tier, int clog,
                                      int threads, int smem_bytes,
                                      void* stream) {
  const ShardArgs& a = *static_cast<const ShardArgs*>(args);
  const bool tier_ok = tier == kTierCluster
      ? clog >= 1 && clog <= kCloseMaxClusterLog
      : (tier == kTierBlock || tier == kTierDevice) && clog == 0;
  const int in_smem = tier == kTierDevice ? 0 : 1;
  if (!args_ok(a) || !tier_ok || clog > a.WL
      || !threads_ok(threads, kCloseMaxWarps * 32) || a.changed == nullptr
      || a.kept == nullptr || a.order == nullptr || a.NW > 2
      || (!in_smem && a.flags == nullptr)
      || smem_bytes < 4 * close_smem_words(a.WL, clog, a.NW, a.V, in_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = a.NW == 1 ? shard_close_kernel<1> : shard_close_kernel<2>;
  cudaError_t err = close_attributes(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.rows == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.rows) << clog, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << clog;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, clog, in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters (CTAs when clog is 0) of shard_close's plan the card
// keeps resident at once, into *clusters.
extern "C" int wgl_shard_close_residency(int NW, int clog, int threads,
                                         int smem_bytes, int* clusters) {
  auto kernel = NW == 1 ? shard_close_kernel<1> : shard_close_kernel<2>;
  const cudaError_t err = close_attributes(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << clog, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << clog;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

extern "C" int wgl_shard_image_launch(const void* args, int threads,
                                      void* stream) {
  const ShardArgs& a = *static_cast<const ShardArgs*>(args);
  if (!args_ok(a) || !threads_ok(threads, kMaxThreads) || a.send == nullptr
      || a.b < 0 || a.b >= a.W - a.WL || ((a.d >> a.b) & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows > 0)
    shard_image_kernel<<<a.rows, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgl_shard_commit_launch(const void* args, int threads,
                                       void* stream) {
  const ShardArgs& a = *static_cast<const ShardArgs*>(args);
  if (!args_ok(a) || !threads_ok(threads, kMaxThreads) || a.Fbad == nullptr
      || a.nonempty == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows > 0)
    shard_commit_kernel<<<a.rows, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The descriptor's size and the compiled limits, for the wrapper's check.
extern "C" int wgl_shard_args_bytes() {
  return static_cast<int>(sizeof(ShardArgs));
}

extern "C" int wgl_shard_limits(int* max_wl, int* max_top, int* max_v,
                                int* close_clog, int* close_threads) {
  *max_wl = kMaxWLocal;
  *max_top = kMaxTop;
  *max_v = kMaxV;
  *close_clog = kCloseMaxClusterLog;
  *close_threads = kCloseMaxWarps * 32;
  return 0;
}

extern "C" const char* wgl_shard_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
