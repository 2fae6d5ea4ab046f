// wgl_frontier.cu — the packed-frontier Wing–Gong linearizability search
// for Hopper (sm_90a), in three tiers by window width.
//
// Replaces the TPU kernel jepsen_tpu/ops/pallas_wgl.py::_kernel_body (built
// by make_pallas_kernel, pl.pallas_call at pallas_wgl.py:411) and its XLA
// twin jepsen_tpu/ops/linearize.py::make_kernel (check and check_resume).
// The function is the same, bit for bit: the plain PyTorch version
// jepsen_torch/ops/linearize.py::plain_wgl is its yardstick.
//
// What it computes. A row's configuration set is a packed bit frontier
// F[w][m]: bit s of word w at mask m holds config (state 32w+s, the set m
// of linearized pending slots). For each event e (global index idx0 + e):
//   * closure: the least fixpoint containing F under, for every slot
//     i < WL and every mask m without bit i,
//     F[m | 1<<i] |= T_i(F[m]), with T_i the slot's packed one-hot
//     transition rows;
//   * completion (EV_OK / EV_FUSED on slot q): F_ok[m] = Fc[m | 1<<q] for
//     masks without bit q, 0 for masks with it. If F_ok is empty the first
//     time, the pre-completion closure Fc is latched into Fb, valid drops
//     to 0 and bad = idx0 + e;
//   * EV_CLOSE keeps the closure; EV_PAD (and any other code) is a no-op.
// The carry (F, Fb, valid, bad) is read and written in place, so one
// entry serves the one-shot check and the event-chunked resume.
//
// What bounds it on this card. The work is a sequential walk over events
// with a small fixpoint per event. At the main path's widths (W = 2..9
// masks after the per-key partition, V = 8 states) a row's frontier is a
// few hundred bytes and an event a few hundred integer operations, so
// neither device memory bandwidth nor the integer rate is the limit: the
// latency of each event's dependent steps is, and the card hides it only
// by running many rows at once. The tiers:
//
//   * Warp tier, W <= W_warp (chosen by ops/cuda_wgl.py, at most
//     kWarpMaxW = 8): one warp walks one row, R rows (warps) per block.
//     This is what the main path runs. What it does about the block
//     tier's costs:
//       - idle lanes and the barrier chain: the frontier lives in the
//         warp's registers, lane l holding masks l + 32j (2^W / 32 of
//         them, at least one), so a slot's step is a register shuffle
//         (__shfl_xor_sync, slots 0..4) or a register move (slots 5..7)
//         and needs no barrier at all. At one mask per lane (W <= 5)
//         every live slot steps at once from the configs that are new
//         since the last sweep, and the closure ends on a ballot when no
//         new config lies where a live slot reads: no fixpoint test
//         sweep. With more masks per lane a slot steps in place, again
//         only after another slot changed the frontier (one __any_sync a
//         step), and empty sources are skipped. The completion's "a
//         config survives" is one __any_sync. No block barrier is left in
//         the event loop, and no shared-memory frontier traffic;
//       - re-staging per event: the row's (or the block's, when shared)
//         transition table is staged once into shared memory, with one
//         reach flag per kind so that a slot reaching no state is
//         skipped. For V <= 8 at one word it is staged as the images of
//         every nibble of states, so an image is two lookups without a
//         branch instead of a loop over set states (a lane that diverges
//         costs its warp a reconvergence on every step); otherwise as
//         int8 target states. A table past the budget stays in device
//         memory and is read through L1;
//       - device-memory loads in the event loop: lane l holds event
//         e0 + l of a 32-event tile in registers and writes its slots'
//         table offsets to the warp's tile in shared memory; the next
//         tile's loads are issued before the current tile is walked, and
//         an event reaches the other lanes as one shuffled word;
//       - padding one event at a time: a __ballot_sync over the tile's
//         event types yields the live events; padding costs nothing past
//         its tile's load, and a row that fails stops walking (nothing
//         changes after a failure but a bad index that cannot drop);
//       - occupancy: blocks of R x 32 threads, one kernel per masks-per-
//         lane and state-word count, each held to 64 registers so that
//         four blocks (32 warps) share an SM.
//   * Block tier, W_warp < W <= 15 (14 at two state words): one block per
//     row, one thread per mask pair, the frontier in shared memory for the
//     whole row, the closure swept slot by slot in place to a fixpoint
//     with block barriers, the event's transition rows staged per event
//     (wgl_row below).
//   * Device-memory tier, W = 16..18 (the data1wide route): the block
//     tier's body with the frontier in the row's slice of the output
//     tensor, for frontiers past the 227 KB a block may use.
//
// The instrumented entry (wgl_instrument_kernel) replaces the fourth
// output of make_kernel(instrument=True) (jepsen_tpu/ops/linearize.py:158,
// :243): each row's closure while_loop passes, summed over EVERY event of
// its event axis. That count depends on the reference's schedule, slots
// 0..WL-1 applied in place in order and then one whole-frontier change
// test, which is the block tier's closure; the warp tier propagates only
// new configurations and skips pads, so it cannot count it. The entry is
// the block tier's row body with the counter switched on: a pad event's
// closure runs on a scratch copy of the frontier (beside it in shared
// memory, or the row's scratch slice in device memory) and is dropped, a
// closure whose slots reach no state counts one pass, and a failed row's
// every later event counts one (the closure of its empty frontier). Its
// valid, bad and frontier are K1's, bit for bit.
//
// The group entry (wgl_frontier_group_kernel) replaces the TPU dispatch
// group jepsen_tpu/ops/linearize.py::make_fused_kernel: one XLA call that
// scans several class buckets of different shapes back to back. Here it is
// one launch over up to kMaxMembers member chunks (different V, W, w_live,
// event lengths, slot dtypes, shared or per-row targets). Each member has
// a tier and a block count (ceil(rows / R) in the warp tier, one block per
// row in the block tier); block b finds its member by scanning the
// members' block prefix sums in a __grid_constant__ descriptor. Blocks are
// R x 32 threads for every member, and shared memory is the largest
// member's need. What it saves is launches, not work: the scheduler's many
// small chunks stop paying a launch and a host round trip each. The
// scheduler ships a member that needs the device-memory tier alone. A
// row's latched pre-failure closure is written straight into its frontier
// output, which therefore holds the check form's where(valid, F, Fb) when
// the row ends. Padding rows of a member are not launched: their outputs
// arrive pre-filled as the plain version leaves an all-EV_PAD row.
//
// Why the updates are race-free. Applying slot i reads only masks without
// bit i and writes only masks with bit i: in the warp tier a lane updates
// only its own registers from a shuffled copy of its partner's, in the
// block tier each mask pair (m, m | 1<<i) belongs to one thread. The
// closure is a monotone OR to a unique least fixpoint, so the order of
// slots and lanes does not change Fc. Completion moves each pair's upper
// word down and clears it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEvOk = 2;
constexpr int kEvClose = 3;
constexpr int kEvFused = 4;

// Tiers, as ops/cuda_wgl.py numbers them.
constexpr int kTierWarp = 0;
constexpr int kTierBlock = 1;

// Widest window the warp tier's per-lane slot registers hold, and the most
// rows (warps) one warp-tier block walks.
constexpr int kWarpMaxW = 8;
constexpr int kWarpRows = 8;
// Blocks of kWarpRows warps an SM should hold at once: caps a warp-tier
// kernel at 64 registers a thread (32 warps an SM).
constexpr int kWarpMinBlocks = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// Mask of the p-th pair for slot bit i: p with a zero bit inserted at i.
__device__ __forceinline__ uint32_t pair_mask(uint32_t p, int i) {
  const uint32_t low = (1u << i) - 1u;
  return ((p & ~low) << 1) | (p & low);
}

__device__ __forceinline__ int load_kind(const void* slots, long long at,
                                         int slots_i32) {
  return slots_i32 ? static_cast<const int32_t*>(slots)[at]
                   : static_cast<const int8_t*>(slots)[at];
}

// The block tier's closure of the frontier Fw under the staged rows of the
// live slots, slot by slot in place to a fixpoint. Returns the number of
// sweeps, the last one (which changes nothing) included; block-uniform.
__device__ __forceinline__ int block_closure(uint32_t* Fw,
                                             const uint32_t* rows,
                                             uint32_t live, int WL, int NW,
                                             int V, uint32_t M, uint32_t P,
                                             int tid, int nt) {
  int passes = 0;
  int changed;
  do {
    int ch = 0;
    for (int i = 0; i < WL; ++i) {
      if (!((live >> i) & 1u)) continue;
      const uint32_t bit = 1u << i;
      const uint32_t* r = rows + i * NW * V;
      for (uint32_t p = tid; p < P; p += nt) {
        const uint32_t m0 = pair_mask(p, i);
        uint32_t s0 = Fw[m0];
        uint32_t s1 = NW > 1 ? Fw[M + m0] : 0u;
        if (!(s0 | s1)) continue;
        uint32_t n0 = 0u, n1 = 0u;
        while (s0) {
          const int s = __ffs(s0) - 1;
          s0 &= s0 - 1u;
          if (s < V) {
            n0 |= r[s];
            if (NW > 1) n1 |= r[V + s];
          }
        }
        while (s1) {
          const int s = 32 + __ffs(s1) - 1;
          s1 &= s1 - 1u;
          if (s < V) {
            n0 |= r[s];
            n1 |= r[V + s];
          }
        }
        const uint32_t m1 = m0 | bit;
        const uint32_t o0 = Fw[m1];
        if (n0 & ~o0) {
          Fw[m1] = o0 | n0;
          ch = 1;
        }
        if (NW > 1) {
          const uint32_t o1 = Fw[M + m1];
          if (n1 & ~o1) {
            Fw[M + m1] = o1 | n1;
            ch = 1;
          }
        }
      }
      __syncthreads();
    }
    changed = __syncthreads_or(ch);
    ++passes;
  } while (changed);
  return passes;
}

// The block and device-memory tiers: one row's walk over its N events by
// a whole block, under both entries. `et`, `es` and `ev_slots` are the
// row's event tables (its slot table at element offset `slots_base`, Wt
// entries per event), `tg` its [K1][V] transition table, Fg and Fbg its
// carry frontiers in device memory, valid_p and bad_p its verdict. With
// frontier_in_smem the frontier lives in shared memory after the staged
// transition rows and is copied back to Fg at the end, unless Fbg aliases
// Fg and the row has failed: then Fg keeps the latched closure (the group
// entry's output). kInstrument is the instrumented entry's body: Sg is the
// row's scratch frontier in device memory (used when the frontier is not
// in shared memory) and *iters_p gets the row's closure passes.
template <bool kInstrument>
__device__ void wgl_row(const int8_t* __restrict__ et,
                        const int8_t* __restrict__ es,
                        const void* __restrict__ ev_slots,
                        long long slots_base,
                        int slots_i32, const int32_t* __restrict__ tg,
                        uint32_t* Fg, uint32_t* Fbg, uint8_t* valid_p,
                        int32_t* bad_p, int N, int Wt, int K1, int V, int NW,
                        int W, int WL, int idx0, int frontier_in_smem,
                        uint32_t* Sg, int32_t* iters_p) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t live_slots;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uint32_t M = 1u << W;
  const uint32_t P = M >> 1;
  const uint32_t NWM = static_cast<uint32_t>(NW) * M;

  // [WL][NW][V] packed one-hot target rows of this event's slots.
  uint32_t* rows = smem;
  uint32_t* Fw = frontier_in_smem ? smem + WL * NW * V : Fg;
  // The instrumented body's scratch frontier for pad events' closures.
  uint32_t* Sw = frontier_in_smem ? Fw + NWM : Sg;
  int32_t sweeps = 0;

  if (frontier_in_smem) {
    for (uint32_t m = tid; m < NWM; m += nt) Fw[m] = Fg[m];
  }
  bool ok = *valid_p != 0;
  int32_t first_bad = *bad_p;
  // True once a failed completion has emptied F: from then on every event
  // leaves F, Fb and valid as they are, and only bad's running min moves.
  bool dead = false;

  for (int e = 0; e < N; ++e) {
    const int typ = et[e];
    const bool is_ok = typ == kEvOk || typ == kEvFused;
    const bool is_close = typ == kEvClose;
    const bool is_live = is_ok || is_close;
    // EV_PAD: a no-op, block-uniform (the instrumented body counts it).
    if (!kInstrument && !is_live) continue;
    if (dead) {
      if (is_ok) first_bad = min(first_bad, idx0 + e);
      if (kInstrument) sweeps += 1;  // the closure of an empty frontier
      continue;
    }

    // Stage the slots' transition rows. Kind indices follow the
    // reference's gather: negative wraps once, then clamps into [0, K1).
    if (tid == 0) live_slots = 0u;
    __syncthreads();
    for (int t = tid; t < WL * V; t += nt) {
      const int i = t / V;
      const int s = t - i * V;
      int k = load_kind(ev_slots, slots_base + static_cast<long long>(e) * Wt
                                      + i, slots_i32);
      if (k < 0) k += K1;
      k = min(max(k, 0), K1 - 1);
      const int to = tg[static_cast<long long>(k) * V + s];
      for (int w = 0; w < NW; ++w) {
        const int sh = to - 32 * w;
        rows[(i * NW + w) * V + s] = (sh >= 0 && sh < 32) ? (1u << sh) : 0u;
      }
      if (to >= 0 && to < 32 * NW) atomicOr(&live_slots, 1u << i);
    }
    __syncthreads();
    const uint32_t live = live_slots;

    if (kInstrument && !is_live) {
      // A pad event: close a scratch copy, count its passes, drop it.
      int passes = 1;
      if (live) {
        for (uint32_t m = tid; m < NWM; m += nt) Sw[m] = Fw[m];
        __syncthreads();
        passes = block_closure(Sw, rows, live, WL, NW, V, M, P, tid, nt);
      }
      sweeps += passes;
      __syncthreads();
      continue;
    }

    // Closure to fixpoint, slot by slot in place (one pass counted when
    // no slot reaches a state).
    const int passes =
        live ? block_closure(Fw, rows, live, WL, NW, V, M, P, tid, nt) : 1;
    if (kInstrument) sweeps += passes;

    if (is_ok) {
      // The reference selects among WL static branches, so the slot index
      // clamps into [0, WL).
      const int q = min(max(static_cast<int>(es[e]), 0), WL - 1);
      const uint32_t bit = 1u << q;
      int any = 0;
      for (uint32_t p = tid; p < P; p += nt) {
        const uint32_t m1 = pair_mask(p, q) | bit;
        any |= Fw[m1] != 0u;
        if (NW > 1) any |= Fw[M + m1] != 0u;
      }
      if (__syncthreads_or(any)) {
        for (uint32_t p = tid; p < P; p += nt) {
          const uint32_t m0 = pair_mask(p, q);
          for (int w = 0; w < NW; ++w) {
            const uint32_t base = w * M;
            Fw[base + m0] = Fw[base + (m0 | bit)];
            Fw[base + (m0 | bit)] = 0u;
          }
        }
      } else {
        // No config survives: latch the closure on the row's first
        // failure, then the frontier becomes empty.
        for (uint32_t m = tid; m < NWM; m += nt) {
          if (ok) Fbg[m] = Fw[m];
          Fw[m] = 0u;
        }
        ok = false;
        dead = true;
        first_bad = min(first_bad, idx0 + e);
      }
    }
    __syncthreads();
  }

  if (frontier_in_smem && (ok || Fbg != Fg)) {
    __syncthreads();
    for (uint32_t m = tid; m < NWM; m += nt) Fg[m] = Fw[m];
  }
  if (tid == 0) {
    *valid_p = ok ? 1 : 0;
    *bad_p = first_bad;
    if (kInstrument) *iters_p = sweeps;
  }
}

// Where a warp-tier row's transition table lives (table_form): in device
// memory as given (int32 [K1][V]), staged in shared memory as int8 target
// states [K1][V], or staged as nibble images for V <= 8 at one state word
// ([K1][2][16] uint32: entry [k][n][v] is T_k of the states 4n + b for the
// bits b of v). Either staged form ends with [K1] reach flags.
constexpr int kTableDevice = 0;
constexpr int kTableInt8 = 1;
constexpr int kTableNibble = 2;

// Bytes of one staged transition table, rounded up to 16.
__host__ __device__ __forceinline__ int table_bytes(int K1, int V,
                                                    int form) {
  const int entries = form == kTableNibble ? K1 * 32 * 4 : K1 * V;
  return (entries + K1 + 15) & ~15;
}

// Bytes of one warp's event tile in shared memory: each of its 32
// events' slot offsets into the table.
constexpr int kTileBytes = 32 * kWarpMaxW * 4;

// A target state as the packed rows hold it: -1 where it lies outside
// the packed words (pack_rows drops it).
__device__ __forceinline__ int packed_target(int to, int NW) {
  return (to >= 0 && to < 32 * NW) ? to : -1;
}

// Stage a [K1][V] int32 transition table in the given form at `dst`, with
// threads t0, t0 + nt, ... of the caller's group, and one reach flag per
// kind after it: does any state < V reach a target? A slot whose kind
// reaches none adds nothing to the closure.
__device__ void stage_table(const int32_t* __restrict__ tg, int8_t* dst,
                            int form, int K1, int V, int NW, int t0,
                            int nt) {
  uint8_t* reach;
  if (form == kTableNibble) {
    uint32_t* nib = reinterpret_cast<uint32_t*>(dst);
    for (int x = t0; x < K1 * 32; x += nt) {
      const int k = x >> 5, n = (x >> 4) & 1, v = x & 15;
      uint32_t acc = 0u;
      for (int b = 0; b < 4; ++b) {
        const int s = 4 * n + b;
        const int to =
            s < V && ((v >> b) & 1) ? packed_target(tg[k * V + s], 1) : -1;
        if (to >= 0) acc |= 1u << to;
      }
      nib[x] = acc;
    }
    reach = reinterpret_cast<uint8_t*>(nib + K1 * 32);
  } else {
    for (int x = t0; x < K1 * V; x += nt)
      dst[x] = static_cast<int8_t>(packed_target(tg[x], NW));
    reach = reinterpret_cast<uint8_t*>(dst + K1 * V);
  }
  for (int k = t0; k < K1; k += nt) {
    int r = 0;
    for (int s = 0; s < V; ++s) r |= packed_target(tg[k * V + s], NW) >= 0;
    reach[k] = static_cast<uint8_t>(r);
  }
}

// The raw tile registers of one lane: event e0 + lane's type, slot and
// the kinds of its first WL slots, as loaded (converted at use).
struct Tile {
  int typ;
  int q;
  int kind[kWarpMaxW];
};

__device__ __forceinline__ void load_tile(Tile& t, const int8_t* et,
                                          const int8_t* es,
                                          const void* ev_slots,
                                          long long slots_base, int e,
                                          int N, int Wt, int WL,
                                          int slots_i32) {
  t.typ = 0;
  t.q = 0;
#pragma unroll
  for (int i = 0; i < kWarpMaxW; ++i) t.kind[i] = 0;
  if (e < N) {
    t.typ = et[e];
    t.q = es[e];
    const long long at = slots_base + static_cast<long long>(e) * Wt;
#pragma unroll
    for (int i = 0; i < kWarpMaxW; ++i) {
      if (i < WL) t.kind[i] = load_kind(ev_slots, at + i, slots_i32);
    }
  }
}

// Where a row's transition table lives in the warp tier: staged nibble
// images (nib) or int8 targets (tab) in shared memory, or (both null) the
// int32 table in device memory. image() is T(x) for one slot, `so` its
// kind's offset (k * kstride).
struct WarpTable {
  const uint32_t* nib;
  const int8_t* tab;
  const int32_t* tg;
  int NW;
  int kstride;     // 32 for nibble images, else V
  uint64_t vmask;  // states < V

  __device__ __forceinline__ int target(int so, int s) const {
    if (tab != nullptr) return tab[so + s];
    const int to = __ldg(tg + so + s);
    return to < 32 * NW ? to : -1;
  }
};

template <int NW>
__device__ __forceinline__ void image(const WarpTable& t, int so,
                                      const uint32_t (&x)[NW],
                                      uint32_t (&out)[NW]) {
  if (NW == 1) {
    uint32_t y = x[0] & static_cast<uint32_t>(t.vmask);
    if (t.nib != nullptr) {  // V <= 8: two lookups
      out[0] = t.nib[so + (y & 15u)] | t.nib[so + 16 + (y >> 4)];
      return;
    }
    uint32_t acc = 0u;
    while (y) {
      const int s = __ffs(y) - 1;
      y &= y - 1u;
      const int to = t.target(so, s);
      if (to >= 0) acc |= 1u << to;
    }
    out[0] = acc;
  } else {
    uint64_t y = (x[0] | static_cast<uint64_t>(x[NW - 1]) << 32) & t.vmask;
    uint64_t acc = 0ull;
    while (y) {
      const int s = __ffsll(static_cast<long long>(y)) - 1;
      y &= y - 1ull;
      const int to = t.target(so, s);
      if (to >= 0) acc |= 1ull << to;
    }
    out[0] = static_cast<uint32_t>(acc);
    out[NW - 1] = static_cast<uint32_t>(acc >> 32);
  }
}

// Slot i's step on a warp's register frontier: f[j] holds mask
// lane + 32j. Every mask with bit i takes T_i of its partner without the
// bit: from the lane lane ^ 1<<i (i < 5, a shuffle) or from register
// j ^ JB of the same lane (i >= 5, JB = 1 << (i - 5)). Empty sources are
// skipped: most masks of a wide window are. Returns this lane's
// "something changed".
template <int MPL, int NW>
__device__ __forceinline__ bool apply_low(uint32_t (&f)[MPL][NW],
                                          const WarpTable& t, int so,
                                          uint32_t bit, bool up) {
  bool ch = false;
#pragma unroll
  for (int j = 0; j < MPL; ++j) {
    uint32_t src[NW], n[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w)
      src[w] = __shfl_xor_sync(kFullMask, f[j][w], bit);
    if (up && (src[0] | src[NW - 1])) {
      image<NW>(t, so, src, n);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (n[w] & ~f[j][w]) {
          f[j][w] |= n[w];
          ch = true;
        }
      }
    }
  }
  return ch;
}

template <int JB, int MPL, int NW>
__device__ __forceinline__ bool apply_high(uint32_t (&f)[MPL][NW],
                                           const WarpTable& t, int so) {
  bool ch = false;
  if constexpr (JB < MPL) {
#pragma unroll
    for (int j = 0; j < MPL; ++j) {
      if (!(j & JB) || !(f[j ^ JB][0] | f[j ^ JB][NW - 1])) continue;
      uint32_t n[NW];
      image<NW>(t, so, f[j ^ JB], n);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (n[w] & ~f[j][w]) {
          f[j][w] |= n[w];
          ch = true;
        }
      }
    }
  }
  return ch;
}

// The masks (lanes, at one mask per lane) slot i < 5 reads: those
// without bit i.
__host__ __device__ constexpr uint32_t slot_reads(int i) {
  return i == 0   ? 0x55555555u
         : i == 1 ? 0x33333333u
         : i == 2 ? 0x0F0F0F0Fu
         : i == 3 ? 0x00FF00FFu
                  : 0x0000FFFFu;
}

// Slot i's image at one mask per lane (i a constant where the slot loop
// is unrolled, so that the shuffle's lane mask is an immediate), ORed into
// acc: a lane whose mask has bit i takes T_i of its partner's configs.
// Nibble images take no branch (the image of nothing is entry 0, which is
// empty): a lane that diverges from its warp costs the warp a
// reconvergence on every step.
template <int NW>
__device__ __forceinline__ void pull_low(const uint32_t (&f)[NW],
                                         uint32_t (&acc)[NW],
                                         const WarpTable& t, int so, int i,
                                         int lane) {
  const uint32_t bit = 1u << i;
  const bool up = (lane & bit) != 0u;
  uint32_t src[NW], n[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    src[w] = __shfl_xor_sync(kFullMask, f[w], bit);
    if (t.nib != nullptr) src[w] = up ? src[w] : 0u;
  }
  if (t.nib != nullptr) {
    image<NW>(t, so, src, n);
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] |= n[w];
  } else if (up && (src[0] | src[NW - 1])) {
    image<NW>(t, so, src, n);
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] |= n[w];
  }
}

// OK completion on slot q, moves only: every mask without bit q takes its
// partner with the bit, which is cleared.
template <int JB, int MPL, int NW>
__device__ __forceinline__ void complete_high(uint32_t (&f)[MPL][NW]) {
  if constexpr (JB < MPL) {
#pragma unroll
    for (int j = 0; j < MPL; ++j) {
      if (j & JB) continue;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        f[j][w] = f[j | JB][w];
        f[j | JB][w] = 0u;
      }
    }
  }
}

// One row's walk in the warp tier, by the calling warp, with the
// frontier in registers: lane l holds masks l + 32j, j < MPL (2^W / 32,
// at least 1; lanes past 2^W hold nothing and only ever meet each other).
// `offs` is the warp's event tile in shared memory; `t` the row's table,
// `reach` its reach flags (null when the table is in device memory).
// Fg and Fbg are the row's carry frontiers in device memory, valid_p and
// bad_p its verdict; Fbg may alias Fg (the group entry), and then Fg keeps
// the latched closure of a row that failed.
template <int MPL, int NW>
__device__ void wgl_warp_walk(const int8_t* __restrict__ et,
                              const int8_t* __restrict__ es,
                              const void* __restrict__ ev_slots,
                              long long slots_base, int slots_i32,
                              const WarpTable t, const uint8_t* reach,
                              int* offs, uint32_t* Fg, uint32_t* Fbg,
                              uint8_t* valid_p, int32_t* bad_p, int N,
                              int Wt, int K1, int W, int WL, int idx0) {
  // Slots a window of MPL masks a lane can have: 5 at one mask, then one
  // more per doubling.
  constexpr int kSlots = MPL == 1 ? 5 : MPL == 2 ? 6 : MPL == 4 ? 7 : 8;
  const int lane = threadIdx.x & 31;
  const uint32_t M = 1u << W;

  uint32_t f[MPL][NW];
#pragma unroll
  for (int j = 0; j < MPL; ++j) {
    const uint32_t m = lane + 32u * j;
#pragma unroll
    for (int w = 0; w < NW; ++w) f[j][w] = m < M ? Fg[w * M + m] : 0u;
  }
  bool ok = *valid_p != 0;
  int32_t first_bad = *bad_p;
  bool dead = false;

  Tile next;
  load_tile(next, et, es, ev_slots, slots_base, lane, N, Wt, WL, slots_i32);
  for (int e0 = 0; e0 < N && !dead; e0 += 32) {
    // This tile's lane values: kinds wrap once, clamp into [0, K1), and
    // become row offsets into the table in the warp's tile, with the
    // set of slots whose kind reaches a state.
    const bool live_ev = next.typ == kEvOk || next.typ == kEvFused
                         || next.typ == kEvClose;
    uint32_t live_l = 0u;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i >= WL) continue;
      int k = next.kind[i];
      if (k < 0) k += K1;
      k = min(max(k, 0), K1 - 1);
      offs[lane * kWarpMaxW + i] = k * t.kstride;
      if (reach == nullptr || reach[k]) live_l |= 1u << i;
    }
    __syncwarp();
    // One word per event: its slot's low byte, whether it completes, and
    // the live slots from bit 16.
    const uint32_t word = (static_cast<uint32_t>(next.q) & 0xffu)
                          | (next.typ == kEvOk || next.typ == kEvFused
                                 ? 0x100u : 0u)
                          | live_l << 16;
    load_tile(next, et, es, ev_slots, slots_base, e0 + 32 + lane, N, Wt,
              WL, slots_i32);
    uint32_t pending = __ballot_sync(kFullMask, live_ev);

    while (pending) {
      const int j = __ffs(pending) - 1;
      pending &= pending - 1u;
      const uint32_t ew = __shfl_sync(kFullMask, word, j);
      const uint32_t live = ew >> 16;
      const int* eo = offs + j * kWarpMaxW;

      // Closure. At one mask per lane a step is a few instructions, and
      // the walk's time is their latency. So every live slot steps at
      // once (each unrolled on its slot, the event's table offsets read up
      // front, the steps independent), pulling the images of only the
      // configs that are new since the last sweep (T distributes over
      // union), and skipping a slot that no new config feeds (one with
      // bit i clear). The closure is done when no new config lies where a
      // live slot reads: a ballot, no verification sweep. With more masks
      // per lane a step costs more than its vote: step one slot at a time
      // in place, and a slot again only when another slot has changed the
      // frontier since its last step (a slot's step never feeds itself:
      // it reads masks without its bit only).
      if constexpr (MPL == 1) {
        int so[kSlots];
        uint32_t feeds = 0u;  // lanes (masks) some live slot reads
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          so[i] = (live >> i) & 1u ? eo[i] : 0;
          if ((live >> i) & 1u) feeds |= slot_reads(i);
        }
        uint32_t d[NW];       // this lane's new configs
        bool nz = false;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          d[w] = f[0][w];
          nz |= d[w] != 0u;
        }
        for (uint32_t fresh = __ballot_sync(kFullMask, nz); fresh & feeds;) {
          uint32_t acc[NW];
#pragma unroll
          for (int w = 0; w < NW; ++w) acc[w] = 0u;
#pragma unroll
          for (int i = 0; i < kSlots; ++i)
            if (((live >> i) & 1u) && (fresh & slot_reads(i)))
              pull_low<NW>(d, acc, t, so[i], i, lane);
          nz = false;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            d[w] = acc[w] & ~f[0][w];
            f[0][w] |= acc[w];
            nz |= d[w] != 0u;
          }
          fresh = __ballot_sync(kFullMask, nz);
        }
      } else {
        uint32_t dirty = live;
        int from = 0;
        while (dirty) {
          uint32_t cand = dirty & (~0u << from);
          if (!cand) cand = dirty;
          const int i = __ffs(cand) - 1;
          dirty &= ~(1u << i);
          from = i + 1;
          bool ch;
          if (i < 5)
            ch = apply_low<MPL, NW>(f, t, eo[i], 1u << i, (lane >> i) & 1);
          else if (i == 5)
            ch = apply_high<1, MPL, NW>(f, t, eo[i]);
          else if (i == 6)
            ch = apply_high<2, MPL, NW>(f, t, eo[i]);
          else
            ch = apply_high<4, MPL, NW>(f, t, eo[i]);
          if (__any_sync(kFullMask, ch)) dirty |= live & ~(1u << i);
        }
      }

      if (ew & 0x100u) {
        // The reference selects among WL static branches, so the slot
        // index clamps into [0, WL).
        const int qc = min(max(static_cast<int>(
                                   static_cast<int8_t>(ew & 0xffu)), 0),
                           WL - 1);
        bool any = false;
        if (qc < 5) {
          const uint32_t bit = 1u << qc;
          const bool up = (lane & bit) != 0u;
#pragma unroll
          for (int j2 = 0; j2 < MPL; ++j2)
#pragma unroll
            for (int w = 0; w < NW; ++w) any |= up && f[j2][w] != 0u;
          if (__any_sync(kFullMask, any)) {
#pragma unroll
            for (int j2 = 0; j2 < MPL; ++j2)
#pragma unroll
              for (int w = 0; w < NW; ++w) {
                const uint32_t p = __shfl_xor_sync(kFullMask, f[j2][w], bit);
                f[j2][w] = up ? 0u : p;
              }
            continue;
          }
        } else {
          const int jb = 1 << (qc - 5);
#pragma unroll
          for (int j2 = 0; j2 < MPL; ++j2)
#pragma unroll
            for (int w = 0; w < NW; ++w) any |= (j2 & jb) && f[j2][w] != 0u;
          if (__any_sync(kFullMask, any)) {
            if (jb == 1) complete_high<1, MPL, NW>(f);
            else if (jb == 2) complete_high<2, MPL, NW>(f);
            else complete_high<4, MPL, NW>(f);
            continue;
          }
        }
        // No config survives: latch the closure on the row's first
        // failure; the frontier becomes empty and stays so, and nothing
        // after it can change the row.
#pragma unroll
        for (int j2 = 0; j2 < MPL; ++j2) {
          const uint32_t m = lane + 32u * j2;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            if (ok && m < M) Fbg[w * M + m] = f[j2][w];
            f[j2][w] = 0u;
          }
        }
        ok = false;
        dead = true;
        first_bad = min(first_bad, idx0 + e0 + j);
        break;
      }
    }
  }

  if (ok || Fbg != Fg) {
#pragma unroll
    for (int j = 0; j < MPL; ++j) {
      const uint32_t m = lane + 32u * j;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        if (m < M) Fg[w * M + m] = f[j][w];
    }
  }
  if (lane == 0) {
    *valid_p = ok ? 1 : 0;
    *bad_p = first_bad;
  }
}

// One warp-tier block: rows blk * R + warp of a bucket (B rows), MPL
// masks per lane and NW state words. Shared memory holds R event tiles,
// then the staged table(s): one for the block when the target is shared
// (target_row_stride 0), one per warp otherwise, or none when the table
// stays in device memory (table_form, kTable*).
// (Not inlined: the group entry calls every instantiation, and each keeps
// its own register allocation.)
template <int MPL, int NW>
__device__ __noinline__ void wgl_warp_block(
    const int8_t* ev_type, const int8_t* ev_slot, const void* ev_slots,
    int slots_i32, const int32_t* target, long long target_row_stride,
    uint32_t* F, uint32_t* Fb, uint8_t* valid, int32_t* bad, long long blk,
    int B, int N, int Wt, int K1, int V, int W, int WL, int idx0, int R,
    int table_form) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = blk * R + warp;
  const bool real = warp < R && row < B;
  int8_t* tables = reinterpret_cast<int8_t*>(smem) + R * kTileBytes;
  const int form = table_form;
  const int tb = table_bytes(K1, V, form);
  int8_t* mine = nullptr;
  if (form != kTableDevice) {
    if (target_row_stride == 0) {
      stage_table(target, tables, form, K1, V, NW, threadIdx.x, blockDim.x);
      __syncthreads();
      mine = tables;
    } else if (real) {
      mine = tables + static_cast<long long>(warp) * tb;
      stage_table(target + row * target_row_stride, mine, form, K1, V, NW,
                  lane, 32);
      __syncwarp();
    }
  }
  if (!real) return;
  const int entries = form == kTableNibble ? K1 * 32 * 4 : K1 * V;
  const uint8_t* reach =
      mine != nullptr ? reinterpret_cast<const uint8_t*>(mine) + entries
                      : nullptr;
  const WarpTable t{
      form == kTableNibble ? reinterpret_cast<const uint32_t*>(mine)
                           : nullptr,
      form == kTableInt8 ? mine : nullptr,
      target + row * target_row_stride, NW,
      form == kTableNibble ? 32 : V, V >= 64 ? ~0ull : (1ull << V) - 1ull};
  int* offs = reinterpret_cast<int*>(smem) + warp * (kTileBytes / 4);
  const long long NWM = static_cast<long long>(NW) << W;
  wgl_warp_walk<MPL, NW>(ev_type + row * N, ev_slot + row * N, ev_slots,
                         row * static_cast<long long>(N) * Wt, slots_i32, t,
                         reach, offs, F + row * NWM, Fb + row * NWM,
                         valid + row, bad + row, N, Wt, K1, W, WL, idx0);
}

// Masks per lane of a warp-tier window: 2^W / 32, at least 1.
__host__ __device__ __forceinline__ int warp_mpl(int W) {
  return W <= 5 ? 1 : 1 << (W - 5);
}

// The single-bucket entry's warp tier: one kernel per (MPL, NW), so that
// each gets the registers its frontier needs and no more.
template <int MPL, int NW>
__global__ void __launch_bounds__(kWarpRows * 32, kWarpMinBlocks)
wgl_warp_kernel(const int8_t* __restrict__ ev_type,
                const int8_t* __restrict__ ev_slot,
                const void* __restrict__ ev_slots, int slots_i32,
                const int32_t* __restrict__ target,
                long long target_row_stride, uint32_t* F, uint32_t* Fb,
                uint8_t* valid, int32_t* bad, int B, int N, int Wt, int K1,
                int V, int W, int WL, int idx0, int R, int table_form) {
  wgl_warp_block<MPL, NW>(ev_type, ev_slot, ev_slots, slots_i32, target,
                          target_row_stride, F, Fb, valid, bad, blockIdx.x,
                          B, N, Wt, K1, V, W, WL, idx0, R, table_form);
}

__global__ void wgl_frontier_kernel(
    const int8_t* __restrict__ ev_type, const int8_t* __restrict__ ev_slot,
    const void* __restrict__ ev_slots, int slots_i32,
    const int32_t* __restrict__ target, long long target_row_stride,
    uint32_t* F, uint32_t* Fb, uint8_t* valid, int32_t* bad,
    int N, int Wt, int K1, int V, int NW, int W, int WL, int idx0,
    int frontier_in_smem) {
  const long long row = blockIdx.x;
  const long long NWM = static_cast<long long>(NW) << W;
  wgl_row<false>(ev_type + row * N, ev_slot + row * N, ev_slots,
                 row * static_cast<long long>(N) * Wt, slots_i32,
                 target + row * target_row_stride, F + row * NWM,
                 Fb + row * NWM, valid + row, bad + row, N, Wt, K1, V, NW,
                 W, WL, idx0, frontier_in_smem, nullptr, nullptr);
}

// The instrumented entry: the block tier's body with the pass counter on,
// one block per row; `scratch` ([B][NW][2^W]) is read only when the
// frontier is not in shared memory (then it may not be null).
__global__ void wgl_instrument_kernel(
    const int8_t* __restrict__ ev_type, const int8_t* __restrict__ ev_slot,
    const void* __restrict__ ev_slots, int slots_i32,
    const int32_t* __restrict__ target, long long target_row_stride,
    uint32_t* F, uint32_t* Fb, uint8_t* valid, int32_t* bad,
    uint32_t* scratch, int32_t* iters, int N, int Wt, int K1, int V, int NW,
    int W, int WL, int idx0, int frontier_in_smem) {
  const long long row = blockIdx.x;
  const long long NWM = static_cast<long long>(NW) << W;
  wgl_row<true>(ev_type + row * N, ev_slot + row * N, ev_slots,
                row * static_cast<long long>(N) * Wt, slots_i32,
                target + row * target_row_stride, F + row * NWM,
                Fb + row * NWM, valid + row, bad + row, N, Wt, K1, V, NW, W,
                WL, idx0, frontier_in_smem,
                frontier_in_smem ? nullptr : scratch + row * NWM,
                iters + row);
}

// One member chunk of a group launch. Layout shared with the ctypes
// Structure in ops/cuda_wgl.py: keep the two in step.
struct WglMember {
  const int8_t* ev_type;   // [Bp, N]
  const int8_t* ev_slot;   // [Bp, N]
  const void* ev_slots;    // [Bp, N, Wt] int8 or int32
  const int32_t* target;   // [K1, V] shared or [Bp, K1, V]
  uint32_t* frontier;      // [Bp, NW, 2^W] in: initial carry, out: result
  uint8_t* valid;          // [Bp] in: 1, out: verdict
  int32_t* bad;            // [Bp] in: INT32_MAX, out: first bad event
  long long target_row_stride;  // 0 when shared, else K1 * V
  int slots_i32, N, Wt, K1, V, NW, W, WL;
  int tier;                // kTierWarp or kTierBlock
  int rows_per_block;      // R of the warp tier, 1 in the block tier
  int table_form;          // warp tier: kTableDevice, Int8 or Nibble
  int block_start;         // prefix sum of the blocks before it
  int rows;                // real rows launched (<= Bp)
};

constexpr int kMaxMembers = 8;

struct WglGroup {
  WglMember m[kMaxMembers];
  int n_members;
  int total_blocks;
};

__global__ void __launch_bounds__(kWarpRows * 32, kWarpMinBlocks)
wgl_frontier_group_kernel(const __grid_constant__ WglGroup g) {
  const int b = blockIdx.x;
  int j = 0;
  while (j + 1 < g.n_members && g.m[j + 1].block_start <= b) ++j;
  const WglMember& mb = g.m[j];
  const long long blk = b - mb.block_start;
  if (mb.tier == kTierWarp) {
#define WGL_GROUP_WARP(MPL, NW)                                             \
  wgl_warp_block<MPL, NW>(mb.ev_type, mb.ev_slot, mb.ev_slots,              \
                          mb.slots_i32, mb.target, mb.target_row_stride,    \
                          mb.frontier, mb.frontier, mb.valid, mb.bad, blk,  \
                          mb.rows, mb.N, mb.Wt, mb.K1, mb.V, mb.W, mb.WL,   \
                          0, mb.rows_per_block, mb.table_form)
    const int mpl = warp_mpl(mb.W);
    if (mb.NW == 1) {
      if (mpl == 1) WGL_GROUP_WARP(1, 1);
      else if (mpl == 2) WGL_GROUP_WARP(2, 1);
      else if (mpl == 4) WGL_GROUP_WARP(4, 1);
      else WGL_GROUP_WARP(8, 1);
    } else {
      if (mpl == 1) WGL_GROUP_WARP(1, 2);
      else if (mpl == 2) WGL_GROUP_WARP(2, 2);
      else if (mpl == 4) WGL_GROUP_WARP(4, 2);
      else WGL_GROUP_WARP(8, 2);
    }
#undef WGL_GROUP_WARP
    return;
  }
  const long long NWM = static_cast<long long>(mb.NW) << mb.W;
  uint32_t* Fg = mb.frontier + blk * NWM;
  wgl_row<false>(mb.ev_type + blk * mb.N, mb.ev_slot + blk * mb.N,
                 mb.ev_slots, blk * static_cast<long long>(mb.N) * mb.Wt,
                 mb.slots_i32, mb.target + blk * mb.target_row_stride, Fg,
                 Fg, mb.valid + blk, mb.bad + blk, mb.N, mb.Wt, mb.K1, mb.V,
                 mb.NW, mb.W, mb.WL, 0, 1, nullptr, nullptr);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// Does the warp tier take this window, rows per block and table form?
bool warp_tier_ok(int W, int V, int NW, int R, int form) {
  return W >= 1 && W <= kWarpMaxW && R >= 1 && R <= kWarpRows
         && (form == kTableDevice || form == kTableInt8
             || (form == kTableNibble && NW == 1 && V <= 8));
}

}  // namespace

// One bucket of B rows. tier 0 (warp): ceil(B / R) blocks of `threads` =
// R x 32; tier 1 (block) and 2 (device memory): B blocks of `threads`,
// the frontier in shared memory in tier 1 only.
extern "C" int wgl_frontier_launch(
    const void* ev_type, const void* ev_slot, const void* ev_slots,
    int slots_i32, const void* target, long long target_row_stride,
    void* F, void* Fb, void* valid, void* bad, int B, int N, int Wt, int K1,
    int V, int NW, int W, int WL, int idx0, int tier, int rows_per_block,
    int table_form, int threads, int smem_bytes, void* stream) {
  const auto* et = static_cast<const int8_t*>(ev_type);
  const auto* es = static_cast<const int8_t*>(ev_slot);
  const auto* tg = static_cast<const int32_t*>(target);
  auto* f = static_cast<uint32_t*>(F);
  auto* fb = static_cast<uint32_t*>(Fb);
  auto* v = static_cast<uint8_t*>(valid);
  auto* bd = static_cast<int32_t*>(bad);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tier == kTierWarp) {
    if (!warp_tier_ok(W, V, NW, rows_per_block, table_form)
        || threads != 32 * rows_per_block)
      return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (B + rows_per_block - 1) / rows_per_block;
    const int mpl = warp_mpl(W);
    auto kernel = wgl_warp_kernel<1, 1>;
    if (NW == 1) {
      kernel = mpl == 1   ? wgl_warp_kernel<1, 1>
               : mpl == 2 ? wgl_warp_kernel<2, 1>
               : mpl == 4 ? wgl_warp_kernel<4, 1>
                          : wgl_warp_kernel<8, 1>;
    } else {
      kernel = mpl == 1   ? wgl_warp_kernel<1, 2>
               : mpl == 2 ? wgl_warp_kernel<2, 2>
               : mpl == 4 ? wgl_warp_kernel<4, 2>
                          : wgl_warp_kernel<8, 2>;
    }
    const cudaError_t e = allow_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<blocks, threads, smem_bytes, st>>>(
        et, es, ev_slots, slots_i32, tg, target_row_stride, f, fb, v, bd, B,
        N, Wt, K1, V, W, WL, idx0, rows_per_block, table_form);
  } else {
    const cudaError_t e = allow_smem(wgl_frontier_kernel, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    wgl_frontier_kernel<<<B, threads, smem_bytes, st>>>(
        et, es, ev_slots, slots_i32, tg, target_row_stride, f, fb, v, bd, N,
        Wt, K1, V, NW, W, WL, idx0, tier == kTierBlock ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instrumented entry over B rows: B blocks of `threads`, the frontier
// and its scratch copy in shared memory when frontier_in_smem, else both
// in device memory (F and `scratch`); iters[b] gets row b's closure
// passes over these N events.
extern "C" int wgl_frontier_instrument_launch(
    const void* ev_type, const void* ev_slot, const void* ev_slots,
    int slots_i32, const void* target, long long target_row_stride,
    void* F, void* Fb, void* valid, void* bad, void* scratch, void* iters,
    int B, int N, int Wt, int K1, int V, int NW, int W, int WL, int idx0,
    int frontier_in_smem, int threads, int smem_bytes, void* stream) {
  if (!frontier_in_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(wgl_instrument_kernel, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgl_instrument_kernel<<<B, threads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ev_type),
      static_cast<const int8_t*>(ev_slot), ev_slots, slots_i32,
      static_cast<const int32_t*>(target), target_row_stride,
      static_cast<uint32_t*>(F), static_cast<uint32_t*>(Fb),
      static_cast<uint8_t*>(valid), static_cast<int32_t*>(bad),
      static_cast<uint32_t*>(scratch), static_cast<int32_t*>(iters), N, Wt,
      K1, V, NW, W, WL, idx0, frontier_in_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgl_frontier_group_launch(const void* group, int threads,
                                         int smem_bytes, void* stream) {
  const WglGroup* g = static_cast<const WglGroup*>(group);
  if (g->n_members < 1 || g->n_members > kMaxMembers
      || threads != 32 * kWarpRows)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < g->n_members; ++j) {
    const WglMember& mb = g->m[j];
    if (mb.tier == kTierWarp
        && !warp_tier_ok(mb.W, mb.V, mb.NW, mb.rows_per_block,
                         mb.table_form))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = allow_smem(wgl_frontier_group_kernel, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (g->total_blocks > 0) {
    wgl_frontier_group_kernel<<<g->total_blocks, threads, smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(*g);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgl_frontier_group_desc_bytes() {
  return static_cast<int>(sizeof(WglGroup));
}

// The warp tier's compiled limits: kWarpMaxW, kWarpRows.
extern "C" int wgl_frontier_warp_limits(int* max_w, int* rows) {
  *max_w = kWarpMaxW;
  *rows = kWarpRows;
  return 0;
}

extern "C" const char* wgl_frontier_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
