// wgl_frontier.cu — the packed-frontier Wing–Gong linearizability search
// for Hopper (sm_90a), in tiers by window width.
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
//   * The wide tiers, W > W_warp, a delta closure over groups of 32 masks
//     (wgl_wide_row below, where the design is set out):
//       - block tier, W <= 15 (14 at two state words): one block a row,
//         the frontier in its shared memory;
//       - cluster tier, W = 16..18 (15..17 at two words): a thread-block
//         cluster of 2, 4 or 8 CTAs a row, the frontier split over their
//         shared memory by its top mask bits, a step on a top slot bit
//         reaching the partner CTA's words through distributed shared
//         memory;
//       - device-memory tier, W = 18 at two words: one block a row, the
//         frontier in the row's slice of the output tensor.
//     They replace the first block and device-memory tiers, which swept every
//     mask pair of every live slot per pass with a block barrier after
//     each slot, confirmed the fixpoint with one more whole pass,
//     re-staged the event's transition rows every event, and past one
//     block's shared memory (W 16 at one word, 15 at two) walked a
//     frontier in device memory.
//
// The instrumented entry (wgl_frontier_instrument_launch) replaces the
// fourth output of make_kernel(instrument=True)
// (jepsen_tpu/ops/linearize.py:158, :243): each row's closure while_loop
// passes, summed over EVERY event of its event axis. That count depends
// on the reference's schedule: a pass applies slots 0..WL-1 in place, in
// that order, then tests the whole frontier for a change, and the last
// pass (which changes nothing) counts. The warp tier and the delta
// closure propagate only new configurations and skip pads, so neither
// counts it; the entry runs the same tiers' layouts with a counting
// closure instead (count_closure, count_block_closure), which steps the
// live slots in that order, skipping a slot whose step cannot change the
// frontier, and votes after each step it takes:
//   * W <= W_warp: wgl_count_walk, a warp a row with the frontier in
//     registers, the table staged once a row or block and events in
//     32-event tiles, as the warp tier;
//   * W > W_warp: wgl_count_block_kernel, a block a row, mask bits split
//     over lanes, warps and each thread's own masks, the table staged
//     once a row, the frontier and its pad copy in shared memory or in
//     device memory.
// A pad event's closure runs on a copy of the frontier and is dropped; a
// closure whose slots reach no state counts one pass; a failed row's
// every later event counts one (the closure of its empty frontier). Its
// valid, bad and frontier are K1's, bit for bit. What bounds it: as K1,
// each event's chain of dependent slot steps and votes, one slot after
// another (PERF.md has the measured times).
//
// The group entry (wgl_frontier_group_kernel) replaces the TPU dispatch
// group jepsen_tpu/ops/linearize.py::make_fused_kernel: one XLA call that
// scans several class buckets of different shapes back to back. Here it is
// one launch over up to kMaxMembers member chunks (different V, W, w_live,
// event lengths, slot dtypes, shared or per-row targets). Each member has
// a tier and a block count (ceil(rows / R) in the warp tier, one block per
// row in the block tier, which runs the wide delta closure); block b finds
// its member by scanning the members' block prefix sums in a
// __grid_constant__ descriptor. Blocks are kWarpRows x 32 threads for
// every member, and shared memory is the largest member's need. What it
// saves is launches, not work: the scheduler's many small chunks stop
// paying a launch and a host round trip each. The scheduler ships a
// member that needs the cluster or device-memory tier alone. A
// row's latched pre-failure closure is written straight into its frontier
// output, which therefore holds the check form's where(valid, F, Fb) when
// the row ends. Padding rows of a member are not launched: their outputs
// arrive pre-filled as the plain version leaves an all-EV_PAD row.
//
// Why the updates are race-free. Applying slot i reads only masks without
// bit i and writes only masks with bit i: in the warp tier a lane updates
// only its own registers from a shuffled copy of its partner's, in the
// instrumented entry's block tier a thread updates only its own masks,
// with a barrier between slots whose partners lie in other warps (a warp
// barrier between the others), and the wide tiers OR into destinations atomically. The closure is a
// monotone OR to a unique least fixpoint, so the order of slots, lanes
// and pushes does not change Fc. Completion moves each pair's upper word
// down and clears it.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEvOk = 2;
constexpr int kEvClose = 3;
constexpr int kEvFused = 4;

// Tiers, as ops/cuda_wgl.py numbers them.
constexpr int kTierWarp = 0;
constexpr int kTierBlock = 1;
constexpr int kTierDevice = 2;
constexpr int kTierCluster = 3;

// Widest window the warp tier's per-lane slot registers hold, and the most
// rows (warps) one warp-tier block walks.
constexpr int kWarpMaxW = 8;
constexpr int kWarpRows = 8;
// Blocks of kWarpRows warps an SM should hold at once: caps a warp-tier
// kernel at 64 registers a thread (32 warps an SM).
constexpr int kWarpMinBlocks = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int load_kind(const void* slots, long long at,
                                         int slots_i32) {
  return slots_i32 ? static_cast<const int32_t*>(slots)[at]
                   : static_cast<const int8_t*>(slots)[at];
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

// OK completion on slot qc (already clamped into [0, WL)) of a warp's
// register frontier. When some mask with bit qc holds a config, every mask
// without the bit takes its partner's words, the partner is cleared, and
// it returns true; when no config survives it returns false and changes
// nothing. Warp-uniform.
template <int MPL, int NW>
__device__ __forceinline__ bool warp_complete(uint32_t (&f)[MPL][NW],
                                              int qc, int lane) {
  bool any = false;
  if (qc < 5) {
    const uint32_t bit = 1u << qc;
    const bool up = (lane & bit) != 0u;
#pragma unroll
    for (int j = 0; j < MPL; ++j)
#pragma unroll
      for (int w = 0; w < NW; ++w) any |= up && f[j][w] != 0u;
    if (!__any_sync(kFullMask, any)) return false;
#pragma unroll
    for (int j = 0; j < MPL; ++j)
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t p = __shfl_xor_sync(kFullMask, f[j][w], bit);
        f[j][w] = up ? 0u : p;
      }
    return true;
  }
  const int jb = 1 << (qc - 5);
#pragma unroll
  for (int j = 0; j < MPL; ++j)
#pragma unroll
    for (int w = 0; w < NW; ++w) any |= (j & jb) && f[j][w] != 0u;
  if (!__any_sync(kFullMask, any)) return false;
  if (jb == 1) complete_high<1, MPL, NW>(f);
  else if (jb == 2) complete_high<2, MPL, NW>(f);
  else complete_high<4, MPL, NW>(f);
  return true;
}

// A row's first failure: its pre-completion closure is latched into Fbg
// (when the row was still valid), and the register frontier is emptied.
template <int MPL, int NW>
__device__ __forceinline__ void warp_latch(uint32_t (&f)[MPL][NW],
                                           uint32_t* Fbg, bool ok,
                                           uint32_t M, int lane) {
#pragma unroll
  for (int j = 0; j < MPL; ++j) {
    const uint32_t m = lane + 32u * j;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (ok && m < M) Fbg[w * M + m] = f[j][w];
      f[j][w] = 0u;
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
        if (warp_complete<MPL, NW>(f, qc, lane)) continue;
        // No config survives: latch the closure on the row's first
        // failure; the frontier becomes empty and stays so, and nothing
        // after it can change the row.
        warp_latch<MPL, NW>(f, Fbg, ok, M, lane);
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

// ---- The instrumented entry's counting closure.
//
// The reference's closure, as make_kernel(instrument=True) counts it: a
// pass applies slots 0 .. WL-1 in place, in that order (a later slot sees
// what an earlier one added in the same pass), and ends with one change
// test over the whole frontier; the passes are counted up to and
// including the first that changes nothing. Applying slot i reads only
// masks without bit i and writes only masks with it, so one slot's step
// is the same whether its masks step at once or one by one: only the
// order of the slots matters.
//
// A step that cannot change the frontier may be skipped without changing
// what any later step sees, or the count. Slot i's step cannot when the
// frontier is closed under its kind: its kind reaches no state; or no
// step changed the frontier since slot i's own last step (a step never
// feeds itself); or, at the closure's start, its kind is the one it had
// at the row's last live event, whose closure (and completion, but for
// the freed slot) left the frontier closed under it. So each slot is
// stepped only while it is dirty, and a step that changes something
// (one vote) marks the other live slots dirty.

// One closure of a warp's register frontier x, counted: returns its
// passes (at least 1). `so` holds the event's slot offsets into the
// table, `live` its slots whose kind reaches a state, `dirty` (within
// live) those whose steps may change x. Warp-uniform.
template <int MPL, int NW, int kSlots>
__device__ __forceinline__ int count_closure(uint32_t (&x)[MPL][NW],
                                             const WarpTable& t,
                                             const int (&so)[kSlots],
                                             uint32_t live, uint32_t dirty,
                                             int lane) {
  int passes = 1;
  while (dirty) {
    bool changed = false;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (!((dirty >> i) & 1u)) continue;
      dirty &= ~(1u << i);
      bool ch;
      if (i < 5)
        ch = apply_low<MPL, NW>(x, t, so[i], 1u << i, (lane >> i) & 1);
      else if (i == 5)
        ch = apply_high<1, MPL, NW>(x, t, so[i]);
      else if (i == 6)
        ch = apply_high<2, MPL, NW>(x, t, so[i]);
      else
        ch = apply_high<4, MPL, NW>(x, t, so[i]);
      if (__any_sync(kFullMask, ch)) {
        dirty |= live & ~(1u << i);
        changed = true;
      }
    }
    if (!changed) break;
    ++passes;
  }
  return passes;
}

// The instrumented entry's warp tier (W <= W_warp): wgl_warp_walk's row
// walk, with its frontier registers, 32-event tiles, staged table and
// completion, but each event's closure run as the reference schedules it
// (count_closure) and every event of the row counted into *iters_p:
//   * a pad event (EV_PAD) closes a register copy of the frontier, adds
//     its passes and drops it; one whose slots reach no state counts one
//     pass without a walk (a ballot per tile finds them);
//   * EV_CLOSE keeps its closure, an OK completes it;
//   * a row that fails stops walking: every later event closes an empty
//     frontier, one pass each, added in one step.
template <int MPL, int NW>
__device__ void wgl_count_walk(const int8_t* __restrict__ et,
                               const int8_t* __restrict__ es,
                               const void* __restrict__ ev_slots,
                               long long slots_base, int slots_i32,
                               const WarpTable t, const uint8_t* reach,
                               int* offs, uint32_t* Fg, uint32_t* Fbg,
                               uint8_t* valid_p, int32_t* bad_p,
                               int32_t* iters_p, int N, int Wt, int K1,
                               int W, int WL, int idx0) {
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
  int32_t passes = 0;
  // Lane i < WL: slot i's table offset at the row's last live event, -1
  // while the frontier is not known to be closed under slot i.
  int closed = -1;

  Tile next;
  load_tile(next, et, es, ev_slots, slots_base, lane, N, Wt, WL, slots_i32);
  for (int e0 = 0; e0 < N; e0 += 32) {
    const bool in_row = e0 + lane < N;
    const bool is_ok = next.typ == kEvOk || next.typ == kEvFused;
    const bool live_ev = is_ok || next.typ == kEvClose;
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
    // One word per event: its slot's low byte, whether it completes,
    // whether it is live (not a pad), and its live slots from bit 16.
    const uint32_t word = (static_cast<uint32_t>(next.q) & 0xffu)
                          | (is_ok ? 0x100u : 0u) | (live_ev ? 0x200u : 0u)
                          | live_l << 16;
    load_tile(next, et, es, ev_slots, slots_base, e0 + 32 + lane, N, Wt,
              WL, slots_i32);
    const uint32_t walk =
        __ballot_sync(kFullMask, in_row && (live_ev || live_l != 0u));
    // Pads whose slots reach no state: one pass each.
    const uint32_t quiet = __ballot_sync(kFullMask, in_row) & ~walk;
    passes += __popc(quiet);

    bool failed = false;
    for (uint32_t pend = walk; pend;) {
      const int j = __ffs(pend) - 1;
      pend &= pend - 1u;
      const uint32_t ew = __shfl_sync(kFullMask, word, j);
      const uint32_t live = ew >> 16;
      int so[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        so[i] = (live >> i) & 1u ? offs[j * kWarpMaxW + i] : 0;
      const int mine = lane < WL ? offs[j * kWarpMaxW + lane] : -1;
      const uint32_t dirty = live & __ballot_sync(kFullMask, mine != closed);
      uint32_t x[MPL][NW];
#pragma unroll
      for (int j2 = 0; j2 < MPL; ++j2)
#pragma unroll
        for (int w = 0; w < NW; ++w) x[j2][w] = f[j2][w];
      passes += count_closure<MPL, NW, kSlots>(x, t, so, live, dirty, lane);
      if (!(ew & 0x200u)) continue;   // a pad: its closure is dropped
#pragma unroll
      for (int j2 = 0; j2 < MPL; ++j2)
#pragma unroll
        for (int w = 0; w < NW; ++w) f[j2][w] = x[j2][w];
      closed = mine;
      if (!(ew & 0x100u)) continue;   // EV_CLOSE keeps the closure
      // The reference selects among WL static branches, so the slot
      // index clamps into [0, WL).
      const int qc = min(max(static_cast<int>(
                                 static_cast<int8_t>(ew & 0xffu)), 0),
                         WL - 1);
      if (warp_complete<MPL, NW>(f, qc, lane)) {
        if (lane == qc) closed = -1;   // the freed slot is not closed
        continue;
      }
      warp_latch<MPL, NW>(f, Fbg, ok, M, lane);
      ok = false;
      first_bad = min(first_bad, idx0 + e0 + j);
      // Every later event closes the empty frontier in one pass; this
      // tile's quiet events past j are counted already.
      passes += N - 1 - (e0 + j) - __popc(quiet & (~1u << j));
      failed = true;
      break;
    }
    if (failed) break;
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
    *iters_p = passes;
  }
}

// One warp-tier block: rows blk * R + warp of a bucket (B rows), MPL
// masks per lane and NW state words. Shared memory holds R event tiles,
// then the staged table(s): one for the block when the target is shared
// (target_row_stride 0), one per warp otherwise, or none when the table
// stays in device memory (table_form, kTable*). kCount walks the rows
// with the instrumented entry's counting closure (wgl_count_walk), each
// row's passes into iters[row].
// (Not inlined: the group entry calls every instantiation, and each keeps
// its own register allocation.)
template <int MPL, int NW, bool kCount>
__device__ __noinline__ void wgl_warp_block(
    const int8_t* ev_type, const int8_t* ev_slot, const void* ev_slots,
    int slots_i32, const int32_t* target, long long target_row_stride,
    uint32_t* F, uint32_t* Fb, uint8_t* valid, int32_t* bad, int32_t* iters,
    long long blk, int B, int N, int Wt, int K1, int V, int W, int WL,
    int idx0, int R, int table_form) {
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
  if constexpr (kCount) {
    wgl_count_walk<MPL, NW>(ev_type + row * N, ev_slot + row * N, ev_slots,
                            row * static_cast<long long>(N) * Wt, slots_i32,
                            t, reach, offs, F + row * NWM, Fb + row * NWM,
                            valid + row, bad + row, iters + row, N, Wt, K1,
                            W, WL, idx0);
  } else {
    wgl_warp_walk<MPL, NW>(ev_type + row * N, ev_slot + row * N, ev_slots,
                           row * static_cast<long long>(N) * Wt, slots_i32,
                           t, reach, offs, F + row * NWM, Fb + row * NWM,
                           valid + row, bad + row, N, Wt, K1, W, WL, idx0);
  }
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
  wgl_warp_block<MPL, NW, false>(ev_type, ev_slot, ev_slots, slots_i32,
                                 target, target_row_stride, F, Fb, valid,
                                 bad, nullptr, blockIdx.x, B, N, Wt, K1, V,
                                 W, WL, idx0, R, table_form);
}

// ---- The wide tiers (W > W_warp): a delta closure over mask groups.
//
// A row's mask axis is cut into groups of 32 masks (one word of each
// bitmap below, one lane a mask), and, in the cluster tier, split by its
// top `clog` bits over the 2^clog CTAs of a thread-block cluster: CTA
// `rank` holds the masks rank·Ml .. rank·Ml + Ml - 1 (Ml = 2^(W - clog))
// in its shared memory, as [NW][Ml] words. Beside the frontier each CTA
// keeps three bitmaps of one word per group: NZ (masks whose words are
// not empty) and D[0], D[1] (masks whose words changed in the last
// round, read and written by alternate rounds).
//
// The closure of an event runs in rounds, one barrier (a cluster barrier
// when clog > 0) each. A round expands only source masks that are dirty:
// the warps take the CTA's groups a few at a time from a shared counter
// (the dirty masks gather unevenly, and a warp that owned a fixed share
// left the others waiting at the barrier), read and clear their bitmap
// words, and for each dirty group expand its dirty masks' words under
// each slot of the round's set,
// OR-ing the images into the destination masks (atomicOr, in its own
// shared memory, or in the partner CTA's through distributed shared
// memory for a top slot bit) and marking the destinations that gained a
// configuration in the next round's bitmap and in NZ. The closure ends
// after the first round that adds nothing: no confirming sweep, and no
// visit to a group that did not change. Round 0 takes its sources from
// NZ (every configuration) but applies only the slots whose kind changed
// since the row's previous live event (all slots at the launch's first
// one, and the slot an OK just freed): the frontier is already closed
// under every other slot, because closure and completion both keep it
// so. The closure is a monotone OR to a unique least fixpoint, so the
// order of the pushes, and whether a read sees a push of the same round,
// cannot change Fc: a source whose words grow in a round is dirty for the
// next one.
//
// Each warp votes "something changed" and, on an OK event, "a mask with
// bit q is not empty" (from NZ, which is exact once a round adds
// nothing) by stamping a per-round flag in every CTA of the cluster; the
// barrier then makes both votes cluster-uniform, so every CTA takes the
// same path. Completion is two dense passes over the CTA's masks with a
// barrier between: masks without bit q take their partner's words (from
// the partner CTA when q is a top bit), recomputing NZ, then masks with
// bit q are cleared. The row's transition table is staged once per row
// (int8 targets and reach flags, as the warp tier's int8 form) where it
// fits, else read from device memory; event types, slots and wrapped,
// clamped kinds are staged 32 events at a time.
//
// Tiers (ops/cuda_wgl.py smem_plan picks one per bucket): block, clog 0,
// the frontier in one block's shared memory; cluster, clog 1..3, the
// frontier split over 2..8 CTAs' shared memory; device, clog 0, the
// frontier in the row's slice of the output tensor (two state words at
// W 18) with the bitmaps in shared memory.
//
// What bounds it. At the dc headline's shapes (W 11-16, V 32-56) a row's
// closure needs 10^4-10^6 integer operations an event, most of them
// chains of dependent shared-memory lookups (a set bit of a word at a
// time), against a round's barrier and, per dirty group and slot, a
// shuffle, the lookups, two atomics and a vote: the walk is bound by that
// latency, hidden only by the rows running beside it, not by bytes or the
// integer rate (PERF.md §6 has the measured gap).

// Events staged per tile, the widest window the wide tiers take, and the
// most warps of a wide block.
constexpr int kWideTile = 32;
constexpr int kWideMaxW = 18;
constexpr int kWideMaxWarps = 32;
constexpr int kWideMaxClusterLog = 3;
// Groups a warp takes at a time from its CTA's round counter.
constexpr int kWideGrab = 4;

namespace cg = cooperative_groups;

__device__ __forceinline__ void wide_sync(int clog) {
  if (clog > 0) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// A pointer into CTA `rank`'s shared memory at the same offset as `p` in
// this CTA's (a cluster launch only).
template <typename T>
__device__ __forceinline__ T* on_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// Words of shared memory a wide-tier CTA keeps besides its frontier and
// table: three bitmaps of Gl words, the event tile, the vote flags and
// the two rounds' group counters.
__host__ __device__ __forceinline__ int wide_fixed_words(int Gl) {
  return 3 * Gl + kWideTile * kWideMaxW + 2 * kWideTile + 6;
}

// Expand dirty group g (bits `dbits` of its 32 masks) under the slots of
// `slots`: each lane's mask pushes T_i of its words to its partner with
// bit i. Returns "some destination gained a configuration" (warp-
// uniform). `so_lane` holds, at lane i, slot i's table offset.
template <int NW>
__device__ __forceinline__ bool wide_group(uint32_t* Fl, uint32_t* NZ,
                                           uint32_t* nxt, int g,
                                           uint32_t dbits, uint32_t slots,
                                           int so_lane, const WarpTable& t,
                                           int Wl, uint32_t Ml, int rank,
                                           int lane) {
  const uint32_t m = static_cast<uint32_t>(g) * 32u + lane;
  const bool mine = (dbits >> lane) & 1u;
  uint32_t x[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) x[w] = mine ? Fl[w * Ml + m] : 0u;
  const bool has = mine && (x[0] | x[NW - 1]) != 0u;
  bool changed = false;
  for (uint32_t sl = slots; sl;) {
    const int i = __ffs(sl) - 1;
    sl &= sl - 1u;
    const int so = __shfl_sync(kFullMask, so_lane, i);
    uint32_t* dF = Fl;
    uint32_t* dD = nxt;
    uint32_t* dNZ = NZ;
    uint32_t dm = m;
    int dg = g;
    int up = 0;             // destination lane - source lane
    bool src = has;
    if (i < 5) {
      const uint32_t bit = 1u << i;
      if (!(dbits & slot_reads(i))) continue;
      src = has && !(lane & bit);
      dm = m | bit;
      up = static_cast<int>(bit);
    } else if (i < Wl) {
      const int J = 1 << (i - 5);
      if (g & J) continue;
      dg = g | J;
      dm = static_cast<uint32_t>(dg) * 32u + lane;
    } else {
      const int rb = 1 << (i - Wl);
      if (rank & rb) continue;
      const int pr = rank | rb;
      dF = on_rank(Fl, pr);
      dD = on_rank(nxt, pr);
      dNZ = on_rank(NZ, pr);
    }
    bool c = false;
    if (src) {
      uint32_t n[NW];
      image<NW>(t, so, x, n);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t* at = dF + w * Ml + dm;
        if (n[w] & ~*at) c |= (n[w] & ~atomicOr(at, n[w])) != 0u;
      }
    }
    const uint32_t b = __ballot_sync(kFullMask, c) << up;
    if (b) {
      changed = true;
      if (lane == 0) {
        atomicOr(dD + dg, b);
        atomicOr(dNZ + dg, b);
      }
    }
  }
  return changed;
}

// The masks of local group g that have bit q (the OK's slot), as a lane
// bitmap.
__device__ __forceinline__ uint32_t q_lanes(int q, int g, int Wl,
                                            int rank) {
  if (q < 5) return ~slot_reads(q);
  if (q < Wl) return (g >> (q - 5)) & 1 ? kFullMask : 0u;
  return (rank >> (q - Wl)) & 1 ? kFullMask : 0u;
}

// One row's walk in a wide tier by one CTA (of 2^clog, this one `rank`).
// `et`, `es` and `ev_slots` are the row's event tables (its slot table at
// element offset `slots_base`, Wt entries per event), `tg` its [K1][V]
// transition table, valid_p and bad_p its verdict; Fg and Fbg are the
// row's whole [NW][2^W] carry frontiers. `table_staged` stages the int8 table in shared memory (else
// it is read from device memory, every slot counted live).
template <int NW>
__device__ __noinline__ void wgl_wide_row(
    const int8_t* __restrict__ et, const int8_t* __restrict__ es,
    const void* __restrict__ ev_slots, long long slots_base, int slots_i32,
    const int32_t* __restrict__ tg, uint32_t* Fg, uint32_t* Fbg,
    uint8_t* valid_p, int32_t* bad_p, int N, int Wt, int K1, int V, int W,
    int WL, int idx0, int clog, int rank, int frontier_in_smem,
    int table_staged) {
  extern __shared__ uint32_t smem[];
  const int C = 1 << clog;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int Wl = W - clog;
  const uint32_t Ml = 1u << Wl;
  const uint32_t M = 1u << W;
  const uint32_t off = static_cast<uint32_t>(rank) * Ml;  // first mask
  const int Gl = static_cast<int>(Ml >> 5);

  uint32_t* cur = smem;
  uint32_t* Fl = frontier_in_smem ? cur : Fg;   // [NW][Ml]
  if (frontier_in_smem) cur += NW * Ml;
  uint32_t* NZ = cur;
  uint32_t* Dbuf = cur + Gl;                    // D[0], D[1]
  cur += 3 * Gl;
  int* tk = reinterpret_cast<int*>(cur);        // [kWideTile][kWideMaxW]
  int* ttyp = tk + kWideTile * kWideMaxW;
  int* tq = ttyp + kWideTile;
  int* flags = tq + kWideTile;                  // [parity][change, any]
  int* grab = flags + 4;                        // [parity] next group
  int8_t* tab = reinterpret_cast<int8_t*>(flags + 6);

  if (table_staged) stage_table(tg, tab, kTableInt8, K1, V, NW, tid, nt);
  const uint8_t* reach =
      table_staged ? reinterpret_cast<const uint8_t*>(tab) + K1 * V
                   : nullptr;
  const WarpTable t{nullptr, table_staged ? tab : nullptr, tg, NW, V,
                    V >= 64 ? ~0ull : (1ull << V) - 1ull};

  if (frontier_in_smem) {
    for (int w = 0; w < NW; ++w)
      for (uint32_t m = tid; m < Ml; m += nt)
        Fl[w * Ml + m] = Fg[static_cast<long long>(w) * M + off + m];
  }
  for (int x = tid; x < 2 * Gl; x += nt) Dbuf[x] = 0u;
  if (tid < 6) flags[tid] = tid < 4 ? -1 : 0;
  __syncthreads();
  for (int g = warp; g < Gl; g += nwarps) {
    const uint32_t m = static_cast<uint32_t>(g) * 32u + lane;
    bool nz = false;
#pragma unroll
    for (int w = 0; w < NW; ++w) nz |= Fl[w * Ml + m] != 0u;
    const uint32_t b = __ballot_sync(kFullMask, nz);
    if (lane == 0) NZ[g] = b;
  }
  // Every CTA's bitmaps and flags are set before any CTA pushes.
  wide_sync(clog);

  bool ok = *valid_p != 0;
  int32_t first_bad = *bad_p;
  bool dead = false;
  int prevk = -1;       // lane i: slot i's kind at the last live event
  int stamp = 0;        // rounds so far, cluster-uniform

  for (int e0 = 0; e0 < N && !dead; e0 += kWideTile) {
    const int ne = min(kWideTile, N - e0);
    __syncthreads();    // the last tile is consumed
    for (int x = tid; x < ne * WL; x += nt) {
      const int ev = x / WL;
      const int i = x - ev * WL;
      int k = load_kind(ev_slots,
                        slots_base + static_cast<long long>(e0 + ev) * Wt
                            + i, slots_i32);
      if (k < 0) k += K1;
      tk[ev * kWideMaxW + i] = min(max(k, 0), K1 - 1);
    }
    for (int x = tid; x < ne; x += nt) {
      ttyp[x] = et[e0 + x];
      tq[x] = es[e0 + x];
    }
    __syncthreads();

    for (int j = 0; j < ne; ++j) {
      const int typ = ttyp[j];
      const bool is_ok = typ == kEvOk || typ == kEvFused;
      if (!is_ok && typ != kEvClose) continue;   // EV_PAD: a no-op
      const int k = lane < WL ? tk[j * kWideMaxW + lane] : 0;
      const bool lv = lane < WL && (reach == nullptr || reach[k]);
      const uint32_t live = __ballot_sync(kFullMask, lv);
      const uint32_t fresh =
          live & __ballot_sync(kFullMask, lane < WL && k != prevk);
      if (lane < WL) prevk = k;
      const int so_lane = k * V;
      // The reference selects among WL static branches, so the slot
      // index clamps into [0, WL).
      const int q = min(max(tq[j], 0), WL - 1);

      bool any_q = false;
      for (int r = 0;; ++r) {
        ++stamp;
        const uint32_t slots = r == 0 ? fresh : live;
        uint32_t* src = r == 0 ? NZ : Dbuf + (r & 1) * Gl;
        uint32_t* nxt = Dbuf + ((r + 1) & 1) * Gl;
        bool wch = false, wany = false;
        // Warps take kWideGrab groups at a time from this round's counter
        // (the next round's is reset meanwhile: its last use ended at the
        // previous barrier), so a warp whose groups changed little helps
        // the others instead of waiting at the barrier.
        int* gc = grab + (stamp & 1);
        if (tid == 0) grab[(stamp + 1) & 1] = 0;
        for (;;) {
          int gb = 0;
          if (lane == 0) gb = atomicAdd(gc, kWideGrab);
          gb = __shfl_sync(kFullMask, gb, 0);
          if (gb >= Gl) break;
          const int gl = gb + lane;
          uint32_t word = 0u;
          if (lane < kWideGrab && gl < Gl) {
            word = src[gl];
            if (r > 0 && word) src[gl] = 0u;
            if (is_ok) wany |= (NZ[gl] & q_lanes(q, gl, Wl, rank)) != 0u;
          }
          if (!slots) continue;
          for (uint32_t pend = __ballot_sync(kFullMask, word != 0u); pend;) {
            const int jl = __ffs(pend) - 1;
            pend &= pend - 1u;
            const uint32_t dbits = __shfl_sync(kFullMask, word, jl);
            wch |= wide_group<NW>(Fl, NZ, nxt, gb + jl, dbits, slots,
                                  so_lane, t, Wl, Ml, rank, lane);
          }
        }
        const bool vch = __any_sync(kFullMask, wch);
        const bool vany = __any_sync(kFullMask, wany);
        int* fl = flags + 2 * (stamp & 1);
        if (lane == 0 && (vch || vany)) {
          for (int c = 0; c < C; ++c) {
            volatile int* to = clog > 0 ? on_rank(fl, c) : fl;
            if (vch) to[0] = stamp;
            if (vany) to[1] = stamp;
          }
        }
        wide_sync(clog);
        const volatile int* seen = fl;
        if (seen[0] != stamp) {
          any_q = seen[1] == stamp;
          break;
        }
      }
      if (!is_ok) continue;

      if (any_q) {
        // Masks without bit q take their partner's words, then masks
        // with bit q are cleared; NZ follows.
        const uint32_t qb = 1u << q;
        const uint32_t* P = Fl;
        if (q >= Wl && !((rank >> (q - Wl)) & 1))
          P = on_rank(Fl, rank | (1 << (q - Wl)));
        for (int g = warp; g < Gl; g += nwarps) {
          const uint32_t m = static_cast<uint32_t>(g) * 32u + lane;
          const bool has_q = ((off + m) & qb) != 0u;
          bool nz = false;
          if (!has_q) {
            const uint32_t pm = q < Wl ? (m | qb) : m;
#pragma unroll
            for (int w = 0; w < NW; ++w) {
              const uint32_t v = P[w * Ml + pm];
              Fl[w * Ml + m] = v;
              nz |= v != 0u;
            }
          }
          const uint32_t b = __ballot_sync(kFullMask, nz);
          if (lane == 0) NZ[g] = b;
        }
        wide_sync(clog);
        for (int g = warp; g < Gl; g += nwarps) {
          const uint32_t m = static_cast<uint32_t>(g) * 32u + lane;
          if ((off + m) & qb) {
#pragma unroll
            for (int w = 0; w < NW; ++w) Fl[w * Ml + m] = 0u;
          }
        }
        if (lane == q) prevk = -1;   // the freed slot is not closed
        wide_sync(clog);
      } else {
        // No config survives: latch the closure on the row's first
        // failure; the frontier becomes empty, and nothing after it can
        // change the row (a later bad index is larger).
        for (int w = 0; w < NW; ++w)
          for (uint32_t m = tid; m < Ml; m += nt) {
            if (ok) Fbg[static_cast<long long>(w) * M + off + m] =
                Fl[w * Ml + m];
            Fl[w * Ml + m] = 0u;
          }
        ok = false;
        dead = true;
        first_bad = min(first_bad, idx0 + e0 + j);
        break;
      }
    }
  }

  if (frontier_in_smem && (ok || Fbg != Fg)) {
    for (int w = 0; w < NW; ++w)
      for (uint32_t m = tid; m < Ml; m += nt)
        Fg[static_cast<long long>(w) * M + off + m] = Fl[w * Ml + m];
  }
  if (rank == 0 && tid == 0) {
    *valid_p = ok ? 1 : 0;
    *bad_p = first_bad;
  }
  // No CTA leaves while another may still read its shared memory.
  if (clog > 0) cg::this_cluster().sync();
}

// The single-bucket entry's wide tiers: 2^clog CTAs a row (a cluster
// when clog > 0), `threads` each.
template <int NW>
__global__ void __launch_bounds__(kWideMaxWarps * 32, 1)
wgl_wide_kernel(const int8_t* __restrict__ ev_type,
                const int8_t* __restrict__ ev_slot,
                const void* __restrict__ ev_slots, int slots_i32,
                const int32_t* __restrict__ target,
                long long target_row_stride, uint32_t* F, uint32_t* Fb,
                uint8_t* valid, int32_t* bad, int N, int Wt, int K1, int V,
                int W, int WL, int idx0, int clog, int frontier_in_smem,
                int table_staged) {
  const long long row = blockIdx.x >> clog;
  const int rank =
      clog > 0 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long NWM = static_cast<long long>(NW) << W;
  wgl_wide_row<NW>(ev_type + row * N, ev_slot + row * N, ev_slots,
                   row * static_cast<long long>(N) * Wt, slots_i32,
                   target + row * target_row_stride, F + row * NWM,
                   Fb + row * NWM, valid + row, bad + row, N, Wt, K1, V, W,
                   WL, idx0, clog, rank, frontier_in_smem, table_staged);
}

// ---- The instrumented entry's block tier (W > W_warp): one block a row.
//
// The block's T threads (a power of two, min(2^W, kCountMaxThreads)) split
// the row's masks: thread tid = 32 * warp + lane owns masks tid + T * j,
// j < 2^W / T, of the frontier and of its pad copy, so a mask's bits 0..4
// name its lane, bits 5 .. log2(T) - 1 its warp and the bits above its
// index j on the thread. A slot step writes only its owner's masks with
// bit i, each from its partner without the bit, which lies on the same
// thread (a bit of j), on another lane of the warp (bits 0..4) or in
// another warp. Each step ends on the block's vote (__syncthreads_or),
// which the dirty-slot rule needs and which also orders the step against
// the next one's reads and writes. The frontier and its pad copy live in
// shared memory while both fit beside the event tile and the table (W 14
// at one state word, 13 at two), else in device memory: the row's slice
// of F and of `scratch`. The row's table is staged once, as the warp
// tier stages it (nibble images for V <= 8 at one word, else int8
// targets, else left in device memory), and events 32 at a time: each
// slot's table offset, the event's live slots (those whose kind reaches
// a state), its type and its completing slot.
constexpr int kCountTile = 32;
constexpr int kCountMaxThreads = 1024;

// Words of shared memory the block tier keeps besides the frontiers and
// the table: the event tile's slot offsets, live slots and event words.
__host__ __device__ __forceinline__ int count_fixed_words() {
  return kCountTile * kWideMaxW + 2 * kCountTile;
}

// Slot bit `bit`'s step on the frontier X ([NW][M]) by thread tid of T:
// its masks with the bit take T_i of their partners. Returns this
// thread's "something changed".
template <int NW>
__device__ __forceinline__ bool count_step(uint32_t* X, const WarpTable& t,
                                           int so, uint32_t bit, uint32_t M,
                                           uint32_t T, int tid) {
  if (bit < T && !(tid & bit)) return false;
  bool ch = false;
  for (uint32_t m = tid; m < M; m += T) {
    if (!(m & bit)) continue;
    uint32_t src[NW], n[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) src[w] = X[w * M + (m ^ bit)];
    if (!(src[0] | src[NW - 1])) continue;
    image<NW>(t, so, src, n);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t o = X[w * M + m];
      if (n[w] & ~o) {
        X[w * M + m] = o | n[w];
        ch = true;
      }
    }
  }
  return ch;
}

// One closure of the frontier X by the whole block, counted: returns its
// passes (at least 1; block-uniform), stepping the dirty slots as
// count_closure does. `so` is the event's slot offsets in the tile. Each
// step ends on a block vote, which also orders it against the next one;
// a barrier first orders the caller's last writes (to its own masks)
// against the first step's reads.
template <int NW>
__device__ int count_block_closure(uint32_t* X, const WarpTable& t,
                                   const int* so, uint32_t live,
                                   uint32_t dirty, int WL, uint32_t M,
                                   uint32_t T, int tid) {
  int passes = 1;
  if (dirty) __syncthreads();
  while (dirty) {
    bool changed = false;
    for (int i = 0; i < WL; ++i) {
      if (!((dirty >> i) & 1u)) continue;
      dirty &= ~(1u << i);
      const bool ch = count_step<NW>(X, t, so[i], 1u << i, M, T, tid);
      if (__syncthreads_or(ch)) {
        dirty |= live & ~(1u << i);
        changed = true;
      }
    }
    if (!changed) break;
    ++passes;
  }
  return passes;
}

// The block tier's row walk: block b walks row b over its N events,
// counting every event's closure passes into iters[b] as the warp tier's
// wgl_count_walk does (a pad closes the copy, a failed row adds one pass
// for each later event), with valid, bad and the frontier K1's.
template <int NW>
__global__ void __launch_bounds__(kCountMaxThreads, 1)
wgl_count_block_kernel(
    const int8_t* __restrict__ ev_type, const int8_t* __restrict__ ev_slot,
    const void* __restrict__ ev_slots, int slots_i32,
    const int32_t* __restrict__ target, long long target_row_stride,
    uint32_t* F, uint32_t* Fb, uint8_t* valid, int32_t* bad,
    uint32_t* scratch, int32_t* iters, int N, int Wt, int K1, int V, int W,
    int WL, int idx0, int frontier_in_smem, int table_form) {
  extern __shared__ uint32_t smem[];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t T = blockDim.x;
  const uint32_t M = 1u << W;
  const long long NWM = static_cast<long long>(NW) << W;
  const int8_t* et = ev_type + row * N;
  const int8_t* es = ev_slot + row * N;
  const long long slots_base = row * static_cast<long long>(N) * Wt;
  const int32_t* tg = target + row * target_row_stride;
  uint32_t* Fg = F + row * NWM;
  uint32_t* Fbg = Fb + row * NWM;

  uint32_t* cur = smem;
  uint32_t* Fw = Fg;
  uint32_t* Sw = frontier_in_smem ? nullptr : scratch + row * NWM;
  if (frontier_in_smem) {
    Fw = cur;
    Sw = cur + NWM;
    cur += 2 * NWM;
  }
  int* tk = reinterpret_cast<int*>(cur);      // [kCountTile][kWideMaxW]
  int* tlive = tk + kCountTile * kWideMaxW;   // [kCountTile]
  int* tev = tlive + kCountTile;              // [kCountTile]
  int8_t* tab = reinterpret_cast<int8_t*>(tev + kCountTile);
  const int form = table_form;
  if (form != kTableDevice) stage_table(tg, tab, form, K1, V, NW, tid, T);
  const int entries = form == kTableNibble ? K1 * 32 * 4 : K1 * V;
  const uint8_t* reach =
      form != kTableDevice ? reinterpret_cast<const uint8_t*>(tab) + entries
                           : nullptr;
  const WarpTable t{
      form == kTableNibble ? reinterpret_cast<const uint32_t*>(tab)
                           : nullptr,
      form == kTableInt8 ? tab : nullptr, tg, NW,
      form == kTableNibble ? 32 : V, V >= 64 ? ~0ull : (1ull << V) - 1ull};
  if (frontier_in_smem) {
    for (uint32_t m = tid; m < M; m += T)
#pragma unroll
      for (int w = 0; w < NW; ++w) Fw[w * M + m] = Fg[w * M + m];
  }
  bool ok = valid[row] != 0;
  int32_t first_bad = bad[row];
  int32_t passes = 0;
  // Lane i < WL of every warp: slot i's table offset at the row's last
  // live event, -1 while the frontier is not known to be closed under it.
  const int lane = tid & 31;
  int closed = -1;

  for (int e0 = 0; e0 < N; e0 += kCountTile) {
    const int ne = min(kCountTile, N - e0);
    __syncthreads();   // the table is staged, the last tile consumed
    for (int x = tid; x < ne; x += T) {
      const int e = e0 + x;
      const int typ = et[e];
      const bool is_ok = typ == kEvOk || typ == kEvFused;
      int live = 0;
      for (int i = 0; i < WL; ++i) {
        int k = load_kind(ev_slots,
                          slots_base + static_cast<long long>(e) * Wt + i,
                          slots_i32);
        if (k < 0) k += K1;
        k = min(max(k, 0), K1 - 1);
        tk[x * kWideMaxW + i] = k * t.kstride;
        if (reach == nullptr || reach[k]) live |= 1 << i;
      }
      tlive[x] = live;
      tev[x] = (static_cast<int>(es[e]) & 0xff) | (is_ok ? 0x100 : 0)
               | (is_ok || typ == kEvClose ? 0x200 : 0);
    }
    __syncthreads();

    bool failed = false;
    for (int j = 0; j < ne; ++j) {
      const int ev = tev[j];
      const uint32_t live = static_cast<uint32_t>(tlive[j]);
      const bool live_ev = (ev & 0x200) != 0;
      const int mine = lane < WL ? tk[j * kWideMaxW + lane] : -1;
      const uint32_t dirty = live & __ballot_sync(kFullMask, mine != closed);
      if (!dirty) {
        ++passes;      // no step can change the frontier: one pass
      } else {
        uint32_t* X = Fw;
        if (!live_ev) {  // a pad closes a copy of the frontier
          for (uint32_t m = tid; m < M; m += T)
#pragma unroll
            for (int w = 0; w < NW; ++w) Sw[w * M + m] = Fw[w * M + m];
          X = Sw;
        }
        passes += count_block_closure<NW>(X, t, tk + j * kWideMaxW, live,
                                          dirty, WL, M, T, tid);
      }
      if (!live_ev) continue;   // a pad's closure is dropped
      closed = mine;
      if (!(ev & 0x100)) continue;   // EV_CLOSE keeps the closure
      // The reference selects among WL static branches, so the slot
      // index clamps into [0, WL).
      const int q = min(max(static_cast<int>(static_cast<int8_t>(ev & 0xff)),
                            0), WL - 1);
      const uint32_t qb = 1u << q;
      bool any = false;
      for (uint32_t m = tid; m < M; m += T) {
        if (!(m & qb)) continue;
#pragma unroll
        for (int w = 0; w < NW; ++w) any |= Fw[w * M + m] != 0u;
      }
      if (__syncthreads_or(any)) {
        // Masks without bit q take their partner's words, then masks
        // with bit q are cleared.
        for (uint32_t m = tid; m < M; m += T) {
          if (m & qb) continue;
#pragma unroll
          for (int w = 0; w < NW; ++w) Fw[w * M + m] = Fw[w * M + (m | qb)];
        }
        __syncthreads();
        for (uint32_t m = tid; m < M; m += T) {
          if (!(m & qb)) continue;
#pragma unroll
          for (int w = 0; w < NW; ++w) Fw[w * M + m] = 0u;
        }
        if (lane == q) closed = -1;   // the freed slot is not closed
        continue;
      }
      // No config survives: latch the closure on the row's first failure;
      // the frontier becomes empty, and every later event closes it in
      // one pass.
      for (uint32_t m = tid; m < M; m += T)
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          if (ok) Fbg[w * M + m] = Fw[w * M + m];
          Fw[w * M + m] = 0u;
        }
      ok = false;
      first_bad = min(first_bad, idx0 + e0 + j);
      passes += N - 1 - (e0 + j);
      failed = true;
      break;
    }
    if (failed) break;
  }

  if (frontier_in_smem && (ok || Fbg != Fg)) {
    for (uint32_t m = tid; m < M; m += T)
#pragma unroll
      for (int w = 0; w < NW; ++w) Fg[w * M + m] = Fw[w * M + m];
  }
  if (tid == 0) {
    valid[row] = ok ? 1 : 0;
    bad[row] = first_bad;
    iters[row] = passes;
  }
}

// The instrumented entry's warp tier: one kernel per (MPL, NW), as the
// single-bucket entry's.
template <int MPL, int NW>
__global__ void __launch_bounds__(kWarpRows * 32, kWarpMinBlocks)
wgl_count_warp_kernel(const int8_t* __restrict__ ev_type,
                      const int8_t* __restrict__ ev_slot,
                      const void* __restrict__ ev_slots, int slots_i32,
                      const int32_t* __restrict__ target,
                      long long target_row_stride, uint32_t* F, uint32_t* Fb,
                      uint8_t* valid, int32_t* bad, int32_t* iters, int B,
                      int N, int Wt, int K1, int V, int W, int WL, int idx0,
                      int R, int table_form) {
  wgl_warp_block<MPL, NW, true>(ev_type, ev_slot, ev_slots, slots_i32,
                                target, target_row_stride, F, Fb, valid, bad,
                                iters, blockIdx.x, B, N, Wt, K1, V, W, WL,
                                idx0, R, table_form);
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
  int table_form;          // kTableDevice, Int8 or (warp) Nibble
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
  wgl_warp_block<MPL, NW, false>(mb.ev_type, mb.ev_slot, mb.ev_slots,       \
                                 mb.slots_i32, mb.target,                   \
                                 mb.target_row_stride, mb.frontier,         \
                                 mb.frontier, mb.valid, mb.bad, nullptr,    \
                                 blk, mb.rows, mb.N, mb.Wt, mb.K1, mb.V,    \
                                 mb.W, mb.WL, 0, mb.rows_per_block,         \
                                 mb.table_form)
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
  // A wide member: the block tier's delta closure, one block a row, the
  // frontier in shared memory.
  const long long NWM = static_cast<long long>(mb.NW) << mb.W;
  uint32_t* Fg = mb.frontier + blk * NWM;
#define WGL_GROUP_WIDE(NW)                                                  \
  wgl_wide_row<NW>(mb.ev_type + blk * mb.N, mb.ev_slot + blk * mb.N,        \
                   mb.ev_slots, blk * static_cast<long long>(mb.N) * mb.Wt, \
                   mb.slots_i32, mb.target + blk * mb.target_row_stride,   \
                   Fg, Fg, mb.valid + blk, mb.bad + blk, mb.N, mb.Wt,       \
                   mb.K1, mb.V, mb.W, mb.WL, 0, 0, 0, 1,                    \
                   mb.table_form == kTableInt8)
  if (mb.NW == 1) WGL_GROUP_WIDE(1);
  else WGL_GROUP_WIDE(2);
#undef WGL_GROUP_WIDE
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

// Does a wide tier take this window, cluster (clog, -1 when the CTA
// count is not a power of two up to 8), block and table form? Every CTA
// holds whole 32-mask groups (the plan takes the wide tiers past W_warp;
// chip_smoke's tier_cut also runs them from W 5); the block and device
// tiers run one CTA a row.
bool wide_tier_ok(int W, int NW, int tier, int clog, int threads,
                  int form) {
  const bool tier_ok = tier == kTierCluster
                           ? clog >= 1 && clog <= kWideMaxClusterLog
                           : (tier == kTierBlock || tier == kTierDevice)
                                 && clog == 0;
  return tier_ok && W - clog >= 5 && W <= kWideMaxW
         && (NW == 1 || NW == 2) && threads >= 32
         && threads <= 32 * kWideMaxWarps && threads % 32 == 0
         && (form == kTableDevice || form == kTableInt8);
}

}  // namespace

// One bucket of B rows. tier 0 (warp): ceil(B / R) blocks of `threads` =
// R x 32; tier 1 (block), 2 (device memory) and 3 (cluster): B clusters
// of `cluster_ctas` CTAs (1 but in tier 3) of `threads`, the frontier in
// shared memory but in tier 2. A cluster launch CUDA refuses returns
// its error; nothing drops to another tier.
extern "C" int wgl_frontier_launch(
    const void* ev_type, const void* ev_slot, const void* ev_slots,
    int slots_i32, const void* target, long long target_row_stride,
    void* F, void* Fb, void* valid, void* bad, int B, int N, int Wt, int K1,
    int V, int NW, int W, int WL, int idx0, int tier, int rows_per_block,
    int table_form, int cluster_ctas, int threads, int smem_bytes,
    void* stream) {
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
    const int clog = cluster_ctas == 1 ? 0 : cluster_ctas == 2 ? 1
                     : cluster_ctas == 4 ? 2 : cluster_ctas == 8 ? 3 : -1;
    const int in_smem = tier == kTierDevice ? 0 : 1;
    const int staged = table_form == kTableInt8 ? 1 : 0;
    const long long Ml = 1LL << (W - (clog > 0 ? clog : 0));
    const long long need =
        4 * (in_smem * NW * Ml + wide_fixed_words(static_cast<int>(Ml >> 5)))
        + (staged ? table_bytes(K1, V, kTableInt8) : 0);
    if (!wide_tier_ok(W, NW, tier, clog, threads, table_form)
        || smem_bytes < need)
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = NW == 1 ? wgl_wide_kernel<1> : wgl_wide_kernel<2>;
    const cudaError_t e = allow_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (B == 0) return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(B) << clog, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1u << clog;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t le = cudaLaunchKernelEx(
        &cfg, kernel, et, es, ev_slots, slots_i32, tg, target_row_stride, f,
        fb, v, bd, N, Wt, K1, V, W, WL, idx0, clog, in_smem, staged);
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instrumented entry over B rows: tier 0 (warp), ceil(B / R) blocks
// of `threads` = R x 32, as wgl_frontier_launch's warp tier; tier 1
// (block) and 2 (device memory), B blocks of min(2^W, kCountMaxThreads),
// the frontier and its pad copy in shared memory (tier 1) or in F and
// `scratch` (tier 2, which may then not be null). iters[b] gets row b's
// closure passes over these N events.
extern "C" int wgl_frontier_instrument_launch(
    const void* ev_type, const void* ev_slot, const void* ev_slots,
    int slots_i32, const void* target, long long target_row_stride,
    void* F, void* Fb, void* valid, void* bad, void* scratch, void* iters,
    int B, int N, int Wt, int K1, int V, int NW, int W, int WL, int idx0,
    int tier, int rows_per_block, int table_form, int threads,
    int smem_bytes, void* stream) {
  const auto* et = static_cast<const int8_t*>(ev_type);
  const auto* es = static_cast<const int8_t*>(ev_slot);
  const auto* tg = static_cast<const int32_t*>(target);
  auto* f = static_cast<uint32_t*>(F);
  auto* fb = static_cast<uint32_t*>(Fb);
  auto* v = static_cast<uint8_t*>(valid);
  auto* bd = static_cast<int32_t*>(bad);
  auto* it = static_cast<int32_t*>(iters);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tier == kTierWarp) {
    if (!warp_tier_ok(W, V, NW, rows_per_block, table_form)
        || threads != 32 * rows_per_block)
      return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (B + rows_per_block - 1) / rows_per_block;
    const int mpl = warp_mpl(W);
    auto kernel = wgl_count_warp_kernel<1, 1>;
    if (NW == 1) {
      kernel = mpl == 1   ? wgl_count_warp_kernel<1, 1>
               : mpl == 2 ? wgl_count_warp_kernel<2, 1>
               : mpl == 4 ? wgl_count_warp_kernel<4, 1>
                          : wgl_count_warp_kernel<8, 1>;
    } else {
      kernel = mpl == 1   ? wgl_count_warp_kernel<1, 2>
               : mpl == 2 ? wgl_count_warp_kernel<2, 2>
               : mpl == 4 ? wgl_count_warp_kernel<4, 2>
                          : wgl_count_warp_kernel<8, 2>;
    }
    const cudaError_t e = allow_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks > 0) {
      kernel<<<blocks, threads, smem_bytes, st>>>(
          et, es, ev_slots, slots_i32, tg, target_row_stride, f, fb, v, bd,
          it, B, N, Wt, K1, V, W, WL, idx0, rows_per_block, table_form);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int in_smem = tier == kTierBlock ? 1 : 0;
  const long long need =
      4LL * ((in_smem ? 2LL * NW << W : 0LL) + count_fixed_words())
      + (table_form != kTableDevice ? table_bytes(K1, V, table_form) : 0);
  const bool ok = (tier == kTierBlock || tier == kTierDevice) && W >= 5
                  && W <= kWideMaxW && (NW == 1 || NW == 2) && WL >= 1
                  && WL <= W && threads == min(1 << W, kCountMaxThreads)
                  && smem_bytes >= need
                  && (table_form == kTableDevice || table_form == kTableInt8
                      || (table_form == kTableNibble && NW == 1 && V <= 8))
                  && (in_smem || scratch != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = NW == 1 ? wgl_count_block_kernel<1>
                        : wgl_count_block_kernel<2>;
  const cudaError_t e = allow_smem(kernel, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B > 0) {
    kernel<<<B, threads, smem_bytes, st>>>(
        et, es, ev_slots, slots_i32, tg, target_row_stride, f, fb, v, bd,
        static_cast<uint32_t*>(scratch), it, N, Wt, K1, V, W, WL, idx0,
        in_smem, table_form);
  }
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
    const bool ok =
        mb.tier == kTierWarp
            ? warp_tier_ok(mb.W, mb.V, mb.NW, mb.rows_per_block,
                           mb.table_form)
            : mb.rows_per_block == 1
                  && wide_tier_ok(mb.W, mb.NW, mb.tier, 0, threads,
                                  mb.table_form)
                  && mb.tier == kTierBlock;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
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
