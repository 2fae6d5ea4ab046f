// wgl_frontier.cu — the packed-frontier Wing–Gong linearizability search,
// one CUDA thread block per history row, for Hopper (sm_90a).
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
// with a fixpoint per event: every closure sweep and every completion
// needs the whole block to agree (a barrier), and each step is a few
// integer ops per mask. At the main path's widths (W = 4..6 masks, V = 8
// states) a row's frontier is a few hundred bytes, so neither device
// memory bandwidth nor the integer rate is the limit: the barrier chain
// and the latency of the per-event loads are. The design answers with
// residency and independence: the frontier stays in shared memory for the
// whole row (up to 227 KB per block: W <= 15 at one state word, W <= 14 at
// two), event tables are read straight from device memory through L1,
// and the 132 SMs run thousands of independent rows at once, one block
// each, so the card hides one row's barrier latency behind the others.
// Wider windows (the data1wide route, W = 16..18) keep the frontier in the
// row's slice of the output tensor in device memory; the body is the same
// code on a different pointer.
//
// The group entry (wgl_frontier_group_kernel) replaces the TPU dispatch
// group jepsen_tpu/ops/linearize.py::make_fused_kernel: one XLA call that
// scans several class buckets of different shapes back to back. Here it is
// one launch whose blocks are the real rows of up to kMaxMembers member
// chunks (different V, W, w_live, event lengths, slot dtypes, shared or
// per-row targets). Block b finds its member by scanning the members' row
// prefix sums in a __grid_constant__ descriptor and runs the same row body
// as the single-bucket kernel. What it saves is launches, not work: the
// scheduler's many small chunks stop paying a launch and a host round trip
// each. Every member keeps its frontier in shared memory (the scheduler
// ships a member that needs the device-memory frontier alone), the block
// gets the largest member's shared-memory plan, and a row's latched
// pre-failure closure is written straight into its frontier output, which
// therefore holds the check form's where(valid, F, Fb) when the block ends.
// Padding rows of a member are not launched: their outputs arrive
// pre-filled as the plain version leaves an all-EV_PAD row.
//
// Why in-place updates are race-free. Applying slot i reads only masks
// without bit i and writes only masks with bit i, and each mask pair
// (m, m | 1<<i) belongs to one thread, so a slot needs no barrier inside
// it, only between slots. The closure is a monotone OR to a unique least
// fixpoint, so sweeping slots in place reaches the same Fc as the
// reference's sweep (and in the same number of sweeps). Completion moves
// each pair's upper word down and clears it, again one thread per pair.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEvOk = 2;
constexpr int kEvClose = 3;
constexpr int kEvFused = 4;

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

// One row's walk over its N events: the body both entries share. `et`,
// `es` and `ev_slots` are the row's event tables (its slot table at element
// offset `slots_base`, Wt entries per event), `tg` its [K1][V] transition table,
// Fg and Fbg its carry frontiers in device memory, valid_p and bad_p its
// verdict. With frontier_in_smem the frontier lives in shared memory after
// the staged transition rows and is copied back to Fg at the end, unless
// Fbg aliases Fg and the row has failed: then Fg keeps the latched
// closure (the group entry's output).
__device__ void wgl_row(const int8_t* __restrict__ et,
                        const int8_t* __restrict__ es,
                        const void* __restrict__ ev_slots,
                        long long slots_base,
                        int slots_i32, const int32_t* __restrict__ tg,
                        uint32_t* Fg, uint32_t* Fbg, uint8_t* valid_p,
                        int32_t* bad_p, int N, int Wt, int K1, int V, int NW,
                        int W, int WL, int idx0, int frontier_in_smem) {
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
    if (!is_ok && !is_close) continue;  // EV_PAD: no-op, block-uniform
    if (dead) {
      if (is_ok) first_bad = min(first_bad, idx0 + e);
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

    // Closure to fixpoint, slot by slot in place.
    if (live) {
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
      } while (changed);
    }

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
  }
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
  wgl_row(ev_type + row * N, ev_slot + row * N, ev_slots,
          row * static_cast<long long>(N) * Wt, slots_i32,
          target + row * target_row_stride, F + row * NWM, Fb + row * NWM,
          valid + row, bad + row, N, Wt, K1, V, NW, W, WL, idx0,
          frontier_in_smem);
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
  int row_start;           // prefix sum of the real rows before it
  int rows;                // real rows launched (<= Bp)
};

constexpr int kMaxMembers = 8;

struct WglGroup {
  WglMember m[kMaxMembers];
  int n_members;
  int total_rows;
};

__global__ void wgl_frontier_group_kernel(const __grid_constant__ WglGroup g) {
  const int b = blockIdx.x;
  int j = 0;
  while (j + 1 < g.n_members && g.m[j + 1].row_start <= b) ++j;
  const WglMember& mb = g.m[j];
  const long long row = b - mb.row_start;
  const long long NWM = static_cast<long long>(mb.NW) << mb.W;
  uint32_t* Fg = mb.frontier + row * NWM;
  wgl_row(mb.ev_type + row * mb.N, mb.ev_slot + row * mb.N, mb.ev_slots,
          row * static_cast<long long>(mb.N) * mb.Wt, mb.slots_i32,
          mb.target + row * mb.target_row_stride, Fg, Fg, mb.valid + row,
          mb.bad + row, mb.N, mb.Wt, mb.K1, mb.V, mb.NW, mb.W, mb.WL, 0, 1);
}

}  // namespace

extern "C" int wgl_frontier_launch(
    const void* ev_type, const void* ev_slot, const void* ev_slots,
    int slots_i32, const void* target, long long target_row_stride,
    void* F, void* Fb, void* valid, void* bad, int B, int N, int Wt, int K1,
    int V, int NW, int W, int WL, int idx0, int frontier_in_smem,
    int threads, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgl_frontier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wgl_frontier_kernel<<<B, threads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ev_type),
      static_cast<const int8_t*>(ev_slot), ev_slots, slots_i32,
      static_cast<const int32_t*>(target), target_row_stride,
      static_cast<uint32_t*>(F), static_cast<uint32_t*>(Fb),
      static_cast<uint8_t*>(valid), static_cast<int32_t*>(bad), N, Wt, K1, V,
      NW, W, WL, idx0, frontier_in_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgl_frontier_group_launch(const void* group, int threads,
                                         int smem_bytes, void* stream) {
  const WglGroup* g = static_cast<const WglGroup*>(group);
  if (g->n_members < 1 || g->n_members > kMaxMembers)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgl_frontier_group_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (g->total_rows > 0) {
    wgl_frontier_group_kernel<<<g->total_rows, threads, smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(*g);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgl_frontier_group_desc_bytes() {
  return static_cast<int>(sizeof(WglGroup));
}

extern "C" const char* wgl_frontier_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
