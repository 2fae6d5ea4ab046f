// wgl_shard.cu — the frontier-sharded step of the packed-frontier WGL
// search for Hopper (sm_90a): one shard's part of an event, a block a row.
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
//     under the live local slots to its local fixpoint (in place: for a
//     slot i, F[m | 1<<i] |= T_i(F[m]) over masks without bit i, sources
//     and destinations disjoint, a block barrier between slots, passes
//     until one changes nothing), and set "kept": whether a config of
//     this shard survives the event's completion (a local slot q: a
//     config at a mask with bit q; top slot b: any config, on a shard
//     with bit b set). The first round of an event always closes; later
//     rounds close only a row that received something new;
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
// What bounds it on this card. A shard's slice is 2^WL words a state word
// (2^16 on every production frontier route: 256 KB a row at one word),
// past a block's shared memory, so it lives in device memory and each
// slot step streams it through L1/L2; the step itself is a loop over the
// set states of each non-empty source mask. The work an event needs is
// K1's (the configurations its closure expands), but a row's block sweeps
// every mask of every live slot each pass, and the host round trip of
// each round (a flag read) sets the time of the exchange rounds. What the
// design does about it: slots whose transition row reaches no state are
// skipped (a block-uniform flag from the staged table), empty source
// masks cost one load, padding and invalid rows return at once, and the
// transition rows of the event's slots are staged once per launch in
// shared memory as packed one-hot words. It is the simple form; a delta
// closure over dirty mask groups (K1's wide tiers) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ int kind_at(const ShardArgs& a, int row,
                                       int slot) {
  const long long off =
      ((long long)row * a.N + a.e) * a.Wt + slot;
  int k = a.slots_i32 ? static_cast<const int32_t*>(a.ev_slots)[off]
                      : static_cast<const int8_t*>(a.ev_slots)[off];
  if (k < 0) k += a.K1;
  return min(max(k, 0), a.K1 - 1);
}

// Stage slot `slot`'s packed one-hot transition row into tab[V][NW];
// returns, block-uniform, whether it reaches any state.
__device__ bool stage_row(const ShardArgs& a, int row, int slot,
                          uint32_t* tab) {
  const int k = kind_at(a, row, slot);
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

__global__ void __launch_bounds__(kMaxThreads)
shard_close_kernel(const ShardArgs a) {
  __shared__ uint32_t tab[kMaxWLocal * kMaxV * 2];
  __shared__ int live[kMaxWLocal];
  const int row = blockIdx.x;
  const int typ = a.ev_type[(long long)row * a.N + a.e];
  const int M = 1 << a.WL;
  const long long NM = (long long)a.NW * M;
  if (!a.valid[row] || !live_event(typ)) {
    if (threadIdx.x == 0) {
      a.changed[row] = 0;
      a.kept[row] = 0;
    }
    return;
  }
  uint32_t* F = reinterpret_cast<uint32_t*>(a.F) + row * NM;
  // Merge the partners' images.
  int added = 0;
  for (int b = 0; b < kMaxTop; ++b) {
    if (a.recv[b] == nullptr) continue;
    const uint32_t* R = reinterpret_cast<const uint32_t*>(a.recv[b])
                        + row * NM;
    for (long long j = threadIdx.x; j < NM; j += blockDim.x) {
      const uint32_t x = R[j];
      const uint32_t f = F[j];
      if (x & ~f) {
        F[j] = f | x;
        added = 1;
      }
    }
  }
  added = __syncthreads_or(added);
  if (a.first_round || added) {
    for (int i = 0; i < a.WL; ++i) {
      const bool l = stage_row(a, row, i, tab + i * a.V * a.NW);
      if (threadIdx.x == 0) live[i] = l;
    }
    __syncthreads();
    const int half = M >> 1;
    int ch;
    do {
      ch = 0;
      for (int i = 0; i < a.WL; ++i) {
        if (!live[i]) continue;            // block-uniform
        const uint32_t* t = tab + i * a.V * a.NW;
        const int bit = 1 << i;
        for (int p = threadIdx.x; p < half; p += blockDim.x) {
          const int m = ((p & ~(bit - 1)) << 1) | (p & (bit - 1));
          uint32_t src[2] = {F[m], a.NW > 1 ? F[M + m] : 0u};
          if (!(src[0] | src[1])) continue;
          uint32_t img[2];
          image_of(src, a.NW, t, img);
          for (int w = 0; w < a.NW; ++w) {
            const uint32_t old = F[(long long)w * M + (m | bit)];
            const uint32_t nw = old | img[w];
            if (nw != old) {
              F[(long long)w * M + (m | bit)] = nw;
              ch = 1;
            }
          }
        }
        __syncthreads();
      }
      ch = __syncthreads_or(ch);
    } while (ch);
  }
  // kept: does a config of this shard survive the completion?
  int k = 0;
  if (typ != kEvClose) {
    const int q = min(max(static_cast<int>(a.ev_slot[(long long)row * a.N
                                                     + a.e]), 0), a.W - 1);
    if (q < a.WL) {
      const int bit = 1 << q;
      for (long long j = threadIdx.x; j < NM && !k; j += blockDim.x)
        k = ((j & (M - 1)) & bit) && F[j];
    } else if ((a.d >> (q - a.WL)) & 1) {
      for (long long j = threadIdx.x; j < NM && !k; j += blockDim.x)
        k = F[j] != 0;
    }
  }
  k = __syncthreads_or(k);
  if (threadIdx.x == 0) {
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

bool args_ok(const ShardArgs& a, int threads) {
  return a.F != nullptr && a.rows >= 0 && a.N >= 1 && a.e >= 0
      && a.e < a.N && a.WL >= 1 && a.WL <= kMaxWLocal && a.W >= a.WL
      && a.W - a.WL <= kMaxTop && a.Wt >= a.W && a.V >= 1 && a.V <= kMaxV
      && a.NW == (a.V + 31) / 32 && a.K1 >= 1 && threads >= 32
      && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

extern "C" int wgl_shard_close_launch(const void* args, int threads,
                                      void* stream) {
  const ShardArgs& a = *static_cast<const ShardArgs*>(args);
  if (!args_ok(a, threads) || a.changed == nullptr || a.kept == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows > 0)
    shard_close_kernel<<<a.rows, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgl_shard_image_launch(const void* args, int threads,
                                      void* stream) {
  const ShardArgs& a = *static_cast<const ShardArgs*>(args);
  if (!args_ok(a, threads) || a.send == nullptr || a.b < 0
      || a.b >= a.W - a.WL || ((a.d >> a.b) & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows > 0)
    shard_image_kernel<<<a.rows, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wgl_shard_commit_launch(const void* args, int threads,
                                       void* stream) {
  const ShardArgs& a = *static_cast<const ShardArgs*>(args);
  if (!args_ok(a, threads) || a.Fbad == nullptr || a.nonempty == nullptr)
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

extern "C" int wgl_shard_limits(int* max_wl, int* max_top, int* max_v) {
  *max_wl = kMaxWLocal;
  *max_top = kMaxTop;
  *max_v = kMaxV;
  return 0;
}

extern "C" const char* wgl_shard_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
