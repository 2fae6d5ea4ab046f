// dc_peel.cu — the decrease-and-conquer peel loop of the register class,
// for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/dc_monitor.py:372 get_dc_kernel, a vmapped
// lax.while_loop over plan rows. Inputs per row (E padded events, row-
// major [B, E]): inv int32 (an op's invocation event), cluster int32 (the
// event of the write whose value the op carries, in [0, E)), active
// uint8 (0/1: the op takes part). An op's response time is its own event
// index. Each round of the reference's row:
//   1. m_resp[c] = min over alive ops of cluster c of their event index
//      (BIG = 2^30 where no alive op), a scatter-min;
//   2. m_inv[c] = max over alive ops of cluster c of their invocation
//      (-1 where none), a scatter-max;
//   3. the outside bound: g1 the smallest m_resp, at cluster a1, g2 the
//      smallest over every other cluster; t_out[c] = (c == a1) ? g2 : g1;
//   4. every cluster with m_resp < BIG and m_inv <= t_out is peeled: its
//      ops die.
// The loop runs while the last round made progress, some op is alive and
// fewer than `cap` rounds ran (the reference's max_rounds, else E + 1).
// Outputs: decided uint8 [B] (no op alive at the end) and rounds int32 [B]
// (body executions, the last one without progress included). The plain
// PyTorch version is ops/dc_monitor.py plain_dc_peel, bit for bit.
//
// The two minima without m_resp. An event belongs to one cluster, so
// m_resp[c] is the least alive event of cluster c, and the smallest m_resp
// is the least alive event of all:
//   g1 = the least alive event, a1 = cluster[g1],
//   g2 = the least alive event whose cluster is not a1 (BIG if none).
// Why the argmin's tie-break cannot matter: the m_resp of distinct
// clusters are distinct event indices, so two clusters tie only at BIG,
// and g1 < BIG whenever some op is alive, which holds in every round the
// loop runs; a1 is unique. Every op the peel tests is alive, so its own
// cluster has an alive op and `m_resp < BIG` holds for it. A round is then
// alive[e] &= !(m_inv[cl[e]] <= (cl[e] == a1 ? g2 : g1)), and m_inv is
// read only at alive ops' clusters: each round resets just those slots to
// -1 before the scatter-max, and slots of dead clusters go stale unread.
//
// Three tiers, by E (cuda_dc.tier):
//   * warp (E <= 256, every plan the dc path makes): one warp a row, eight
//     rows a block. Lane l holds events l + 32k (k < E/32 rounded up to a
//     power of two, at most 8) in registers: inv, cluster and an alive bit
//     mask. A round is g1 by __reduce_min_sync over each lane's least alive
//     event, a1 by a shuffle from g1's lane, g2 by a second
//     __reduce_min_sync over the alive events outside a1, the reset and
//     shared atomicMax of the row's m_inv (E int32 in the block's shared
//     memory) between __syncwarp()s, the peel test, and two __any_sync
//     votes. No block barrier: each row stops on its own.
//   * smem (13·E bytes fit in shared memory): one block of 256 threads a
//     row; inv, cluster, m_inv and the alive bytes in shared memory. A
//     round: reset the alive ops' m_inv slots while each thread folds its
//     alive events into (least event, its cluster, least event of another
//     cluster) — a fold that merges — and the warps' shuffles and partials
//     (barrier); the scatter-max while every thread merges the partials
//     (barrier); the peel pass and two __syncthreads_or. Four barriers,
//     no E-wide scan.
//   * global (larger E): the same block body with m_inv and alive in the
//     row's slice of a scratch the wrapper allocates (2·E int32 words a
//     row), inv and cluster read from the inputs.
//
// What bounds it on this card. Bytes: at most 9 bytes an event in, 5
// bytes a row out; at the dc path's batch (1,024 rows of E 128) about
// 1.2 MB, under 0.4 us at 3.35 TB/s. Operations: what the peel needs,
// about 4 int32 operations an alive op and 6 a live cluster a round
// (chip_smoke.py's DC_OP_OPS and DC_CLUSTER_OPS, counted over each
// round's alive ops), a few rounds a row. Neither is close: a round is a
// chain of dependent warp collectives and shared-memory atomics, so the
// warp tier is bound by their latency, well under a microsecond a round,
// and a launch by its longest row's rounds and the launch itself.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kBig = 1 << 30;
// The warp tier's widest row: eight events a lane.
constexpr int kWarpEvents = 256;
// Dynamic shared memory one block may use on an H100, less what the
// kernel keeps statically.
constexpr int kSmemLimit = 232448 - 256;

// ------------------------------------------------------------ warp tier

// cl[k] for a k known only at run time, without a local-memory array.
template <int K>
__device__ __forceinline__ int32_t pick(const int32_t (&v)[K], int k) {
  int32_t out = v[0];
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (j == k) out = v[j];
  return out;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    dc_peel_warp_kernel(const int32_t* __restrict__ inv_in,
                        const int32_t* __restrict__ cluster_in,
                        const uint8_t* __restrict__ active, int B, int E,
                        int cap, uint8_t* __restrict__ decided,
                        int32_t* __restrict__ rounds_out) {
  extern __shared__ int32_t smem_inv[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;
  int32_t* m_inv = smem_inv + warp * 32 * K;
  const size_t off = static_cast<size_t>(row) * E;
  int32_t inv[K], cl[K];
  unsigned alive = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = lane + 32 * k;
    inv[k] = 0;
    cl[k] = 0;
    if (e < E) {
      inv[k] = inv_in[off + e];
      cl[k] = cluster_in[off + e];
      if (active[off + e]) alive |= 1u << k;
    }
  }
  int rounds = 0;
  bool left = __any_sync(kFull, alive != 0);
  bool running = left;
  while (running) {
    // g1: the least alive event (a lane's own is its lowest alive slot);
    // a1: its cluster, from g1's lane.
    int mine = kBig, mine_cl = 0;
    if (alive) {
      const int k = __ffs(alive) - 1;
      mine = lane + 32 * k;
      mine_cl = pick(cl, k);
    }
    const int g1 = __reduce_min_sync(kFull, mine);
    const int a1 = __shfl_sync(kFull, mine_cl, g1 & 31);
    // g2: the least alive event of another cluster.
    int other = kBig;
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if ((alive >> k & 1u) && cl[k] != a1) other = lane + 32 * k;
    const int g2 = __reduce_min_sync(kFull, other);
    // m_inv at the alive ops' clusters: reset, then the scatter-max.
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (alive >> k & 1u) m_inv[cl[k]] = -1;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (alive >> k & 1u) atomicMax(&m_inv[cl[k]], inv[k]);
    __syncwarp();
    unsigned dead = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((alive >> k & 1u) && m_inv[cl[k]] <= (cl[k] == a1 ? g2 : g1))
        dead |= 1u << k;
    alive &= ~dead;
    ++rounds;
    const bool moved = __any_sync(kFull, dead != 0);
    left = __any_sync(kFull, alive != 0);
    running = moved && left && rounds < cap;
    // This round's reads of m_inv before the next round's resets.
    __syncwarp();
  }
  if (lane == 0) {
    decided[row] = left ? 0 : 1;
    rounds_out[row] = rounds;
  }
}

// ----------------------------------------------------------- block tiers

// A fold of alive events: v1 the least event, c1 its cluster, v2 the
// least event whose cluster is not c1. Two folds merge: the smaller v1
// wins, and the other side offers its v1 when its cluster differs from
// the winner's, else its own v2. (v1 never ties but at kBig.)
struct Least2 {
  int32_t v1;
  int32_t c1;
  int32_t v2;
};

__device__ __forceinline__ Least2 merge(Least2 a, Least2 b) {
  if (b.v1 < a.v1) return {b.v1, b.c1, min(b.v2, a.c1 != b.c1 ? a.v1 : a.v2)};
  return {a.v1, a.c1, min(a.v2, b.c1 != a.c1 ? b.v1 : b.v2)};
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
    dc_peel_block_kernel(const int32_t* __restrict__ inv_in,
                         const int32_t* __restrict__ cluster_in,
                         const uint8_t* __restrict__ active, int E, int cap,
                         int32_t* scratch, uint8_t* __restrict__ decided,
                         int32_t* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Least2 partial[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(row) * E;
  const int32_t* inv;
  const int32_t* cluster;
  int32_t* m_inv;
  uint8_t* alive;
  if constexpr (kSmem) {
    int32_t* s = reinterpret_cast<int32_t*>(smem);
    m_inv = s;
    int32_t* sinv = s + E;
    int32_t* scl = s + 2 * E;
    alive = reinterpret_cast<uint8_t*>(s + 3 * E);
    for (int e = tid; e < E; e += kThreads) {
      sinv[e] = inv_in[off + e];
      scl[e] = cluster_in[off + e];
    }
    inv = sinv;
    cluster = scl;
  } else {
    int32_t* s = scratch + static_cast<size_t>(row) * 2 * E;
    m_inv = s;
    alive = reinterpret_cast<uint8_t*>(s + E);
    inv = inv_in + off;
    cluster = cluster_in + off;
  }
  int any = 0;
  for (int e = tid; e < E; e += kThreads) {
    const uint8_t a = active[off + e] != 0;
    alive[e] = a;
    any |= a;
  }
  int rounds = 0;
  // Also orders the staging above before the first round.
  bool running = __syncthreads_or(any) != 0;
  while (running) {
    Least2 m = {kBig, -1, kBig};
    for (int e = tid; e < E; e += kThreads) {
      if (alive[e]) {
        const int c = cluster[e];
        m_inv[c] = -1;
        m = merge(m, {e, c, kBig});
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const Least2 o = {__shfl_xor_sync(kFull, m.v1, d),
                        __shfl_xor_sync(kFull, m.c1, d),
                        __shfl_xor_sync(kFull, m.v2, d)};
      m = merge(m, o);
    }
    if ((tid & 31) == 0) partial[tid >> 5] = m;
    __syncthreads();
    for (int e = tid; e < E; e += kThreads)
      if (alive[e]) atomicMax(&m_inv[cluster[e]], inv[e]);
    m = partial[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = merge(m, partial[w]);
    __syncthreads();
    int progress = 0;
    any = 0;
    for (int e = tid; e < E; e += kThreads) {
      if (!alive[e]) continue;
      const int c = cluster[e];
      if (m_inv[c] <= (c == m.c1 ? m.v2 : m.v1)) {
        alive[e] = 0;
        progress = 1;
      } else {
        any = 1;
      }
    }
    ++rounds;
    // The two votes also order this round's reads of m_inv and partial
    // before the next round's writes.
    const bool moved = __syncthreads_or(progress) != 0;
    const bool left = __syncthreads_or(any) != 0;
    running = moved && left && rounds < cap;
    any = left;
  }
  if (tid == 0) {
    decided[row] = any ? 0 : 1;
    rounds_out[row] = rounds;
  }
}

// Shared-memory bytes the smem tier takes at width E (0 when the row does
// not fit and the device-memory tier must run).
long long smem_bytes(int E) {
  const long long b = 13LL * E;
  return b <= kSmemLimit ? b : 0;
}

template <int K>
int launch_warp(const void* inv, const void* cluster, const void* active,
                int B, int E, int cap, void* decided, void* rounds,
                cudaStream_t s) {
  const int blocks = (B + kWarps - 1) / kWarps;
  dc_peel_warp_kernel<K><<<blocks, kThreads, sizeof(int32_t) * kThreads * K,
                           s>>>(
      static_cast<const int32_t*>(inv), static_cast<const int32_t*>(cluster),
      static_cast<const uint8_t*>(active), B, E, cap,
      static_cast<uint8_t*>(decided), static_cast<int32_t*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dc_peel: inv, cluster int32 [B, E] (cluster in [0, E)), active uint8
// [B, E] -> decided uint8 [B], rounds int32 [B]. E <= 256 runs the warp
// tier and takes no scratch; above it, scratch null runs the smem tier,
// else scratch holds B·2·E int32 words for the device-memory tier.
// cap >= 1.
extern "C" int dc_peel(const void* inv, const void* cluster,
                       const void* active, int B, int E, int cap,
                       void* scratch, void* decided, void* rounds,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (E < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (E <= kWarpEvents) {
    if (scratch != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (E <= 32)
      return launch_warp<1>(inv, cluster, active, B, E, cap, decided, rounds,
                            s);
    if (E <= 64)
      return launch_warp<2>(inv, cluster, active, B, E, cap, decided, rounds,
                            s);
    if (E <= 128)
      return launch_warp<4>(inv, cluster, active, B, E, cap, decided, rounds,
                            s);
    return launch_warp<8>(inv, cluster, active, B, E, cap, decided, rounds,
                          s);
  }
  const long long smem = smem_bytes(E);
  if (scratch == nullptr) {
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        dc_peel_block_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dc_peel_block_kernel<true><<<B, kThreads, static_cast<size_t>(smem), s>>>(
        static_cast<const int32_t*>(inv), static_cast<const int32_t*>(cluster),
        static_cast<const uint8_t*>(active), E, cap, nullptr,
        static_cast<uint8_t*>(decided), static_cast<int32_t*>(rounds));
  } else {
    dc_peel_block_kernel<false><<<B, kThreads, 0, s>>>(
        static_cast<const int32_t*>(inv), static_cast<const int32_t*>(cluster),
        static_cast<const uint8_t*>(active), E, cap,
        static_cast<int32_t*>(scratch), static_cast<uint8_t*>(decided),
        static_cast<int32_t*>(rounds));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dc_peel_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
