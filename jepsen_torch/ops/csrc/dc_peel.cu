// dc_peel.cu — the decrease-and-conquer peel loop of the register class,
// for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/dc_monitor.py:372 get_dc_kernel, a vmapped
// lax.while_loop over plan rows. Inputs per row (E padded events, row-
// major [B, E]): inv int32 (an op's invocation event), cluster int32 (the
// event of the write whose value the op carries, in [0, E)), active
// uint8 (0/1: the op takes part). An op's response time is its own event
// index. Each round of a row:
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
// Why the argmin's tie-break cannot matter: m_resp values of distinct
// clusters are distinct event indices (an event belongs to one cluster),
// so two clusters tie only at BIG. g1 < BIG whenever some op is alive,
// which holds in every round the loop runs, so a1 is unique. The block
// still breaks ties towards the smaller index, as jnp.argmin does.
//
// Design: right and simple first. One block of 256 threads per row; the
// rounds run inside the kernel, so a row costs one launch whatever its
// round count. Shared-memory tier (17·E bytes fit): the row's inv and
// cluster are staged once, and m_resp, m_inv and the alive bytes live in
// shared memory, updated by shared atomicMin / atomicMax. Device-memory
// tier (larger E): m_resp, m_inv and alive live in the row's slice of a
// scratch the wrapper allocates (3·E int32 words a row), inv and cluster
// are read from the inputs each round. A round is: reset (barrier),
// scatter (barrier), a block reduction of the two smallest m_resp
// (shuffles in each warp, one barrier, then every thread merges the eight
// warps' partials itself), the peel pass, and two __syncthreads_or for
// progress and any-alive.
//
// What bounds it on this card. Bytes: at most 9 bytes an event in, 5
// bytes a row out; at the dc path's batch (1,024 rows of E 128) about
// 1.2 MB, under 0.4 us at 3.35 TB/s. Operations: what the peel needs,
// about 4 int32 operations an alive op and 6 a live cluster a round
// (chip_smoke.py's DC_OP_OPS and DC_CLUSTER_OPS, counted over each
// round's alive ops), a few rounds a row. Neither is close: each round
// is five dependent block barriers around short strided loops, so the
// kernel is bound by barrier and shared-atomic latency, a few
// microseconds a round.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kBig = 1 << 30;
// Dynamic shared memory one block may use on an H100, less what the
// kernel keeps statically.
constexpr int kSmemLimit = 232448 - 256;

// Two smallest values of a set, with the smaller's index: (v1, i1) and
// v2, the smallest over every other position.
struct Min2 {
  int32_t v1;
  int32_t i1;
  int32_t v2;
};

__device__ __forceinline__ Min2 merge(Min2 a, Min2 b) {
  if (b.v1 < a.v1 || (b.v1 == a.v1 && b.i1 < a.i1))
    return {b.v1, b.i1, min(a.v1, b.v2)};
  return {a.v1, a.i1, min(a.v2, b.v1)};
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
    dc_peel_kernel(const int32_t* __restrict__ inv_in,
                   const int32_t* __restrict__ cluster_in,
                   const uint8_t* __restrict__ active, int E, int cap,
                   int32_t* scratch, uint8_t* __restrict__ decided,
                   int32_t* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Min2 partial[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(row) * E;
  const int32_t* inv;
  const int32_t* cluster;
  int32_t* m_resp;
  int32_t* m_inv;
  uint8_t* alive;
  if constexpr (kSmem) {
    int32_t* s = reinterpret_cast<int32_t*>(smem);
    m_resp = s;
    m_inv = s + E;
    int32_t* sinv = s + 2 * E;
    int32_t* scl = s + 3 * E;
    alive = reinterpret_cast<uint8_t*>(s + 4 * E);
    for (int e = tid; e < E; e += kThreads) {
      sinv[e] = inv_in[off + e];
      scl[e] = cluster_in[off + e];
    }
    inv = sinv;
    cluster = scl;
  } else {
    int32_t* s = scratch + static_cast<size_t>(row) * 3 * E;
    m_resp = s;
    m_inv = s + E;
    alive = reinterpret_cast<uint8_t*>(s + 2 * E);
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
    for (int e = tid; e < E; e += kThreads) {
      m_resp[e] = kBig;
      m_inv[e] = -1;
    }
    __syncthreads();
    for (int e = tid; e < E; e += kThreads) {
      if (alive[e]) {
        const int c = cluster[e];
        atomicMin(&m_resp[c], e);
        atomicMax(&m_inv[c], inv[e]);
      }
    }
    __syncthreads();
    Min2 m = {kBig, INT_MAX, kBig};
    for (int e = tid; e < E; e += kThreads) m = merge(m, {m_resp[e], e, kBig});
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const Min2 o = {__shfl_xor_sync(0xffffffffu, m.v1, d),
                      __shfl_xor_sync(0xffffffffu, m.i1, d),
                      __shfl_xor_sync(0xffffffffu, m.v2, d)};
      m = merge(m, o);
    }
    if ((tid & 31) == 0) partial[tid >> 5] = m;
    __syncthreads();
    m = partial[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = merge(m, partial[w]);
    int progress = 0;
    any = 0;
    for (int e = tid; e < E; e += kThreads) {
      if (!alive[e]) continue;
      const int c = cluster[e];
      const int32_t t_out = c == m.i1 ? m.v2 : m.v1;
      if (m_resp[c] < kBig && m_inv[c] <= t_out) {
        alive[e] = 0;
        progress = 1;
      } else {
        any = 1;
      }
    }
    ++rounds;
    // The two votes also order this round's reads of m_resp, m_inv and
    // partial before the next round's writes.
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

// Shared-memory bytes the shared-memory tier takes at width E (0 when the
// row does not fit and the device-memory tier must run).
long long smem_bytes(int E) {
  const long long b = 17LL * E;
  return b <= kSmemLimit ? b : 0;
}

}  // namespace

// dc_peel: inv, cluster int32 [B, E] (cluster in [0, E)), active uint8
// [B, E] -> decided uint8 [B], rounds int32 [B]. scratch null for the
// shared-memory tier, else B·3·E int32 words. cap >= 1.
extern "C" int dc_peel(const void* inv, const void* cluster,
                       const void* active, int B, int E, int cap,
                       void* scratch, void* decided, void* rounds,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (E < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(E);
  if (scratch == nullptr) {
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        dc_peel_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dc_peel_kernel<true><<<B, kThreads, static_cast<size_t>(smem), s>>>(
        static_cast<const int32_t*>(inv), static_cast<const int32_t*>(cluster),
        static_cast<const uint8_t*>(active), E, cap, nullptr,
        static_cast<uint8_t*>(decided), static_cast<int32_t*>(rounds));
  } else {
    dc_peel_kernel<false><<<B, kThreads, 0, s>>>(
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
