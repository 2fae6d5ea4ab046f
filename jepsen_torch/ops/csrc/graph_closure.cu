// graph_closure.cu — bit-packed transitive closure and cycle probe of
// dependency-graph planes, for Hopper (sm_90a).
//
// Replaces two TPU device programs that compute one algorithm:
//   * jepsen_tpu/ops/graph.py::graph_kernel (the graph entry,
//     graph_closure: 3 cumulative anomaly planes G0 ⊂ G1c ⊂ G2);
//   * jepsen_tpu/ops/txn_graph.py::txn_kernel (the txn entry,
//     txn_closure: 4 packed ladder planes in, the snapshot-isolation
//     plane derived, 5 planes closed).
// The outputs are the same, bit for bit: the plain PyTorch versions
// plain_graph_closure (ops/graph.py) and plain_txn_closure
// (ops/txn_graph.py) are the yardstick.
//
// What it computes. A plane is V rows of Wd = max(V/32, 1) 32-bit words;
// bit c of word w on row i is the edge i -> w*32 + c (the reference's
// np.packbits(..., bitorder="little") words). Per plane: cyc = "some
// vertex lies on a cycle" and node = the smallest such vertex, INT32_MAX
// when there is none. The reference finds them on the diagonal of
// min(A + A·A, 1) after bitlen(V-1) squarings, which closes every path
// of length <= 2^bitlen(V-1) >= V. This kernel computes the full
// transitive closure instead, by Warshall's algorithm on bit rows: for
// k = 0..V-1, every row i whose bit k is set ORs in row k. Both have the
// same diagonal: vertex i lies on a cycle iff it lies on a simple cycle,
// and a simple cycle has at most V edges, so the squarings reach it too.
// Both the reference and this kernel report the diagonal only, so they
// agree bit for bit. The txn entry first builds the SI plane word by
// word: RW = G2 & ~G1c (the reference's max(G2 - G1c, 0) on 0/1
// entries), and SI[i] = N[i] | OR_{k : RW[i] bit k} N[k] with N = G1c,
// the boolean form of min(N + RW·N, 1).
//
// Design: right and simple first.
//   * warp tier (V <= 32, one word per row): one warp per plane, lane i
//     holds row i in a register. Warshall step k broadcasts row k with
//     one shuffle; the probe is one ballot. Eight planes per block.
//   * block tier (V >= 64): one block per plane. Its rows live in shared
//     memory while V·Wd·4 bytes fit (V <= 1024: 128 KiB, opted in above
//     48 KB), else in a global-memory scratch slice of the plane (V >=
//     2048; the slice stays in the 50 MB L2). Thread t keeps word column
//     t % Wd of rows t / Wd + j·T/Wd, so a warp reads one row's
//     consecutive words, and step k reads row i's word k/32 as a
//     broadcast. Step k changes no word of row k (it would OR row k into
//     itself), so the reads of row k and the writes of other rows need
//     no barrier inside a step; one __syncthreads ends each step.
//
// What bounds it on this card. Warshall costs V·Wd word ORs per step,
// L·V²·Wd per graph (plus V²·Wd for the SI prologue): 128 graphs at
// V = 1024 are about 12.9 G word operations, 0.77 ms at the card's int32
// rate of 16.75 T/s, while the packed planes are only 48 MiB to read
// (0.015 ms at 3.35 TB/s). So it is bound by operations at large V; at
// V <= 32 the work is a few thousand operations a plane and a batch is
// bound by its launch. The block tier's barrier per step (V barriers a
// plane) and the skipped rows (an OR only where bit k is set) are where
// a later version would gain: a blocked Floyd–Warshall or bit-matrix
// squaring on the tensor cores' binary path.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpMaxV = 32;
constexpr int kWarpPlanesPerBlock = 8;
constexpr int kBlockMaxThreads = 1024;
// Dynamic shared memory one block may use on an H100.
constexpr int kSmemLimit = 232448 - 64;

// Warp tier: one warp per plane, lane i holds row i (V <= 32, Wd = 1).
// `si_plane` is the output plane derived as SI (-1 for none); every other
// output plane p closes input plane p.
__global__ void closure_warp_kernel(const uint32_t* __restrict__ adj, int B,
                                    int l_in, int l_out, int V,
                                    int si_plane, bool* __restrict__ cyc,
                                    int32_t* __restrict__ node) {
  const int lane = threadIdx.x & 31;
  const long long plane_id =
      static_cast<long long>(blockIdx.x) * kWarpPlanesPerBlock +
      (threadIdx.x >> 5);
  if (plane_id >= static_cast<long long>(B) * l_out) return;  // whole warp
  const long long b = plane_id / l_out;
  const int p = static_cast<int>(plane_id % l_out);
  const uint32_t* g = adj + b * l_in * V;  // Wd = 1: row i is word i
  const bool live = lane < V;
  uint32_t row;
  if (p == si_plane) {
    const uint32_t n = live ? g[1 * V + lane] : 0u;
    const uint32_t rw = live ? (g[3 * V + lane] & ~n) : 0u;
    row = n;
    for (int k = 0; k < V; ++k) {
      const uint32_t nk = __shfl_sync(0xFFFFFFFFu, n, k);
      if ((rw >> k) & 1u) row |= nk;
    }
  } else {
    row = live ? g[p * V + lane] : 0u;
  }
  for (int k = 0; k < V; ++k) {
    const uint32_t rk = __shfl_sync(0xFFFFFFFFu, row, k);
    if ((row >> k) & 1u) row |= rk;
  }
  const uint32_t diag =
      __ballot_sync(0xFFFFFFFFu, live && ((row >> lane) & 1u));
  if (lane == 0) {
    cyc[plane_id] = diag != 0u;
    node[plane_id] = diag ? __ffs(diag) - 1 : INT_MAX;
  }
}

// Block tier: one block per plane; rows in shared memory, or in the
// plane's slice of `scratch` when `scratch` is not null. The block's
// threads are a multiple of Wd, so thread t keeps one word column w =
// t % Wd and takes rows t / Wd, t / Wd + T / Wd, ...; step k loads its
// column of row k once. Indices are 32-bit: a plane holds at most
// V·Wd = 2^25 words (V <= 32768, checked by the wrapper).
__global__ void closure_block_kernel(const uint32_t* __restrict__ adj,
                                     int l_in, int l_out, int V,
                                     int wd_shift, int si_plane,
                                     uint32_t* scratch, bool* cyc,
                                     int32_t* node) {
  extern __shared__ uint32_t smem_rows[];
  __shared__ int first;
  const int tid = threadIdx.x;
  const int Wd = 1 << wd_shift;
  const int E = V << wd_shift;
  const int w = tid & (Wd - 1);
  const int i0 = tid >> wd_shift;
  const int R = blockDim.x >> wd_shift;  // rows a pass of the block covers
  const long long plane_id = blockIdx.x;
  const long long b = plane_id / l_out;
  const int p = static_cast<int>(plane_id % l_out);
  uint32_t* rows = scratch ? scratch + plane_id * E : smem_rows;
  const uint32_t* g = adj + b * l_in * E;
  if (tid == 0) first = INT_MAX;

  if (p == si_plane) {
    const uint32_t* n = g + 1 * E;
    const uint32_t* g2 = g + 3 * E;
    for (int i = i0; i < V; i += R) {
      uint32_t acc = n[(i << wd_shift) + w];
      for (int u = 0; u < Wd; ++u) {
        uint32_t rw = g2[(i << wd_shift) + u] & ~n[(i << wd_shift) + u];
        while (rw) {
          const int c = __ffs(rw) - 1;
          rw &= rw - 1u;
          acc |= n[((u * 32 + c) << wd_shift) + w];
        }
      }
      rows[(i << wd_shift) + w] = acc;
    }
  } else {
    const uint32_t* src = g + p * E;
    for (int e = tid; e < E; e += blockDim.x) rows[e] = src[e];
  }
  __syncthreads();

  for (int k = 0; k < V; ++k) {
    const int kw = k >> 5;
    const uint32_t kb = 1u << (k & 31);
    const uint32_t rk = rows[(k << wd_shift) + w];  // row k is fixed in step k
    for (int i = i0; i < V; i += R) {
      if (i != k && (rows[(i << wd_shift) + kw] & kb))
        rows[(i << wd_shift) + w] |= rk;
    }
    __syncthreads();
  }

  for (int i = tid; i < V; i += blockDim.x) {
    if (rows[(i << wd_shift) + (i >> 5)] & (1u << (i & 31)))
      atomicMin(&first, i);
  }
  __syncthreads();
  if (tid == 0) {
    cyc[plane_id] = first != INT_MAX;
    node[plane_id] = first;
  }
}

int log2_exact(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

int launch(const void* adj, int B, int l_in, int l_out, int V, int si_plane,
           void* scratch, void* cyc, void* node, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long planes = static_cast<long long>(B) * l_out;
  if (planes == 0) return 0;
  if (V <= kWarpMaxV) {
    const long long blocks =
        (planes + kWarpPlanesPerBlock - 1) / kWarpPlanesPerBlock;
    closure_warp_kernel<<<static_cast<unsigned>(blocks),
                          32 * kWarpPlanesPerBlock, 0, s>>>(
        static_cast<const uint32_t*>(adj), B, l_in, l_out, V, si_plane,
        static_cast<bool*>(cyc), static_cast<int32_t*>(node));
    return static_cast<int>(cudaGetLastError());
  }
  const int wd = V / 32;
  const long long E = static_cast<long long>(V) * wd;
  const int threads = static_cast<int>(
      E < kBlockMaxThreads ? ((E + 31) / 32) * 32 : kBlockMaxThreads);
  const long long smem_bytes = E * 4;
  size_t dyn = 0;
  if (scratch == nullptr) {
    if (smem_bytes > kSmemLimit)
      return static_cast<int>(cudaErrorInvalidValue);
    dyn = static_cast<size_t>(smem_bytes);
    cudaError_t e = cudaFuncSetAttribute(
        closure_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  closure_block_kernel<<<static_cast<unsigned>(planes), threads, dyn, s>>>(
      static_cast<const uint32_t*>(adj), l_in, l_out, V, log2_exact(wd),
      si_plane, static_cast<uint32_t*>(scratch), static_cast<bool*>(cyc),
      static_cast<int32_t*>(node));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The graph entry: adj uint32 [B, 3, V, Wd] -> cyc bool [B, 3], node int32
// [B, 3]. `scratch` is null when the rows fit in shared memory, else
// B * 3 * V * Wd words of device memory.
extern "C" int graph_closure(const void* adj, int B, int V, void* scratch,
                             void* cyc, void* node, void* stream) {
  return launch(adj, B, 3, 3, V, -1, scratch, cyc, node, stream);
}

// The txn entry: adj uint32 [B, 4, V, Wd] (G0, G1c, G2-item, G2) -> cyc
// bool [B, 5], node int32 [B, 5], plane 4 the derived SI plane. `scratch`
// as above, B * 5 * V * Wd words.
extern "C" int txn_closure(const void* adj, int B, int V, void* scratch,
                           void* cyc, void* node, void* stream) {
  return launch(adj, B, 4, 5, V, 4, scratch, cyc, node, stream);
}

extern "C" const char* graph_closure_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
