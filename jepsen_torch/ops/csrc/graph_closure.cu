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
// transitive closure instead, by Warshall's algorithm on bit rows (for
// k = 0..V-1, every row i whose bit k is set ORs in row k; the tiled
// tiers below take the k in blocks of 32). Both have the
// same diagonal: vertex i lies on a cycle iff it lies on a simple cycle,
// and a simple cycle has at most V edges, so the squarings reach it too.
// Both the reference and this kernel report the diagonal only, so they
// agree bit for bit. The txn entry first builds the SI plane word by
// word: RW = G2 & ~G1c (the reference's max(G2 - G1c, 0) on 0/1
// entries), and SI[i] = N[i] | OR_{k : RW[i] bit k} N[k] with N = G1c,
// the boolean form of min(N + RW·N, 1).
//
// Design.
//   * warp tier (V <= 32, one word per row): one warp per plane, lane i
//     holds row i in a register. Warshall step k broadcasts row k with
//     one shuffle; the probe is one ballot. Eight planes per block.
//   * tiled tiers (V >= 64): blocked Warshall on 32 x 32 bit tiles. Tile
//     (I, J) is the 32 words of rows 32I..32I+31 in column word J; row r
//     is word (r + J) mod 32 of them, so that a warp reads a tile, and
//     writes a row's words, without bank conflicts. With T = V/32, round
//     K of T closes the plane over the intermediate vertices of block K:
//       1. one warp closes the diagonal tile (K, K) (lane r holds row r;
//          step k broadcasts row k by a shuffle), giving D*;
//       2. every tile of row block K becomes A | D*·A, and every tile
//          of column block K becomes A | A·D* (32 shuffles a tile);
//       3. every other tile (I, J) becomes C | A(I,K)·A(K,J): a warp
//          takes a column J (or part of one), builds the eight 16-entry
//          tables of ORs of A(K,J)'s rows by nibble (the method of Four
//          Russians), and each lane ORs in eight table words chosen by
//          its A(I,K) word's nibbles, skipping a zero word.
//     The tiles lie in shared memory while the plane and the warps'
//     tables fit in one block (V <= 1024: 144 KiB, opted in above 48
//     KB). There a plane spreads over a thread-block cluster of C = 2,
//     4 or 8 CTAs when the batch has few enough planes (the wrapper's
//     plan, ops/cuda_graph.py tile_plan: the widest cluster that keeps
//     the batch within one CTA an SM): CTA c holds row blocks [c·T/C,
//     (c+1)·T/C), updates only its own tiles, and reads round K's D*
//     and row block K from the CTA that owns block K through distributed
//     shared memory, with two cluster barriers a round. From V 2048 a
//     plane's tiles lie in a global-memory scratch slice (the slice
//     stays in the 50 MB L2), one block a plane. Three barriers a round:
//     3·V/32 a plane, against V for the first design, which had each
//     step of Warshall OR row k into every row with bit k set (three
//     shared-memory accesses a word a step, V barriers a plane: about 3
//     µs a step at V 1024 on an H100).
//
// What bounds it on this card. Warshall costs V·Wd word ORs per step,
// L·V²·Wd per graph (plus V²·Wd for the SI prologue): 128 graphs at
// V = 1024 are about 12.9 G word operations, 0.77 ms at the card's int32
// rate of 16.75 T/s, while the packed planes are only 48 MiB to read
// (0.015 ms at 3.35 TB/s). So it is bound by operations at large V; at
// V <= 32 the work is a few thousand operations a plane and a batch is
// bound by its launch. The tiled tiers do T³ tile products a plane,
// each ten shared-memory loads a lane: at V 1024 about 330,000 warp
// loads a plane, so one plane an SM is bound by shared memory; a batch
// of fewer planes than SMs spreads its planes over clusters.

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpMaxV = 32;
constexpr int kWarpPlanesPerBlock = 8;
constexpr int kBlockMaxThreads = 1024;
// Table words a warp of a tiled block keeps: eight nibble tables of 16.
constexpr int kTableWords = 128;
// CTAs a plane at most (the portable cluster size).
constexpr int kMaxCluster = 8;
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

// Tiled tiers: the word index of row r of tile (I, J) in a block of
// tiles T wide.
__device__ __forceinline__ int tile_word(int I, int J, int r, int T) {
  return ((I * T + J) << 5) | ((r + J) & 31);
}

namespace cg = cooperative_groups;

// A barrier over the plane's CTAs: the cluster's, or the block's alone.
__device__ __forceinline__ void plane_sync(int c_shift) {
  if (c_shift > 0) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// `p` (this CTA's shared memory) in CTA `rank` of the plane's cluster;
// `p` itself for this CTA, or when the plane has one CTA.
template <typename P>
__device__ __forceinline__ P* on_rank(P* p, int rank, int self,
                                      int c_shift) {
  if (c_shift == 0 || rank == self) return p;
  return cg::this_cluster().map_shared_rank(p, rank);
}

// C = 2^c_shift CTAs a plane (a thread-block cluster when C > 1), blocked
// Warshall on 32 x 32 bit tiles. CTA c holds the tiles of row blocks
// [c·Tc, c·Tc + Tc), Tc = T / C, at tile_word(I - c·Tc, J, r, T), in its
// shared memory, or (C = 1) in the plane's slice of `scratch` when
// `scratch` is not null; each warp keeps kTableWords table words in
// shared memory after the tiles (or from its start). Round K's owner
// (the CTA of row block K) closes the diagonal tile; after a plane
// barrier it updates row block K and every CTA its own tiles of column
// block K, reading D* from the owner; after another, every CTA updates
// its other tiles, building the tables from the owner's row block K.
// Indices are 32-bit: a plane holds at most V·Wd = 2^25 words (V <=
// 32768, checked by the wrapper).
__global__ void __launch_bounds__(kBlockMaxThreads)
closure_tiled_kernel(const uint32_t* __restrict__ adj, int l_in, int l_out,
                     int V, int t_shift, int c_shift, int si_plane,
                     uint32_t* scratch, bool* cyc, int32_t* node) {
  extern __shared__ uint32_t smem_tiles[];
  __shared__ int first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int T = 1 << t_shift;
  const int tc_shift = t_shift - c_shift;
  const int Tc = 1 << tc_shift;
  const int E = V << t_shift;
  const int Ec = E >> c_shift;
  const long long plane_id = blockIdx.x >> c_shift;
  const int rank = blockIdx.x & ((1 << c_shift) - 1);
  const int I_lo = rank << tc_shift;
  const long long b = plane_id / l_out;
  const int p = static_cast<int>(plane_id % l_out);
  uint32_t* tiles = scratch ? scratch + plane_id * E : smem_tiles;
  uint32_t* table = (scratch ? smem_tiles : smem_tiles + Ec) +
                    warp * kTableWords;
  const uint32_t* g = adj + b * l_in * E;
  if (tid == 0) first = INT_MAX;

  const int row_lo = I_lo << 5, row_hi = (I_lo + Tc) << 5;
  if (p == si_plane) {
    // Thread t builds word column w = t % T of rows t / T, t / T + R, ...
    const uint32_t* n = g + 1 * E;
    const uint32_t* g2 = g + 3 * E;
    const int w = tid & (T - 1);
    const int R = blockDim.x >> t_shift;
    for (int i = row_lo + (tid >> t_shift); i < row_hi; i += R) {
      uint32_t acc = n[(i << t_shift) + w];
      for (int u = 0; u < T; ++u) {
        uint32_t rw = g2[(i << t_shift) + u] & ~n[(i << t_shift) + u];
        while (rw) {
          const int c = __ffs(rw) - 1;
          rw &= rw - 1u;
          acc |= n[((u * 32 + c) << t_shift) + w];
        }
      }
      tiles[tile_word((i >> 5) - I_lo, w, i & 31, T)] = acc;
    }
  } else {
    const uint32_t* src = g + p * E + (row_lo << t_shift);
    for (int e = tid; e < Ec; e += blockDim.x) {
      const int i = e >> t_shift;
      tiles[tile_word(i >> 5, e & (T - 1), i & 31, T)] = src[e];
    }
  }
  __syncthreads();

  // Phase 3's work items: column J of own tile rows [seg·len, seg·len +
  // len) (the plan keeps nwarps <= Tc·T, so that len >= 1).
  const int nseg = nwarps > T ? nwarps / T : 1;
  const int seg_len = Tc / nseg;
  for (int K = 0; K < T; ++K) {
    const int o = K >> tc_shift;
    const bool owner = o == rank;
    const int Ko = K - (o << tc_shift);   // K's tile row in its owner
    // 1. The diagonal tile's closure.
    if (owner && warp == 0) {
      const int at = tile_word(Ko, K, lane, T);
      uint32_t d = tiles[at];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const uint32_t dk = __shfl_sync(0xFFFFFFFFu, d, k);
        if ((d >> k) & 1u) d |= dk;
      }
      tiles[at] = d;
    }
    plane_sync(c_shift);
    // 2. Row block K (its owner): A | D*·A; own tiles of column block K:
    //    A | A·D*.
    const uint32_t* kt = on_rank(tiles, o, rank, c_shift);
    const uint32_t dstar = kt[tile_word(Ko, K, lane, T)];
    const int nrow = owner ? T - 1 : 0;
    const int ncol = Tc - (owner ? 1 : 0);
    for (int q = warp; q < nrow + ncol; q += nwarps) {
      const bool row_block = q < nrow;
      int at;
      if (row_block) {
        at = tile_word(Ko, q < K ? q : q + 1, lane, T);
      } else {
        const int i = q - nrow;
        at = tile_word(owner && i >= Ko ? i + 1 : i, K, lane, T);
      }
      const uint32_t a = tiles[at];
      uint32_t acc = a;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (row_block) {
          const uint32_t ak = __shfl_sync(0xFFFFFFFFu, a, k);
          if ((dstar >> k) & 1u) acc |= ak;
        } else {
          const uint32_t dk = __shfl_sync(0xFFFFFFFFu, dstar, k);
          if ((a >> k) & 1u) acc |= dk;
        }
      }
      if (acc != a) tiles[at] = acc;
    }
    plane_sync(c_shift);
    // 3. Every other own tile: C | A(I,K)·A(K,J), by nibble tables of
    //    the owner's A(K,J).
    for (int q = warp; q < T * nseg; q += nwarps) {
      const int J = q & (T - 1);
      if (J == K) continue;
      const uint32_t brow = kt[tile_word(Ko, J, lane, T)];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = lane + 32 * x;
        const int base = (e >> 4) << 2, m = e & 15;
        uint32_t v = 0;
#pragma unroll
        for (int bit = 0; bit < 4; ++bit) {
          const uint32_t rb = __shfl_sync(0xFFFFFFFFu, brow, base + bit);
          if ((m >> bit) & 1) v |= rb;
        }
        table[e] = v;
      }
      __syncwarp();
      const int i0 = (q >> t_shift) * seg_len;
      for (int i = i0; i < i0 + seg_len; ++i) {
        if (owner && i == Ko) continue;
        const uint32_t a = tiles[tile_word(i, K, lane, T)];
        if (a) {
          const int at = tile_word(i, J, lane, T);
          const uint32_t c = tiles[at];
          uint32_t acc = c;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            acc |= table[(n << 4) | ((a >> (4 * n)) & 15u)];
          if (acc != c) tiles[at] = acc;
        }
      }
      __syncwarp();
    }
    // The next round's first plane barrier orders these reads of the
    // owner's tiles before the owner changes them again.
    __syncthreads();
  }

  for (int i = tid; i < (Tc << 5); i += blockDim.x) {
    if ((tiles[tile_word(i >> 5, (i >> 5) + I_lo, i & 31, T)] >>
         (i & 31)) & 1u)
      atomicMin(&first, row_lo + i);
  }
  plane_sync(c_shift);
  if (rank == 0 && tid == 0) {
    int f = first;
    for (int r = 1; r < (1 << c_shift); ++r)
      f = min(f, *on_rank(&first, r, 0, c_shift));
    cyc[plane_id] = f != INT_MAX;
    node[plane_id] = f;
  }
  // Every CTA keeps its shared memory until rank 0 has read it.
  if (c_shift > 0) cg::this_cluster().sync();
}

int log2_exact(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

int launch(const void* adj, int B, int l_in, int l_out, int V, int si_plane,
           int cluster, void* scratch, void* cyc, void* node,
           void* stream) {
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
  const int T = V / 32;
  const int c_shift = log2_exact(cluster);
  if (cluster < 1 || (1 << c_shift) != cluster || cluster > kMaxCluster
      || cluster > T || (scratch != nullptr && cluster != 1)
      || planes * cluster > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long E = static_cast<long long>(V) * T;
  const int threads = static_cast<int>(std::min<long long>(
      kBlockMaxThreads, 32LL * (T / cluster) * T));
  const long long tables = (threads / 32) * kTableWords * 4LL;
  const long long smem_bytes =
      (scratch == nullptr ? E * 4 / cluster : 0) + tables;
  if (smem_bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = static_cast<size_t>(smem_bytes);
  cudaError_t e = cudaFuncSetAttribute(
      closure_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* a = static_cast<const uint32_t*>(adj);
  auto* sc = static_cast<uint32_t*>(scratch);
  auto* cy = static_cast<bool*>(cyc);
  auto* nd = static_cast<int32_t*>(node);
  const int t_shift = log2_exact(T);
  if (cluster == 1) {
    closure_tiled_kernel<<<static_cast<unsigned>(planes), threads, dyn, s>>>(
        a, l_in, l_out, V, t_shift, 0, si_plane, sc, cy, nd);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes * cluster), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, closure_tiled_kernel, a, l_in, l_out, V,
                         t_shift, c_shift, si_plane, sc, cy, nd);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The graph entry: adj uint32 [B, 3, V, Wd] -> cyc bool [B, 3], node int32
// [B, 3]. `cluster` CTAs a plane at V >= 64 (a power of two to
// min(kMaxCluster, V/32); 1 with `scratch`). `scratch` is null when the
// tiles fit in shared memory, else B * 3 * V * Wd words of device
// memory.
extern "C" int graph_closure(const void* adj, int B, int V, int cluster,
                             void* scratch, void* cyc, void* node,
                             void* stream) {
  return launch(adj, B, 3, 3, V, -1, cluster, scratch, cyc, node, stream);
}

// The txn entry: adj uint32 [B, 4, V, Wd] (G0, G1c, G2-item, G2) -> cyc
// bool [B, 5], node int32 [B, 5], plane 4 the derived SI plane.
// `cluster` and `scratch` as above, B * 5 * V * Wd words.
extern "C" int txn_closure(const void* adj, int B, int V, int cluster,
                           void* scratch, void* cyc, void* node,
                           void* stream) {
  return launch(adj, B, 4, 5, V, 4, cluster, scratch, cyc, node, stream);
}

extern "C" const char* graph_closure_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
