// Sequential accept of the heuristic prune (kernel K3) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's accept is a lax.scan over
// the sorted candidate columns (hnswindex_tpu/core/heuristic.py
// _accept_scan), which the port ran as a Python loop of about four small
// launches a column (core/heuristic._accept_cols).  A build prunes some
// 770 columns a 1,000 rows, so that loop, and not the device, set the
// build's pace.  This kernel takes the whole accept of one prune call in
// one launch.
//
// Contract (core/heuristic._accept_capped is its plain twin, bit for bit):
// for each row b, whose N candidates are sorted by sd[b, c], their distance
// to the target, and whose pairwise distances are pd[b, c, s] = d(s, c),
//   * a row with fewer than max_edges valid columns accepts every valid
//     column (Heuristic.cs:13-18);
//   * otherwise column c is accepted iff svalid[b, c], fewer than max_edges
//     columns were accepted before it, and no accepted s < c has
//     pd[b, c, s] < sd[b, c] (Heuristic.cs:22-41).  The comparison is the
//     strict float32 `<` of the twin: a tie or a NaN is no conflict.
//   out[b, c] is 1 for an accepted column, else 0.
// Acceptance of c depends only on the accepts before c, so stopping at
// max_edges accepts gives the mask the twin gets by capping its cumulative
// count afterwards.
//
// What bounds it on this card: per row the walk is one chain: column c
// cannot be decided before column c - 1.  Each step reads at most
// max_edges floats of one row of pd (scattered within that row) and takes
// one warp vote, so a row costs O(N * max_edges) loads and never builds
// the (N, N) conflict table.  The least it must move is sd, svalid and the
// pd entries it compares, at most B * N * (max_edges + 2) * 4 bytes (7.0 MB
// at the build's B=512, N=100, 32 edges: 2.1 us at 3.35 TB/s); the chain of a
// load, a vote and a list store per column is what its time follows, and
// the many rows of a call run side by side to hide it.
//
// Design: one warp a row, WPB rows a block.
//  1. The warp counts the row's valid columns (one ballot per 32 columns);
//     a row with fewer than max_edges copies svalid to out and is done.
//  2. It walks the columns 32 at a time: lane l loads svalid and sd of
//     column c0 + l, one ballot gives the chunk's valid columns, and each
//     is taken in order, its sd broadcast by a shuffle.  Lane j reads
//     pd[b, c, acc[j]] for the j-th accepted column (j < n_acc, 32 apart
//     when n_acc > 32) and one __any_sync decides c.  The accepted column
//     indices are a list in shared memory, min(max_edges, N) entries a
//     warp; lane 0 appends, and a __syncwarp publishes the entry.
//  3. Each lane writes its column's bit of the chunk: out is written once,
//     in full, 32 bytes at a time; columns after the last accept write 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WPB = 4;                  // warps (rows) of a block
constexpr unsigned FULL = 0xffffffffu;  // every lane of a warp

__global__ void __launch_bounds__(WPB * 32)
accept_scan_kernel(const float* __restrict__ pd, const float* __restrict__ sd,
                   const uint8_t* __restrict__ svalid,
                   uint8_t* __restrict__ out, int B, int N, int max_edges,
                   int cap) {
  extern __shared__ int32_t lists[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WPB + warp;
  if (b >= B) return;
  int32_t* acc = lists + warp * cap;
  const float* prow = pd + b * N * (long long)N;
  const float* srow = sd + b * N;
  const uint8_t* vrow = svalid + b * N;
  uint8_t* orow = out + b * N;

  int n_valid = 0;
  for (int c0 = 0; c0 < N; c0 += 32) {
    const int c = c0 + lane;
    n_valid += __popc(__ballot_sync(FULL, c < N && vrow[c] != 0));
  }
  const bool keep_all = n_valid < max_edges;

  int n_acc = 0;
  for (int c0 = 0; c0 < N; c0 += 32) {
    const int cl = c0 + lane;
    const bool v = cl < N && vrow[cl] != 0;
    unsigned todo = __ballot_sync(FULL, v);
    unsigned took = 0;
    if (keep_all) {
      took = todo;
    } else {
      const float s = cl < N ? srow[cl] : 0.0f;
      // todo and n_acc are the same in every lane: the loop is uniform
      while (todo != 0 && n_acc < max_edges) {
        const int k = __ffs(todo) - 1;
        todo &= todo - 1;
        const float dc = __shfl_sync(FULL, s, k);
        const float* pc = prow + (long long)(c0 + k) * N;
        bool hit = false;
        for (int j = lane; j < n_acc; j += 32) hit |= pc[acc[j]] < dc;
        if (!__any_sync(FULL, hit)) {
          if (lane == 0) acc[n_acc] = c0 + k;
          __syncwarp();
          ++n_acc;
          took |= 1u << k;
        }
      }
    }
    if (cl < N) orow[cl] = (uint8_t)((took >> lane) & 1u);
  }
}

}  // namespace

// pd (B, N, N) float32, sd (B, N) float32, svalid (B, N) bool, out (B, N)
// bool, all contiguous on the current device; launched on `stream`.
// Returns 0 or the CUDA error of the launch.  The lists take
// 16 * min(max_edges, N) bytes of a block's 48 KB of dynamic shared memory:
// past 3,072 edges and columns the launch is refused and reports it.
extern "C" int hnsw_accept_scan(const void* pd, const void* sd,
                                const void* svalid, void* out, int B, int N,
                                int max_edges, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  int cap = max_edges < N ? max_edges : N;
  if (cap < 1) cap = 1;
  const size_t smem = (size_t)WPB * cap * sizeof(int32_t);
  const unsigned grid = (unsigned)((B + WPB - 1) / WPB);
  accept_scan_kernel<<<grid, WPB * 32, smem, (cudaStream_t)stream>>>(
      (const float*)pd, (const float*)sd, (const uint8_t*)svalid,
      (uint8_t*)out, B, N, max_edges, cap);
  return (int)cudaGetLastError();
}
