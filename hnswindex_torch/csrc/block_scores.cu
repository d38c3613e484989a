// Probed-block scoring (kernel K2) for Hopper (sm_90a).
//
// Replaces the Pallas kernel hnswindex_tpu/ops/pallas_block.py:block_scores.
// For every query b and probe p it returns the distances from q_b to all BS
// rows of block bids[b, p]:
//     out[b, p*BS + r] = dist(q_b, blk[bids[b, p], r, :])
// for sq_euclid (|q|^2 + |v|^2 - 2 q.v), cosine (1 - q.v / (|q| |v|), and
// exactly 1 when either norm is zero) and ucosine (1 - q.v).  A block id
// below 0 is clamped to block 0 and scored like any other; callers mask
// those columns.  Tiles are float32 or bfloat16; q arrives in the tile type.
// Every product is widened to float32 and summed in float32 (FMA on the CUDA
// cores, no TF32), and both norms are taken in float32 from the stored
// values.
//
// What bounds it on this card: two flops per tile element and probe, i.e.
// 0.5 flop per byte for float32 tiles read once: bound by bytes, three
// orders of magnitude below the line where arithmetic would matter.  The
// least it must move is each DISTINCT probed tile once.  At the block path's
// shape (13,568 blocks of 128 x 128 float32, 1,024 queries x 32 probes) one
// thread block per (query, probe), as the TPU kernel's grid has it, reads
// 32,768 tiles of 64 KB = 2.15 GB, though only about 12,200 distinct tiles
// (0.80 GB) are probed: the 889 MB table does not fit the 50 MB L2, so a
// tile two queries probe crosses device memory twice.  So the pairs are
// grouped by block and each tile is read once for all queries that probe it.
//
// Four steps, all on the caller's stream, no host sync:
//  1. Group the pairs (a counting sort on the device).  count_kernel counts
//     pairs per clamped block id with atomics; segment_kernel (one block)
//     takes the exclusive scan of the counts (segment offsets) and, in the
//     same scan, of ceil(count / qt): it writes one work item (block, first
//     pair, count <= qt) per qt pairs of a segment and the number of items
//     to counts[NB].  scatter_kernel writes each pair's flat index b*P+p
//     into its block's segment.  The order inside a segment is whatever
//     the atomics give; it does not matter, since every output column is
//     computed from one pair alone by the same instructions wherever the
//     pair sits: the panel is bit-for-bit the same for any order.  Work
//     items keep a hot block (the -1 pads all land on block 0; clustered
//     traffic sends many queries to one block) from serialising on one SM.
//  2. Stage the tile once.  score_kernel runs one thread block per work
//     item (the grid is the wrapper's upper bound on the item count;
//     blocks past the real count exit).  The tile is copied into shared
//     memory in chunks of RB rows (all BS rows when the tile fits the
//     wrapper's budget, else two buffers that alternate so the next chunk
//     is in flight while this one is scored), each chunk one 1-D TMA bulk
//     copy completing on an mbarrier.  A slab that is not 16-byte aligned
//     or whose rows are not a multiple of 16 bytes (D=100 bf16, D=50) is
//     copied by plain loads instead, in the same kernel.  Each row's
//     squared norm is taken once per tile, in float32, into shared memory.
//  3. Score.  The item's queries are widened to float32 in shared memory
//     with their squared norms.  For each query, each warp takes four rows
//     at a time: lanes read four elements of each row per step from shared
//     memory (16 bytes of float32, 8 of bfloat16, so a 128-wide row keeps
//     all 32 lanes busy), and the dots are FMAs in float32.  The four dots
//     are reduced over the warp together, in 6 shuffles where a warp sum
//     per row takes 20, and leave each group of eight lanes holding one
//     row's dot, so the metric (a square root and a division under cosine)
//     is applied to the four rows at once.  With each tile read once, these
//     instructions and not the bytes are what the kernel's time follows: a
//     warp sum per row and the metric taken lane by lane left bfloat16
//     tiles (half the bytes) as slow as float32 ones.
//  4. Write each pair's distances for the chunk at out[b, p*BS + chunk
//     rows]: a warp's four rows are one 16-byte run, and the block's warps
//     together write the pair's whole run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads of a scoring block
constexpr int NW = NT / 32;       // warps of a scoring block
constexpr int RU = 4;             // rows a warp takes at a time
constexpr int LR = 32 / RU;       // lanes left holding one row's sum
constexpr int ST = 1024;          // threads of the segment scan
constexpr int GT = 256;           // threads of the count and scatter blocks

template <typename T> struct Tile;

// N elements per shared-memory load: 16 bytes of float32, 8 of bfloat16,
// so that a 128-wide row keeps all 32 lanes busy either way.
template <> struct Tile<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ float one(float x) { return x; }
};

template <> struct Tile<__nv_bfloat16> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The warp sums of a lane's RU partial sums, one per row, in RU - 1 +
// log2(LR) shuffles instead of 5 * RU: each of the first log2(RU) steps of
// the butterfly hands the partner the half of the sums this lane gives up
// and keeps the other half.  Returns the sum of row lane / LR, which the
// LR lanes of that group all hold.  The order of the additions depends on
// the row and lane only.
__device__ __forceinline__ float rows_sum(float (&x)[RU], int lane) {
#pragma unroll
  for (int n = RU, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool hi = lane & o;
#pragma unroll
    for (int k = 0; k < n / 2; ++k) {
      const float give = hi ? x[k] : x[k + n / 2];
      const float keep = hi ? x[k + n / 2] : x[k];
      x[k] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
  }
  float s = x[0];
#pragma unroll
  for (int o = LR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ int clamp_block(int bid, int NB) {
  return min(max(bid, 0), NB - 1);
}

// -- step 1: group the pairs by block --------------------------------------

__global__ void count_kernel(const int32_t* __restrict__ bids,
                             int32_t* __restrict__ counts, long long n,
                             int NB) {
  for (long long i = (long long)blockIdx.x * GT + threadIdx.x; i < n;
       i += (long long)gridDim.x * GT)
    atomicAdd(&counts[clamp_block(bids[i], NB)], 1);
}

// One block.  Thread t owns blocks [t*per, t*per + per); the exclusive scan
// of (pairs, work items) over the threads gives each its first offset and
// first item.
__global__ void __launch_bounds__(ST)
segment_kernel(const int32_t* __restrict__ counts,
               int32_t* __restrict__ offsets, int32_t* __restrict__ items,
               int32_t* __restrict__ n_items, int NB, int qt) {
  __shared__ int wsum[ST / 32][2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (NB + ST - 1) / ST;
  const int lo = min(NB, tid * per);
  const int hi = min(NB, lo + per);
  int s = 0, m = 0;
  for (int b = lo; b < hi; ++b) {
    const int c = counts[b];
    s += c;
    m += (c + qt - 1) / qt;
  }
  int is = s, im = m;                       // inclusive scan in the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ts = __shfl_up_sync(0xffffffffu, is, o);
    const int tm = __shfl_up_sync(0xffffffffu, im, o);
    if (lane >= o) { is += ts; im += tm; }
  }
  if (lane == 31) { wsum[warp][0] = is; wsum[warp][1] = im; }
  __syncthreads();
  if (warp == 0) {                          // ST / 32 == 32 warp totals
    int a = wsum[lane][0], e = wsum[lane][1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ta = __shfl_up_sync(0xffffffffu, a, o);
      const int te = __shfl_up_sync(0xffffffffu, e, o);
      if (lane >= o) { a += ta; e += te; }
    }
    wsum[lane][0] = a;
    wsum[lane][1] = e;
  }
  __syncthreads();
  int off = is - s + (warp ? wsum[warp - 1][0] : 0);
  long long k = im - m + (warp ? wsum[warp - 1][1] : 0);
  for (int b = lo; b < hi; ++b) {
    const int c = counts[b];
    offsets[b] = off;
    for (int j = 0; j < c; j += qt, ++k) {
      items[3 * k] = b;
      items[3 * k + 1] = off + j;
      items[3 * k + 2] = min(qt, c - j);
    }
    off += c;
  }
  if (tid == ST - 1) {
    offsets[NB] = off;
    *n_items = (int32_t)k;
  }
}

// Takes the counts back to zero on the way: a pair's slot in its segment is
// the count left when it decrements it.
__global__ void scatter_kernel(const int32_t* __restrict__ bids,
                               int32_t* __restrict__ counts,
                               const int32_t* __restrict__ offsets,
                               int32_t* __restrict__ order, long long n,
                               int NB) {
  for (long long i = (long long)blockIdx.x * GT + threadIdx.x; i < n;
       i += (long long)gridDim.x * GT) {
    const int b = clamp_block(bids[i], NB);
    order[offsets[b] + atomicSub(&counts[b], 1) - 1] = (int32_t)i;
  }
}

// -- steps 2-4: score each work item ---------------------------------------

// Shared memory of a scoring block, in bytes from its base; the wrapper's
// _smem_bytes mirrors it.  `buf` is one tile buffer of RB rows.
struct Layout {
  size_t buf, bars, qs, qn, pairs, nrm, total;
};

__host__ __device__ inline Layout layout(int BS, int D, int RB, int qt,
                                         int elem) {
  Layout L;
  const size_t Dp = (size_t)((D + 3) & ~3);  // keeps query rows 16-byte aligned
  L.buf = ((size_t)RB * D * elem + 15) & ~(size_t)15;
  L.bars = (RB < BS ? 2 : 1) * L.buf;
  L.qs = L.bars + 16;
  L.qn = L.qs + (size_t)qt * Dp * 4;
  L.pairs = L.qn + (size_t)qt * 4;
  L.nrm = L.pairs + (size_t)qt * 4;
  L.total = L.nrm + (size_t)RB * 4;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of the given parity has completed.  A wait that
// outlasts 2^20 polls (far longer than any chunk's copy) can only be a lost
// copy, and traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 20)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One contiguous global -> shared copy by the TMA unit, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// metric: 0 sq_euclid, 1 cosine, 2 ucosine.  VEC: D is a multiple of 4,
// so shared memory is read four elements a lane at a time; `bulk`: rows are
// a multiple of 16 bytes and the table is 16-byte aligned, so the tile
// comes in by TMA.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
score_kernel(const T* __restrict__ blk, const T* __restrict__ q,
             float* __restrict__ out, const int32_t* __restrict__ order,
             const int32_t* __restrict__ items,
             const int32_t* __restrict__ n_items, int BS, int D, int P,
             int RB, int qt, int metric, int bulk) {
  const long long item = blockIdx.x;
  if (item >= *n_items) return;
  const int bid = items[3 * item];
  const int first = items[3 * item + 1];
  const int cnt = items[3 * item + 2];

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(BS, D, RB, qt, sizeof(T));
  const uint32_t bar0 = smem_u32(smem + L.bars);
  float* qs = reinterpret_cast<float*>(smem + L.qs);     // (qt, Dp)
  float* qn = reinterpret_cast<float*>(smem + L.qn);     // (qt,)
  int32_t* pairs = reinterpret_cast<int32_t*>(smem + L.pairs);
  float* nrm = reinterpret_cast<float*>(smem + L.nrm);   // (RB,)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Dp = (D + 3) & ~3;
  const int nchunks = (BS + RB - 1) / RB;
  const T* tile = blk + (long long)bid * BS * D;

  if (bulk && tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(2, nchunks); ++c)
      bulk_load(smem_u32(smem + c * L.buf), tile + (long long)c * RB * D,
                (uint32_t)(min(RB, BS - c * RB) * D * sizeof(T)),
                bar0 + 8 * c);
  }

  // the item's queries, float32, while the first chunks are in flight
  for (int i = tid; i < cnt; i += NT) pairs[i] = order[first + i];
  __syncthreads();
  for (int e = tid; e < cnt * D; e += NT) {
    const int i = e / D, d = e - i * D;
    qs[i * Dp + d] = Tile<T>::one(q[(long long)(pairs[i] / P) * D + d]);
  }
  __syncthreads();
  if (metric != 2) {
    for (int i = warp; i < cnt; i += NW) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s = fmaf(qs[i * Dp + d], qs[i * Dp + d], s);
      s = warp_sum(s);
      if (lane == 0) qn[i] = s;
    }
  }

  constexpr int N = Tile<T>::N;
  static_assert(N == 4, "the VEC loops read four elements a lane");
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * RB;
    const int rows = min(RB, BS - c0);
    T* s = reinterpret_cast<T*>(smem + (c & 1) * L.buf);   // this chunk
    if (bulk) {
      mbar_wait(bar0 + 8 * (c & 1), (c >> 1) & 1);
    } else {
      const T* src = tile + (long long)c0 * D;
      for (int e = tid; e < rows * D; e += NT) s[e] = src[e];
    }
    __syncthreads();

    // squared norms of the chunk's rows, once for all the item's queries
    const int j = lane / LR;              // the row this lane's sums end on
    if (metric != 2) {
      for (int r0 = warp * RU; r0 < rows; r0 += NW * RU) {
        float acc[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) acc[u] = 0.f;
        if (VEC) {
          for (int d = lane * N; d < D; d += 32 * N) {
#pragma unroll
            for (int u = 0; u < RU; ++u) {
              if (r0 + u < rows) {
                float v[N];
                Tile<T>::load(s + (r0 + u) * D + d, v);
#pragma unroll
                for (int e = 0; e < N; ++e) acc[u] = fmaf(v[e], v[e], acc[u]);
              }
            }
          }
        } else {
          for (int d = lane; d < D; d += 32) {
#pragma unroll
            for (int u = 0; u < RU; ++u) {
              if (r0 + u < rows) {
                const float x = Tile<T>::one(s[(r0 + u) * D + d]);
                acc[u] = fmaf(x, x, acc[u]);
              }
            }
          }
        }
        const float t = rows_sum(acc, lane);
        if (lane % LR == 0 && r0 + j < rows) nrm[r0 + j] = t;
      }
    }
    __syncthreads();

    for (int i = 0; i < cnt; ++i) {
      const float* qv = qs + i * Dp;
      const float qn2 = metric != 2 ? qn[i] : 0.f;
      float* orow = out + (long long)pairs[i] * BS + c0;
      for (int r0 = warp * RU; r0 < rows; r0 += NW * RU) {
        float dot[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) dot[u] = 0.f;
        if (VEC) {
          for (int d = lane * N; d < D; d += 32 * N) {
            const float4 qe = *reinterpret_cast<const float4*>(qv + d);
#pragma unroll
            for (int u = 0; u < RU; ++u) {
              if (r0 + u < rows) {
                float v[N];
                Tile<T>::load(s + (r0 + u) * D + d, v);
                dot[u] = fmaf(v[0], qe.x, dot[u]);
                dot[u] = fmaf(v[1], qe.y, dot[u]);
                dot[u] = fmaf(v[2], qe.z, dot[u]);
                dot[u] = fmaf(v[3], qe.w, dot[u]);
              }
            }
          }
        } else {
          for (int d = lane; d < D; d += 32) {
            const float qe = qv[d];
#pragma unroll
            for (int u = 0; u < RU; ++u) {
              if (r0 + u < rows)
                dot[u] = fmaf(Tile<T>::one(s[(r0 + u) * D + d]), qe, dot[u]);
            }
          }
        }
        // every lane finishes a row's metric at once; one lane of its
        // group writes it
        const float dt = rows_sum(dot, lane);
        const int r = r0 + j;
        if (r < rows) {
          float dist;
          if (metric == 0) {
            dist = qn2 + nrm[r] - 2.0f * dt;
          } else if (metric == 1) {
            const float denom = sqrtf(qn2) * sqrtf(nrm[r]);
            dist = denom > 0.f ? 1.0f - dt / denom : 1.0f;
          } else {
            dist = 1.0f - dt;
          }
          if (lane % LR == 0) orow[r] = dist;
        }
      }
    }
    __syncthreads();

    // the buffer just scored takes chunk c + 2; generic reads of it are
    // ordered before the TMA unit's writes by the proxy fence
    if (bulk && tid == 0 && c + 2 < nchunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(smem_u32(s), tile + (long long)(c + 2) * RB * D,
                (uint32_t)(min(RB, BS - (c + 2) * RB) * D * sizeof(T)),
                bar0 + 8 * (c & 1));
    }
  }
}

template <typename T, bool VEC>
int launch_scores(const void* blk, const void* q, void* out,
                  const int32_t* order, const int32_t* items,
                  const int32_t* n_items, int BS, int D, int P, int RB,
                  int qt, int max_items, int metric, cudaStream_t stream) {
  const size_t smem = layout(BS, D, RB, qt, sizeof(T)).total;
  auto* kernel = score_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bulk = (size_t)D * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(blk) % 16 == 0;
  kernel<<<(unsigned)max_items, NT, smem, stream>>>(
      (const T*)blk, (const T*)q, (float*)out, order, items, n_items, BS, D,
      P, RB, qt, metric, bulk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* blk, const void* q, void* out, const int32_t* order,
           const int32_t* items, const int32_t* n_items, int BS, int D, int P,
           int RB, int qt, int max_items, int metric, cudaStream_t stream) {
  if (D % Tile<T>::N == 0)
    return launch_scores<T, true>(blk, q, out, order, items, n_items, BS, D,
                                  P, RB, qt, max_items, metric, stream);
  return launch_scores<T, false>(blk, q, out, order, items, n_items, BS, D,
                                 P, RB, qt, max_items, metric, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer to a contiguous array: blk (NB, BS, D) and q (B, D) in float32
// (is_bf16 == 0) or bfloat16 (is_bf16 == 1), bids (B, P) i32, out
// (B, P*BS) f32.  Scratch, all i32: counts (NB + 1) zeroed by the caller
// (its last element receives the number of work items), offsets (NB + 1),
// order (B * P), items (max_items, 3).  RB rows a tile chunk, at most qt
// pairs a work item, max_items >= the number of work items (the wrapper's
// _max_work_items), B * P below 2^31.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error.
extern "C" int hnsw_block_scores(const void* blk, const void* bids,
                                 const void* q, void* out, void* counts,
                                 void* offsets, void* order, void* items,
                                 int NB, int BS, int D, int B, int P, int RB,
                                 int qt, int max_items, int metric,
                                 int is_bf16, void* stream) {
  if (B <= 0 || P <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * P;
  const unsigned grid = (unsigned)((n + GT - 1) / GT < 4096
                                       ? (n + GT - 1) / GT : 4096);
  int32_t* cnt = (int32_t*)counts;
  int32_t* off = (int32_t*)offsets;
  int32_t* ord = (int32_t*)order;
  int32_t* its = (int32_t*)items;
  count_kernel<<<grid, GT, 0, st>>>((const int32_t*)bids, cnt, n, NB);
  segment_kernel<<<1, ST, 0, st>>>(cnt, off, its, cnt + NB, NB, qt);
  scatter_kernel<<<grid, GT, 0, st>>>((const int32_t*)bids, cnt, off, ord, n,
                                      NB);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    return launch<__nv_bfloat16>(blk, q, out, ord, its, cnt + NB, BS, D, P,
                                 RB, qt, max_items, metric, st);
  return launch<float>(blk, q, out, ord, its, cnt + NB, BS, D, P, RB, qt,
                       max_items, metric, st);
}
