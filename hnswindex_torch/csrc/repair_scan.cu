// Exact top-k over an allowed slot prefix in one fused float32 scan
// (kernel K4) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package scans the removal's repair
// candidates with its blocked exact_knn (hnswindex_tpu/ops/bruteforce.py),
// an XLA product and approx_min_k a block.  The port ran the same blocked
// form (ops/bruteforce.exact_knn): for each 4,096-query chunk and each
// 65,536-row block it wrote a 1 GB float32 panel of dots, wrote it again as
// distances and again under the allowed mask, and ran torch.topk for 400
// of 65,536 columns on every row.  The product was a small part of that
// time.  This kernel computes the same answer without ever writing a
// distance to device memory.
//
// Contract (ops/repair_scan.repair_scan_ref, i.e. exact_knn, is its plain
// twin): q (S, D) and x (ns, D) both float32 or both bfloat16 (a bf16
// ranking table; the caller rounds the queries to it, as the twin does),
// widened to float32 as they are loaded.  For each query s in [0, S) and
// each row c in [0, ns),
//     d(s, c) = (qa[s] + cb[c]) + dot(q_s, x_c) * (qm[s] * cm[c])
// where the caller folds the metric into the four per-vector terms
// (ops/repair_scan.affine_terms: distance.from_dot's sq_euclid, cosine and
// ucosine distance for an allowed row, and cb = +inf, so d = +inf, for
// any other).  The result is the k rows of smallest (d, c), ascending by d
// and then by row, as out_d (S, k) float32 and out_i (S, k) int64; slots
// past the allowed rows hold (+inf, -1).  A NaN distance never enters.
// The dot products are full float32 FMA chains (no TF32, no bf16 stage);
// only the order of the sums differs from the twin's cuBLAS product.
//
// What bounds it on this card: 2 * S * ns * D operations against
// (S + ns) * D * 4 bytes read once.  At the removal's shape (S = 32,768
// removed rows, ns = 1M rows, D = 100) that is 6.6e12 operations, 98 ms at
// the 67 TFLOP/s float32 peak of the CUDA cores, against 0.4 GB: bound by
// operations, and only if almost every issued instruction is an FMA.
//
// Design.
//  * A block owns 128 queries and walks a contiguous range of 128-row
//    corpus tiles (its split).  256 threads as 16 x 16, each computing an
//    8 x 8 register tile of dots (queries ty*4 + {0..3, 64..67}, rows
//    tx*4 + {0..3, 64..67}).  Depth moves in stages of 8: each thread loads
//    one float4 of the query tile and one of the corpus tile into registers
//    (the next stage's, while the current one is multiplied) and stores
//    them transposed into a double-buffered shared tile (row pitch 132
//    floats: conflict-free stores), so the inner loop reads its eight
//    queries and eight rows of a depth as four 16-byte loads for 64 FMAs.
//    The stream of (tile, stage) pairs is flattened, so the next tile's
//    first stage is in flight during a tile's last one and its epilogue.
//    A depth that is not a multiple of 4, or an unaligned operand, loads
//    element by element; past D and past the last row the tiles are zero.
//    The query tile is read again for every corpus tile (from L2: 64 FMAs
//    a loaded float keep the read far under L2's rate); resident, it would
//    take the shared memory that the candidate lists below need.
//  * Epilogue of a tile, in registers: each dot becomes a distance with one
//    add, one multiply and one FMA, and is compared with its query's
//    threshold, the k-th best (d, row) found so far.  Survivors are
//    appended to the query's candidate list in shared memory (an atomic on
//    the query's count).  No distance panel is written anywhere.
//  * A query holds at most CAP = 88 pending candidates.  The epilogue
//    takes a tile in two halves of 64 rows, and once any query holds more
//    than 24 after a half the block runs a merge round before the next
//    one: a warp a query folds each pending candidate into the query's
//    top-k (kept in the output's partial slot in global memory, unsorted,
//    4, 8 or 16 entries a lane for k up to 128, 256 or 512) by
//    replace-the-maximum under the (d, row) order,
//    and publishes the new threshold.  The k smallest of a set do not
//    depend on the order they arrive in, so the result does not depend on
//    the order of the atomics, and repeated calls are bit-identical.
//    Thresholds only tighten; after the first few tiles most candidates
//    fail them and merge rounds become rare.
//  * Where the queries alone cannot fill the card (a layer's few members
//    above layer 0, a small wave), the corpus is cut into splits of whole
//    tiles (hnsw_repair_scan_plan picks the count); each (query tile,
//    split) block leaves its partial top-k, and a second small kernel
//    (one warp a query) sorts the union of the splits' lists by a bitonic
//    sort in shared memory and writes the first k.  With one split it only
//    sorts.
//
// Shared memory of the scan block: 2 x 2 staged tiles (16.5 KB), the
// candidate lists (128 x 88 x 8 B = 88 KB) and per-query terms, 106.5 KB:
// two blocks an SM (16 warps, 128 registers a thread).  Measured at the
// removal's shape on an H100 80GB HBM3 at 700 W: 14% faster than one
// block an SM with lists of 192 (the second block hides the stage
// barrier and the loads), and 16-deep stages were 10% slower.  A resident
// query tile would leave too little room for the lists.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;              // queries a block
constexpr int BN = 128;              // corpus rows a tile
constexpr int BK = 8;                // depth a stage
constexpr int NT = 256;              // threads of the scan block
constexpr int NW = NT / 32;
constexpr int MIN_BLOCKS = 2;        // scan blocks an SM
constexpr int PITCH = BQ + 4;        // floats a depth row of a staged tile
constexpr int CAP = 88;              // pending candidates a query may hold
constexpr int EPI_PARTS = 2;         // epilogue parts, a merge check each
constexpr int LIMIT = CAP - BN / EPI_PARTS;  // a merge round past this
constexpr int KMAX = 512;            // widest top-k (16 entries a lane)
constexpr int MERGE_MAX = 2048;      // widest union the sort kernel takes
constexpr int MAX_SPLITS = 16;       // most corpus splits of one launch
constexpr int MIN_TILES_PER_SPLIT = 16;  // a split's first tiles fill its
                                         // top-k, so none is shorter
constexpr double FILL = 0.9;         // share of the card's block slots a
                                     // launch fills before no more splits
                                     // are tried
constexpr int FWPB = 4;              // warps (queries) a sort block
constexpr int PAD_ID = 0x7fffffff;   // ids of the initial +inf entries
constexpr unsigned FULL = 0xffffffffu;

constexpr int STAGE_FLOATS = BK * PITCH;
constexpr size_t SCAN_SMEM =
    (size_t)4 * STAGE_FLOATS * sizeof(float)       // A and B, two buffers
    + (size_t)3 * BQ * sizeof(float)               // qa, qm, threshold
    + (size_t)BQ * sizeof(int)                     // pending counts
    + (size_t)BQ * CAP * (sizeof(float) + sizeof(int32_t));

struct Params {
  const void* q;       // (S, D) float32 or bfloat16
  const void* x;       // (ns, D), the same type
  const float* qa;     // (S,)
  const float* qm;     // (S,)
  const float* cb;     // (ns,)
  const float* cm;     // (ns,)
  float* pd;           // (P, S, k): each split's top-k, unsorted
  int32_t* pi;
  int S, ns, D, k;
  int rows_per_split;  // a multiple of BN
};

__device__ __forceinline__ bool lex_less(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One stage of a 128-row tile, widened to float32: thread t takes row
// t / 2, depth k0 + 4 (t % 2) .. + 3.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(float (&r)[4],
                                           const T* __restrict__ m,
                                           int nrows, int D, int row0,
                                           int k0, int tid) {
  const int row = row0 + (tid >> 1);
  const int kk = k0 + (tid & 1) * 4;
  const T* src = m + (size_t)row * D + kk;
  if (VEC) {
    // D % 4 == 0: the four values lie all inside D or all past it
    r[0] = r[1] = r[2] = r[3] = 0.f;
    if (row < nrows && kk < D) {
      if constexpr (sizeof(T) == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src));
        r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
      } else {
        // four bf16 in 8 bytes, the first in the low half of .x
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        r[0] = __uint_as_float(v.x << 16);
        r[1] = __uint_as_float(v.x & 0xffff0000u);
        r[2] = __uint_as_float(v.y << 16);
        r[3] = __uint_as_float(v.y & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = (row < nrows && kk + i < D) ? widen(src[i]) : 0.f;
  }
}

__device__ __forceinline__ void store_stage(float* s, const float (&r)[4],
                                            int tid) {
  const int row = tid >> 1;
  const int kk = (tid & 1) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[(kk + i) * PITCH + row] = r[i];
}

// Lexicographic maximum of a warp's top-k entries, in every lane.
template <int KPL>
__device__ __forceinline__ void warp_max(const float (&ld)[KPL],
                                         const int (&li)[KPL], float& md,
                                         int& mi) {
  md = ld[0];
  mi = li[0];
#pragma unroll
  for (int r = 1; r < KPL; ++r)
    if (lex_less(md, mi, ld[r], li[r])) { md = ld[r]; mi = li[r]; }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(FULL, md, off);
    const int oi = __shfl_xor_sync(FULL, mi, off);
    if (lex_less(md, mi, od, oi)) { md = od; mi = oi; }
  }
}

// Fold every query's pending candidates into its top-k and reset them.
// Each warp takes queries warp, warp + NW, ...; the (d, id) pairs of a list
// are distinct (rows once each, +inf pads with distinct ids), so exactly
// one lane holds the maximum.
template <int KPL>
__device__ void merge_round(const Params& p, int q0, int sp, float* thr,
                            int* cnt, const float* bd, const int32_t* bi,
                            int warp, int lane) {
  for (int ql = warp; ql < BQ; ql += NW) {
    const int n = cnt[ql];
    if (n == 0) continue;
    const size_t base = ((size_t)sp * p.S + q0 + ql) * p.k;
    float ld[KPL];
    int li[KPL];
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int j = r * 32 + lane;
      ld[r] = j < p.k ? p.pd[base + j] : -INFINITY;
      li[r] = j < p.k ? p.pi[base + j] : INT32_MIN;
    }
    float md;
    int mi;
    warp_max<KPL>(ld, li, md, mi);
    const float* cd = bd + ql * CAP;
    const int32_t* ci = bi + ql * CAP;
    for (int c = 0; c < n; ++c) {
      const float d = cd[c];
      const int id = ci[c];
      if (lex_less(d, id, md, mi)) {    // the same in every lane
#pragma unroll
        for (int r = 0; r < KPL; ++r)
          if (ld[r] == md && li[r] == mi) { ld[r] = d; li[r] = id; }
        warp_max<KPL>(ld, li, md, mi);
      }
    }
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int j = r * 32 + lane;
      if (j < p.k) { p.pd[base + j] = ld[r]; p.pi[base + j] = li[r]; }
    }
    __syncwarp();
    if (lane == 0) {
      thr[ql] = fminf(md, FLT_MAX);     // +inf pads: everything finite
      cnt[ql] = 0;
    }
  }
}

template <typename T, bool VEC, int KPL>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
repair_scan_kernel(Params p) {
  const T* __restrict__ qv = static_cast<const T*>(p.q);
  const T* __restrict__ xv = static_cast<const T*>(p.x);
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);        // [2][BK][PITCH]
  float* Bs = As + 2 * STAGE_FLOATS;                  // [2][BK][PITCH]
  float* qa_s = Bs + 2 * STAGE_FLOATS;
  float* qm_s = qa_s + BQ;
  float* thr = qm_s + BQ;
  int* cnt = reinterpret_cast<int*>(thr + BQ);
  float* bd = reinterpret_cast<float*>(cnt + BQ);     // [BQ][CAP]
  int32_t* bi = reinterpret_cast<int32_t*>(bd + BQ * CAP);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int sp = blockIdx.y;
  const int c_begin = sp * p.rows_per_split;
  const int c_end = min(p.ns, c_begin + p.rows_per_split);
  const int D = p.D;

  if (tid < BQ) {
    const int qg = q0 + tid;
    const bool ok = qg < p.S;
    qa_s[tid] = ok ? p.qa[qg] : 0.f;
    qm_s[tid] = ok ? p.qm[qg] : 0.f;
    thr[tid] = ok ? FLT_MAX : -INFINITY;   // a missing query takes nothing
    cnt[tid] = 0;
  }
  for (int ql = warp; ql < BQ; ql += NW) {
    if (q0 + ql >= p.S) break;
    const size_t base = ((size_t)sp * p.S + q0 + ql) * p.k;
    for (int j = lane; j < p.k; j += 32) {
      p.pd[base + j] = INFINITY;
      p.pi[base + j] = PAD_ID - j;
    }
  }

  const int KT = (D + BK - 1) / BK;
  const int ntiles = c_end > c_begin ? (c_end - c_begin + BN - 1) / BN : 0;
  float ra[4], rb[4];
  load_stage<T, VEC>(ra, qv, p.S, D, q0, 0, tid);
  load_stage<T, VEC>(rb, xv, p.ns, D, c_begin, 0, tid);
  store_stage(As, ra, tid);
  store_stage(Bs, rb, tid);
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int buf = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int tile = c_begin + t * BN;
    for (int kt = 0; kt < KT; ++kt) {
      const bool last = kt + 1 == KT;
      const bool more = !last || t + 1 < ntiles;
      if (more) {
        const int nk = last ? 0 : (kt + 1) * BK;
        load_stage<T, VEC>(ra, qv, p.S, D, q0, nk, tid);
        load_stage<T, VEC>(rb, xv, p.ns, D, last ? tile + BN : tile, nk,
                           tid);
      }
      const float* a_s = As + buf * STAGE_FLOATS;
      const float* b_s = Bs + buf * STAGE_FLOATS;
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(a_s + k * PITCH + ty * 4);
        const float4 a1 =
            *reinterpret_cast<const float4*>(a_s + k * PITCH + 64 + ty * 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(b_s + k * PITCH + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(b_s + k * PITCH + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {
        store_stage(As + (buf ^ 1) * STAGE_FLOATS, ra, tid);
        store_stage(Bs + (buf ^ 1) * STAGE_FLOATS, rb, tid);
      }
      __syncthreads();
      buf ^= 1;
    }

    // epilogue: distances, the threshold test, survivors appended; a row
    // past ns takes (+inf, 0), so its distance is +inf
    float cbv[8], cmv[8];
    if (tile + BN <= p.ns) {
      const float4* cb4 = reinterpret_cast<const float4*>(p.cb + tile);
      const float4* cm4 = reinterpret_cast<const float4*>(p.cm + tile);
      const float4 cb0 = __ldg(cb4 + tx), cb1 = __ldg(cb4 + 16 + tx);
      const float4 cm0 = __ldg(cm4 + tx), cm1 = __ldg(cm4 + 16 + tx);
      cbv[0] = cb0.x; cbv[1] = cb0.y; cbv[2] = cb0.z; cbv[3] = cb0.w;
      cbv[4] = cb1.x; cbv[5] = cb1.y; cbv[6] = cb1.z; cbv[7] = cb1.w;
      cmv[0] = cm0.x; cmv[1] = cm0.y; cmv[2] = cm0.z; cmv[3] = cm0.w;
      cmv[4] = cm1.x; cmv[5] = cm1.y; cmv[6] = cm1.z; cmv[7] = cm1.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile + (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
        cbv[j] = c < p.ns ? __ldg(p.cb + c) : INFINITY;
        cmv[j] = c < p.ns ? __ldg(p.cm + c) : 0.f;
      }
    }
#pragma unroll
    for (int part = 0; part < EPI_PARTS; ++part) {
      bool over = false;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ql = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        const float th = thr[ql];
        const float a = qa_s[ql];
        const float m = qm_s[ql];
#pragma unroll
        for (int jj = 0; jj < 8 / EPI_PARTS; ++jj) {
          const int j = part * (8 / EPI_PARTS) + jj;
          const float d = fmaf(acc[i][j], m * cmv[j], a + cbv[j]);
          if (d <= th) {
            const int pos = atomicAdd(&cnt[ql], 1);
            bd[ql * CAP + pos] = d;
            bi[ql * CAP + pos] = tile + (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
            over |= pos >= LIMIT;
          }
          acc[i][j] = 0.f;
        }
      }
      if (__syncthreads_or(over)) {
        merge_round<KPL>(p, q0, sp, thr, cnt, bd, bi, warp, lane);
        __syncthreads();
      }
    }
  }
  __syncthreads();
  merge_round<KPL>(p, q0, sp, thr, cnt, bd, bi, warp, lane);
}

// One warp a query: the union of the splits' lists (P * k entries, +inf
// pads to a power of two n2), bitonic-sorted by (d, id) in shared memory;
// the first k written out, ids of +inf entries as -1.
__global__ void __launch_bounds__(FWPB * 32)
repair_sort_kernel(const float* __restrict__ pd,
                   const int32_t* __restrict__ pi, float* __restrict__ out_d,
                   int64_t* __restrict__ out_i, int S, int k, int P, int n2) {
  extern __shared__ __align__(16) unsigned char fsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * FWPB + warp;
  if (s >= S) return;     // no barrier below spans warps
  float* sd = reinterpret_cast<float*>(fsm) + (size_t)warp * 2 * n2;
  int32_t* si = reinterpret_cast<int32_t*>(sd + n2);
  const int n = P * k;
  for (int t = lane; t < n2; t += 32) {
    if (t < n) {
      const int sp = t / k, j = t - sp * k;
      const size_t o = ((size_t)sp * S + s) * k + j;
      sd[t] = pd[o];
      si[t] = pi[o];
    } else {
      sd[t] = INFINITY;
      si[t] = PAD_ID;
    }
  }
  __syncwarp();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < n2 / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const float a = sd[i], b = sd[j];
        const int ai = si[i], bj = si[j];
        if (lex_less(b, bj, a, ai) == up) {
          sd[i] = b; si[i] = bj;
          sd[j] = a; si[j] = ai;
        }
      }
      __syncwarp();
    }
  }
  for (int j = lane; j < k; j += 32) {
    const float d = sd[j];
    out_d[(size_t)s * k + j] = d;
    out_i[(size_t)s * k + j] = d < INFINITY ? (int64_t)si[j] : -1;
  }
}

template <typename T, bool VEC, int KPL>
cudaError_t launch_scan(const Params& p, dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      repair_scan_kernel<T, VEC, KPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SCAN_SMEM);
  if (err != cudaSuccess) return err;
  repair_scan_kernel<T, VEC, KPL><<<grid, NT, SCAN_SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The instance for the element type, the load width and k.
template <typename T>
cudaError_t dispatch_scan(const Params& p, dim3 grid, cudaStream_t st) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = p.D % 4 == 0 && (uintptr_t)p.q % align == 0 &&
                   (uintptr_t)p.x % align == 0;
  if (vec)
    return p.k <= 128   ? launch_scan<T, true, 4>(p, grid, st)
           : p.k <= 256 ? launch_scan<T, true, 8>(p, grid, st)
                        : launch_scan<T, true, 16>(p, grid, st);
  return p.k <= 128   ? launch_scan<T, false, 4>(p, grid, st)
         : p.k <= 256 ? launch_scan<T, false, 8>(p, grid, st)
                      : launch_scan<T, false, 16>(p, grid, st);
}

}  // namespace

// The corpus splits of one call: the fewest whose (query tile, split)
// blocks fill at least FILL of the current device's block slots
// (MIN_BLOCKS an SM) over the rounds they take, else the best filling,
// with no split shorter than MIN_TILES_PER_SPLIT tiles and splits * k
// within MERGE_MAX.  Splits are whole tiles and none is empty.  Writes
// *splits and *rows_per_split; returns 0, a CUDA error, or -1 for
// arguments the kernels do not take.
extern "C" int hnsw_repair_scan_plan(int S, int ns, int k, int* splits,
                                     int* rows_per_split) {
  if (S < 1 || ns < 1 || k < 1 || k > KMAX) return -1;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long q_tiles = (S + BQ - 1) / BQ;
  const int n_tiles = (ns + BN - 1) / BN;
  const int pmax = max(1, min(MAX_SPLITS, min(MERGE_MAX / k,
                                              n_tiles / MIN_TILES_PER_SPLIT)));
  const long long slots = (long long)n_sm * MIN_BLOCKS;
  int best = 1;
  double best_fill = 0.0;
  for (int pp = 1; pp <= pmax; ++pp) {
    const long long blocks = q_tiles * pp;
    const double fill =
        (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill >= FILL) { best = pp; break; }
    if (fill > best_fill) { best = pp; best_fill = fill; }
  }
  const int rows = (n_tiles + best - 1) / best * BN;
  *rows_per_split = rows;
  *splits = (ns + rows - 1) / rows;
  return 0;
}

// q (S, D), x (ns, D) contiguous, float32, or bfloat16 where bf16 != 0;
// qa, qm (S,) and cb, cm (ns,) float32 (affine_terms); pd, pi (P, S, k)
// scratch; out_d (S, k) float32, out_i (S, k) int64; P and
// rows_per_split from hnsw_repair_scan_plan.  Launched on `stream`.
// Returns 0, the CUDA error of a launch, or -1 for arguments the kernels
// do not take (k past 512, P * k past 2,048, splits not covering ns).
extern "C" int hnsw_repair_scan(const void* q, const void* x, const void* qa,
                                const void* qm, const void* cb,
                                const void* cm, void* pd, void* pi,
                                void* out_d, void* out_i, int S, int ns,
                                int D, int k, int P, int rows_per_split,
                                int bf16, void* stream) {
  if (S <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > KMAX || P < 1 || P * k > MERGE_MAX || ns < 1 || D < 1 ||
      rows_per_split % BN != 0 || (long long)P * rows_per_split < ns)
    return -1;
  Params p{q, x, (const float*)qa,
           (const float*)qm, (const float*)cb, (const float*)cm,
           (float*)pd, (int32_t*)pi, S, ns, D, k, rows_per_split};
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)P);
  cudaError_t err = bf16 ? dispatch_scan<__nv_bfloat16>(p, grid, st)
                         : dispatch_scan<float>(p, grid, st);
  if (err != cudaSuccess) return (int)err;

  int n2 = 32;
  while (n2 < P * k) n2 <<= 1;
  const size_t smem = (size_t)FWPB * n2 * (sizeof(float) + sizeof(int32_t));
  err = cudaFuncSetAttribute(repair_sort_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  repair_sort_kernel<<<(unsigned)((S + FWPB - 1) / FWPB), FWPB * 32, smem,
                       st>>>((const float*)pd, (const int32_t*)pi,
                             (float*)out_d, (int64_t*)out_i, S, k, P, n2);
  return (int)cudaGetLastError();
}
