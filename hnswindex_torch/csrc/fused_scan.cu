// Lane-min streaming corpus scan (kernel K1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel hnswindex_tpu/ops/fused_scan.py:lane_min_scan.
// For every query b and lane s in [0, BS) it returns the minimum of
//     key = (q_b . coarse_c) * mult[c] + bias[c]
// over the columns c with c % BS == s, c != exclude[b], and that column.
// Inactive rows carry bias = 3e38 and mult = 0, so they never win.  The
// lowest column wins an exact tie, exactly as on the TPU.  A lane that never
// saw a key below 1e37 returns (>= 1e37, -1).
//
// What bounds it on this card: at a 512-query build wave against 1M rows of
// D = 128 the scan is 2*512*1M*128 ~ 134 GFLOP against 258 MB of bf16 corpus,
// ~500 FLOP per byte: bound by operations, and only the tensor cores (989
// TFLOP/s in bf16) are fast enough for it.  After them the epilogue counts:
// 516 M keys a launch, each an FMA, a compare and a minimum on the CUDA
// cores.
//
// Design.
//  * The product runs as wgmma.mma_async m64n128k16 on the bf16 operands as
//    stored (f32 accumulators in registers).  Both operands are K-major (D
//    contiguous), which wgmma reads from 128-byte-swizzled shared memory
//    without a transpose.  bf16 x bf16 is exact in f32; only the order of
//    the f32 sums differs from the plain version.
//  * A block owns (128 queries) x (128 lanes) x (a contiguous range of lane
//    groups g).  It has three warpgroups: a producer and two consumers of 64
//    queries each.  The query tile is loaded once and stays in shared memory
//    (D <= 384; a wider D streams its query chunks through the ring beside
//    the corpus chunks).  Corpus tiles of 128 rows x 64 values of D arrive
//    by TMA (one tensor map over `coarse`, 128-byte swizzle, zero fill past
//    the ragged edges) into a ring of up to 8 stages (7 at D = 128) guarded
//    by full/empty mbarriers, so several tiles are in flight while the
//    tensor cores work.  Both consumers multiply the same corpus tile, which
//    halves the reads a 64-query tile would make.
//  * The grid is (query tiles) x (lane tiles) x (splits of the corpus
//    walk); the caller picks the split count so that the grid fills the SMs
//    (4 x 8 x 4 = 128 blocks for a 512-query wave) and a short corpus does
//    not launch empty blocks.  Each split writes a partial (vals, ids); a
//    second small kernel merges them in split order with a strict '<'.
//    Inside a block g rises and the update is a strict '<' too, so the
//    lowest column keeps a tie.  With one split the scan writes the result
//    itself and no merge runs.
//  * Epilogue, four instructions a key (FMA, compare, minimum, predicated
//    store): the running minimum of each accumulator element stays in a
//    register; the group index g that achieved it goes to the thread's own
//    column of shared memory, written only when the minimum improves (the
//    column c = g BS + lane is formed once at the end).  Minimum and index
//    both in registers would need 192 registers a thread beside the
//    accumulators, and the compiler holds a 384-thread block to 168
//    whatever setmaxnreg asks for: it spilled, and the scan took twice as
//    long.  mult and bias of the tile's 128 columns are fetched by the
//    consumer while its product runs and passed through shared memory; the
//    excluded column is tested only in the one group that holds it.
//  * Ragged shapes: C, B, D and BS % 128 need no alignment.  TMA zero-fills
//    rows past C and B and values past D; bias is 3e38 past C; stores are
//    guarded.  A row pitch TMA cannot take (D % 8 != 0, or D < 64) uses the
//    same kernel with the producer warpgroup filling the swizzled tiles by
//    plain loads (slow: it serves odd shapes, not the main one).
//
// What still separates it from the bound (0.35 ms against 0.13 ms at the
// shape above; this and the other measurements named here were taken on an
// NVIDIA H100 80GB HBM3 at 700 W, CUDA 12.9): successive products into one
// accumulator tile start about 140 cycles apart, twice the 64 cycles the
// tensor cores need, so one consumer alone runs them at half rate.  The two
// consumers fall into step: they multiply together (full rate, ~1,100
// cycles a tile), then fold together (~900 cycles, tensor cores idle), plus
// ~400 cycles of barriers.
// Measured and rejected: strict turns (one multiplies while the other
// folds; slower, since each then multiplies at half rate); the tile as two
// half-tile accumulator chains a consumer, one folded while the other
// multiplies (with a product in flight where the loop turns round the
// compiler puts a full wait before every fold; with two tiles an iteration
// and nothing in flight at the turn it accepts the overlap, but an
// m64n64k16 product takes as long as an m64n128k16 one, so the tensor
// cores do half the work a cycle: slower both ways); a cluster of two
// blocks with a multicast load of the corpus tile (same time: with or
// without any load the scan takes as long, so L2 traffic is not what holds
// it back).  A third consumer, or two accumulator sets each, does not fit
// 168 registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TQ = 128;            // queries per block (64 per consumer)
constexpr int TL = 128;            // lanes per block = n of one wgmma
constexpr int KC = 64;             // values of D per chunk: one swizzled row
constexpr int CHUNK_BYTES = 128 * KC * 2;    // 128 rows x 128 bytes
constexpr int NT = 384;            // two consumer warpgroups and a producer
constexpr int NP = 128;            // producer threads
constexpr int MAX_STAGES = 8;
constexpr int MB_BYTES = 2 * 2 * 2 * TL * 4; // mult/bias, 2 buffers x 2 WGs
constexpr int BAR_BYTES = 256;
constexpr int BG_BYTES = 64 * 256 * 4;       // group index of every minimum
constexpr int SMEM_LIMIT = 232448;
constexpr int RESIDENT_MAX_CHUNKS = 6;       // query tile resident to D = 384
constexpr float BIG = 3.0e38f;

struct Params {
  const __nv_bfloat16* coarse;
  const float* mult;
  const float* bias;
  const __nv_bfloat16* q;
  const int32_t* excl;
  float* vals;       // (S, B, BS): each split's partial result
  int32_t* ids;
  int C, D, B, BS;
  int G;             // lane groups: ceil(C / BS)
  int S;             // splits of the corpus walk
  int kch;           // chunks of D
  int stages;        // ring depth
  int resident;      // query tile resident in shared memory
  int use_tma;       // tiles by TMA, else filled by the producer's loads
  int pair_loads;    // plain loads may take two values at once
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of the given parity has completed.  A wait that
// outlasts 2^20 polls (seconds; a whole scan takes milliseconds) can only be
// a broken pipeline, and traps instead of hanging the card.
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = a (64 x 16, bf16) . b (128 x 16, bf16)^T [+ d]
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ int lds_i32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Folds one tile's dots into the running lane minima.  Accumulator element
// 4j + 2h + e is query row (lane/4 + 8h) and tile column 8j + 2(lane%4) + e.
// With EXCL, ex0 / ex1 are the tile columns to skip for rows h = 0 / 1
// (-1: none).
// The running minimum stays in a register; the group index that achieved it
// goes to the thread's own column of shared memory (element i at
// bg + 1024 i), written only when the minimum improves.
template <bool EXCL>
__device__ __forceinline__ void fold_tile(const float (&acc)[64],
                                          float (&best)[64], uint32_t bg,
                                          uint32_t mb, int cq, int g,
                                          int ex0, int ex1) {
  // mult and bias of columns 8j + cq, + 1, fetched two steps ahead
  float2 m0 = lds_f2(mb + 4 * cq), b0 = lds_f2(mb + 4 * (TL + cq));
  float2 m1 = lds_f2(mb + 4 * (8 + cq)), b1 = lds_f2(mb + 4 * (TL + 8 + cq));
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float2 m2 = m1, b2 = b1;
    if (j + 2 < 16) {
      m2 = lds_f2(mb + 4 * (8 * (j + 2) + cq));
      b2 = lds_f2(mb + 4 * (TL + 8 * (j + 2) + cq));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float key = fmaf(acc[i], e ? m0.y : m0.x, e ? b0.y : b0.x);
        if (EXCL) {
          if ((h ? ex1 : ex0) == 8 * j + cq + e) key = BIG;
        }
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.lt.f32 p, %0, %1;\n"
            "@p st.shared.u32 [%2], %3;\n"
            "}\n" ::"f"(key),
            "f"(best[i]), "r"(bg + 1024 * i), "r"(g)
            : "memory");
        best[i] = fminf(best[i], key);
      }
    }
    m0 = m1;
    b0 = b1;
    m1 = m2;
    b1 = b2;
  }
}

// Producer without TMA: the warpgroup's 128 threads write a 128-row x
// 64-value chunk of `src` (rows row0.., values d0..) into the swizzled
// layout TMA would produce, with zeros past the edges.
__device__ __forceinline__ void fill_chunk(uint8_t* dst,
                                           const __nv_bfloat16* src,
                                           long long nrows, long long row0,
                                           int d0, int D, int pair, int tid) {
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  for (int u = tid; u < 128 * 8; u += NP) {
    const int r = u >> 3, cu = u & 7;
    const long long row = row0 + r;
    const int d = d0 + cu * 8;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < nrows && d < D) {
      const unsigned short* p = s16 + row * D + d;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pair) {
          if (d + 2 * i < D)
            w[i] = *reinterpret_cast<const uint32_t*>(p + 2 * i);
        } else {
          const uint32_t lo = d + 2 * i < D ? p[2 * i] : 0u;
          const uint32_t hi = d + 2 * i + 1 < D ? p[2 * i + 1] : 0u;
          w[i] = lo | (hi << 16);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((cu ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(NT, 1)
lane_min_scan_kernel(const __grid_constant__ CUtensorMap map_c,
                     const __grid_constant__ CUtensorMap map_q,
                     const Params P) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q_bytes = P.resident ? P.kch * CHUNK_BYTES : 0;
  const int stage_bytes = P.resident ? CHUNK_BYTES : 2 * CHUNK_BYTES;
  uint8_t* q_res = smem;
  uint8_t* ring = smem + q_bytes;
  float* mb_all = reinterpret_cast<float*>(ring + P.stages * stage_bytes);
  uint8_t* bg_all = reinterpret_cast<uint8_t*>(mb_all) + MB_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bg_all + BG_BYTES);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + MAX_STAGES);
  const uint32_t qfull = smem_u32(bars + 2 * MAX_STAGES);

  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int b0 = blockIdx.x * TQ;
  const int s0 = blockIdx.y * TL;
  const int split = blockIdx.z;
  const int g_lo = static_cast<int>(static_cast<long long>(split) * P.G / P.S);
  const int g_hi =
      static_cast<int>(static_cast<long long>(split + 1) * P.G / P.S);
  const int T = g_hi - g_lo;

  if (threadIdx.x == 0) {
    const int producers = P.use_tma ? 1 : NP;
    for (int s = 0; s < P.stages; ++s) {
      mbar_init(full0 + 8 * s, producers);
      mbar_init(empty0 + 8 * s, 8);          // one arrival per consumer warp
    }
    mbar_init(qfull, producers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The register hand-over frees nothing here (the compiler keeps all
  // three warpgroups to 168), but without it the compiler no longer takes
  // the consumers' path for a warpgroup's own and serializes their products
  // (ptxas C7520; measured 25% slower).
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // ---------------------------------------------------------- producer
    if (P.use_tma) {
      if (tid == 0) {
        if (P.resident) {
          mbar_expect_tx(qfull, P.kch * CHUNK_BYTES);
          for (int kc = 0; kc < P.kch; ++kc)
            tma_load_2d(smem_u32(q_res + kc * CHUNK_BYTES), &map_q, qfull,
                        kc * KC, b0);
        }
        int stage = 0;
        uint32_t phase = 1;                  // the ring starts empty
        for (int t = 0; t < T; ++t) {
          const int row0 = (g_lo + t) * P.BS + s0;
          for (int kc = 0; kc < P.kch; ++kc) {
            mbar_wait(empty0 + 8 * stage, phase);
            const uint32_t full = full0 + 8 * stage;
            uint32_t dst = smem_u32(ring + stage * stage_bytes);
            mbar_expect_tx(full, stage_bytes);
            if (!P.resident) {
              tma_load_2d(dst, &map_q, full, kc * KC, b0);
              dst += CHUNK_BYTES;
            }
            tma_load_2d(dst, &map_c, full, kc * KC, row0);
            if (++stage == P.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else {
      if (P.resident) {
        for (int kc = 0; kc < P.kch; ++kc)
          fill_chunk(q_res + kc * CHUNK_BYTES, P.q, P.B, b0, kc * KC, P.D,
                     P.pair_loads, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(qfull);
      }
      int stage = 0;
      uint32_t phase = 1;
      for (int t = 0; t < T; ++t) {
        const long long row0 =
            static_cast<long long>(g_lo + t) * P.BS + s0;
        for (int kc = 0; kc < P.kch; ++kc) {
          mbar_wait(empty0 + 8 * stage, phase);
          uint8_t* dst = ring + stage * stage_bytes;
          if (!P.resident) {
            fill_chunk(dst, P.q, P.B, b0, kc * KC, P.D, P.pair_loads, tid);
            dst += CHUNK_BYTES;
          }
          fill_chunk(dst, P.coarse, P.C, row0, kc * KC, P.D, P.pair_loads,
                     tid);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full0 + 8 * stage);
          if (++stage == P.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid >> 5, lane = tid & 31;
    const int cq = (lane & 3) * 2;           // first tile column of a pair
    const int row_a = b0 + wg * 64 + warp * 16 + (lane >> 2);
    const int row_b = row_a + 8;
    // excluded column of each row as (group, column inside this tile)
    const int exa = row_a < P.B ? P.excl[row_a] : -1;
    const int exb = row_b < P.B ? P.excl[row_b] : -1;
    const int exa_g = exa >= 0 ? exa / P.BS : -1;
    const int exb_g = exb >= 0 ? exb / P.BS : -1;
    const int exa_c = exa >= 0 ? exa % P.BS - s0 : -1;
    const int exb_c = exb >= 0 ? exb % P.BS - s0 : -1;

    float acc[64], best[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      best[i] = BIG;
    }
    const uint32_t bg = smem_u32(bg_all) + 4 * threadIdx.x;

    int stage = 0;
    uint32_t phase = 0;
    if (P.resident) mbar_wait(qfull, 0);
    for (int t = 0; t < T; ++t) {
      const int g = g_lo + t;
      // this tile's mult and bias: one column a thread, in flight while
      // the product runs
      const long long col = static_cast<long long>(g) * P.BS + s0 + tid;
      float pm = 0.f, pb = BIG;
      if (col < P.C) {
        pm = __ldg(P.mult + col);
        pb = __ldg(P.bias + col);
      }

      acc_fence(acc);
      int prev = -1;                         // stage of the group in flight
      for (int kc = 0; kc < P.kch; ++kc) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sbase = smem_u32(ring + stage * stage_bytes);
        const uint32_t a_addr =
            (P.resident ? smem_u32(q_res + kc * CHUNK_BYTES) : sbase) +
            wg * 64 * 128;
        const uint32_t b_addr = P.resident ? sbase : sbase + CHUNK_BYTES;
        const uint64_t da = wgmma_desc(a_addr), db = wgmma_desc(b_addr);
        wgmma_fence();
        // 32 bytes of D a step.  A ragged last chunk is zero-filled, so all
        // four steps always run: a loop with a run-time count makes the
        // compiler fence every product and costs 13% of the whole scan.
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks)
          wgmma_m64n128k16(acc, da + 2 * ks, db + 2 * ks, (kc | ks) != 0);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == P.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      acc_fence(acc);

      // Double-buffered: the barrier of tile t+1 stands between the reads
      // of tile t and the writes of tile t+2 into the same buffer.
      float* mb = mb_all + (wg * 2 + (t & 1)) * 2 * TL;
      mb[tid] = pm;
      mb[TL + tid] = pb;
      // named barrier 1 + wg: this consumer's 128 threads
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

      const bool hit_a = g == exa_g, hit_b = g == exb_g;
      if (hit_a || hit_b)
        fold_tile<true>(acc, best, bg, smem_u32(mb), cq, g,
                        hit_a ? exa_c : -1, hit_b ? exb_c : -1);
      else
        fold_tile<false>(acc, best, bg, smem_u32(mb), cq, g, -1, -1);
    }

    const long long plane = static_cast<long long>(P.B) * P.BS;
    float* ov = P.vals + split * plane;
    int32_t* oi = P.ids + split * plane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row_b : row_a;
      if (row >= P.B) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int s = s0 + 8 * j + cq;       // s and s + 1 < BS together
        if (s >= P.BS) continue;
        const int i = 4 * j + 2 * h;
        const long long o = static_cast<long long>(row) * P.BS + s;
        int2 id;
        id.x = best[i] < 1.0e37f ? lds_i32(bg + 1024 * i) * P.BS + s : -1;
        id.y = best[i + 1] < 1.0e37f
                   ? lds_i32(bg + 1024 * (i + 1)) * P.BS + s + 1
                   : -1;
        *reinterpret_cast<float2*>(ov + o) = make_float2(best[i], best[i + 1]);
        *reinterpret_cast<int2*>(oi + o) = id;
      }
    }
  }
}

// Merges the S partial results in split order.  A later split replaces a
// lane only when strictly smaller, so the lowest column keeps a tie.
__global__ void lane_min_merge_kernel(const float* __restrict__ pv,
                                      const int32_t* __restrict__ pi,
                                      float* __restrict__ vals,
                                      int32_t* __restrict__ ids, long long n,
                                      int S) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bv = pv[i];
  int32_t bi = pi[i];
  for (int s = 1; s < S; ++s) {
    const float v = pv[s * n + i];
    if (v < bv) {
      bv = v;
      bi = pi[s * n + i];
    }
  }
  vals[i] = bv;
  ids[i] = bi;
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has loaded already.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Tensor map over a (rows, D) bf16 matrix: boxes of 128 rows x 64 values,
// 128-byte swizzle, zeros out of range.
int make_map(CUtensorMap* map, const void* base, int rows, int D) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return -1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {KC, 128};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer to a contiguous array: coarse (C, D) bf16, mult and bias (C,) f32,
// q (B, D) bf16, excl (B,) i32, the splits' partial results pvals (S, B, BS)
// f32 and pids (S, B, BS) i32, and the merged vals (B, BS) f32 and ids
// (B, BS) i32 (with S == 1 nothing is merged: the result is pvals / pids
// and vals / ids are not touched).  BS must be a multiple of 64 and
// 1 <= S <= max(1, ceil(C / BS)) (the caller checks).  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError(), or a
// negative number when no tensor map could be made (-1: libcuda
// has no cuTensorMapEncodeTiled, -2: it refused the matrix).
extern "C" int hnsw_lane_min_scan(const void* coarse, const void* mult,
                                  const void* bias, const void* q,
                                  const void* excl, void* vals, void* ids,
                                  void* pvals, void* pids, int C, int D,
                                  int B, int BS, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params P;
  P.coarse = static_cast<const __nv_bfloat16*>(coarse);
  P.mult = static_cast<const float*>(mult);
  P.bias = static_cast<const float*>(bias);
  P.q = static_cast<const __nv_bfloat16*>(q);
  P.excl = static_cast<const int32_t*>(excl);
  P.vals = static_cast<float*>(pvals);
  P.ids = static_cast<int32_t*>(pids);
  P.C = C;
  P.D = D;
  P.B = B;
  P.BS = BS;
  P.G = (C + BS - 1) / BS;
  P.S = S;
  P.kch = (D + KC - 1) / KC;
  P.resident = P.kch <= RESIDENT_MAX_CHUNKS;
  const int stage_bytes = P.resident ? CHUNK_BYTES : 2 * CHUNK_BYTES;
  const int fixed = 1024 + (P.resident ? P.kch * CHUNK_BYTES : 0) + MB_BYTES +
                    BG_BYTES + BAR_BYTES;
  P.stages = (SMEM_LIMIT - fixed) / stage_bytes;
  if (P.stages > MAX_STAGES) P.stages = MAX_STAGES;
  const int smem = fixed + P.stages * stage_bytes;
  const uintptr_t both = reinterpret_cast<uintptr_t>(coarse) |
                         reinterpret_cast<uintptr_t>(q);
  P.use_tma = D % 8 == 0 && D >= KC && C > 0 && B > 0 && both % 16 == 0;
  P.pair_loads = D % 2 == 0 && both % 4 == 0;

  CUtensorMap map_c, map_q;
  if (P.use_tma) {
    int r = make_map(&map_c, coarse, C, D);
    if (r == 0) r = make_map(&map_q, q, B, D);
    if (r != 0) return r;
  } else {
    memset(&map_c, 0, sizeof(map_c));
    memset(&map_q, 0, sizeof(map_q));
  }

  cudaError_t err = cudaFuncSetAttribute(
      lane_min_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((B + TQ - 1) / TQ, (BS + TL - 1) / TL, S);
  lane_min_scan_kernel<<<grid, NT, smem, st>>>(map_c, map_q, P);
  err = cudaGetLastError();
  if (err != cudaSuccess || S <= 1) return static_cast<int>(err);

  const long long n = static_cast<long long>(B) * BS;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  lane_min_merge_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float*>(pvals), static_cast<const int32_t*>(pids),
      static_cast<float*>(vals), static_cast<int32_t*>(ids), n, S);
  return static_cast<int>(cudaGetLastError());
}
