// Lane-min streaming corpus scan (kernel K1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel hnswindex_tpu/ops/fused_scan.py:lane_min_scan.
// For every query b and lane s in [0, BS) it returns the minimum of
//     key = (q_b . coarse_c) * mult[c] + bias[c]
// over the columns c with c % BS == s, c != exclude[b], and that column.
// Inactive rows carry bias = 3e38 and mult = 0, so they never win.  Updates
// use a strict '<' while the corpus is walked in increasing column order, so
// the lowest column wins a tie, exactly as on the TPU.  A lane that never
// saw a key below 1e37 returns (3e38, -1).
//
// What bounds it on this card: at a 512-query build wave against 1M rows of
// D = 128 the scan is 2*512*1M*128 ~ 134 GFLOP (67 G multiply-adds) against
// 256 MB of bf16 corpus reads, i.e. ~500 FLOP per byte: compute-bound.  This
// first version runs the products as float32 FMAs on the CUDA cores (67
// TFLOP/s peak), not on the tensor cores; mma/wgmma and TMA come later.
//
// Design.  The TPU walks the corpus in one sequential grid with (B, BS)
// accumulators resident in VMEM, which would occupy one SM here.  Instead a
// block owns a (64 queries) x (64 lanes) tile of the outputs outright and
// walks every corpus group g = 0 .. ceil(C/BS)-1 in order, reading columns
// g*BS + s0 .. s0+63.  Because a block sees its lanes' columns in
// increasing order, no cross-block merge is needed and the tie rule holds.
// At B = 512, BS = 1024 the grid is 8 x 16 = 128 blocks.  Each of the 256
// threads owns a 4 x 4 sub-tile: 16 dot accumulators and 16 running
// (min, column) pairs in registers.  D is read in chunks of 32 through
// shared memory (query chunk and corpus chunk, widened to float32 and
// stored d-major), so D is not capped by shared memory.  The kernel masks
// the ragged corpus edge and the ragged query tile itself.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;        // queries per block
constexpr int TL = 64;        // lanes per block
constexpr int DC = 32;        // D chunk
constexpr int LD = TL + 4;    // padded smem row (keeps float4 alignment)
constexpr int NT = 256;       // threads per block
constexpr float BIG = 3.0e38f;

__global__ void __launch_bounds__(NT)
lane_min_scan_kernel(const __nv_bfloat16* __restrict__ coarse,
                     const float* __restrict__ mult,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ q,
                     const int32_t* __restrict__ excl,
                     float* __restrict__ vals,
                     int32_t* __restrict__ ids,
                     int C, int D, int B, int BS) {
  __shared__ __align__(16) float qs[DC][LD];
  __shared__ __align__(16) float cs[DC][LD];
  __shared__ float ms[TL];
  __shared__ float bs[TL];

  const int tid = threadIdx.x;
  const int tq = tid / 16;          // query sub-tile 0..15
  const int tl = tid % 16;          // lane sub-tile 0..15
  const int b0 = blockIdx.x * TQ;
  const int s0 = blockIdx.y * TL;

  // loader mapping: thread -> (row r, 8 consecutive d starting at dd)
  const int lr = tid / 4;           // 0..63
  const int ld = (tid % 4) * 8;     // 0, 8, 16, 24

  float best[4][4];
  int bid[4][4];
  int ex[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + tq * 4 + i;
    ex[i] = b < B ? excl[b] : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      best[i][j] = BIG;
      bid[i][j] = -1;
    }
  }

  const int G = (C + BS - 1) / BS;
  for (int g = 0; g < G; ++g) {
    const long long col0 = (long long)g * BS + s0;
    if (col0 >= C) break;             // uniform across the block
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();                // previous chunk / epilogue done
      {
        const int b = b0 + lr;
        const long long c = col0 + lr;
        const __nv_bfloat16* qrow = q + (long long)b * D;
        const __nv_bfloat16* crow = coarse + c * D;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int d = d0 + ld + e;
          const bool dok = d < D;
          qs[ld + e][lr] = (dok && b < B) ? __bfloat162float(qrow[d]) : 0.f;
          cs[ld + e][lr] = (dok && c < C) ? __bfloat162float(crow[d]) : 0.f;
        }
        if (d0 == 0 && tid < TL) {
          const long long c2 = col0 + tid;
          ms[tid] = c2 < C ? mult[c2] : 0.f;
          bs[tid] = c2 < C ? bias[c2] : BIG;
        }
      }
      __syncthreads();
      const int dn = min(DC, D - d0);
      for (int d = 0; d < dn; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[d][tq * 4]);
        const float4 v = *reinterpret_cast<const float4*>(&cs[d][tl * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
      }
    }

    // epilogue: fold this group's keys into the running lane minima
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = tl * 4 + j;
      const long long c = col0 + l;
      if (c >= C) continue;
      const float m = ms[l];
      const float bb = bs[l];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float key = acc[i][j] * m + bb;
        if (c == ex[i]) key = BIG;
        if (key < best[i][j]) {
          best[i][j] = key;
          bid[i][j] = (int)c;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + tq * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tl * 4 + j;
      const long long o = (long long)b * BS + s;
      vals[o] = best[i][j];
      ids[o] = best[i][j] < 1.0e37f ? bid[i][j] : -1;
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer to a contiguous array: coarse (C, D) bf16, mult and bias (C,) f32,
// q (B, D) bf16, excl (B,) i32, vals (B, BS) f32, ids (B, BS) i32.
// BS must be a multiple of 64 (the caller checks).  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int hnsw_lane_min_scan(const void* coarse, const void* mult,
                                  const void* bias, const void* q,
                                  const void* excl, void* vals, void* ids,
                                  int C, int D, int B, int BS, void* stream) {
  dim3 grid((B + TQ - 1) / TQ, BS / TL);
  lane_min_scan_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)coarse, (const float*)mult, (const float*)bias,
      (const __nv_bfloat16*)q, (const int32_t*)excl, (float*)vals,
      (int32_t*)ids, C, D, B, BS);
  return (int)cudaGetLastError();
}
