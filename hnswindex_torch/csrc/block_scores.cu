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
// What bounds it on this card: B*P independent (BS, D) x (D,) products, two
// flops per tile element read, i.e. 0.5 flop per byte for float32 tiles and
// 1 for bfloat16: bound by bytes, three orders of magnitude below the line
// where arithmetic would matter.  So the design only has to keep wide loads
// in flight.  The TPU body's all-rows-by-all-queries product and its
// ones-vector norm product exist to feed a matrix unit and are not carried
// over.
//
// Design.  One thread block per (query, probe).  The query row is widened
// to float32 in shared memory once.  The tile is one contiguous BS*D slab:
// each warp takes four consecutive rows at a time, each lane reads 16 bytes
// of each row per step (four independent loads in flight per lane), and the
// dot and the row's squared norm are accumulated in the same pass, then
// reduced with shuffles.  The metric is applied per row, the BS results are
// staged in shared memory and written out as one coalesced run.  BS and D
// are arguments: rows past BS are masked, and a D that the 16-byte width
// does not divide (or a base pointer that is not 16-byte aligned) takes the
// scalar-load path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NW = NT / 32;       // warps per block
constexpr int RU = 4;             // rows a warp keeps in flight

template <typename T> struct Tile;

template <> struct Tile<float> {
  static constexpr int N = 4;     // elements per 16-byte load
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ float one(const float* p) {
    return __ldg(p);
  }
};

template <> struct Tile<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// metric: 0 sq_euclid, 1 cosine, 2 ucosine
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
block_scores_kernel(const T* __restrict__ blk, const int32_t* __restrict__ bids,
                    const T* __restrict__ q, float* __restrict__ out,
                    int NB, int BS, int D, int P, int metric) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // (Dp,) the query, float32
  const int Dp = (D + 3) & ~3;              // keeps `res` 16-byte aligned
  float* res = smem + Dp;                   // (BS,) this tile's distances

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long bp = blockIdx.x;          // b * P + p
  const long long b = bp / P;

  int bid = bids[bp];
  bid = min(max(bid, 0), NB - 1);
  const T* tile = blk + (long long)bid * BS * D;
  const T* qrow = q + b * D;

  for (int d = tid; d < D; d += NT) qs[d] = Tile<T>::one(qrow + d);
  __syncthreads();

  float qn2 = 0.f;
  if (metric != 2) {
    for (int d = lane; d < D; d += 32) qn2 = fmaf(qs[d], qs[d], qn2);
    qn2 = warp_sum(qn2);
  }

  constexpr int N = Tile<T>::N;
  for (int r0 = warp * RU; r0 < BS; r0 += NW * RU) {
    float dot[RU], nrm[RU];
#pragma unroll
    for (int j = 0; j < RU; ++j) dot[j] = nrm[j] = 0.f;

    if (VEC) {
      for (int d = lane * N; d < D; d += 32 * N) {
        float v[RU][N];
#pragma unroll
        for (int j = 0; j < RU; ++j) {
          if (r0 + j < BS) {
            Tile<T>::load(tile + (long long)(r0 + j) * D + d, v[j]);
          } else {
#pragma unroll
            for (int e = 0; e < N; ++e) v[j][e] = 0.f;
          }
        }
        float qv[N];
#pragma unroll
        for (int e = 0; e < N; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qs + d + e);
          qv[e] = x.x; qv[e + 1] = x.y; qv[e + 2] = x.z; qv[e + 3] = x.w;
        }
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float qe = qv[e];
#pragma unroll
          for (int j = 0; j < RU; ++j) {
            dot[j] = fmaf(v[j][e], qe, dot[j]);
            nrm[j] = fmaf(v[j][e], v[j][e], nrm[j]);
          }
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const float qe = qs[d];
#pragma unroll
        for (int j = 0; j < RU; ++j) {
          if (r0 + j < BS) {
            const float x = Tile<T>::one(tile + (long long)(r0 + j) * D + d);
            dot[j] = fmaf(x, qe, dot[j]);
            nrm[j] = fmaf(x, x, nrm[j]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < RU; ++j) {
      const float dt = warp_sum(dot[j]);
      const float cn2 = metric != 2 ? warp_sum(nrm[j]) : 0.f;
      if (lane == j && r0 + j < BS) {
        float dist;
        if (metric == 0) {
          dist = qn2 + cn2 - 2.0f * dt;
        } else if (metric == 1) {
          const float denom = sqrtf(qn2) * sqrtf(cn2);
          dist = denom > 0.f ? 1.0f - dt / denom : 1.0f;
        } else {
          dist = 1.0f - dt;
        }
        res[r0 + j] = dist;
      }
    }
  }
  __syncthreads();

  float* orow = out + bp * BS;
  for (int r = tid; r < BS; r += NT) orow[r] = res[r];
}

template <typename T>
void launch(const void* blk, const void* bids, const void* q, void* out,
            int NB, int BS, int D, int B, int P, int metric,
            cudaStream_t stream) {
  const size_t smem = (size_t)(((D + 3) & ~3) + BS) * sizeof(float);
  const unsigned grid = (unsigned)((long long)B * P);
  const bool vec = D % Tile<T>::N == 0 &&
                   reinterpret_cast<uintptr_t>(blk) % 16 == 0;
  if (vec) {
    block_scores_kernel<T, true><<<grid, NT, smem, stream>>>(
        (const T*)blk, (const int32_t*)bids, (const T*)q, (float*)out, NB, BS,
        D, P, metric);
  } else {
    block_scores_kernel<T, false><<<grid, NT, smem, stream>>>(
        (const T*)blk, (const int32_t*)bids, (const T*)q, (float*)out, NB, BS,
        D, P, metric);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer to a contiguous array: blk (NB, BS, D) and q (B, D) in float32
// (is_bf16 == 0) or bfloat16 (is_bf16 == 1), bids (B, P) i32, out
// (B, P*BS) f32.  The caller keeps (D + BS) * 4 bytes within the 48 KB of
// static-limit shared memory and B * P below 2^31.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int hnsw_block_scores(const void* blk, const void* bids,
                                 const void* q, void* out, int NB, int BS,
                                 int D, int B, int P, int metric, int is_bf16,
                                 void* stream) {
  if (B > 0 && P > 0) {
    if (is_bf16) {
      launch<__nv_bfloat16>(blk, bids, q, out, NB, BS, D, B, P, metric,
                            (cudaStream_t)stream);
    } else {
      launch<float>(blk, bids, q, out, NB, BS, D, B, P, metric,
                    (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}
