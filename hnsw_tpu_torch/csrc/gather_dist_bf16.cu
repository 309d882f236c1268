// Row-gather distance kernels over a bf16 vector table, for sm_90a.
//
// Replaces: hnsw_tpu/ops/pallas_gather.py, gather_dist_pallas on a bf16
// table / _gather_dist_kernel_pair (:74-109), the exact rescore of an index
// whose vectors are stored in bf16. For each query b and each j < K it
// computes, from q[b] in f32 and x = table[ids[b, j]] widened from bf16, the
// TPU kernel's direct-difference form (not the norm expansion of the f32
// kernel):
//   L2: sum_i (x_i - q_i)^2
//   IP: 1 - sum_i x_i * q_i
// The TPU kernel copies aligned row pairs and picks one by id parity, a
// workaround for Mosaic's bf16 DMA tiling; here each row is read directly.
// An id outside [0, N) reads nothing and yields NaN.
//
// What bounds it: bytes, B*K*D*2 of rows read from random places in the
// table (1024 x 40 rows of 256 B at d=128: 10.5 MB, ~3.1 us at 3.35 TB/s),
// and at that size a launch's fixed cost and the round trips to device
// memory (ids, then rows) are most of the time. So a query's rows must be
// read at once, and all of the launch's blocks must be resident at once.
//
// Two CUDA paths, one C entry:
//
// 1. D % 8 == 0 with 16-byte aligned q and table (every row a whole number
//    of 16-byte chunks; the port's tables at d = 96, 128, 768): one block of
//    4 warps per query, a half-warp per row, 5 rows per half-warp: 40 rows
//    of a query in flight at once, in registers. A half-warp loads its 5
//    ids, then issues the 16-byte loads of all 5 rows (one 8-value chunk per
//    lane per row) before any arithmetic, takes the query's matching chunk
//    straight from global memory (the L1 serves the block's other warps),
//    accumulates in f32 and reduces with __shfl_xor_sync; past 40 rows (K >
//    40) it goes again. No shared memory and no block barrier. The registers
//    are capped at 64 so that 8 blocks fit on an SM: the 1,024 queries of a
//    rescore are one wave. On an H100, cold at B=1024 K=40, staging the rows
//    in shared memory by cp.async (one or two block barriers per query) took
//    0.0093 ms against this design's 0.0072, and this design without the
//    cap (70 registers a thread, 7 blocks per SM) 0.0091.
//
// 2. Any other width (the bf16 table is stored unpadded, so d=30 gives
//    60-byte rows, 4-byte aligned): the first design of this kernel, one
//    block of 8 warps per query, the query staged in shared memory, a warp
//    per row with one 8-byte (D % 4 == 0) or 2-byte load per lane per step,
//    rows taken one after another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a bf16 is the top 16 bits of the f32 it came from
__device__ __forceinline__ float bf16_lo(uint32_t bits) { return __uint_as_float(bits << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t bits) {
  return __uint_as_float(bits & 0xffff0000u);
}

template <bool kIP>
__device__ __forceinline__ float accum(float acc, float x, float q) {
  if (kIP) return fmaf(x, q, acc);
  const float t = x - q;
  return fmaf(t, t, acc);
}

// ---- path 1: every row of a query in flight --------------------------------

constexpr int kRowWarps = 4;
constexpr int kRowThreads = kRowWarps * 32;
constexpr int kHalves = kRowThreads / 16;
constexpr int kRowsPerHalf = 5;  // rows in flight per half-warp: 40 per block

// acc += the 8 values of one 16-byte chunk of a row against q's chunk
template <bool kIP>
__device__ __forceinline__ float accumulate8(uint4 raw, float4 qa, float4 qb, float acc) {
  acc = accum<kIP>(acc, bf16_lo(raw.x), qa.x);
  acc = accum<kIP>(acc, bf16_hi(raw.x), qa.y);
  acc = accum<kIP>(acc, bf16_lo(raw.y), qa.z);
  acc = accum<kIP>(acc, bf16_hi(raw.y), qa.w);
  acc = accum<kIP>(acc, bf16_lo(raw.z), qb.x);
  acc = accum<kIP>(acc, bf16_hi(raw.z), qb.y);
  acc = accum<kIP>(acc, bf16_lo(raw.w), qb.z);
  acc = accum<kIP>(acc, bf16_hi(raw.w), qb.w);
  return acc;
}

template <bool kIP>
__global__ void __launch_bounds__(kRowThreads, 8)
gather_dist_bf16_rows_kernel(const float* __restrict__ q,         // [B, D]
                             const uint16_t* __restrict__ table,  // [N, D] bf16 bits
                             const int32_t* __restrict__ ids,     // [B, K]
                             float* __restrict__ out,             // [B, K]
                             int K, int D, long long N) {
  const int b = blockIdx.x;
  const int hw = threadIdx.x >> 4;  // half-warp of the block
  const int hl = threadIdx.x & 15;  // lane within the half-warp
  const int cpr = D >> 3;           // 16-byte chunks per row
  const int32_t* idb = ids + (size_t)b * K;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * D);
  // base is block-uniform and i is unrolled, so every lane reaches the shuffles
  for (int base = 0; base < K; base += kHalves * kRowsPerHalf) {
    int row[kRowsPerHalf];  // -1: no row (past K, or an id outside [0, N))
#pragma unroll
    for (int i = 0; i < kRowsPerHalf; ++i) {
      const int r = base + hw + kHalves * i;
      row[i] = r < K ? __ldg(idb + r) : -1;
      if (row[i] >= N) row[i] = -1;
    }
    float acc[kRowsPerHalf];
#pragma unroll
    for (int i = 0; i < kRowsPerHalf; ++i) acc[i] = 0.f;
    for (int c = hl; c < cpr; c += 16) {
      uint4 raw[kRowsPerHalf];
#pragma unroll
      for (int i = 0; i < kRowsPerHalf; ++i)
        raw[i] = row[i] >= 0
                     ? __ldg(reinterpret_cast<const uint4*>(table + (size_t)row[i] * D) + c)
                     : make_uint4(0, 0, 0, 0);
      const float4 qa = __ldg(q4 + 2 * c), qb = __ldg(q4 + 2 * c + 1);
#pragma unroll
      for (int i = 0; i < kRowsPerHalf; ++i) acc[i] = accumulate8<kIP>(raw[i], qa, qb, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerHalf; ++i) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      const int r = base + hw + kHalves * i;
      if (hl == 0 && r < K)
        out[(size_t)b * K + r] =
            row[i] >= 0 ? (kIP ? 1.f - acc[i] : acc[i]) : __int_as_float(0x7fc00000);
    }
  }
}

// ---- path 2: any width, a warp per row -------------------------------------

constexpr int kWarps = 8;

template <bool kIP, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gather_dist_bf16_kernel(const float* __restrict__ q,         // [B, D]
                        const uint16_t* __restrict__ table,  // [N, D] bf16 bits
                        const int32_t* __restrict__ ids,     // [B, K]
                        float* __restrict__ out,             // [B, K]
                        int K, int D, long long N) {
  extern __shared__ __align__(16) float q_s[];  // [D]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* qb = q + (size_t)b * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) q_s[i] = qb[i];
  __syncthreads();

  for (int j = warp; j < K; j += kWarps) {  // j is warp-uniform
    const long long row = ids[(size_t)b * K + j];
    float* o = out + (size_t)b * K + j;
    if (row < 0 || row >= N) {
      if (lane == 0) *o = __int_as_float(0x7fc00000);
      continue;
    }
    const uint16_t* x = table + (size_t)row * D;
    float acc = 0.f;
    if (kVec) {
      const uint2* x4 = reinterpret_cast<const uint2*>(x);
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
      for (int c = lane; c < (D >> 2); c += 32) {
        const uint2 raw = __ldg(x4 + c);
        const float4 qv = q4[c];
        acc = accum<kIP>(acc, bf16_lo(raw.x), qv.x);
        acc = accum<kIP>(acc, bf16_hi(raw.x), qv.y);
        acc = accum<kIP>(acc, bf16_lo(raw.y), qv.z);
        acc = accum<kIP>(acc, bf16_hi(raw.y), qv.w);
      }
    } else {
      for (int i = lane; i < D; i += 32) {
        acc = accum<kIP>(acc, bf16_lo(static_cast<uint32_t>(__ldg(x + i))), q_s[i]);
      }
    }
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o2);
    if (lane == 0) *o = kIP ? 1.f - acc : acc;
  }
}

template <bool kIP>
int launch(const float* q, const uint16_t* t, const int32_t* ids, float* out, int B, int K, int D,
           long long N, cudaStream_t s) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(t);
  const bool aligned = (addr & 15) == 0;
  if (D % 8 == 0 && aligned) {
    gather_dist_bf16_rows_kernel<kIP><<<B, kRowThreads, 0, s>>>(q, t, ids, out, K, D, N);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(B), block(kWarps * 32);
  const size_t smem = (size_t)D * sizeof(float);
  if (D % 4 == 0) {
    gather_dist_bf16_kernel<kIP, true><<<grid, block, smem, s>>>(q, t, ids, out, K, D, N);
  } else {
    gather_dist_bf16_kernel<kIP, false><<<grid, block, smem, s>>>(q, t, ids, out, K, D, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int gather_dist_bf16(const void* q, const void* table, const void* ids, void* out,
                                int B, int K, int D, long long N, int ip, void* stream) {
  if (B <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const auto* qf = static_cast<const float*>(q);
  const auto* tb = static_cast<const uint16_t*>(table);
  const auto* id = static_cast<const int32_t*>(ids);
  auto* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ip ? launch<true>(qf, tb, id, of, B, K, D, N, s)
            : launch<false>(qf, tb, id, of, B, K, D, N, s);
}
