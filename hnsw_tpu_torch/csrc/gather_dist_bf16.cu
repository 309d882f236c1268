// Row-gather distance kernel over a bf16 vector table, for sm_90a.
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
//
// What bounds it: bytes, B*K*D*2 of rows read from random places in the
// table (1024 x 40 rows of 256 B at d=128: 10.5 MB, ~3.1 us at 3.35 TB/s).
//
// Design: the shape of gather_dist.cu. One block of 8 warps per query, the
// query staged in shared memory as f32. One warp per gathered row: when D is
// a multiple of 4 each lane loads 4 bf16 values (8 bytes) per step, so at
// d=128 a warp reads its 256-byte row in one coalesced load; otherwise lanes
// read one value each per step. Lanes accumulate in f32 and reduce with
// __shfl_xor_sync; lane 0 writes the distance. An id outside [0, N) reads
// nothing and yields NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

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
void launch(const float* q, const uint16_t* t, const int32_t* ids, float* out, int B, int K,
            int D, long long N, cudaStream_t s) {
  const dim3 grid(B), block(kWarps * 32);
  const size_t smem = (size_t)D * sizeof(float);
  if (D % 4 == 0) {
    gather_dist_bf16_kernel<kIP, true><<<grid, block, smem, s>>>(q, t, ids, out, K, D, N);
  } else {
    gather_dist_bf16_kernel<kIP, false><<<grid, block, smem, s>>>(q, t, ids, out, K, D, N);
  }
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int gather_dist_bf16(const void* q, const void* table, const void* ids, void* out,
                                int B, int K, int D, long long N, int ip, void* stream) {
  if (B > 0 && K > 0) {
    const auto* qf = static_cast<const float*>(q);
    const auto* tb = static_cast<const uint16_t*>(table);
    const auto* id = static_cast<const int32_t*>(ids);
    auto* of = static_cast<float*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ip) {
      launch<true>(qf, tb, id, of, B, K, D, N, s);
    } else {
      launch<false>(qf, tb, id, of, B, K, D, N, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
