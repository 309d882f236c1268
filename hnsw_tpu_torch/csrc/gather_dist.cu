// Row-gather distance kernel over an f32 vector table, for sm_90a.
//
// Replaces: hnsw_tpu/ops/pallas_gather.py, gather_dist_pallas /
// _gather_dist_kernel (f32 table), the exact rescore of
// HNSWIndex._rescore_topk. For each query b and each j < K it computes the
// distance from q[b] to table[ids[b, j]] in the TPU kernel's norm-expansion
// form:
//   L2: max(|q|^2 + |x|^2 - 2 q.x, 0)
//   IP: 1 - q.x
//
// What bounds it: bytes, B*K*D*4 of rows read from random places in the
// table (1024 x 40 rows of 512 B at d=128: 21 MB, ~6 us at 3.35 TB/s).
//
// Design: one block of 8 warps per query. The query row is staged in shared
// memory and |q|^2 is reduced once per query by warp 0. One warp per
// gathered row: lanes stride over the row with coalesced f32 loads,
// accumulate q.x and x.x with FMAs, and reduce with __shfl_xor_sync; lane 0
// writes the distance. An id outside [0, N) reads nothing and yields NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kIP>
__global__ void __launch_bounds__(kWarps * 32)
gather_dist_f32_kernel(const float* __restrict__ q,      // [B, D]
                       const float* __restrict__ table,  // [N, D]
                       const int32_t* __restrict__ ids,  // [B, K]
                       float* __restrict__ out,          // [B, K]
                       int K, int D, long long N) {
  extern __shared__ __align__(16) float q_s[];  // [D]
  __shared__ float q2_s;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* qb = q + (size_t)b * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) q_s[i] = qb[i];
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s = fmaf(q_s[i], q_s[i], s);
    s = warp_sum(s);
    if (lane == 0) q2_s = s;
  }
  __syncthreads();
  const float q2 = q2_s;

  for (int j = warp; j < K; j += kWarps) {  // j is warp-uniform
    const long long row = ids[(size_t)b * K + j];
    float* o = out + (size_t)b * K + j;
    if (row < 0 || row >= N) {
      if (lane == 0) *o = __int_as_float(0x7fc00000);
      continue;
    }
    const float* x = table + (size_t)row * D;
    float qx = 0.f, xx = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float v = __ldg(x + i);
      qx = fmaf(v, q_s[i], qx);
      xx = fmaf(v, v, xx);
    }
    qx = warp_sum(qx);
    xx = warp_sum(xx);
    if (lane == 0) *o = kIP ? 1.f - qx : fmaxf(q2 + xx - 2.f * qx, 0.f);
  }
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int gather_dist_f32(const void* q, const void* table, const void* ids, void* out,
                               int B, int K, int D, long long N, int ip, void* stream) {
  if (B > 0 && K > 0) {
    const dim3 grid(B), block(kWarps * 32);
    const size_t smem = (size_t)D * sizeof(float);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* qf = static_cast<const float*>(q);
    const auto* tf = static_cast<const float*>(table);
    const auto* id = static_cast<const int32_t*>(ids);
    auto* of = static_cast<float*>(out);
    if (ip) {
      gather_dist_f32_kernel<true><<<grid, block, smem, s>>>(qf, tf, id, of, K, D, N);
    } else {
      gather_dist_f32_kernel<false><<<grid, block, smem, s>>>(qf, tf, id, of, K, D, N);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
