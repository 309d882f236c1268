// Unified node-block hop kernel, bf16, for sm_90a.
//
// Replaces: hnsw_tpu/ops/pallas_gather.py, hop_dist_unified /
// _hop_dist_unified_kernel (bf16 rows). For each query b and each of its E
// chosen nodes c = chosen[b, e], it reads the node's block of m0 neighbor
// vectors (bf16, [m0, d_pad]) and their m0 payload ids, and writes
//   L2: dists[b, e*m0 + j] = sum_i (x_i - q_i)^2
//   IP: dists[b, e*m0 + j] = 1 - sum_i x_i * q_i
// with x widened from bf16 to f32 and q in f32, and ids[b, e*m0 + j] =
// payload[c, j] (neighbor ids at level 0, neighbor slots in the upper-level
// tables).
//
// What bounds it: bytes. Each (query, chosen) pair reads one contiguous
// m0*d_pad*2-byte block plus m0*4 bytes of ids from a random place in the
// table. At B=8192, E=2, m0=32, d=128 one beam iteration reads about
// 8192*2*(32*128*2 + 32*4) B = 136 MB, ~41 us at the H100's 3.35 TB/s; the
// arithmetic (3 flops per byte read) is far below the compute roof.
//
// Design: one block of 8 warps per query. The query row is staged once in
// shared memory and reused for all E*m0 neighbor rows. One warp per neighbor
// row: each lane loads 4 bf16 values (8 bytes) per step, so at d_pad=128 a
// warp reads its 256-byte row in one coalesced load; lanes accumulate in f32
// and reduce with __shfl_xor_sync, and lane 0 writes the distance and copies
// the payload id. Consecutive warps read consecutive rows of the same node
// block. A chosen id outside [0, R) reads nothing and yields NaN and id -1;
// the traversal never passes one (the sentinel n_pad-1 is a real dummy row).
// Later work: cp.async/TMA pipelining of several blocks per warp, and fusing
// the dedup and merge that follow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

// Two bf16 values packed in 32 bits (the lower address in the low half)
// widened to f32: a bf16 is the top 16 bits of the f32 it came from.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t bits) {
  return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xffff0000u));
}

template <bool kIP>
__global__ void __launch_bounds__(kWarps * 32)
hop_dist_unified_bf16_kernel(const float* __restrict__ q,               // [B, d_pad]
                             const uint16_t* __restrict__ vecs,         // [R, m0, d_pad] bf16 bits
                             const int32_t* __restrict__ payload,       // [R, m0]
                             const int32_t* __restrict__ chosen,        // [B, E]
                             float* __restrict__ out_d,                 // [B, E*m0]
                             int32_t* __restrict__ out_ids,             // [B, E*m0]
                             int E, int m0, int d_pad, long long R) {
  extern __shared__ __align__(16) float q_s[];  // [d_pad]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* qb = q + (size_t)b * d_pad;
  for (int i = threadIdx.x; i < d_pad; i += blockDim.x) q_s[i] = qb[i];
  __syncthreads();

  const int em = E * m0;
  const int chunks = d_pad >> 2;  // 4 bf16 = 8 bytes per chunk
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  float* od = out_d + (size_t)b * em;
  int32_t* oi = out_ids + (size_t)b * em;

  for (int r = warp; r < em; r += kWarps) {  // r is warp-uniform
    const int e = r / m0;
    const int j = r - e * m0;
    const long long node = chosen[(size_t)b * E + e];
    if (node < 0 || node >= R) {
      if (lane == 0) {
        od[r] = __int_as_float(0x7fc00000);
        oi[r] = -1;
      }
      continue;
    }
    const size_t row = (size_t)node * m0 + j;
    const uint2* src = reinterpret_cast<const uint2*>(vecs + row * d_pad);
    float acc = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      const uint2 raw = __ldg(src + c);
      const float4 qv = q4[c];
      const float2 x01 = bf16x2_to_float2(raw.x);
      const float2 x23 = bf16x2_to_float2(raw.y);
      if (kIP) {
        acc = fmaf(x01.x, qv.x, acc);
        acc = fmaf(x01.y, qv.y, acc);
        acc = fmaf(x23.x, qv.z, acc);
        acc = fmaf(x23.y, qv.w, acc);
      } else {
        const float t0 = x01.x - qv.x, t1 = x01.y - qv.y;
        const float t2 = x23.x - qv.z, t3 = x23.y - qv.w;
        acc = fmaf(t0, t0, acc);
        acc = fmaf(t1, t1, acc);
        acc = fmaf(t2, t2, acc);
        acc = fmaf(t3, t3, acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      od[r] = kIP ? 1.f - acc : acc;
      oi[r] = payload[row];
    }
  }
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int hop_dist_unified_bf16(const void* q, const void* vecs, const void* payload,
                                     const void* chosen, void* out_d, void* out_ids, int B,
                                     int E, int m0, int d_pad, long long R, int ip,
                                     void* stream) {
  if (B > 0) {
    const dim3 grid(B), block(kWarps * 32);
    const size_t smem = (size_t)d_pad * sizeof(float);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* qf = static_cast<const float*>(q);
    const auto* vb = static_cast<const uint16_t*>(vecs);
    const auto* pl = static_cast<const int32_t*>(payload);
    const auto* ch = static_cast<const int32_t*>(chosen);
    auto* od = static_cast<float*>(out_d);
    auto* oi = static_cast<int32_t*>(out_ids);
    if (ip) {
      hop_dist_unified_bf16_kernel<true><<<grid, block, smem, s>>>(qf, vb, pl, ch, od, oi, E,
                                                                    m0, d_pad, R);
    } else {
      hop_dist_unified_bf16_kernel<false><<<grid, block, smem, s>>>(qf, vb, pl, ch, od, oi, E,
                                                                     m0, d_pad, R);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
