// Unified node-block hop kernels, int8 and int4 rows, for sm_90a.
//
// Replaces: hnsw_tpu/ops/pallas_gather.py, hop_dist_unified /
// _hop_dist_unified_kernel with int8=True (dequant :724-735) and int4=True
// (nibble unpack :717-723). For each query b and each of its E chosen nodes
// c = chosen[b, e] it reads the node's block of m0 neighbors' codes, their
// m0 dequant scales and m0 payload ids, and writes, with
// r_i = float(code_i) * scale (the TPU kernel's f32 dequant, in its order):
//   L2: dists[b, e*m0 + j] = sum_i (r_i - q_i)^2
//   IP: dists[b, e*m0 + j] = 1 - sum_i r_i * q_i
// and ids[b, e*m0 + j] = payload[c, j]. With the l2u8 space's scale-1 codes
// and integer queries every term and partial sum is an exact integer below
// 2^24, so the L2 distance is exact.
//
// What bounds it: bytes. One (query, chosen) pair reads m0*(d_pad + 4 + 4)
// bytes for int8 (4,352 B at m0=32, d=128, against 8,320 B for bf16 rows)
// and m0*(d_pad/2 + 4 + 4) for int4 (2,304 B). At B=8192, E=2 one beam
// iteration reads ~71 MB (int8) or ~38 MB (int4): ~21 us / ~11 us at the
// H100 SXM's 3.35 TB/s. The arithmetic (4 flops per code) is far below the
// compute roof.
//
// int8: the node-block ring of hop_ring.cuh (TMA bulk copies of whole
// blocks, codes, scales and ids, into a shared-memory ring; a half-warp per
// row reads 8 codes per lane per step from shared memory).
//
// int4: one block of 8 warps per query, the query staged once in shared
// memory as f32 and reused for all E*m0 rows. A row is half as long as an
// int8 row, so a half-warp takes a row (two rows per warp), each lane
// loading one word (8 nibbles) per step. A code is sign-extended with a
// shift pair, (int)(w << (32 - 4*(k+1))) >> 28, as the TPU kernel does
// (:722). The slot's scale is one broadcast read per row. Lanes accumulate
// in f32 and reduce with __shfl_xor_sync inside their half; the half's first
// lane writes the distance and copies the payload id. A chosen id outside
// [0, R) reads nothing and yields NaN and id -1; the traversal never passes
// one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hop_ring.cuh"

namespace {

constexpr int kWarps = 8;

template <bool kIP>
__device__ __forceinline__ float accum(float acc, float r, float q) {
  if (kIP) return fmaf(r, q, acc);
  const float t = r - q;
  return fmaf(t, t, acc);
}

// 16 lanes per row, 8 codes per 32-bit word (nibble k = code 8c+k).
template <bool kIP>
__global__ void __launch_bounds__(kWarps * 32)
hop_dist_int4_kernel(const float* __restrict__ q,          // [B, d_pad]
                     const uint32_t* __restrict__ codes,   // [R, m0, d_pad/8] words
                     const float* __restrict__ scales,     // [R, m0]
                     const int32_t* __restrict__ payload,  // [R, m0]
                     const int32_t* __restrict__ chosen,   // [B, E]
                     float* __restrict__ out_d,            // [B, E*m0]
                     int32_t* __restrict__ out_ids,        // [B, E*m0]
                     int E, int m0, int d_pad, long long R) {
  constexpr int kBits = 4;
  constexpr int kGroup = 16;                    // lanes per row
  constexpr int kRowsPerWarp = 32 / kGroup;
  constexpr int kPerWord = 32 / kBits;          // codes per word
  extern __shared__ __align__(16) float q_s[];  // [d_pad]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / kGroup;  // row of this lane within the warp's rows
  const int gl = lane % kGroup;   // lane within the row group

  const float* qb = q + (size_t)b * d_pad;
  for (int i = threadIdx.x; i < d_pad; i += blockDim.x) q_s[i] = qb[i];
  __syncthreads();

  const int em = E * m0;
  const int words = d_pad / kPerWord;
  float* od = out_d + (size_t)b * em;
  int32_t* oi = out_ids + (size_t)b * em;

  // `base` is warp-uniform, so every lane reaches the shuffles
  for (int base = warp * kRowsPerWarp; base < em; base += kWarps * kRowsPerWarp) {
    const int r = base + sub;
    const bool live = r < em;
    size_t row = 0;
    bool ok = false;
    if (live) {
      const int e = r / m0;
      const long long node = chosen[(size_t)b * E + e];
      ok = node >= 0 && node < R;
      row = (size_t)node * m0 + (r - e * m0);
    }
    float acc = 0.f;
    if (ok) {
      const float scale = scales[row];
      const uint32_t* src = codes + row * words;
      for (int c = gl; c < words; c += kGroup) {
        const uint32_t w = __ldg(src + c);
        const float4* q4 = reinterpret_cast<const float4*>(q_s + c * kPerWord);
#pragma unroll
        for (int t = 0; t < kPerWord / 4; ++t) {
          const float4 qv = q4[t];
          const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = 4 * t + u;
            const int code = static_cast<int>(w << (32 - kBits * (k + 1))) >> (32 - kBits);
            acc = accum<kIP>(acc, static_cast<float>(code) * scale, qs[u]);
          }
        }
      }
    }
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (live && gl == 0) {
      od[r] = ok ? (kIP ? 1.f - acc : acc) : __int_as_float(0x7fc00000);
      oi[r] = ok ? payload[row] : -1;
    }
  }
}

int launch_int4(const void* q, const void* codes, const void* scales, const void* payload,
                const void* chosen, void* out_d, void* out_ids, int B, int E, int m0, int d_pad,
                long long R, int ip, void* stream) {
  if (B > 0) {
    const dim3 grid(B), block(kWarps * 32);
    const size_t smem = (size_t)d_pad * sizeof(float);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* qf = static_cast<const float*>(q);
    const auto* cw = static_cast<const uint32_t*>(codes);
    const auto* sc = static_cast<const float*>(scales);
    const auto* pl = static_cast<const int32_t*>(payload);
    const auto* ch = static_cast<const int32_t*>(chosen);
    auto* od = static_cast<float*>(out_d);
    auto* oi = static_cast<int32_t*>(out_ids);
    if (ip) {
      hop_dist_int4_kernel<true><<<grid, block, smem, s>>>(qf, cw, sc, pl, ch, od, oi, E, m0,
                                                           d_pad, R);
    } else {
      hop_dist_int4_kernel<false><<<grid, block, smem, s>>>(qf, cw, sc, pl, ch, od, oi, E, m0,
                                                            d_pad, R);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries, bound with ctypes. Pointers are device pointers; `stream` is
// the caller's cudaStream_t. Each returns cudaGetLastError() after the launch.
extern "C" int hop_dist_unified_int8(const void* q, const void* codes, const void* scales,
                                     const void* payload, const void* chosen, void* out_d,
                                     void* out_ids, int B, int E, int m0, int d_pad,
                                     long long R, int ip, void* stream) {
  return hop_ring::launch<hop_ring::kInt8>(q, codes, scales, payload, chosen, out_d, out_ids, B,
                                           E, m0, d_pad, R, ip, stream);
}

extern "C" int hop_dist_unified_int4(const void* q, const void* codes, const void* scales,
                                     const void* payload, const void* chosen, void* out_d,
                                     void* out_ids, int B, int E, int m0, int d_pad,
                                     long long R, int ip, void* stream) {
  return launch_int4(q, codes, scales, payload, chosen, out_d, out_ids, B, E, m0, d_pad, R, ip,
                     stream);
}
