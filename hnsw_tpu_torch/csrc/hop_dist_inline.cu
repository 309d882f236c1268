// Split-tier hop kernel (bf16 neighbor vectors, ids from level0), for sm_90a.
//
// Replaces: hnsw_tpu/ops/pallas_gather.py, hop_dist_inline / _hop_dist_kernel
// together with extract_level0_ids. For each query b and each of its E chosen
// nodes c = chosen[b, e], it reads the node's block of m0 neighbor vectors
// from nbr_vectors [N_pad, m0, d_pad] (bf16) and the node's row of the
// graph's own adjacency level0 [N_pad, m0], and writes
//   L2: dists[b, e*m0 + j] = sum_i (x_i - q_i)^2
//   IP: dists[b, e*m0 + j] = 1 - sum_i x_i * q_i
// with x widened from bf16 to f32 and q in f32, and ids[b, e*m0 + j] =
// level0[c, j].
//
// The TPU kernel copies a 4 KB tile of 32 nodes' ids per expansion, because
// Mosaic's DMA wants (8, 128) tiles, and XLA then picks the node's m0 ids out
// of the tile with one-hot reduces; its chosen ids are lane-packed in SMEM and
// d is padded to 128 lanes. None of that is carried over: here the m0 ids are
// read straight from level0, so the split tier holds one table and no second
// copy of the adjacency, and a row delta written to level0 is at once what
// this kernel returns.
//
// What is true on this card: the port's bf16 unified table is already two
// tensors (vectors and payload ids), so this kernel reads the same bytes as
// hop_dist_unified_bf16. What differs is which tensors it is handed (the
// payload is level0 itself) and how a warp is mapped to the rows.
//
// What bounds it: bytes. Each (query, chosen) pair reads one contiguous
// m0*d_pad*2-byte block plus m0*4 bytes of ids from a random place. A bulk
// build wave at B=16384, E=2, m0=32, d=128 reads 16384*2*(32*128*2 + 32*4) B =
// 272 MB per beam iteration, ~81 us at the H100's 3.35 TB/s; 3 flops per byte
// read is far below the compute roof.
//
// Design: one block of 8 warps per query, the query staged once in shared
// memory. A half-warp takes one neighbor row with 16-byte loads (8 bf16 per
// lane: a 256-byte row at d_pad=128 is one load per lane), and each warp
// works on two pairs of rows per step, so a lane has two 16-byte loads in
// flight where the unified bf16 kernel has one 8-byte load: with random
// block reads the bytes in flight per SM set the rate. Lanes accumulate in
// f32 and reduce within the half-warp by __shfl_xor_sync; the first lane of
// each half writes the distance and the id. A chosen id outside [0, R) reads
// nothing and yields NaN and id -1; the traversal never passes one (the
// sentinel n_pad-1 is a real dummy row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerStep = 4 * kWarps;  // two half-warp pairs per warp

// Two bf16 values packed in 32 bits (the lower address in the low half)
// widened to f32: a bf16 is the top 16 bits of the f32 it came from.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t bits) {
  return make_float2(__uint_as_float(bits << 16), __uint_as_float(bits & 0xffff0000u));
}

// acc += the 8 lanes of `raw` (bf16) against q0, q1 (f32).
template <bool kIP>
__device__ __forceinline__ float accumulate8(const uint4 raw, const float4 q0, const float4 q1,
                                             float acc) {
  const float2 x01 = bf16x2_to_float2(raw.x), x23 = bf16x2_to_float2(raw.y);
  const float2 x45 = bf16x2_to_float2(raw.z), x67 = bf16x2_to_float2(raw.w);
  if (kIP) {
    acc = fmaf(x01.x, q0.x, acc);
    acc = fmaf(x01.y, q0.y, acc);
    acc = fmaf(x23.x, q0.z, acc);
    acc = fmaf(x23.y, q0.w, acc);
    acc = fmaf(x45.x, q1.x, acc);
    acc = fmaf(x45.y, q1.y, acc);
    acc = fmaf(x67.x, q1.z, acc);
    acc = fmaf(x67.y, q1.w, acc);
  } else {
    const float t0 = x01.x - q0.x, t1 = x01.y - q0.y, t2 = x23.x - q0.z, t3 = x23.y - q0.w;
    const float t4 = x45.x - q1.x, t5 = x45.y - q1.y, t6 = x67.x - q1.z, t7 = x67.y - q1.w;
    acc = fmaf(t0, t0, acc);
    acc = fmaf(t1, t1, acc);
    acc = fmaf(t2, t2, acc);
    acc = fmaf(t3, t3, acc);
    acc = fmaf(t4, t4, acc);
    acc = fmaf(t5, t5, acc);
    acc = fmaf(t6, t6, acc);
    acc = fmaf(t7, t7, acc);
  }
  return acc;
}

// The flat row index (node*m0 + j) of output column r of query b, or -1 when
// r is past the E*m0 columns or the chosen node is out of range.
__device__ __forceinline__ long long locate_row(const int32_t* __restrict__ chosen, int b, int E,
                                                int m0, long long R, int r) {
  if (r >= E * m0) return -1;
  const int e = r / m0;
  const long long node = chosen[(size_t)b * E + e];
  if (node < 0 || node >= R) return -1;
  return node * m0 + (r - e * m0);
}

template <bool kIP>
__global__ void __launch_bounds__(kWarps * 32)
hop_dist_inline_kernel(const float* __restrict__ q,            // [B, d_pad]
                       const uint16_t* __restrict__ nbr,        // [R, m0, d_pad] bf16 bits
                       const int32_t* __restrict__ level0,      // [R, m0]
                       const int32_t* __restrict__ chosen,      // [B, E]
                       float* __restrict__ out_d,               // [B, E*m0]
                       int32_t* __restrict__ out_ids,           // [B, E*m0]
                       int E, int m0, int d_pad, long long R) {
  extern __shared__ __align__(16) float q_s[];  // [d_pad]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane >> 4;  // which row of the warp's pair
  const int hl = lane & 15;    // lane within the half-warp

  const float* qb = q + (size_t)b * d_pad;
  for (int i = threadIdx.x; i < d_pad; i += blockDim.x) q_s[i] = qb[i];
  __syncthreads();

  const int em = E * m0;
  const int chunks = d_pad >> 3;  // 8 bf16 = 16 bytes per chunk
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  float* od = out_d + (size_t)b * em;
  int32_t* oi = out_ids + (size_t)b * em;

  // r0 is warp-uniform, so every lane reaches the shuffles below
  for (int r0 = 2 * warp; r0 < em; r0 += kRowsPerStep) {
    const int ra = r0 + half, rb = r0 + 2 * kWarps + half;
    const long long row_a = locate_row(chosen, b, E, m0, R, ra);
    const long long row_b = locate_row(chosen, b, E, m0, R, rb);
    const uint4* src_a = reinterpret_cast<const uint4*>(nbr + (row_a < 0 ? 0 : row_a) * d_pad);
    const uint4* src_b = reinterpret_cast<const uint4*>(nbr + (row_b < 0 ? 0 : row_b) * d_pad);
    int32_t id_a = -1, id_b = -1;
    if (hl == 0 && row_a >= 0) id_a = __ldg(level0 + row_a);
    if (hl == 0 && row_b >= 0) id_b = __ldg(level0 + row_b);
    float acc_a = 0.f, acc_b = 0.f;
    for (int c = hl; c < chunks; c += 16) {
      uint4 xa = make_uint4(0, 0, 0, 0), xb = make_uint4(0, 0, 0, 0);
      if (row_a >= 0) xa = __ldg(src_a + c);
      if (row_b >= 0) xb = __ldg(src_b + c);
      const float4 q0 = q4[2 * c], q1 = q4[2 * c + 1];
      acc_a = accumulate8<kIP>(xa, q0, q1, acc_a);
      acc_b = accumulate8<kIP>(xb, q0, q1, acc_b);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {  // stays within each half-warp
      acc_a += __shfl_xor_sync(0xffffffffu, acc_a, o);
      acc_b += __shfl_xor_sync(0xffffffffu, acc_b, o);
    }
    if (hl == 0) {
      const float nan = __int_as_float(0x7fc00000);
      if (ra < em) {
        od[ra] = row_a < 0 ? nan : (kIP ? 1.f - acc_a : acc_a);
        oi[ra] = id_a;
      }
      if (rb < em) {
        od[rb] = row_b < 0 ? nan : (kIP ? 1.f - acc_b : acc_b);
        oi[rb] = id_b;
      }
    }
  }
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int hop_dist_inline(const void* q, const void* nbr_vectors, const void* level0,
                               const void* chosen, void* out_d, void* out_ids, int B, int E,
                               int m0, int d_pad, long long R, int ip, void* stream) {
  if (B > 0) {
    const dim3 grid(B), block(kWarps * 32);
    const size_t smem = (size_t)d_pad * sizeof(float);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* qf = static_cast<const float*>(q);
    const auto* nb = static_cast<const uint16_t*>(nbr_vectors);
    const auto* l0 = static_cast<const int32_t*>(level0);
    const auto* ch = static_cast<const int32_t*>(chosen);
    auto* od = static_cast<float*>(out_d);
    auto* oi = static_cast<int32_t*>(out_ids);
    if (ip) {
      hop_dist_inline_kernel<true><<<grid, block, smem, s>>>(qf, nb, l0, ch, od, oi, E, m0,
                                                             d_pad, R);
    } else {
      hop_dist_inline_kernel<false><<<grid, block, smem, s>>>(qf, nb, l0, ch, od, oi, E, m0,
                                                              d_pad, R);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
