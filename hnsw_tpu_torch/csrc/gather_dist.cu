// Row-gather distance kernels over an f32 vector table, for sm_90a.
//
// Replaces: hnsw_tpu/ops/pallas_gather.py, gather_dist_pallas /
// _gather_dist_kernel (f32 table), the exact rescore of
// HNSWIndex._rescore_topk. For each query b and each j < K it computes the
// distance from q[b] to table[ids[b, j]] in the TPU kernel's norm-expansion
// form:
//   L2: max(|q|^2 + |x|^2 - 2 q.x, 0)
//   IP: 1 - q.x
// An id outside [0, N) reads nothing and yields NaN.
//
// What bounds it: bytes, B*K*D*4 of rows read from random places in the
// table (1024 x 40 rows of 512 B at d=128: 21 MB, ~6.3 us at 3.35 TB/s),
// and at that size a launch's fixed cost and the round trips to device
// memory (ids, then rows) are most of the time. So a query's rows must be
// read at once, and all of the launch's blocks must be resident at once.
//
// Two CUDA paths, one C entry:
//
// 1. D % 4 == 0 with 16-byte aligned q and table (every row a whole number
//    of 16-byte chunks; the port's f32 tables at d = 96, 128, 768): the
//    design of gather_dist_bf16.cu's path 1. One block of 4 warps per query,
//    a half-warp per row, 5 rows per half-warp: 40 rows of a query in
//    flight at once, in registers. A half-warp loads its 5 ids, then issues
//    the 16-byte loads of all 5 rows (one 4-value chunk per lane per row)
//    before any arithmetic, takes the query's matching chunk straight from
//    global memory (the L1 serves the block's other warps), accumulates q.x
//    and x.x in f32 and reduces with __shfl_xor_sync; past 40 rows (K > 40)
//    it goes again. |q|^2 is summed from the same query chunks on the first
//    pass only, once per query in each half-warp (not once per row). No
//    shared memory and no block barrier. The registers are capped at 64 so
//    that 8 blocks fit on an SM: the 1,024 queries of a rescore are one wave.
//
// 2. Any other width or alignment: the first design of this kernel, one
//    block of 8 warps per query, the query staged in shared memory and |q|^2
//    reduced once per query by warp 0, a warp per row with coalesced f32
//    loads, rows taken one after another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the 16 lanes of each half-warp (every lane gets its half's)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <bool kIP>
__device__ __forceinline__ float finish(float qq, float xx, float qx) {
  return kIP ? 1.f - qx : fmaxf(qq + xx - 2.f * qx, 0.f);
}

// ---- path 1: every row of a query in flight --------------------------------

constexpr int kRowWarps = 4;
constexpr int kRowThreads = kRowWarps * 32;
constexpr int kHalves = kRowThreads / 16;
constexpr int kRowsPerHalf = 5;  // rows in flight per half-warp: 40 per block

template <bool kIP>
__global__ void __launch_bounds__(kRowThreads, 8)
gather_dist_f32_rows_kernel(const float* __restrict__ q,      // [B, D]
                            const float* __restrict__ table,  // [N, D]
                            const int32_t* __restrict__ ids,  // [B, K]
                            float* __restrict__ out,          // [B, K]
                            int K, int D, long long N) {
  const int b = blockIdx.x;
  const int hw = threadIdx.x >> 4;  // half-warp of the block
  const int hl = threadIdx.x & 15;  // lane within the half-warp
  const int cpr = D >> 2;           // 16-byte chunks per row
  const int32_t* idb = ids + (size_t)b * K;
  const float4* q4 = reinterpret_cast<const float4*>(q + (size_t)b * D);
  const float4* t4 = reinterpret_cast<const float4*>(table);
  float qq = 0.f;  // |q|^2, summed on the first pass
  // base is block-uniform and i is unrolled, so every lane reaches the shuffles
  for (int base = 0; base < K; base += kHalves * kRowsPerHalf) {
    int row[kRowsPerHalf];  // -1: no row (past K, or an id outside [0, N))
#pragma unroll
    for (int i = 0; i < kRowsPerHalf; ++i) {
      const int r = base + hw + kHalves * i;
      row[i] = r < K ? __ldg(idb + r) : -1;
      if (row[i] >= N) row[i] = -1;
    }
    float qx[kRowsPerHalf], xx[kRowsPerHalf];
#pragma unroll
    for (int i = 0; i < kRowsPerHalf; ++i) qx[i] = xx[i] = 0.f;
    float qq_part = 0.f;
    for (int c = hl; c < cpr; c += 16) {
      float4 x[kRowsPerHalf];
#pragma unroll
      for (int i = 0; i < kRowsPerHalf; ++i)
        x[i] = row[i] >= 0 ? __ldg(t4 + (size_t)row[i] * cpr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 qc = __ldg(q4 + c);
      if (!kIP && base == 0) qq_part = dot4(qc, qc, qq_part);
#pragma unroll
      for (int i = 0; i < kRowsPerHalf; ++i) {
        qx[i] = dot4(x[i], qc, qx[i]);
        if (!kIP) xx[i] = dot4(x[i], x[i], xx[i]);
      }
    }
    if (!kIP && base == 0) qq = half_sum(qq_part);
#pragma unroll
    for (int i = 0; i < kRowsPerHalf; ++i) {
      qx[i] = half_sum(qx[i]);
      if (!kIP) xx[i] = half_sum(xx[i]);
      const int r = base + hw + kHalves * i;
      if (hl == 0 && r < K)
        out[(size_t)b * K + r] = row[i] >= 0 ? finish<kIP>(qq, xx[i], qx[i]) : nan_f32();
    }
  }
}

// ---- path 2: any width, a warp per row -------------------------------------

constexpr int kWarps = 8;

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
      if (lane == 0) *o = nan_f32();
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
    if (lane == 0) *o = finish<kIP>(q2, xx, qx);
  }
}

template <bool kIP>
int launch(const float* q, const float* t, const int32_t* ids, float* out, int B, int K, int D,
           long long N, cudaStream_t s) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(t);
  if (D % 4 == 0 && (addr & 15) == 0) {
    gather_dist_f32_rows_kernel<kIP><<<B, kRowThreads, 0, s>>>(q, t, ids, out, K, D, N);
  } else {
    gather_dist_f32_kernel<kIP><<<B, kWarps * 32, (size_t)D * sizeof(float), s>>>(q, t, ids,
                                                                                 out, K, D, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int gather_dist_f32(const void* q, const void* table, const void* ids, void* out,
                               int B, int K, int D, long long N, int ip, void* stream) {
  if (B <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const auto* qf = static_cast<const float*>(q);
  const auto* tf = static_cast<const float*>(table);
  const auto* id = static_cast<const int32_t*>(ids);
  auto* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ip ? launch<true>(qf, tf, id, of, B, K, D, N, s)
            : launch<false>(qf, tf, id, of, B, K, D, N, s);
}
