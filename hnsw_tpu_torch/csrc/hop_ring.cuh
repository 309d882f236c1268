// The node-block ring: the unified hop kernels of the bf16, int8 and int4
// tiers (hop_dist_unified.cu, hop_dist_quant.cu) and the split tier's hop
// (hop_dist_inline.cu: bf16 rows, the graph's level0 as the payload) for
// sm_90a.
//
// Replaces: hnsw_tpu/ops/pallas_gather.py, hop_dist_unified /
// _hop_dist_unified_kernel on bf16 rows, with int8=True and with int4=True
// (the nibble unpack :717-723, the dequant :724-735), and hop_dist_inline /
// _hop_dist_kernel with extract_level0_ids. For each query b and
// each of its E chosen nodes c = chosen[b, e] it reads the node's block of
// m0 neighbor rows and their m0 payload ids (and, for int8 and int4, the m0
// dequant scales) and writes, with x_i the bf16 value widened to f32 or
// float(code_i) * scale in f32:
//   L2: dists[b, e*m0 + j] = sum_i (x_i - q_i)^2
//   IP: dists[b, e*m0 + j] = 1 - sum_i x_i * q_i
// and ids[b, e*m0 + j] = payload[c, j]. With the l2u8 space's scale-1 codes
// and integer queries every term and partial sum is an exact integer below
// 2^24, so those distances are exact in any order of summation.
//
// What bounds it: bytes read from random places. One (query, chosen) pair
// reads one contiguous block, m0*d_pad*2 bytes of bf16 (8,192 at m0=32,
// d=128), m0*d_pad bytes of int8 or m0*d_pad/2 of int4, plus m0*4 bytes of
// ids (and m0*4 of scales); the arithmetic, 3 to 10 operations per byte, is
// below the compute roof. By Little's law the H100's 3.35 TB/s at ~1-1.5 us
// of loaded latency needs ~25-40 KB in flight on each of the 132 SMs; a warp
// per row with one 8-byte load per lane (the first design of these kernels)
// keeps ~2 KB in flight per block of threads.
//
// Design: a persistent grid of blocks, each a shared-memory ring of S stages.
// The unit of work is a piece: one (query, chosen) pair's block, or a run of
// whole rows of it when the block is larger than a stage. Pieces are
// numbered with e fastest and dealt to the blocks round-robin. The producer
// warp's lane l owns stage l: for each of its pieces it reads `chosen` one
// piece ahead, waits for the stage's "empty" mbarrier, arms the "full"
// mbarrier with the stage's byte count (expect_tx) and issues TMA 1-D bulk
// copies (cp.async.bulk) of the query row (f32), the block's ids (and
// scales) and its rows into the stage. The S lanes do so independently: one
// thread issuing every piece, each after a chain of dependent index
// arithmetic, held the small pieces of int8 to that thread's rate. The block is contiguous, so no tensor map is
// needed; a lone block is its own cluster. So S stages per block, several
// blocks per SM, are in flight with no registers spent on them. The consumer
// warps wait on "full", take two rows per half-warp at a time with one
// 16-byte (bf16, 8 values), 8-byte (int8, 8 codes) or 4-byte (int4, 8
// codes) ld.shared per lane per row and step, accumulate in f32, reduce
// with __shfl_xor_sync within the
// half, and the half's first lane writes the distances and copies the ids.
// Every consumer warp then arrives on "empty", a warp with no row in the
// piece too. A chosen id outside [0, R) issues no copy (a plain arrive on
// "full") and yields NaN and id -1. The grid is min(pieces, blocks that fit
// on the card), with all of the unified L1 that shared memory may take, so
// at a small launch (B=1024, E=1) every piece's copy is in flight in the
// first round. Copies need 16-byte sizes and addresses, so m0 % 4 == 0 (the
// port's tables pad m0 to a multiple of 16) and a piece is a number of rows
// whose bytes are a multiple of 16: even, or a multiple of 4 where an int4
// row is 4 or 12 bytes past a multiple of 16 (d_pad % 16 == 8, as d=104).
// An int4 stage is small (2,816 bytes at m0=32, d=128) and its ring holds 8
// of them: a ring of 16 took the same time, so the count of pieces in
// flight is not what holds int4 at int8's time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hop_ring {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kMinBlocks = 4;                        // per SM: <= 56 registers a thread
constexpr int kMaxStages = 8;
constexpr int kStageTarget = 32 * 1024;  // bytes of one stage, at most (but one piece)
constexpr int kRingTarget = 40 * 1024;   // bytes of one block's ring, about
constexpr int kHeaderBytes = 256;        // 2 * kMaxStages mbarriers + kMaxStages flags

enum Kind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// The layout of one launch: a piece is `rps` rows (the last piece of a block
// may be shorter); a stage holds [q | ids | scales | rows], each region a
// multiple of 16 bytes.
struct Shape {
  int B, E, m0, d_pad;
  int row_bytes;  // bytes of one neighbor row: 2*d_pad (bf16), d_pad (int8), d_pad/2 (int4)
  int rps;        // rows per piece: rps * row_bytes % 16 == 0
  int pieces;     // pieces per (query, chosen) pair
  int ids_off, sc_off, rows_off, stage_bytes, stages;
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

inline Shape make_shape(int B, int E, int m0, int d_pad, Kind kind) {
  Shape s{};
  s.B = B;
  s.E = E;
  s.m0 = m0;
  s.d_pad = d_pad;
  s.row_bytes = kind == kBf16 ? 2 * d_pad : (kind == kInt8 ? d_pad : d_pad / 2);
  const int unit = s.row_bytes % 8 ? 4 : 2;  // rows whose bytes are a multiple of 16
  const int ids = round16(m0 * 4);
  const int fixed = d_pad * 4 + ids * (kind == kBf16 ? 1 : 2);
  int fit = (kStageTarget - fixed) / s.row_bytes;
  if (fit < unit) fit = unit;
  const int pieces = (m0 + fit - 1) / fit;
  int rps = (m0 + pieces - 1) / pieces;
  rps = (rps + unit - 1) / unit * unit;
  s.rps = rps < m0 ? rps : m0;
  s.pieces = (m0 + s.rps - 1) / s.rps;
  s.ids_off = d_pad * 4;
  s.sc_off = s.ids_off + ids;
  s.rows_off = s.sc_off + (kind == kBf16 ? 0 : ids);
  s.stage_bytes = round16(s.rows_off + s.rps * s.row_bytes);
  int st = kRingTarget / s.stage_bytes;
  s.stages = st < 2 ? 2 : (st > kMaxStages ? kMaxStages : st);
  return s;
}

// ---- mbarrier and bulk-copy primitives (PTX) ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase with this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to this block's shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- arithmetic ------------------------------------------------------------

template <bool kIP>
__device__ __forceinline__ float accum(float acc, float x, float q) {
  if (kIP) return fmaf(x, q, acc);
  const float t = x - q;
  return fmaf(t, t, acc);
}

// acc += 8 neighbor values of a row against q[8c .. 8c+8). bf16: one 16-byte
// shared load of 8 values (a bf16 is the top half of its f32). int8: one
// 8-byte load of 8 codes; float(code) is taken without a conversion
// instruction (a quarter-rate one on this card): the code, biased by 128,
// goes into the low mantissa byte of 2^23 with one byte permute, and one
// exact subtraction of 2^23 + 128 leaves the integer. int4: one 4-byte load
// of 8 codes, code 8c+k in nibble k (pack_int4's order, two's complement);
// XOR with 0x88888888 biases every nibble by 8, two masks spread the even
// and the odd nibbles over the bytes of two words, and from there each code
// takes the int8 path's byte permute and one exact subtraction of 2^23 + 8.
// Then x = float(code) * scale, as the TPU kernel dequantizes.
template <Kind kKind, bool kIP>
__device__ __forceinline__ float accumulate8(const unsigned char* row, const float* q_s, int c,
                                             float scale, float acc) {
  const float4 q0 = reinterpret_cast<const float4*>(q_s)[2 * c];
  const float4 q1 = reinterpret_cast<const float4*>(q_s)[2 * c + 1];
  const float qs[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  float x[8];
  if (kKind == kBf16) {
    const uint4 raw = reinterpret_cast<const uint4*>(row)[c];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x[2 * t] = __uint_as_float(w[t] << 16);
      x[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    }
  } else if (kKind == kInt4) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[c] ^ 0x88888888u;  // code + 8
    const uint32_t nib[2] = {w & 0x0f0f0f0fu, (w >> 4) & 0x0f0f0f0fu};  // codes 8c+2j, 8c+2j+1
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // bytes of the result: (code + 8), 0, 0, 0x4B: the f32 2^23 + code + 8
      const uint32_t bits = __byte_perm(nib[k & 1], 0x4B000000u, 0x7540u | (k >> 1));
      x[k] = (__uint_as_float(bits) - 8388616.f) * scale;
    }
  } else {
    const uint2 raw = reinterpret_cast<const uint2*>(row)[c];
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};  // code + 128
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // bytes of the result: (code + 128), 0, 0, 0x4B: the f32 2^23 + code + 128
      const uint32_t bits = __byte_perm(w[k >> 2], 0x4B000000u, 0x7540u | (k & 3));
      x[k] = (__uint_as_float(bits) - 8388736.f) * scale;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = accum<kIP>(acc, x[k], qs[k]);
  return acc;
}

// ---- the kernel ------------------------------------------------------------

template <Kind kKind, bool kIP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hop_dist_ring_kernel(const float* __restrict__ q,            // [B, d_pad]
                     const unsigned char* __restrict__ rows,  // [R, m0, row_bytes]
                     const float* __restrict__ scales,        // [R, m0] (int8, int4) or null
                     const int32_t* __restrict__ payload,     // [R, m0]
                     const int32_t* __restrict__ chosen,      // [B, E]
                     float* __restrict__ out_d,               // [B, E*m0]
                     int32_t* __restrict__ out_ids,           // [B, E*m0]
                     const Shape sh, const long long R) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  volatile int* valid = reinterpret_cast<volatile int*>(empty + kMaxStages);
  unsigned char* ring = smem + kHeaderBytes;

  const int S = sh.stages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_pieces = sh.B * sh.E * sh.pieces;  // < 2^30: launch() checks
  const int step = gridDim.x;

  if (warp == kConsumerWarps) {
    // ---- producer ----
    // Lane l owns stage l and issues the block's pieces l, l + S, ... into
    // it, each lane on its own: nothing here needs the warp in step, and the
    // completion a lane waits for comes from the consumer warps.
    if (lane >= S) return;
    auto node_of = [&](int p) -> int {
      return p < n_pieces ? __ldg(chosen + (sh.pieces == 1 ? p : p / sh.pieces)) : -1;
    };
    unsigned char* st = ring + (size_t)lane * sh.stage_bytes;
    uint64_t* full_l = full + lane;
    uint32_t phase = 1;  // of the "empty" barrier: the ring starts empty
    int p = blockIdx.x + lane * step;
    int node = node_of(p);
    for (; p < n_pieces; p += S * step, phase ^= 1) {
      const int next = node_of(p + S * step);  // read one piece ahead
      mbar_wait(empty + lane, phase);
      const bool ok = node >= 0 && node < R;
      valid[lane] = ok;
      if (ok) {
        const int u = sh.pieces == 1 ? p : p / sh.pieces;
        const int row0 = (p - u * sh.pieces) * sh.rps;
        const int nrows = min(sh.rps, sh.m0 - row0);
        const int b = sh.E == 1 ? u : u / sh.E;
        const long long blk = (long long)node * sh.m0;
        const uint32_t ids = sh.m0 * 4;
        const uint32_t q_bytes = sh.d_pad * 4;
        const uint32_t row_bytes = (uint32_t)nrows * sh.row_bytes;
        mbar_arrive_expect_tx(full_l, q_bytes + ids * (kKind == kBf16 ? 1 : 2) + row_bytes);
        bulk_g2s(st, q + (size_t)b * sh.d_pad, q_bytes, full_l);
        bulk_g2s(st + sh.ids_off, payload + blk, ids, full_l);
        if (kKind != kBf16) bulk_g2s(st + sh.sc_off, scales + blk, ids, full_l);
        bulk_g2s(st + sh.rows_off, rows + (size_t)(blk + row0) * sh.row_bytes, row_bytes,
                 full_l);
      } else {
        mbar_arrive(full_l);
      }
      node = next;
    }
    return;
  }

  // ---- consumers ----
  const int half = lane >> 4;        // which row of the warp's pair
  const int hl = lane & 15;          // lane within the half-warp
  const int chunks = sh.d_pad >> 3;  // 8 values per lane per step
  const float nan = __int_as_float(0x7fc00000);
  int s = 0;           // stage of this piece
  uint32_t phase = 0;  // of the "full" barriers
  for (int p = blockIdx.x; p < n_pieces; p += step) {
    mbar_wait(full + s, phase);
    const int u = sh.pieces == 1 ? p : p / sh.pieces;
    const int row0 = (p - u * sh.pieces) * sh.rps;
    const int nrows = min(sh.rps, sh.m0 - row0);
    const bool ok = valid[s];
    const unsigned char* st = ring + (size_t)s * sh.stage_bytes;
    const float* q_s = reinterpret_cast<const float*>(st);
    const unsigned char* rows_s = st + sh.rows_off;
    const int32_t* ids_s = reinterpret_cast<const int32_t*>(st + sh.ids_off) + row0;
    const float* sc_s = reinterpret_cast<const float*>(st + sh.sc_off) + row0;
    float* od = out_d + (size_t)u * sh.m0 + row0;
    int32_t* oi = out_ids + (size_t)u * sh.m0 + row0;
    // two rows per half-warp per step, rows ra and rb, so that their loads
    // and shuffles overlap; r0 is warp-uniform, so every lane reaches the
    // shuffles
    for (int r0 = 2 * warp; r0 < nrows; r0 += 4 * kConsumerWarps) {
      const int ra = r0 + half, rb = ra + 2 * kConsumerWarps;
      const bool live_a = ra < nrows, live_b = rb < nrows;
      float acc_a = 0.f, acc_b = 0.f;
      if (ok) {
        const float sc_a = kKind != kBf16 && live_a ? sc_s[ra] : 1.f;
        const float sc_b = kKind != kBf16 && live_b ? sc_s[rb] : 1.f;
        for (int c = hl; c < chunks; c += 16) {
          if (live_a)
            acc_a = accumulate8<kKind, kIP>(rows_s + (size_t)ra * sh.row_bytes, q_s, c, sc_a,
                                            acc_a);
          if (live_b)
            acc_b = accumulate8<kKind, kIP>(rows_s + (size_t)rb * sh.row_bytes, q_s, c, sc_b,
                                            acc_b);
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {  // stays within each half-warp
        acc_a += __shfl_xor_sync(0xffffffffu, acc_a, o);
        acc_b += __shfl_xor_sync(0xffffffffu, acc_b, o);
      }
      if (hl == 0) {
        if (live_a) {
          od[ra] = ok ? (kIP ? 1.f - acc_a : acc_a) : nan;
          oi[ra] = ok ? ids_s[ra] : -1;
        }
        if (live_b) {
          od[rb] = ok ? (kIP ? 1.f - acc_b : acc_b) : nan;
          oi[rb] = ok ? ids_s[rb] : -1;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() (or the error of a failed
// query of the device). `scales` is null for bf16.
template <Kind kKind>
int launch(const void* q, const void* rows, const void* scales, const void* payload,
           const void* chosen, void* out_d, void* out_ids, int B, int E, int m0, int d_pad,
           long long R, int ip, void* stream) {
  if (B <= 0 || E <= 0 || m0 <= 0) return static_cast<int>(cudaGetLastError());
  const Shape sh = make_shape(B, E, m0, d_pad, kKind);
  const size_t smem = kHeaderBytes + (size_t)sh.stages * sh.stage_bytes;
  // piece numbers, and those a block reads ahead, stay in an int
  if ((long long)B * E * sh.pieces >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ip ? hop_dist_ring_kernel<kKind, true> : hop_dist_ring_kernel<kKind, false>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // all of the SM's unified L1 that shared memory may take: several rings
  // per SM (the default carveout can leave room for one)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every piece's copy in flight in the first round when the pieces are
  // few (a block per piece), else as many blocks as the card holds
  const int n_pieces = B * E * sh.pieces;
  const int cap = (per_sm > 0 ? per_sm : 1) * sms;
  const int grid = n_pieces < cap ? n_pieces : cap;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(rows),
      static_cast<const float*>(scales), static_cast<const int32_t*>(payload),
      static_cast<const int32_t*>(chosen), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_ids), sh, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop_ring
