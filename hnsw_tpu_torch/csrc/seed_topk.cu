// The landmark seeds: exact top-s over the landmark rows, for sm_90a.
//
// Replaces no Pallas kernel. The JAX package's seeded entry
// (hnsw_tpu/models/hnsw.py, HNSWIndex.search with entry_seeds > 0, and the
// bulk build's waves with wave_entry_seeds > 0) calls
// hnsw_tpu/ops/topk.py bruteforce_topk over the landmark set, which XLA runs
// as a chunked matmul and top_k. For each query b this returns the s
// smallest of
//   L2: max(|q|^2 + |x|^2 - 2 q.x, 0)   (|x|^2 given, |q|^2 summed here)
//   IP: 1 - q.x
// over the NL landmark rows, ascending, equal distances to the lower
// position (the order lax.top_k gives), with their positions.
//
// What bounds it: f32 operations. At B = 8192 queries, NL = 62,500
// landmarks and D = 128 the products are 2*B*NL*D = 131 GFLOP, 1.96 ms at
// the H100's 67 TFLOP/s outside the tensor cores (TF32 and bf16 are below
// the f32 the seeds state). The inputs, 4 MB of queries and 32 MB of
// landmarks, sit in the 50 MB L2. The matmul path wrote the [B, NL]
// distances (2 GB at that size) to device memory and read them back in four
// or five passes; here no [B, NL] value is stored.
//
// Design: an f32 GEMM whose epilogue keeps a running top-s per query.
//  * A block of 256 threads owns 128 queries and walks one slice of the
//    landmarks in tiles of 128 rows. Query and landmark rows are staged
//    through shared memory in chunks of 8 along D, transposed (k-major), by
//    4-byte cp.async copies that spend no registers (two buffers: the next
//    chunk is in flight while the current one is multiplied), so any D is
//    taken and ragged edges read 0. The tile's |x|^2 rides with its first
//    chunk.
//  * Each thread accumulates an 8 x 8 micro-tile of dot products in
//    registers with FFMA (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
//    likewise), read as float4s from the staged chunks.
//  * After a tile's last chunk the dots go to a 128 x 128 tile in shared
//    memory. Each warp then tests its 16 query rows, with no branch between
//    rows so that their loads overlap: a lane forms the distances of 4
//    landmarks and tests them against the row's current s-th best (held in
//    shared memory; equal distances by position). In the few rows where one
//    passes, the warp holds the row's sorted list one entry per lane and
//    inserts each passing candidate with a ballot and a shuffle. After the
//    first tiles almost no candidate passes.
//  * The grid is the query tiles times a few landmark slices, as many as
//    fill every SM's resident blocks in one wave. Each slice writes its
//    [B, s] list to a [B, slices, s] partial; a second launch, a warp per
//    query, merges the slices into [B, s]. With one slice the first launch
//    writes the result itself.
// s is at most 32: the list of a row is held by one warp's lanes.
// Where PyTorch's float32 matmul setting allows TF32, as it would for the
// matmul path, the wrapper (ops/topk.py seed_topk) rounds the inputs to
// TF32 before the launch; the kernel itself always multiplies in f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // queries per block
constexpr int kBN = 128;      // landmarks per tile
constexpr int kBK = 8;        // D per staged chunk
constexpr int kThreads = 256;
constexpr int kPad = kBN + 4;  // row stride of the staged chunks and the dot tile
constexpr int kMaxS = 32;
constexpr int kRowsPerWarp = kBM / (kThreads / 32);
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBM == kBN && kBM == 128, "the thread layout below assumes 128 x 128 tiles");

// (d, i) strictly before (e, j): by distance, then by position
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Insert (cd, ci) into the sorted list held one entry per lane in lanes < s
// (`smask` has those lanes' bits); the last entry drops out. A candidate that
// is not before the last entry changes nothing. Every lane of the warp calls
// it with the same candidate.
__device__ __forceinline__ void warp_insert(float& ed, int& ei, float cd, int ci, int s,
                                            unsigned smask, int lane) {
  const int p = __popc(__ballot_sync(kFull, before(ed, ei, cd, ci)) & smask);
  const float ud = __shfl_up_sync(kFull, ed, 1);
  const int ui = __shfl_up_sync(kFull, ei, 1);
  if (p < s) {
    if (lane == p) {
      ed = cd;
      ei = ci;
    } else if (lane > p) {
      ed = ud;
      ei = ui;
    }
  }
}

// a 4-byte copy from device memory into shared memory that does not pass
// through registers; `ok` false fills the word with 0 and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the one formula of a distance, in the row test and the insertion alike
template <bool kIP>
__device__ __forceinline__ float dist_of(float qq, float xx, float dot) {
  return kIP ? 1.f - dot : fmaxf(qq + xx - 2.f * dot, 0.f);
}

__host__ __device__ constexpr size_t smem_bytes(int s) {
  // staged chunks (2 buffers each of queries and landmarks), the dot tile,
  // |x|^2 of two tiles, |q|^2 of the block's queries, and the rows' lists
  // (distance, position)
  return sizeof(float) * (4 * kBK * kPad + kBM * kPad + 2 * kBN + kBM) + (size_t)kBM * s * 8;
}

template <bool kIP>
__global__ void __launch_bounds__(kThreads, 2)
seed_topk_kernel(const float* __restrict__ q,    // [B, D]
                 const float* __restrict__ x,    // [NL, D]
                 const float* __restrict__ xsq,  // [NL] (L2 only)
                 float* __restrict__ out_d,      // [B, slices, s]
                 int* __restrict__ out_i32,      // [B, slices, s], or null
                 long long* __restrict__ out_i64,  // [B, s] when slices == 1
                 int B, int NL, int D, int s, int tiles_per_slice) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [2][kBK][kPad] queries
  float* Bs = As + 2 * kBK * kPad;              // [2][kBK][kPad] landmarks
  float* dots = Bs + 2 * kBK * kPad;            // [kBM][kPad]
  float* xx_s = dots + kBM * kPad;              // [2][kBN] by tile parity
  float* qq_s = xx_s + 2 * kBN;                 // [kBM]
  float* ld = qq_s + kBM;                       // [kBM][s]
  int* li = reinterpret_cast<int*>(ld + kBM * s);  // [kBM][s]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBM;
  const int slices = gridDim.y, slice = blockIdx.y;
  const int n_tiles = (NL + kBN - 1) / kBN;
  const int t_begin = min(slice * tiles_per_slice, n_tiles);
  const int t_end = min(t_begin + tiles_per_slice, n_tiles);
  const int kc = (D + kBK - 1) / kBK;
  const unsigned smask = s == 32 ? kFull : ((1u << s) - 1u);

  for (int e = tid; e < kBM * s; e += kThreads) {
    ld[e] = INFINITY;
    li[e] = kSentinel;
  }
  if (!kIP) {  // |q|^2: two threads a row, joined by a shuffle
    const int r = tid >> 1;
    float acc = 0.f;
    if (q0 + r < B) {
      const float* qr = q + (size_t)(q0 + r) * D;
      for (int k = tid & 1; k < D; k += 2) acc = fmaf(qr[k], qr[k], acc);
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    if ((tid & 1) == 0) qq_s[r] = acc;
  }

  // the loader: element tid + 256 j of a chunk is row (tid >> 3) + 32 j,
  // column tid & 7 (a warp reads 4 rows x 32 bytes; the transposed stores
  // fall in 32 distinct banks)
  const int lrow = tid >> 3, lk = tid & 7;
  int l_tile = t_begin, l_k0 = 0;  // the next chunk to load
  auto load = [&](int buf) {
    const int k = l_k0 + lk;
    const int x0 = l_tile * kBN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qr = q0 + lrow + 32 * j;
      const bool qok = qr < B && k < D;
      cp_async4(As + (buf * kBK + lk) * kPad + lrow + 32 * j, qok ? q + (size_t)qr * D + k : q,
                qok);
      const int xr = x0 + lrow + 32 * j;
      const bool xok = xr < NL && k < D;
      cp_async4(Bs + (buf * kBK + lk) * kPad + lrow + 32 * j, xok ? x + (size_t)xr * D + k : x,
                xok);
    }
    if (!kIP && l_k0 == 0 && tid < kBN) {
      const int xr = x0 + tid;
      cp_async4(xx_s + (l_tile & 1) * kBN + tid, xr < NL ? xsq + xr : xsq, xr < NL);
    }
    cp_async_commit();
    l_k0 += kBK;
    if (l_k0 >= kc * kBK) {
      l_k0 = 0;
      ++l_tile;
    }
  };

  // the micro-tile: 4 warps down, 2 across, each warp 4 x 8 threads
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int total = (t_end - t_begin) * kc;
  if (total > 0) load(0);
  cp_async_wait_all();
  __syncthreads();

  int c_tile = t_begin, c_k = 0;  // the chunk being multiplied
  for (int g = 0; g < total; ++g) {
    const int buf = g & 1;
    const bool more = g + 1 < total;
    if (more) load(buf ^ 1);
    const float* a = As + buf * kBK * kPad;
    const float* b = Bs + buf * kBK * kPad;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kPad + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kPad + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kPad + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kPad + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    cp_async_wait_all();
    __syncthreads();
    if (++c_k < kc) continue;

    // the epilogue of tile c_tile: dots to shared memory, then the scan.
    // (The next write of `dots` comes after at least one more barrier of
    // the loop, so no warp is still scanning then.)
    c_k = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
      *reinterpret_cast<float4*>(dots + r * kPad + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dots + r * kPad + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();

    const int x0 = c_tile * kBN;
    const float* xt = xx_s + (c_tile & 1) * kBN;
    ++c_tile;
    int pos[4];
    float xx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pos[j] = x0 + lane + 32 * j;
      xx[j] = kIP ? 0.f : xt[lane + 32 * j];
    }
    const int r0 = warp * kRowsPerWarp;
    unsigned rows = 0;  // the warp's rows that hold a candidate
#pragma unroll 4
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = r0 + rr;
      const float td = ld[r * s + s - 1];
      const int ti = li[r * s + s - 1];
      const float qqr = kIP ? 0.f : qq_s[r];
      bool any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = dist_of<kIP>(qqr, xx[j], dots[r * kPad + lane + 32 * j]);
        any |= pos[j] < NL && before(d, pos[j], td, ti);
      }
      rows |= (__any_sync(kFull, any) && q0 + r < B ? 1u : 0u) << rr;
    }
    while (rows) {  // warp-uniform
      const int r = r0 + __ffs(rows) - 1;
      rows &= rows - 1;
      float* lr_d = ld + r * s;
      int* lr_i = li + r * s;
      const float qqr = kIP ? 0.f : qq_s[r];
      float ed = lane < s ? lr_d[lane] : INFINITY;
      int ei = lane < s ? lr_i[lane] : kSentinel;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // tested against the list as it stands: in a row's first tile the
        // first 32 candidates fill it, and few of the next 96 pass
        const float dist = dist_of<kIP>(qqr, xx[j], dots[r * kPad + lane + 32 * j]);
        const float td = __shfl_sync(kFull, ed, s - 1);
        const int ti = __shfl_sync(kFull, ei, s - 1);
        unsigned m = __ballot_sync(kFull, pos[j] < NL && before(dist, pos[j], td, ti));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float cd = __shfl_sync(kFull, dist, src);
          warp_insert(ed, ei, cd, x0 + src + 32 * j, s, smask, lane);
        }
      }
      if (lane < s) {
        lr_d[lane] = ed;
        lr_i[lane] = ei;
      }
    }
    // with one chunk a tile (D <= 8) the loop's next load writes the |x|^2
    // buffer this scan reads: every warp finishes the scan first
    if (kc == 1) __syncthreads();
  }

  // each warp writes the lists of its own rows (only it has touched them)
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int bq = q0 + r;
    if (bq >= B) break;
    if (lane < s) {
      const size_t o = ((size_t)bq * slices + slice) * s + lane;
      out_d[o] = ld[r * s + lane];
      if (out_i64 != nullptr) {
        out_i64[o] = li[r * s + lane];
      } else {
        out_i32[o] = li[r * s + lane];
      }
    }
  }
}

// [B, slices, s] sorted lists -> [B, s], a warp per query
__global__ void seed_merge_kernel(const float* __restrict__ part_d,
                                  const int* __restrict__ part_i, float* __restrict__ out_d,
                                  long long* __restrict__ out_i, int B, int slices, int s) {
  const int lane = threadIdx.x & 31;
  const int bq = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (bq >= B) return;  // warp-uniform
  const unsigned smask = s == 32 ? kFull : ((1u << s) - 1u);
  const int n = slices * s;
  const float* rd = part_d + (size_t)bq * n;
  const int* ri = part_i + (size_t)bq * n;
  float ed = INFINITY;
  int ei = kSentinel;
  for (int base = 0; base < n; base += 32) {
    const int c = base + lane;
    const float cd = c < n ? rd[c] : INFINITY;
    const int ci = c < n ? ri[c] : kSentinel;
    const float td = __shfl_sync(kFull, ed, s - 1);
    const int ti = __shfl_sync(kFull, ei, s - 1);
    unsigned m = __ballot_sync(kFull, before(cd, ci, td, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      warp_insert(ed, ei, __shfl_sync(kFull, cd, src), __shfl_sync(kFull, ci, src), s, smask,
                  lane);
    }
  }
  if (lane < s) {
    out_d[(size_t)bq * s + lane] = ed;
    out_i[(size_t)bq * s + lane] = ei;
  }
}

template <bool kIP>
cudaError_t allow_smem(int s) {
  return cudaFuncSetAttribute(seed_topk_kernel<kIP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(s)));
}

template <bool kIP>
int launch(const float* q, const float* x, const float* xsq, float* out_d, long long* out_i,
           float* part_d, int* part_i, int B, int NL, int D, int s, int slices,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<kIP>(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (NL + kBN - 1) / kBN;
  const int tiles_per_slice = (n_tiles + slices - 1) / slices;
  const dim3 grid((B + kBM - 1) / kBM, slices);
  const size_t smem = smem_bytes(s);
  if (slices == 1) {
    seed_topk_kernel<kIP><<<grid, kThreads, smem, stream>>>(q, x, xsq, out_d, nullptr, out_i, B,
                                                            NL, D, s, tiles_per_slice);
    return static_cast<int>(cudaGetLastError());
  }
  seed_topk_kernel<kIP><<<grid, kThreads, smem, stream>>>(q, x, xsq, part_d, part_i, nullptr, B,
                                                          NL, D, s, tiles_per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kMergeWarps = 8;
  seed_merge_kernel<<<(B + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, stream>>>(
      part_d, part_i, out_d, out_i, B, slices, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of landmark slices for a launch of B queries over NL landmarks
// at this s: as many as fill every SM's resident blocks once (at least 1,
// at most one a tile). The caller sizes the partials from it. Returns a
// negative CUDA error code on failure.
extern "C" int seed_topk_slices(int B, int NL, int s) {
  if (B <= 0 || NL <= 0 || s < 1 || s > kMaxS) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem<false>(s);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seed_topk_kernel<false>,
                                                        kThreads, smem_bytes(s));
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int q_tiles = (B + kBM - 1) / kBM;
  const int n_tiles = (NL + kBN - 1) / kBN;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int slices = slots / q_tiles;
  return slices < 1 ? 1 : (slices > n_tiles ? n_tiles : slices);
}

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. out_d [B, s] f32, out_i [B, s] int64; part_d and
// part_i [B, slices, s] (f32, int32), unused when slices == 1. Returns
// cudaGetLastError() after the launches, or -1 for arguments it does not
// take.
extern "C" int seed_topk(const void* q, const void* x, const void* xsq, void* out_d,
                         void* out_i, void* part_d, void* part_i, int B, int NL, int D, int s,
                         int slices, int ip, void* stream) {
  if (B <= 0 || NL <= 0 || D <= 0 || s < 1 || s > kMaxS || s > NL || slices < 1) return -1;
  if (!ip && xsq == nullptr) return -1;
  if (slices > 1 && (part_d == nullptr || part_i == nullptr)) return -1;
  const auto* qf = static_cast<const float*>(q);
  const auto* xf = static_cast<const float*>(x);
  const auto* sf = static_cast<const float*>(xsq);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<long long*>(out_i);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ip ? launch<true>(qf, xf, sf, od, oi, pd, pi, B, NL, D, s, slices, st)
            : launch<false>(qf, xf, sf, od, oi, pd, pi, B, NL, D, s, slices, st);
}
