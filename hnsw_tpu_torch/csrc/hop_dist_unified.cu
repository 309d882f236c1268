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
// arithmetic (3 flops per byte read) is far below the compute roof. With
// random block reads the bytes in flight per SM set the rate.
//
// Design: the node-block ring of hop_ring.cuh. Whole blocks are copied by
// TMA bulk copies into a shared-memory ring of several stages per block of
// threads, with several such blocks per SM, so tens of KB are in flight on
// each SM; consumer warps take a row per half-warp from shared memory with
// 16-byte loads. A chosen id outside [0, R) reads nothing and yields NaN and
// id -1; the traversal never passes one (the sentinel n_pad-1 is a real
// dummy row).

#include "hop_ring.cuh"

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int hop_dist_unified_bf16(const void* q, const void* vecs, const void* payload,
                                     const void* chosen, void* out_d, void* out_ids, int B,
                                     int E, int m0, int d_pad, long long R, int ip,
                                     void* stream) {
  return hop_ring::launch<hop_ring::kBf16>(q, vecs, nullptr, payload, chosen, out_d, out_ids, B,
                                           E, m0, d_pad, R, ip, stream);
}
