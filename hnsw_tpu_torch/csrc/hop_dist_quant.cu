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
// H100 SXM's 3.35 TB/s. The arithmetic (4 to 5 operations per code) is below
// the compute roof.
//
// Design: the node-block ring of hop_ring.cuh for both (TMA bulk copies of
// whole blocks, codes, scales and ids, into a shared-memory ring; a
// half-warp per row reads 8 codes per lane per step from shared memory and
// decodes them by byte permutes, with no conversion instruction). A chosen
// id outside [0, R) reads nothing and yields NaN and id -1; the traversal
// never passes one.

#include "hop_ring.cuh"

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
  return hop_ring::launch<hop_ring::kInt4>(q, codes, scales, payload, chosen, out_d, out_ids, B,
                                           E, m0, d_pad, R, ip, stream);
}
