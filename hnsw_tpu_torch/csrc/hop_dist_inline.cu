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
// level0[c, j]. A chosen id outside [0, N_pad) reads nothing and yields NaN
// and id -1.
//
// The TPU kernel copies a 4 KB tile of 32 nodes' ids per expansion, because
// Mosaic's DMA wants (8, 128) tiles, and XLA then picks the node's m0 ids out
// of the tile with one-hot reduces. None of that is carried over: the m0 ids
// are read straight from level0, so the split tier holds one table and no
// second copy of the adjacency, and a row delta written to level0 is at once
// what this kernel returns.
//
// What bounds it: bytes. Each (query, chosen) pair reads one contiguous
// m0*d_pad*2-byte block plus m0*4 bytes of ids from a random place. A bulk
// build wave at B=16384, E=2, m0=32, d=128 reads 16384*2*(32*128*2 + 32*4) B =
// 272 MB per beam iteration as read, ~81 us at the H100's 3.35 TB/s; 3 flops
// per byte read is far below the compute roof. But a wave's launches name
// far fewer distinct blocks than pairs (a median of 29-57% in the 100k
// build's waves: new points share entry regions, and every query whose beam
// has ended picks the sentinel row n_pad - 1), so the bytes that must come
// from device memory are a third to a half of those read (bound B, 3.0 ms of
// the wave below).
//
// Design: these are the same bytes, in the same layout, that the unified
// bf16 hop reads (a block of bf16 rows and a row of m0 int32 ids per node),
// so this entry launches the node-block ring of hop_ring.cuh with level0 as
// the payload: TMA bulk copies of whole blocks into a shared-memory ring, a
// producer lane per stage, a persistent grid. Its distances and ids equal
// the unified bf16 hop's bit for bit on the same tensors. The ring needs
// m0 % 4 == 0 and 16-byte aligned tensors and query rows (the wrapper
// checks them). On an H100 (700 W), over the 112 launches of one
// 16,384-node wave of a 100k build replayed cold, this entry took 9.479 ms
// against the first design's 11.604 (a block of 256 threads per query, 8 KB
// in flight through registers), in turns (chip_kernel_ab.py). An earlier
// ring that dealt the pairs sorted by chosen node, so that the reads of one
// block are in flight together, took 16.2 ms there against 10.1 for the
// ring it was built on: the sort costs ~55 us a launch, and without it the
// kernel gained ~2%.

#include "hop_ring.cuh"

// C entry, bound with ctypes. Pointers are device pointers; `stream` is the
// caller's cudaStream_t. Returns cudaGetLastError() after the launch.
extern "C" int hop_dist_inline(const void* q, const void* nbr_vectors, const void* level0,
                               const void* chosen, void* out_d, void* out_ids, int B, int E,
                               int m0, int d_pad, long long R, int ip, void* stream) {
  return hop_ring::launch<hop_ring::kBf16>(q, nbr_vectors, nullptr, level0, chosen, out_d,
                                           out_ids, B, E, m0, d_pad, R, ip, stream);
}
