// hnsw_tpu native vector store.
//
// Role of the reference's RocksDBStore (storage_service/rocksdb_store.{h,cpp}:
// put_vector / get_vector / batch_get_vectors over RocksDB). RocksDB is not
// available in this image, and an LSM tree is overkill for fixed-size vector
// records; this is a purpose-built append-only log with an in-memory id ->
// offset index, crash-safe via record framing, supporting the same API plus
// bulk export (the reference fetches vectors one HTTP GET at a time,
// bin/experiment.py:68-111 — the dominant inefficiency; batch/bulk paths
// here feed whole device arrays).
//
// On-disk format: sequence of records
//   [u32 magic=0x48565631][u32 id][u32 dim][dim x f32]
// Later puts of the same id supersede earlier ones (last wins on load).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x48565631;  // "HVV1"

struct VecStore {
  std::string path;
  FILE* f = nullptr;                      // append handle
  std::unordered_map<uint32_t, uint64_t> index;  // id -> payload offset
  std::unordered_map<uint32_t, uint32_t> dims;   // id -> dim
  uint64_t end_offset = 0;
  std::mutex mu;

  ~VecStore() {
    if (f) fclose(f);
  }
};

bool load_index(VecStore* vs) {
  FILE* rf = fopen(vs->path.c_str(), "rb");
  if (!rf) return true;  // new file
  uint64_t off = 0;
  while (true) {
    uint32_t hdr[3];
    if (fread(hdr, sizeof(uint32_t), 3, rf) != 3) break;
    if (hdr[0] != kMagic) break;  // torn tail; stop
    uint32_t id = hdr[1], dim = hdr[2];
    uint64_t payload = off + 3 * sizeof(uint32_t);
    if (fseek(rf, long(size_t(dim) * 4), SEEK_CUR) != 0) break;
    vs->index[id] = payload;
    vs->dims[id] = dim;
    off = payload + size_t(dim) * 4;
  }
  vs->end_offset = off;
  fclose(rf);
  return true;
}

}  // namespace

extern "C" {

VecStore* vs_open(const char* path) {
  auto* vs = new VecStore();
  vs->path = path;
  if (!load_index(vs)) {
    delete vs;
    return nullptr;
  }
  // truncate any torn tail, then reopen for append
  FILE* tf = fopen(path, "ab");
  if (!tf) {
    delete vs;
    return nullptr;
  }
  fclose(tf);
  vs->f = fopen(path, "rb+");
  if (!vs->f) {
    delete vs;
    return nullptr;
  }
  fseek(vs->f, long(vs->end_offset), SEEK_SET);
  return vs;
}

void vs_close(VecStore* vs) { delete vs; }

int vs_put(VecStore* vs, uint32_t id, uint32_t dim, const float* data) {
  std::lock_guard<std::mutex> g(vs->mu);
  uint32_t hdr[3] = {kMagic, id, dim};
  fseek(vs->f, long(vs->end_offset), SEEK_SET);
  if (fwrite(hdr, sizeof(uint32_t), 3, vs->f) != 3) return -1;
  if (fwrite(data, sizeof(float), dim, vs->f) != dim) return -1;
  uint64_t payload = vs->end_offset + 3 * sizeof(uint32_t);
  vs->index[id] = payload;
  vs->dims[id] = dim;
  vs->end_offset = payload + size_t(dim) * 4;
  return 0;
}

int vs_flush(VecStore* vs) {
  std::lock_guard<std::mutex> g(vs->mu);
  return fflush(vs->f) == 0 ? 0 : -1;
}

// Returns dim, or -1 if missing / buffer too small.
int64_t vs_get(VecStore* vs, uint32_t id, float* out, int64_t capacity) {
  std::lock_guard<std::mutex> g(vs->mu);
  auto it = vs->index.find(id);
  if (it == vs->index.end()) return -1;
  uint32_t dim = vs->dims[id];
  if (int64_t(dim) > capacity) return -1;
  fseek(vs->f, long(it->second), SEEK_SET);
  if (fread(out, sizeof(float), dim, vs->f) != dim) return -1;
  fseek(vs->f, long(vs->end_offset), SEEK_SET);
  return int64_t(dim);
}

// Batch get into a dense [count, dim] buffer; found[i]=1 on hit.
int vs_batch_get(VecStore* vs, const uint32_t* ids, int64_t count, uint32_t dim,
                 float* out, uint8_t* found) {
  std::lock_guard<std::mutex> g(vs->mu);
  for (int64_t i = 0; i < count; ++i) {
    auto it = vs->index.find(ids[i]);
    if (it == vs->index.end() || vs->dims[ids[i]] != dim) {
      found[i] = 0;
      std::memset(out + i * dim, 0, sizeof(float) * dim);
      continue;
    }
    fseek(vs->f, long(it->second), SEEK_SET);
    found[i] = fread(out + i * dim, sizeof(float), dim, vs->f) == dim ? 1 : 0;
  }
  fseek(vs->f, long(vs->end_offset), SEEK_SET);
  return 0;
}

int64_t vs_count(VecStore* vs) {
  std::lock_guard<std::mutex> g(vs->mu);
  return int64_t(vs->index.size());
}

// Export all ids (caller allocates vs_count() u32s).
void vs_ids(VecStore* vs, uint32_t* out) {
  std::lock_guard<std::mutex> g(vs->mu);
  int64_t i = 0;
  for (auto& kv : vs->index) out[i++] = kv.first;
}

}  // extern "C"
