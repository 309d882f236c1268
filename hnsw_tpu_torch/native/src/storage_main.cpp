// Native storage service binary: HTTP vector store over the log-structured
// native store (reference parity: storage_service/main.cpp:13-75, a C++
// executable over RocksDB — SURVEY.md marks C9 "native").
//
// Endpoints and wire formats identical to the Python frontend
// (hnsw_tpu/service/storage_service.py), so the experiment harness and the
// query services work against either:
//   POST /vec/put        [u32 id][u32 dim][dim x f32]   -> "OK"/"ERR"
//   GET  /vec/get?id=N   -> {"id": N, "values": [...]}  (404 if missing)
//   POST /vec/batch_get  JSON [id, ...] -> [[floats]|null, ...]
//   POST /vec/put_batch  [u32 count][u32 dim] + count x (u32 id + dim f32)
//   GET  /vec/bulk?dim=D -> [u32 count][u32 dim] + count x (u32 id + dim f32)
//   GET  /mem            -> {"rss_kb": N}
//   GET  /info           -> {"count": N}
//
// Build: g++ -O3 -march=native -std=c++20 -o storage_service storage_main.cpp
// Usage: storage_service [dbpath] [port]

#include "vecstore.cpp"

#include "httpkit.h"

#include <cstdlib>

using httpkit::Request;
using httpkit::Response;

int main(int argc, char** argv) {
  const char* dbpath = argc > 1 ? argv[1] : "./vec_store.log";
  int port = argc > 2 ? atoi(argv[2]) : 8081;

  VecStore* vs = vs_open(dbpath);
  if (!vs) {
    fprintf(stderr, "cannot open store %s\n", dbpath);
    return 1;
  }

  httpkit::Server srv;

  srv.route("POST", "/vec/put", [vs](const Request& req, Response& resp) {
    resp.content_type = "text/plain";
    if (req.body.size() < 8) {
      resp.status = 400;
      resp.body = "short body";
      return;
    }
    uint32_t id, dim;
    memcpy(&id, req.body.data(), 4);
    memcpy(&dim, req.body.data() + 4, 4);
    if (req.body.size() != 8 + size_t(dim) * 4) {
      resp.status = 400;
      resp.body = "bad length";
      return;
    }
    int rc = vs_put(vs, id, dim, (const float*)(req.body.data() + 8));
    vs_flush(vs);
    resp.body = rc == 0 ? "OK" : "ERR";
  });

  srv.route("POST", "/vec/put_batch", [vs](const Request& req, Response& resp) {
    resp.content_type = "text/plain";
    if (req.body.size() < 8) {
      resp.status = 400;
      resp.body = "short body";
      return;
    }
    uint32_t count, dim;
    memcpy(&count, req.body.data(), 4);
    memcpy(&dim, req.body.data() + 4, 4);
    size_t rec = 4 + size_t(dim) * 4;
    if (req.body.size() != 8 + size_t(count) * rec) {
      resp.status = 400;
      resp.body = "bad length";
      return;
    }
    for (uint32_t i = 0; i < count; ++i) {
      const char* p = req.body.data() + 8 + size_t(i) * rec;
      uint32_t id;
      memcpy(&id, p, 4);
      vs_put(vs, id, dim, (const float*)(p + 4));
    }
    vs_flush(vs);
    resp.body = "OK";
  });

  srv.route("GET", "/vec/get", [vs](const Request& req, Response& resp) {
    long id = req.query_long("id", -1);
    if (id < 0) {
      resp.status = 400;
      resp.content_type = "text/plain";
      resp.body = "bad id";
      return;
    }
    std::vector<float> buf(1u << 16);
    int64_t dim = vs_get(vs, uint32_t(id), buf.data(), int64_t(buf.size()));
    if (dim < 0) {
      resp.status = 404;
      resp.content_type = "text/plain";
      resp.body = "not found";
      return;
    }
    std::string out = "{\"id\": " + std::to_string(id) + ", \"values\": [";
    char num[32];
    for (int64_t i = 0; i < dim; ++i) {
      snprintf(num, sizeof(num), i ? ",%.9g" : "%.9g", double(buf[size_t(i)]));
      out += num;
    }
    out += "]}";
    resp.body = std::move(out);
  });

  srv.route("POST", "/vec/batch_get", [vs](const Request& req, Response& resp) {
    // body: JSON [id, ...]
    std::vector<float> idsf;
    if (!httpkit::json_parse_floats(req.body.c_str(), &idsf)) {
      resp.status = 400;
      resp.content_type = "text/plain";
      resp.body = "bad json";
      return;
    }
    std::string out = "[";
    std::vector<float> buf(1u << 16);
    char num[32];
    for (size_t i = 0; i < idsf.size(); ++i) {
      if (i) out += ",";
      int64_t dim =
          vs_get(vs, uint32_t(idsf[i]), buf.data(), int64_t(buf.size()));
      if (dim < 0) {
        out += "null";
        continue;
      }
      out += "[";
      for (int64_t j = 0; j < dim; ++j) {
        snprintf(num, sizeof(num), j ? ",%.9g" : "%.9g", double(buf[size_t(j)]));
        out += num;
      }
      out += "]";
    }
    out += "]";
    resp.body = std::move(out);
  });

  srv.route("GET", "/vec/bulk", [vs](const Request& req, Response& resp) {
    long dim = req.query_long("dim", -1);
    if (dim <= 0) {
      resp.status = 400;
      resp.content_type = "text/plain";
      resp.body = "bad dim";
      return;
    }
    int64_t n = vs_count(vs);
    std::vector<uint32_t> ids(static_cast<size_t>(n));
    vs_ids(vs, ids.data());
    size_t rec = 4 + size_t(dim) * 4;
    std::string out;
    out.resize(8 + size_t(n) * rec);
    std::vector<float> buf(static_cast<size_t>(dim));
    size_t kept = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (vs_get(vs, ids[size_t(i)], buf.data(), dim) != dim) continue;
      char* p = out.data() + 8 + kept * rec;
      memcpy(p, &ids[size_t(i)], 4);
      memcpy(p + 4, buf.data(), size_t(dim) * 4);
      ++kept;
    }
    out.resize(8 + kept * rec);
    uint32_t hdr[2] = {uint32_t(kept), uint32_t(dim)};
    memcpy(out.data(), hdr, 8);
    resp.content_type = "application/octet-stream";
    resp.body = std::move(out);
  });

  srv.route("GET", "/mem", [](const Request&, Response& resp) {
    resp.body = "{\"rss_kb\": " + std::to_string(httpkit::self_rss_kb()) + "}";
  });

  srv.route("GET", "/info", [vs](const Request&, Response& resp) {
    resp.body = "{\"count\": " + std::to_string(vs_count(vs)) + "}";
  });

  printf("Starting native storage_service on port %d with db %s\n", port,
         dbpath);
  fflush(stdout);
  if (!srv.listen_and_serve(port)) {
    fprintf(stderr, "bind/listen failed on %d\n", port);
    return 1;
  }
  return 0;
}
