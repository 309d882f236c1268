// Minimal HTTP/1.1 server + client + JSON helpers for the native service
// frontends (role of the reference's vendored cpp-httplib + nlohmann/json,
// 36.5k LoC — replaced by ~400 lines of POSIX sockets because the services
// need exactly: fixed routes, Content-Length bodies, small JSON schemas).
//
// Reference surface covered: httplib::Server/Client usage in
// storage_service/main.cpp:17-75, hnsw_service/main.cpp:48-156,
// hnsw_service/hnsw_graph.cpp:153-212 (client with timeouts + retry).
#pragma once

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace httpkit {

struct Request {
  std::string method;
  std::string path;    // path only (no query)
  std::string query;   // raw query string
  std::string body;

  // "a=1&b=2" -> value of key, or fallback
  long query_long(const char* key, long fallback) const {
    std::string k = std::string(key) + "=";
    size_t pos = 0;
    while (pos < query.size()) {
      size_t amp = query.find('&', pos);
      std::string kv = query.substr(pos, amp == std::string::npos ? amp : amp - pos);
      if (kv.rfind(k, 0) == 0) return atol(kv.c_str() + k.size());
      if (amp == std::string::npos) break;
      pos = amp + 1;
    }
    return fallback;
  }
};

struct Response {
  int status = 200;
  std::string content_type = "application/json";
  std::string body;
};

using Handler = std::function<void(const Request&, Response&)>;

inline bool read_exact(int fd, char* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::read(fd, buf + got, n - got);
    if (r <= 0) return false;
    got += size_t(r);
  }
  return true;
}

inline bool write_all(int fd, const char* buf, size_t n) {
  size_t put = 0;
  while (put < n) {
    ssize_t w = ::write(fd, buf + put, n - put);
    if (w <= 0) return false;
    put += size_t(w);
  }
  return true;
}

// --------------------------------------------------------------------------
// Server: accept loop feeding a FIXED worker pool over a bounded connection
// queue (the reference's cpp-httplib serves from a bounded thread pool too;
// the earlier thread-per-connection design spawned unbounded threads under
// load). When the queue is full the accept loop blocks — kernel backlog +
// client timeouts provide the backpressure, the process never runs away.
// Worker count: HTTPKIT_WORKERS env or the constructor arg (default 8).
// --------------------------------------------------------------------------
class Server {
 public:
  explicit Server(int workers = 0) {
    if (workers <= 0) {
      const char* env = getenv("HTTPKIT_WORKERS");
      workers = env ? atoi(env) : 0;
    }
    n_workers_ = workers > 0 ? workers : 8;
  }

  void route(const std::string& method, const std::string& path, Handler h) {
    handlers_[method + " " + path] = std::move(h);
  }

  bool listen_and_serve(int port) {
    int s = ::socket(AF_INET, SOCK_STREAM, 0);
    if (s < 0) return false;
    int one = 1;
    setsockopt(s, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(uint16_t(port));
    if (bind(s, (sockaddr*)&addr, sizeof(addr)) != 0) return false;
    if (listen(s, 256) != 0) return false;
    for (int i = 0; i < n_workers_; i++)
      workers_.emplace_back([this] { worker_loop(); });
    fprintf(stderr, "listening on %d (%d workers)\n", port, n_workers_);
    fflush(stderr);
    const size_t queue_cap = size_t(n_workers_) * 8;
    while (true) {
      int c = accept(s, nullptr, nullptr);
      if (c < 0) continue;
      {
        std::unique_lock<std::mutex> lk(pool_mu_);
        pool_not_full_.wait(lk, [&] { return pending_.size() < queue_cap; });
        pending_.push_back(c);
      }
      pool_not_empty_.notify_one();
    }
  }

 private:
  void worker_loop() {
    while (true) {
      int fd;
      {
        std::unique_lock<std::mutex> lk(pool_mu_);
        pool_not_empty_.wait(lk, [&] { return !pending_.empty(); });
        fd = pending_.front();
        pending_.pop_front();
      }
      pool_not_full_.notify_one();
      handle_conn(fd);
      ::close(fd);
    }
  }

  void handle_conn(int fd) {
    // Idle-read timeout: with a fixed pool, a silent keep-alive peer must
    // not pin a worker forever — reads give up after 10s and the worker
    // moves on to the next queued connection.
    timeval tv{10, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    std::string buf;
    char tmp[8192];
    while (true) {
      // read until end of headers
      size_t hdr_end;
      while ((hdr_end = buf.find("\r\n\r\n")) == std::string::npos) {
        ssize_t r = ::read(fd, tmp, sizeof(tmp));
        if (r <= 0) return;
        buf.append(tmp, size_t(r));
        if (buf.size() > (64u << 20)) return;  // runaway header
      }
      Request req;
      {
        std::istringstream ls(buf.substr(0, hdr_end));
        std::string line;
        std::getline(ls, line);
        std::istringstream rl(line);
        std::string target, ver;
        rl >> req.method >> target >> ver;
        size_t q = target.find('?');
        req.path = q == std::string::npos ? target : target.substr(0, q);
        req.query = q == std::string::npos ? "" : target.substr(q + 1);
      }
      size_t clen = 0;
      bool want_close = false;
      {
        std::string lower = buf.substr(0, hdr_end);
        for (auto& ch : lower) ch = char(tolower((unsigned char)ch));
        size_t p = lower.find("content-length:");
        if (p != std::string::npos) clen = size_t(atol(lower.c_str() + p + 15));
        want_close = lower.find("connection: close") != std::string::npos;
      }
      size_t body_start = hdr_end + 4;
      while (buf.size() < body_start + clen) {
        ssize_t r = ::read(fd, tmp, sizeof(tmp));
        if (r <= 0) return;
        buf.append(tmp, size_t(r));
      }
      req.body = buf.substr(body_start, clen);
      buf.erase(0, body_start + clen);

      Response resp;
      auto it = handlers_.find(req.method + " " + req.path);
      if (it == handlers_.end()) {
        resp.status = 404;
        resp.content_type = "text/plain";
        resp.body = "not found";
      } else {
        it->second(req, resp);
      }
      char hdr[256];
      int n = snprintf(hdr, sizeof(hdr),
                       "HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                       "Content-Length: %zu\r\nConnection: %s\r\n\r\n",
                       resp.status, resp.status == 200 ? "OK" : "ERR",
                       resp.content_type.c_str(), resp.body.size(),
                       want_close ? "close" : "keep-alive");
      if (!write_all(fd, hdr, size_t(n))) return;
      if (!write_all(fd, resp.body.data(), resp.body.size())) return;
      if (want_close) return;
    }
  }

  std::map<std::string, Handler> handlers_;
  int n_workers_ = 8;
  std::vector<std::thread> workers_;
  std::mutex pool_mu_;
  std::condition_variable pool_not_empty_, pool_not_full_;
  std::deque<int> pending_;
};

// --------------------------------------------------------------------------
// Client: one request per call (Connection: close), with the reference's
// retry x3 / linear backoff semantics available at the call site
// (hnsw_graph.cpp:184-209).
// --------------------------------------------------------------------------
inline bool request(const std::string& host, int port, const std::string& method,
                    const std::string& target, const std::string& body,
                    std::string* out, int timeout_s = 30) {
  int s = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s < 0) return false;
  timeval tv{timeout_s, 0};
  setsockopt(s, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(s, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    ::close(s);
    return false;
  }
  if (connect(s, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(s);
    return false;
  }
  char hdr[512];
  int n = snprintf(hdr, sizeof(hdr),
                   "%s %s HTTP/1.1\r\nHost: %s\r\nContent-Length: %zu\r\n"
                   "Connection: close\r\n\r\n",
                   method.c_str(), target.c_str(), host.c_str(), body.size());
  bool ok = write_all(s, hdr, size_t(n)) && write_all(s, body.data(), body.size());
  // Read headers, then exactly Content-Length body bytes: do NOT rely on the
  // server closing the connection (a keep-alive peer would block us until
  // its idle timeout).
  std::string resp;
  char tmp[16384];
  size_t he = std::string::npos;
  while (ok && (he = resp.find("\r\n\r\n")) == std::string::npos) {
    ssize_t r = ::read(s, tmp, sizeof(tmp));
    if (r <= 0) {
      ok = false;
      break;
    }
    resp.append(tmp, size_t(r));
  }
  size_t clen = 0;
  if (ok) {
    std::string lower = resp.substr(0, he);
    for (auto& ch : lower) ch = char(tolower((unsigned char)ch));
    size_t p = lower.find("content-length:");
    if (p != std::string::npos) clen = size_t(atol(lower.c_str() + p + 15));
  }
  while (ok && resp.size() < he + 4 + clen) {
    ssize_t r = ::read(s, tmp, sizeof(tmp));
    if (r <= 0) {
      ok = false;
      break;
    }
    resp.append(tmp, size_t(r));
  }
  ::close(s);
  if (!ok) return false;
  if (resp.compare(0, 12, "HTTP/1.1 200") != 0 &&
      resp.compare(0, 12, "HTTP/1.0 200") != 0)
    return false;
  *out = resp.substr(he + 4, clen);
  return true;
}

// --------------------------------------------------------------------------
// Tiny JSON: just what the service schemas need (float arrays, ints,
// key lookup in a flat object). Not a general parser by design.
// --------------------------------------------------------------------------
inline const char* json_find_key(const std::string& s, const char* key) {
  std::string pat = std::string("\"") + key + "\"";
  size_t p = s.find(pat);
  if (p == std::string::npos) return nullptr;
  p = s.find(':', p + pat.size());
  if (p == std::string::npos) return nullptr;
  return s.c_str() + p + 1;
}

inline bool json_parse_floats(const char* p, std::vector<float>* out) {
  while (*p && isspace((unsigned char)*p)) ++p;
  if (*p != '[') return false;
  ++p;
  while (true) {
    while (*p && (isspace((unsigned char)*p) || *p == ',')) ++p;
    if (*p == ']') return true;
    char* end = nullptr;
    float v = strtof(p, &end);
    if (end == p) return false;
    out->push_back(v);
    p = end;
  }
}

inline long json_long(const std::string& s, const char* key, long fallback) {
  const char* p = json_find_key(s, key);
  if (!p) return fallback;
  char* end = nullptr;
  long v = strtol(p, &end, 10);
  return end == p ? fallback : v;
}

inline long self_rss_kb() {
  FILE* f = fopen("/proc/self/statm", "r");
  if (!f) return -1;
  long pages = 0, rss = 0;
  if (fscanf(f, "%ld %ld", &pages, &rss) != 2) rss = -1;
  fclose(f);
  long pagesz = sysconf(_SC_PAGESIZE);
  return rss < 0 ? -1 : rss * (pagesz / 1024);
}

}  // namespace httpkit
