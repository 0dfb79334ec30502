// Native framed-TCP client for the remote cache server (a copy of
// lmcache_tpu/net/csrc/lmtc_net.cc).
//
// The reference's custom TCP client is pure Python with an explicit TODO
// to move to C/C++ (reference lmcache/storage_backend/connector/
// lm_connector.py:13). This is that client: blocking sockets, zero-copy
// receive straight into caller-provided buffers (numpy arrays on the
// Python side), TCP_NODELAY for the small-header/large-payload pattern.
//
// Wire format: lmcache_tpu_torch/protocol.py (versioned little-endian
// frames), byte for byte the JAX package's.

#include <arpa/inet.h>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <netdb.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

constexpr uint16_t kMagicReq = 0xC7C0;
constexpr uint16_t kMagicResp = 0xC7C1;
constexpr uint8_t kVersion = 1;
constexpr int kRespHeaderSize = 13;

#pragma pack(push, 1)
struct ReqHeader {
  uint16_t magic;
  uint8_t version;
  uint8_t command;
  uint32_t key_len;
  uint64_t payload_len;
};
#pragma pack(pop)
static_assert(sizeof(ReqHeader) == 16, "request header must be 16 bytes");

bool send_all(int fd, const void* buf, int64_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, static_cast<size_t>(n), MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= w;
  }
  return true;
}

bool recv_all(int fd, void* buf, int64_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, static_cast<size_t>(n), MSG_WAITALL);
    if (r <= 0) return false;
    p += r;
    n -= r;
  }
  return true;
}

bool send_request(int fd, uint8_t command, const char* key, uint32_t key_len,
                  const void* payload, uint64_t payload_len) {
  ReqHeader h{kMagicReq, kVersion, command, key_len, payload_len};
  if (!send_all(fd, &h, sizeof(h))) return false;
  if (!send_all(fd, key, key_len)) return false;
  if (payload_len && !send_all(fd, payload, payload_len)) return false;
  return true;
}

// Returns response code (200/400/404) or -1 on socket error; fills
// *payload_len from the response header.
int recv_response_header(int fd, int64_t* payload_len) {
  uint8_t buf[kRespHeaderSize];
  if (!recv_all(fd, buf, sizeof(buf))) return -1;
  uint16_t magic;
  std::memcpy(&magic, buf, 2);
  if (magic != kMagicResp || buf[2] != kVersion) return -1;
  uint16_t code;
  std::memcpy(&code, buf + 3, 2);
  uint64_t plen;
  std::memcpy(&plen, buf + 5, 8);
  *payload_len = static_cast<int64_t>(plen);
  return code;
}

}  // namespace

extern "C" {

// Returns connected socket fd, or -1.
int lmtc_connect(const char* host, int port) {
  char port_str[16];
  std::snprintf(port_str, sizeof(port_str), "%d", port);
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(host, port_str, &hints, &res) != 0) return -1;
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

void lmtc_disconnect(int fd) {
  if (fd >= 0) ::close(fd);
}

// PUT: returns response code, or -1 on transport error.
int lmtc_put(int fd, const char* key, int key_len, const void* payload,
             int64_t payload_len) {
  if (!send_request(fd, /*PUT=*/1, key, key_len, payload, payload_len))
    return -1;
  int64_t plen = 0;
  int code = recv_response_header(fd, &plen);
  if (code >= 0 && plen > 0) {  // drain unexpected payload
    char sink[4096];
    while (plen > 0) {
      int64_t chunk = plen < 4096 ? plen : 4096;
      if (!recv_all(fd, sink, chunk)) return -1;
      plen -= chunk;
    }
  }
  return code;
}

// GET phase 1: send request, read header. Returns payload length
// (>= 0) on code 200; -404 when missing; -1 on error. The payload
// remains pending on the socket for lmtc_read_payload.
int64_t lmtc_get_begin(int fd, const char* key, int key_len) {
  if (!send_request(fd, /*GET=*/2, key, key_len, nullptr, 0)) return -1;
  int64_t plen = 0;
  int code = recv_response_header(fd, &plen);
  if (code == 200) return plen;
  if (code < 0) return -1;
  // non-200 with payload (shouldn't happen): drain
  char sink[4096];
  while (plen > 0) {
    int64_t chunk = plen < 4096 ? plen : 4096;
    if (!recv_all(fd, sink, chunk)) return -1;
    plen -= chunk;
  }
  return code == 404 ? -404 : -1;
}

// GET phase 2: read exactly n pending payload bytes into buf.
int lmtc_read_payload(int fd, void* buf, int64_t n) {
  return recv_all(fd, buf, n) ? 0 : -1;
}

// EXIST: 1 / 0 / -1.
int lmtc_exists(int fd, const char* key, int key_len) {
  if (!send_request(fd, /*EXIST=*/3, key, key_len, nullptr, 0)) return -1;
  int64_t plen = 0;
  int code = recv_response_header(fd, &plen);
  if (code < 0) return -1;
  if (plen > 0) {
    char sink[4096];
    while (plen > 0) {
      int64_t chunk = plen < 4096 ? plen : 4096;
      if (!recv_all(fd, sink, chunk)) return -1;
      plen -= chunk;
    }
  }
  return code == 200 ? 1 : 0;
}

}  // extern "C"
