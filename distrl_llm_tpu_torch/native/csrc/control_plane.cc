// Control-plane transport — C++ TCP core with a plain C ABI (ctypes-bound).
//
// The N5 equivalent (SURVEY §2b): the reference's driver↔worker RPC runs on
// Ray's C++ core (raylet/GCS/gRPC — ray.init at distributed_actor.py:543,
// actor .remote dispatch at distributed_trainer.py:190–197, ray.get barriers
// with timeouts at :200/:333). This file is the native transport under our
// multi-process runtime: length-prefixed typed frames over TCP with
// poll()-based deadlines. gRPC itself is not in this environment (no
// grpc++/protoc plugin); the Python layer (distrl_llm_tpu_torch/distributed/)
// builds the RPC semantics — request ids, dispatch/collect, health checks,
// shard resubmission — on these primitives.
//
// Frame wire format (little-endian):
//   [u32 magic 0xC0DE17A1][u8 type][u64 req_id][u64 payload_len][payload]
//
// All calls are blocking with explicit millisecond deadlines; fds are plain
// sockets so one process can serve/poll many connections from Python threads.

#include <arpa/inet.h>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xC0DE17A1;

#pragma pack(push, 1)
struct FrameHeader {
  uint32_t magic;
  uint8_t type;
  uint64_t req_id;
  uint64_t len;
};
#pragma pack(pop)

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Fully send len bytes before an absolute deadline. The deadline is TOTAL —
// each poll gets only the remaining budget, so a peer trickling bytes cannot
// extend the transfer indefinitely.
bool send_all(int fd, const char* data, int64_t len, int timeout_ms) {
  const int64_t deadline = now_ms() + timeout_ms;
  int64_t off = 0;
  while (off < len) {
    int64_t remaining = deadline - now_ms();
    if (remaining <= 0) return false;
    struct pollfd p = {fd, POLLOUT, 0};
    int r = poll(&p, 1, static_cast<int>(remaining));
    if (r < 0 && errno == EINTR) continue;  // signal (e.g. SIGTERM drain)
    if (r <= 0) return false;
    ssize_t n = ::send(fd, data + off, static_cast<size_t>(len - off),
                       MSG_NOSIGNAL);
    if (n <= 0) {
      if (errno == EINTR || errno == EAGAIN) continue;
      return false;
    }
    off += n;
  }
  return true;
}

// Fully receive len bytes before an absolute deadline (total, as above).
bool recv_all(int fd, char* buf, int64_t len, int timeout_ms) {
  const int64_t deadline = now_ms() + timeout_ms;
  int64_t off = 0;
  while (off < len) {
    int64_t remaining = deadline - now_ms();
    if (remaining <= 0) return false;
    struct pollfd p = {fd, POLLIN, 0};
    int r = poll(&p, 1, static_cast<int>(remaining));
    if (r < 0 && errno == EINTR) continue;  // signal (e.g. SIGTERM drain)
    if (r <= 0) return false;
    ssize_t n = ::recv(fd, buf + off, static_cast<size_t>(len - off), 0);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR || errno == EAGAIN)) continue;
      return false;  // peer closed or hard error
    }
    off += n;
  }
  return true;
}

}  // namespace

extern "C" {

// Listen on 127.0.0.1:port (port 0 = ephemeral). Returns server fd or -1.
int64_t cp_listen(int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    close(fd);
    return -1;
  }
  return fd;
}

// Bound port of a listening fd (for port 0 ephemeral binds). -1 on error.
int cp_bound_port(int64_t server_fd) {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(static_cast<int>(server_fd),
                  reinterpret_cast<sockaddr*>(&addr), &len) != 0)
    return -1;
  return ntohs(addr.sin_port);
}

// Accept one connection. Returns conn fd, -1 on timeout, -2 on error.
int64_t cp_accept(int64_t server_fd, int timeout_ms) {
  struct pollfd p = {static_cast<int>(server_fd), POLLIN, 0};
  int r = poll(&p, 1, timeout_ms);
  if (r == 0) return -1;
  // EINTR reports as a timeout so the Python accept loop regains control
  // (and runs its signal handlers — the SIGTERM drain path) instead of
  // treating a delivered signal as a transport error.
  if (r < 0) return errno == EINTR ? -1 : -2;
  int fd = accept(static_cast<int>(server_fd), nullptr, nullptr);
  if (fd < 0) return -2;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// Connect to host:port with a real deadline (non-blocking connect + poll;
// the kernel's default SYN retry window is ~2 min, far past any RPC budget).
// Returns conn fd or -1.
int64_t cp_connect(const char* host, int port, int timeout_ms) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  snprintf(portbuf, sizeof(portbuf), "%d", port);
  if (getaddrinfo(host, portbuf, &hints, &res) != 0 || !res) return -1;
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    freeaddrinfo(res);
    return -1;
  }
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  int rc = connect(fd, res->ai_addr, res->ai_addrlen);
  freeaddrinfo(res);
  if (rc != 0) {
    if (errno != EINPROGRESS) {
      close(fd);
      return -1;
    }
    struct pollfd p = {fd, POLLOUT, 0};
    if (poll(&p, 1, timeout_ms) <= 0) {
      close(fd);
      return -1;
    }
    int err = 0;
    socklen_t elen = sizeof(err);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) != 0 || err != 0) {
      close(fd);
      return -1;
    }
  }
  fcntl(fd, F_SETFL, flags);  // back to blocking; frame ops poll explicitly
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// Send one frame. Returns 0 ok, -1 failure.
int cp_send(int64_t fd, int type, uint64_t req_id, const char* data,
            int64_t len, int timeout_ms) {
  FrameHeader h{kMagic, static_cast<uint8_t>(type), req_id,
                static_cast<uint64_t>(len)};
  if (!send_all(static_cast<int>(fd), reinterpret_cast<const char*>(&h),
                sizeof(h), timeout_ms))
    return -1;
  if (len > 0 && !send_all(static_cast<int>(fd), data, len, timeout_ms))
    return -1;
  return 0;
}

// Receive a frame header. Returns 0 ok (fills type/req_id/len), -1 timeout,
// -2 closed/protocol error.
int cp_recv_header(int64_t fd, int* type, uint64_t* req_id, int64_t* len,
                   int timeout_ms) {
  FrameHeader h{};
  // peek-poll first so a clean timeout does not consume partial bytes
  struct pollfd p = {static_cast<int>(fd), POLLIN, 0};
  int r = poll(&p, 1, timeout_ms);
  if (r == 0) return -1;
  // EINTR → timeout, not connection death: the Python serve loop must get
  // control back to run signal handlers (SIGTERM drain) without the
  // connection being torn down underneath the driver.
  if (r < 0) return errno == EINTR ? -1 : -2;
  if (!recv_all(static_cast<int>(fd), reinterpret_cast<char*>(&h), sizeof(h),
                timeout_ms))
    return -2;
  if (h.magic != kMagic) return -2;
  *type = h.type;
  *req_id = h.req_id;
  *len = static_cast<int64_t>(h.len);
  return 0;
}

// Receive exactly len payload bytes. Returns 0 ok, -1 failure.
int cp_recv_payload(int64_t fd, char* buf, int64_t len, int timeout_ms) {
  if (len == 0) return 0;
  return recv_all(static_cast<int>(fd), buf, len, timeout_ms) ? 0 : -1;
}

void cp_close(int64_t fd) {
  if (fd >= 0) close(static_cast<int>(fd));
}

}  // extern "C"
