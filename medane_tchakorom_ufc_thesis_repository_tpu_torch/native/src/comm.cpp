// Native TCP message router for the async multisplitting transport.
//
// The C++ counterpart of the reference's C communication layer
// (src/utils/comm.c: MPI_Isend/Iprobe drain loops, packed headers,
// ping-pong latency probe) for OS-process deployments: one epoll router
// thread per transport instance handles all inbound connections, parses
// the framed wire format shared with models/net.py (6 big-endian int32
// header: kind, src, phase_tag, iteration, positive, payload_len), and
// sorts frames into
//   * a protocol-message queue (Alg-5.15 PartialCV/.../Verdict),
//   * per-sender latest-wins data slots (drain-to-newest semantics),
//   * ping echoes / pong tokens for the RTT probe.
// Sends run on the caller's thread over lazily-connected per-destination
// sockets (TCP_NODELAY).  Wire-compatible with the Python TcpTransport:
// native and Python endpoints interoperate frame-for-frame.
//
// Exposed as a C API consumed through ctypes (native/__init__.py).
// The PyTorch port's copy of the JAX package's native/src/comm.cpp,
// unchanged but for this paragraph: the port's models/net.py raises when
// this file does not build ('auto' means this router; 'python' picks the
// thread-per-connection one).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int32_t kDataKind = 255;
constexpr int32_t kPingKind = 254;
constexpr int32_t kPongKind = 253;
constexpr size_t kHdrSize = 24;

struct Header {
  int32_t kind, src, tag, iter, pos;
  int64_t plen;  // parsed from int32 on the wire
};

struct DataSlot {
  std::vector<uint8_t> payload;
  int32_t iter = 0;
  int64_t version = 0;
};

struct Conn {
  int fd = -1;
  std::vector<uint8_t> buf;
};

// WAN link emulation (the reference shapes a bridge with `tc qdisc`
// to 50 mbit / 100 ms for its async-vs-sync study,
// running_bulk_test_local:322-330).  A delay queue in the router: sends
// enqueue with due = serialization(bandwidth) + latency + jitter, a
// sender thread delivers in per-link FIFO order (netem-without-reorder
// semantics — latest-wins mailboxes must never regress).  Drop applies
// to DATA frames only (protocol frames ride TCP reliability, as the
// reference's tc recipe shapes rate/latency but does not drop).
struct WanFrame {
  double due;
  int64_t seq;
  int32_t dst;
  std::vector<uint8_t> frame;
  bool operator>(const WanFrame& o) const {
    return due != o.due ? due > o.due : seq > o.seq;
  }
};

struct WanState {
  double latency_s = 0.0, jitter_s = 0.0, drop = 0.0, bw_bps = 0.0;
  std::mt19937 rng;
  std::mutex mu;
  std::condition_variable cv;
  std::priority_queue<WanFrame, std::vector<WanFrame>,
                      std::greater<WanFrame>> heap;
  std::map<int32_t, double> link_free;   // per-dst serialization clock
  std::map<int32_t, double> last_due;    // per-dst FIFO floor
  int64_t seq = 0;
  std::thread sender;
  std::atomic<bool> stop{false};
};

struct Transport {
  int32_t rank = -1;
  std::vector<std::pair<std::string, int>> addrs;
  int listen_fd = -1;
  int epfd = -1;
  std::thread router;
  std::atomic<bool> stop{false};

  std::mutex out_mu;                       // guards out_fds map
  std::map<int32_t, int> out_fds;
  std::map<int32_t, std::unique_ptr<std::mutex>> out_locks;

  std::mutex q_mu;
  std::deque<std::array<int32_t, 5>> q;    // kind, src, tag, iter, pos

  std::mutex d_mu;
  std::map<int32_t, DataSlot> data;
  std::set<int32_t> pongs;
  int32_t ping_token = 0;

  std::map<int, Conn> conns;               // router thread only
  std::unique_ptr<WanState> wan;           // set once before first send
};

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

bool send_all(int fd, const uint8_t* p, size_t n) {
  while (n) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

void pack_header(uint8_t* out, int32_t kind, int32_t src, int32_t tag,
                 int32_t iter, int32_t pos, int32_t plen) {
  int32_t v[6] = {kind, src, tag, iter, pos, plen};
  for (int i = 0; i < 6; ++i) {
    uint32_t be = htonl(static_cast<uint32_t>(v[i]));
    std::memcpy(out + 4 * i, &be, 4);
  }
}

Header parse_header(const uint8_t* p) {
  Header h;
  int32_t v[6];
  for (int i = 0; i < 6; ++i) {
    uint32_t be;
    std::memcpy(&be, p + 4 * i, 4);
    v[i] = static_cast<int32_t>(ntohl(be));
  }
  h.kind = v[0]; h.src = v[1]; h.tag = v[2];
  h.iter = v[3]; h.pos = v[4]; h.plen = v[5];
  return h;
}

int connect_to(const std::pair<std::string, int>& addr,
               double timeout_s) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(timeout_s);
  char port[16];
  std::snprintf(port, sizeof port, "%d", addr.second);
  while (std::chrono::steady_clock::now() < deadline) {
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(addr.first.c_str(), port, &hints, &res) == 0) {
      for (addrinfo* ai = res; ai; ai = ai->ai_next) {
        int fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) continue;
        if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) {
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          freeaddrinfo(res);
          return fd;
        }
        ::close(fd);
      }
      freeaddrinfo(res);
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  return -1;
}

int get_out_fd(Transport* t, int32_t dst, std::mutex*& lock_out,
               double connect_timeout_s = 60.0) {
  std::unique_lock<std::mutex> lk(t->out_mu);
  auto it = t->out_locks.find(dst);
  if (it == t->out_locks.end()) {
    it = t->out_locks.emplace(dst, std::make_unique<std::mutex>()).first;
  }
  lock_out = it->second.get();
  auto fit = t->out_fds.find(dst);
  if (fit != t->out_fds.end()) return fit->second;
  lk.unlock();
  int fd = connect_to(t->addrs[static_cast<size_t>(dst)],
                      connect_timeout_s);
  if (fd < 0) return -1;
  lk.lock();
  auto again = t->out_fds.find(dst);
  if (again != t->out_fds.end()) {  // lost the race: use the winner's
    ::close(fd);
    return again->second;
  }
  t->out_fds[dst] = fd;
  return fd;
}

bool send_bytes(Transport* t, int32_t dst, const uint8_t* p, size_t n,
                double connect_timeout_s = 60.0) {
  std::mutex* lock = nullptr;
  int fd = get_out_fd(t, dst, lock, connect_timeout_s);
  if (fd < 0) return false;
  std::lock_guard<std::mutex> lg(*lock);
  return send_all(fd, p, n);
}

void wan_sender_main(Transport* t) {
  WanState* w = t->wan.get();
  std::unique_lock<std::mutex> lk(w->mu);
  while (!w->stop.load()) {
    if (w->heap.empty()) {
      w->cv.wait_for(lk, std::chrono::milliseconds(50));
      continue;
    }
    double due = w->heap.top().due;
    double now = now_s();
    if (due > now) {
      w->cv.wait_for(lk, std::chrono::duration<double>(due - now));
      continue;
    }
    WanFrame f = w->heap.top();
    w->heap.pop();
    lk.unlock();
    // delivery failures under emulation drop silently (the peer left)
    send_bytes(t, f.dst, f.frame.data(), f.frame.size(), 5.0);
    lk.lock();
  }
}

bool send_frame(Transport* t, int32_t dst, int32_t kind, int32_t tag,
                int32_t iter, int32_t pos, const uint8_t* payload,
                int64_t plen, double connect_timeout_s = 60.0) {
  std::vector<uint8_t> frame(kHdrSize + static_cast<size_t>(plen));
  pack_header(frame.data(), kind, t->rank, tag, iter, pos,
              static_cast<int32_t>(plen));
  if (plen) std::memcpy(frame.data() + kHdrSize, payload,
                        static_cast<size_t>(plen));
  WanState* w = t->wan.get();
  if (w != nullptr) {
    std::lock_guard<std::mutex> lg(w->mu);
    if (kind == kDataKind && w->drop > 0.0) {
      std::uniform_real_distribution<double> u(0.0, 1.0);
      if (u(w->rng) < w->drop) return true;  // dropped on the "wire"
    }
    double now = now_s();
    double& free_at = w->link_free[dst];
    if (free_at < now) free_at = now;
    if (w->bw_bps > 0.0) {
      free_at += static_cast<double>(frame.size()) * 8.0 / w->bw_bps;
    }
    double due = free_at + w->latency_s;
    if (w->jitter_s > 0.0) {
      std::uniform_real_distribution<double> u(0.0, w->jitter_s);
      due += u(w->rng);
    }
    double& floor = w->last_due[dst];
    if (due < floor) due = floor;   // per-link FIFO: no reordering
    floor = due;
    w->heap.push(WanFrame{due, w->seq++, dst, std::move(frame)});
    w->cv.notify_one();
    return true;   // enqueue = accepted (fire-and-forget on the link)
  }
  return send_bytes(t, dst, frame.data(), frame.size(),
                    connect_timeout_s);
}

void handle_frame(Transport* t, const Header& h,
                  std::vector<uint8_t>&& payload) {
  if (h.kind == kDataKind) {
    std::lock_guard<std::mutex> lg(t->d_mu);
    DataSlot& s = t->data[h.src];
    s.payload = std::move(payload);
    s.iter = h.iter;
    s.version += 1;
  } else if (h.kind == kPingKind) {
    // pong replies run ON the router thread: a long connect retry to an
    // unreachable pinger would stall ALL inbound traffic, so cap the
    // connect budget (a dropped pong just reads as no-reply to the
    // pinger's RTT probe)
    send_frame(t, h.src, kPongKind, 0, h.iter, 0, nullptr, 0, 2.0);
  } else if (h.kind == kPongKind) {
    std::lock_guard<std::mutex> lg(t->d_mu);
    t->pongs.insert(h.iter);
  } else {
    std::lock_guard<std::mutex> lg(t->q_mu);
    t->q.push_back({h.kind, h.src, h.tag, h.iter, h.pos});
  }
}

void drain_conn(Transport* t, Conn& c) {
  uint8_t tmp[65536];
  for (;;) {
    ssize_t r = ::recv(c.fd, tmp, sizeof tmp, 0);
    if (r == 0) { ::close(c.fd); c.fd = -1; return; }
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      ::close(c.fd); c.fd = -1; return;
    }
    c.buf.insert(c.buf.end(), tmp, tmp + r);
  }
  size_t off = 0;
  while (c.buf.size() - off >= kHdrSize) {
    Header h = parse_header(c.buf.data() + off);
    size_t need = kHdrSize + static_cast<size_t>(h.plen);
    if (c.buf.size() - off < need) break;
    std::vector<uint8_t> payload(
        c.buf.begin() + static_cast<long>(off + kHdrSize),
        c.buf.begin() + static_cast<long>(off + need));
    handle_frame(t, h, std::move(payload));
    off += need;
  }
  if (off) c.buf.erase(c.buf.begin(), c.buf.begin() + static_cast<long>(off));
}

void router_main(Transport* t) {
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = t->listen_fd;
  epoll_ctl(t->epfd, EPOLL_CTL_ADD, t->listen_fd, &ev);
  std::vector<epoll_event> evs(64);
  while (!t->stop.load()) {
    int n = epoll_wait(t->epfd, evs.data(), static_cast<int>(evs.size()),
                       100);
    for (int i = 0; i < n; ++i) {
      int fd = evs[i].data.fd;
      if (fd == t->listen_fd) {
        for (;;) {
          int cfd = ::accept4(t->listen_fd, nullptr, nullptr,
                              SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          epoll_event cev{};
          cev.events = EPOLLIN;
          cev.data.fd = cfd;
          epoll_ctl(t->epfd, EPOLL_CTL_ADD, cfd, &cev);
          t->conns[cfd] = Conn{cfd, {}};
        }
      } else {
        auto it = t->conns.find(fd);
        if (it == t->conns.end()) continue;
        drain_conn(t, it->second);
        if (it->second.fd < 0) {
          epoll_ctl(t->epfd, EPOLL_CTL_DEL, fd, nullptr);
          t->conns.erase(it);
        }
      }
    }
  }
  for (auto& kv : t->conns) ::close(kv.second.fd);
  t->conns.clear();
}

std::mutex g_mu;
std::map<int64_t, std::unique_ptr<Transport>> g_transports;
int64_t g_next = 1;

Transport* get(int64_t h) {
  std::lock_guard<std::mutex> lg(g_mu);
  auto it = g_transports.find(h);
  return it == g_transports.end() ? nullptr : it->second.get();
}

}  // namespace

extern "C" {

// addrs_csv: "host:port,host:port,..." (one per rank).  Returns a
// handle >= 1, or -1 on failure.
int64_t comm_create(int32_t rank, const char* addrs_csv) {
  auto t = std::make_unique<Transport>();
  t->rank = rank;
  std::string s(addrs_csv);
  size_t pos = 0;
  while (pos <= s.size()) {
    size_t comma = s.find(',', pos);
    std::string item = s.substr(
        pos, comma == std::string::npos ? std::string::npos : comma - pos);
    size_t colon = item.rfind(':');
    if (colon == std::string::npos) return -1;
    t->addrs.emplace_back(item.substr(0, colon),
                          std::atoi(item.c_str() + colon + 1));
    if (comma == std::string::npos) break;
    pos = comma + 1;
  }
  if (rank < 0 || static_cast<size_t>(rank) >= t->addrs.size()) return -1;

  t->listen_fd = ::socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (t->listen_fd < 0) return -1;
  int one = 1;
  setsockopt(t->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons(static_cast<uint16_t>(t->addrs[rank].second));
  sa.sin_addr.s_addr = htonl(INADDR_ANY);
  if (::bind(t->listen_fd, reinterpret_cast<sockaddr*>(&sa), sizeof sa) ||
      ::listen(t->listen_fd, 64)) {
    ::close(t->listen_fd);
    return -1;
  }
  t->epfd = epoll_create1(0);
  if (t->epfd < 0) {
    ::close(t->listen_fd);
    return -1;
  }
  Transport* raw = t.get();
  raw->router = std::thread(router_main, raw);
  std::lock_guard<std::mutex> lg(g_mu);
  int64_t h = g_next++;
  g_transports[h] = std::move(t);
  return h;
}

// Enable WAN link emulation on a transport (call once, before traffic).
// latency/jitter seconds, drop in [0,1) (DATA frames only), bw_bps
// bits/second (0 = unlimited).  Returns 0, or -1 on a bad handle.
int32_t comm_set_wan(int64_t h, double latency_s, double jitter_s,
                     double drop, double bw_bps, int64_t seed) {
  Transport* t = get(h);
  if (!t) return -1;
  auto w = std::make_unique<WanState>();
  w->latency_s = latency_s;
  w->jitter_s = jitter_s;
  w->drop = drop;
  w->bw_bps = bw_bps;
  w->rng.seed(static_cast<uint32_t>(seed));
  t->wan = std::move(w);
  WanState* raw = t->wan.get();
  raw->sender = std::thread(wan_sender_main, t);
  return 0;
}

int32_t comm_send(int64_t h, int32_t dst, int32_t kind, int32_t tag,
                  int32_t iter, int32_t pos, const uint8_t* payload,
                  int64_t plen) {
  Transport* t = get(h);
  if (!t) return -1;
  return send_frame(t, dst, kind, tag, iter, pos, payload, plen) ? 0 : -1;
}

// Pops up to cap protocol messages; out receives 5 int32 per message
// (kind, src, tag, iter, pos).  Returns the count.
int32_t comm_drain(int64_t h, int32_t* out, int32_t cap) {
  Transport* t = get(h);
  if (!t) return -1;
  std::lock_guard<std::mutex> lg(t->q_mu);
  int32_t n = 0;
  while (n < cap && !t->q.empty()) {
    const auto& m = t->q.front();
    std::memcpy(out + 5 * n, m.data(), 5 * sizeof(int32_t));
    t->q.pop_front();
    ++n;
  }
  return n;
}

// Copies src's newest payload into buf (cap bytes), sets *iter_out.
// Returns the version (0 = nothing yet; -2 = cap too small).
int64_t comm_read_data(int64_t h, int32_t src, uint8_t* buf, int64_t cap,
                       int32_t* iter_out) {
  Transport* t = get(h);
  if (!t) return -1;
  std::lock_guard<std::mutex> lg(t->d_mu);
  auto it = t->data.find(src);
  if (it == t->data.end()) return 0;
  const DataSlot& s = it->second;
  if (static_cast<int64_t>(s.payload.size()) > cap) return -2;
  std::memcpy(buf, s.payload.data(), s.payload.size());
  *iter_out = s.iter;
  return s.version;
}

// Ping-pong RTT in seconds (< 0 on timeout) — comm.c:390-424 analog.
double comm_rtt(int64_t h, int32_t dst, double timeout_s) {
  Transport* t = get(h);
  if (!t) return -1.0;
  int32_t token;
  {
    std::lock_guard<std::mutex> lg(t->d_mu);
    token = ++t->ping_token * 1000 + t->rank;
  }
  auto t0 = std::chrono::steady_clock::now();
  if (!send_frame(t, dst, kPingKind, 0, token, 0, nullptr, 0)) return -1.0;
  auto deadline = t0 + std::chrono::duration<double>(timeout_s);
  while (std::chrono::steady_clock::now() < deadline) {
    {
      std::lock_guard<std::mutex> lg(t->d_mu);
      if (t->pongs.count(token)) {
        t->pongs.erase(token);
        std::chrono::duration<double> dt =
            std::chrono::steady_clock::now() - t0;
        return dt.count();
      }
    }
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
  return -1.0;
}

void comm_close(int64_t h) {
  std::unique_ptr<Transport> t;
  {
    std::lock_guard<std::mutex> lg(g_mu);
    auto it = g_transports.find(h);
    if (it == g_transports.end()) return;
    t = std::move(it->second);
    g_transports.erase(it);
  }
  if (t->wan) {
    // drain pending delayed frames (bounded): peers may still need the
    // final exchange that is sitting in the delay queue
    auto drain_deadline = std::chrono::steady_clock::now() +
                          std::chrono::seconds(5);
    for (;;) {
      {
        std::lock_guard<std::mutex> lg(t->wan->mu);
        if (t->wan->heap.empty()) break;
      }
      if (std::chrono::steady_clock::now() > drain_deadline) break;
      std::this_thread::sleep_for(std::chrono::milliseconds(5));
    }
    t->wan->stop.store(true);
    t->wan->cv.notify_all();
    if (t->wan->sender.joinable()) t->wan->sender.join();
  }
  t->stop.store(true);
  if (t->router.joinable()) t->router.join();
  ::close(t->epfd);
  ::close(t->listen_fd);
  std::lock_guard<std::mutex> lg(t->out_mu);
  for (auto& kv : t->out_fds) ::close(kv.second);
  t->out_fds.clear();
}

}  // extern "C"
