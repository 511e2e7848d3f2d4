// Native parameter-server RPC transport (TCP, length-prefixed frames).
//
// TPU-native equivalent of the reference's distributed RPC stack:
//   - RPCClient API (operators/distributed/rpc_client.h:32 —
//     AsyncSendVar/AsyncGetVar/AsyncPrefetchVar/barriers/Complete)
//   - RPCServer + RequestHandler (operators/distributed/rpc_server.h,
//     request_handler_impl.cc:37 Send, :83 Get, :189 Checkpoint)
//   - gRPC/BRPC transports (operators/distributed/grpc/, brpc/) and the
//     tensor serde (sendrecvop_utils.cc, variable_response.cc)
//
// Design differences (deliberate, TPU-first): the reference interleaves
// transport with graph execution (listen_and_serv runs optimize blocks
// inside the server). Here the native layer is a *barrier-cycled var
// exchange*: trainers SEND grads then SEND_BARRIER; the host runtime drains
// the cycle's vars, applies the optimizer as one XLA computation, publishes
// params and calls serve(); GETs unblock; FETCH_BARRIERs flip the cycle
// back. Dense tensors and sparse (SelectedRows: rows + values, analog of
// selected_rows.h:32) travel the same frames. Async mode = no barriers,
// every SEND goes straight to a queue (Hogwild analog, async_executor.cc).
//
// C API (ctypes-friendly; pybind11 not available in this image): see the
// extern "C" block at the bottom.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum MsgType : uint8_t {
  kHello = 0,
  kSendVar = 1,
  kGetVar = 2,
  kPrefetch = 3,
  kSendBarrier = 4,
  kFetchBarrier = 5,
  kComplete = 6,
  kCheckpoint = 7,
};

// dtype codes shared with the Python side (native/dtypes.py)
inline size_t DtypeSize(uint8_t dt) {
  switch (dt) {
    case 0: return 4;   // f32
    case 1: return 8;   // i64
    case 2: return 8;   // f64
    case 3: return 4;   // i32
    case 4: return 1;   // u8
    case 5: return 2;   // bf16
    case 6: return 1;   // bool
    case 7: return 2;   // f16
    case 8: return 1;   // i8
    case 9: return 4;   // u32
    case 10: return 2;  // i16
    default: return 1;
  }
}

struct VarBlob {
  std::string name;
  uint8_t dtype = 0;
  std::vector<int64_t> dims;
  std::vector<int64_t> rows;  // sparse row ids; empty + nrows=-1 -> dense
  int64_t nrows = -1;
  std::vector<uint8_t> data;
  int trainer_id = -1;
};

// ---- framed IO helpers -----------------------------------------------------

bool ReadFull(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool WriteFull(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool ReadString(int fd, std::string* s) {
  uint32_t len;
  if (!ReadFull(fd, &len, 4)) return false;
  s->resize(len);
  return len == 0 || ReadFull(fd, &(*s)[0], len);
}

bool WriteString(int fd, const std::string& s) {
  uint32_t len = static_cast<uint32_t>(s.size());
  if (!WriteFull(fd, &len, 4)) return false;
  return s.empty() || WriteFull(fd, s.data(), s.size());
}

// var payload: dtype u8, ndim u8, dims i64[], nrows i64, rows i64[],
// nbytes u64, raw data
bool ReadVarPayload(int fd, VarBlob* v) {
  uint8_t ndim;
  if (!ReadFull(fd, &v->dtype, 1) || !ReadFull(fd, &ndim, 1)) return false;
  v->dims.resize(ndim);
  if (ndim && !ReadFull(fd, v->dims.data(), 8 * ndim)) return false;
  if (!ReadFull(fd, &v->nrows, 8)) return false;
  if (v->nrows >= 0) {
    v->rows.resize(v->nrows);
    if (v->nrows && !ReadFull(fd, v->rows.data(), 8 * v->nrows)) return false;
  }
  uint64_t nbytes;
  if (!ReadFull(fd, &nbytes, 8)) return false;
  v->data.resize(nbytes);
  return nbytes == 0 || ReadFull(fd, v->data.data(), nbytes);
}

bool WriteVarPayload(int fd, const VarBlob& v) {
  uint8_t ndim = static_cast<uint8_t>(v.dims.size());
  if (!WriteFull(fd, &v.dtype, 1) || !WriteFull(fd, &ndim, 1)) return false;
  if (ndim && !WriteFull(fd, v.dims.data(), 8 * ndim)) return false;
  if (!WriteFull(fd, &v.nrows, 8)) return false;
  if (v.nrows > 0 && !WriteFull(fd, v.rows.data(), 8 * v.nrows)) return false;
  uint64_t nbytes = v.data.size();
  if (!WriteFull(fd, &nbytes, 8)) return false;
  return nbytes == 0 || WriteFull(fd, v.data.data(), nbytes);
}

// ---- server ---------------------------------------------------------------

enum Phase { kReceiving = 0, kUpdating = 1, kServing = 2 };

class PSServer {
 public:
  PSServer(int port, int num_trainers, bool sync)
      : num_trainers_(num_trainers), active_(num_trainers), sync_(sync) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    // bind to all interfaces so multi-host trainers can reach us
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
      port_ = -1;
      return;
    }
    socklen_t alen = sizeof(addr);
    ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
    port_ = ntohs(addr.sin_port);
    ::listen(listen_fd_, 128);
  }

  ~PSServer() { Stop(); }

  int port() const { return port_; }

  void Start() {
    accept_thread_ = std::thread([this] { AcceptLoop(); });
  }

  void Stop() {
    bool was = stopped_.exchange(true);
    if (was) return;
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
      cv_.notify_all();
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    for (auto& t : conn_threads_)
      if (t.joinable()) t.join();
  }

  // host-runtime (Python) side --------------------------------------------
  void SetVar(VarBlob v) {
    std::string name = v.name;  // rhs of = is sequenced first: grab the key
    std::lock_guard<std::mutex> lk(mu_);
    store_[name] = std::make_shared<VarBlob>(std::move(v));
  }

  std::shared_ptr<VarBlob> ReadVar(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = store_.find(name);
    return it == store_.end() ? nullptr : it->second;
  }

  // blocks until every active trainer has SEND_BARRIER'd this cycle (sync
  // mode); hands the cycle's received vars to the caller
  std::vector<std::unique_ptr<VarBlob>> WaitGrads() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] {
      return stopped_ || active_ <= 0 || send_barriers_ >= active_;
    });
    phase_ = kUpdating;
    send_barriers_ = 0;
    auto out = std::move(recv_);
    recv_.clear();
    return out;
  }

  // publish updated params and open the GET window
  void Serve() {
    std::lock_guard<std::mutex> lk(mu_);
    phase_ = kServing;
    ++serve_gen_;
    fetch_barriers_ = 0;
    cv_.notify_all();
  }

  std::unique_ptr<VarBlob> PopAsync(int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
          return stopped_ || !async_q_.empty();
        }))
      return nullptr;
    if (async_q_.empty()) return nullptr;
    auto v = std::move(async_q_.front());
    async_q_.pop_front();
    return v;
  }

  bool PollNotify(std::string* out, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
          return stopped_ || !notify_q_.empty();
        }))
      return false;
    if (notify_q_.empty()) return false;
    *out = std::move(notify_q_.front());
    notify_q_.pop_front();
    return true;
  }

  int ActiveTrainers() {
    std::lock_guard<std::mutex> lk(mu_);
    return active_;
  }

  bool PopTrace(std::string* out) {
    std::lock_guard<std::mutex> lk(mu_);
    if (trace_q_.empty()) return false;
    *out = std::move(trace_q_.front());
    trace_q_.pop_front();
    return true;
  }

 private:
  void AcceptLoop() {
    while (!stopped_) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lk(mu_);
      conn_fds_.push_back(fd);
      conn_threads_.emplace_back([this, fd] { ConnLoop(fd); });
    }
  }

  void ConnLoop(int fd) {
    int trainer_id = -1;
    // last serve generation this connection consumed: a GET waits for a
    // serve window NEWER than its last fetch_barrier, not for the phase —
    // the phase can flip back to kReceiving early when another trainer
    // sends kComplete mid-window (would deadlock a phase-gated GET)
    int64_t my_gen = 0;
    for (;;) {
      uint8_t type;
      if (!ReadFull(fd, &type, 1)) break;
      switch (type) {
        case kHello: {
          uint32_t tid;
          if (!ReadFull(fd, &tid, 4)) return;
          trainer_id = static_cast<int>(tid);
          if (!Ack(fd)) return;
          break;
        }
        case kSendVar: {
          auto v = std::make_unique<VarBlob>();
          if (!ReadString(fd, &v->name) || !ReadVarPayload(fd, v.get())) return;
          v->trainer_id = trainer_id;
          {
            std::lock_guard<std::mutex> lk(mu_);
            if (sync_)
              recv_.push_back(std::move(v));
            else
              async_q_.push_back(std::move(v));
            cv_.notify_all();
          }
          if (!Ack(fd)) return;
          break;
        }
        case kGetVar: {
          std::string name;
          if (!ReadString(fd, &name)) return;
          // optional trace metadata rides the name after a 0x1f
          // separator ("name\x1ft=<trace>,s=<span>"): strip it before
          // the store lookup and log the request so the host runtime
          // can link a server-side get_var span to the calling
          // trainer's trace (distributed/rpc.py drains the log)
          std::string trace_meta;
          size_t sep = name.find('\x1f');
          if (sep != std::string::npos) {
            trace_meta = name.substr(sep + 1);
            name.resize(sep);
          }
          std::shared_ptr<VarBlob> v;
          {
            std::unique_lock<std::mutex> lk(mu_);
            if (sync_)
              cv_.wait(lk, [&] {
                return stopped_ ||
                       (serve_gen_ > my_gen && phase_ != kUpdating);
              });
            auto it = store_.find(name);
            v = it == store_.end() ? nullptr : it->second;
            if (!trace_meta.empty() && trace_q_.size() < 1024)
              trace_q_.push_back(name + '\x1f' + trace_meta + '\x1f' +
                                 std::to_string(trainer_id));
          }
          uint8_t ok = v != nullptr;
          if (!WriteFull(fd, &ok, 1)) return;
          if (v && !WriteVarPayload(fd, *v)) return;
          break;
        }
        case kPrefetch: {
          std::string name;
          int64_t n_ids;
          if (!ReadString(fd, &name) || !ReadFull(fd, &n_ids, 8)) return;
          std::vector<int64_t> ids(n_ids);
          if (n_ids && !ReadFull(fd, ids.data(), 8 * n_ids)) return;
          VarBlob rows;
          uint8_t ok = 0;
          {
            std::unique_lock<std::mutex> lk(mu_);
            if (sync_)
              cv_.wait(lk, [&] { return stopped_ || phase_ != kUpdating; });
            auto it = store_.find(name);
            if (it != store_.end() && it->second->dims.size() == 2) {
              const VarBlob& t = *it->second;
              size_t width = static_cast<size_t>(t.dims[1]) * DtypeSize(t.dtype);
              rows.dtype = t.dtype;
              rows.dims = {n_ids, t.dims[1]};
              rows.data.resize(width * n_ids);
              for (int64_t i = 0; i < n_ids; ++i) {
                int64_t r = ids[i];
                if (r >= 0 && r < t.dims[0])
                  std::memcpy(rows.data.data() + i * width,
                              t.data.data() + r * width, width);
                else
                  std::memset(rows.data.data() + i * width, 0, width);
              }
              ok = 1;
            }
          }
          if (!WriteFull(fd, &ok, 1)) return;
          if (ok && !WriteVarPayload(fd, rows)) return;
          break;
        }
        case kSendBarrier: {
          {
            std::lock_guard<std::mutex> lk(mu_);
            if (sync_) {
              ++send_barriers_;
              cv_.notify_all();
            }
          }
          if (!Ack(fd)) return;
          break;
        }
        case kFetchBarrier: {
          {
            std::lock_guard<std::mutex> lk(mu_);
            if (sync_) {
              my_gen = serve_gen_;  // this serve window is consumed
              ++fetch_barriers_;
              if (fetch_barriers_ >= active_ && phase_ == kServing) {
                phase_ = kReceiving;
                fetch_barriers_ = 0;
              }
              cv_.notify_all();
            }
          }
          if (!Ack(fd)) return;
          break;
        }
        case kComplete: {
          {
            std::lock_guard<std::mutex> lk(mu_);
            --active_;
            if (sync_ && fetch_barriers_ >= active_ && phase_ == kServing) {
              phase_ = kReceiving;
              fetch_barriers_ = 0;
            }
            cv_.notify_all();
          }
          if (!Ack(fd)) return;
          break;
        }
        case kCheckpoint: {
          std::string dir;
          if (!ReadString(fd, &dir)) return;
          {
            std::lock_guard<std::mutex> lk(mu_);
            notify_q_.push_back(std::move(dir));
            cv_.notify_all();
          }
          if (!Ack(fd)) return;
          break;
        }
        default:
          return;
      }
    }
  }

  bool Ack(int fd) {
    uint8_t ok = 1;
    return WriteFull(fd, &ok, 1);
  }

  int listen_fd_ = -1;
  int port_ = -1;
  int num_trainers_;
  int active_;
  bool sync_;
  std::atomic<bool> stopped_{false};
  std::thread accept_thread_;
  std::vector<std::thread> conn_threads_;
  std::vector<int> conn_fds_;

  std::mutex mu_;
  std::condition_variable cv_;
  Phase phase_ = kReceiving;
  int64_t serve_gen_ = 0;
  int send_barriers_ = 0;
  int fetch_barriers_ = 0;
  std::map<std::string, std::shared_ptr<VarBlob>> store_;
  std::vector<std::unique_ptr<VarBlob>> recv_;
  std::deque<std::unique_ptr<VarBlob>> async_q_;
  std::deque<std::string> notify_q_;
  std::deque<std::string> trace_q_;  // "name\x1fmeta\x1ftrainer" get log
};

// ---- client ---------------------------------------------------------------

class PSClient {
 public:
  PSClient(const std::string& host, int port, int trainer_id)
      : host_(host), port_(port), trainer_id_(trainer_id) {}

  ~PSClient() {
    if (fd_ >= 0) ::close(fd_);
  }

  bool EnsureConnected() {
    std::lock_guard<std::mutex> lk(mu_);
    return ConnectLocked();
  }

  bool SendVar(const VarBlob& v) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!ConnectLocked()) return false;
    uint8_t t = kSendVar;
    if (!WriteFull(fd_, &t, 1) || !WriteString(fd_, v.name) ||
        !WriteVarPayload(fd_, v))
      return false;
    return ReadAck();
  }

  std::unique_ptr<VarBlob> GetVar(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!ConnectLocked()) return nullptr;
    uint8_t t = kGetVar;
    if (!WriteFull(fd_, &t, 1) || !WriteString(fd_, name)) return nullptr;
    uint8_t ok;
    if (!ReadFull(fd_, &ok, 1) || !ok) return nullptr;
    auto v = std::make_unique<VarBlob>();
    v->name = name;
    if (!ReadVarPayload(fd_, v.get())) return nullptr;
    return v;
  }

  std::unique_ptr<VarBlob> Prefetch(const std::string& table,
                                    const int64_t* ids, int64_t n) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!ConnectLocked()) return nullptr;
    uint8_t t = kPrefetch;
    if (!WriteFull(fd_, &t, 1) || !WriteString(fd_, table) ||
        !WriteFull(fd_, &n, 8) || (n && !WriteFull(fd_, ids, 8 * n)))
      return nullptr;
    uint8_t ok;
    if (!ReadFull(fd_, &ok, 1) || !ok) return nullptr;
    auto v = std::make_unique<VarBlob>();
    v->name = table;
    if (!ReadVarPayload(fd_, v.get())) return nullptr;
    return v;
  }

  bool Simple(uint8_t type) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!ConnectLocked()) return false;
    if (!WriteFull(fd_, &type, 1)) return false;
    return ReadAck();
  }

  bool Checkpoint(const std::string& dir) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!ConnectLocked()) return false;
    uint8_t t = kCheckpoint;
    if (!WriteFull(fd_, &t, 1) || !WriteString(fd_, dir)) return false;
    return ReadAck();
  }

 private:
  static int DeadlineMs() {
    // FLAGS_rpc_deadline analog (grpc_client.cc retry logic): how long
    // a trainer keeps re-trying to reach a pserver before the RPC
    // fails. Default 60s covers pserver-after-trainer startup; fault
    // tests shrink it so a killed pserver surfaces fast.
    static int ms = [] {
      const char* env = ::getenv("PADDLE_TPU_RPC_DEADLINE_MS");
      int v = env ? ::atoi(env) : 60000;
      return v > 0 ? v : 60000;
    }();
    return ms;
  }

  bool ConnectLocked() {
    if (fd_ >= 0) return true;
    // the pserver process may come up after the trainer: retry until
    // the deadline (100 ms per attempt)
    const int max_attempts = DeadlineMs() / 100 + 1;
    for (int attempt = 0; attempt < max_attempts; ++attempt) {
      int fd = ::socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_port = htons(static_cast<uint16_t>(port_));
      if (::inet_pton(AF_INET, host_.c_str(), &addr.sin_addr) != 1)
        ::inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
      if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        uint8_t t = kHello;
        uint32_t tid = static_cast<uint32_t>(trainer_id_);
        if (WriteFull(fd, &t, 1) && WriteFull(fd, &tid, 4)) {
          uint8_t ok;
          if (ReadFull(fd, &ok, 1) && ok) {
            fd_ = fd;
            return true;
          }
        }
      }
      ::close(fd);
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
    }
    return false;
  }

  bool ReadAck() {
    uint8_t ok;
    if (!ReadFull(fd_, &ok, 1)) {
      ::close(fd_);
      fd_ = -1;
      return false;
    }
    return ok;
  }

  std::string host_;
  int port_;
  int trainer_id_;
  int fd_ = -1;
  std::mutex mu_;
};

struct GradBatch {
  std::vector<std::unique_ptr<VarBlob>> vars;
};

}  // namespace

// ---- C API ----------------------------------------------------------------

extern "C" {

void* ps_server_create(int port, int num_trainers, int sync) {
  auto* s = new PSServer(port, num_trainers, sync != 0);
  if (s->port() < 0) {
    delete s;
    return nullptr;
  }
  return s;
}
int ps_server_port(void* h) { return static_cast<PSServer*>(h)->port(); }
void ps_server_start(void* h) { static_cast<PSServer*>(h)->Start(); }
void ps_server_stop(void* h) { static_cast<PSServer*>(h)->Stop(); }
void ps_server_destroy(void* h) { delete static_cast<PSServer*>(h); }
int ps_server_active(void* h) {
  return static_cast<PSServer*>(h)->ActiveTrainers();
}

void ps_server_set_var(void* h, const char* name, int dtype, int ndim,
                       const int64_t* dims, const void* data) {
  VarBlob v;
  v.name = name;
  v.dtype = static_cast<uint8_t>(dtype);
  size_t n = 1;
  for (int i = 0; i < ndim; ++i) {
    v.dims.push_back(dims[i]);
    n *= static_cast<size_t>(dims[i]);
  }
  v.data.resize(n * DtypeSize(v.dtype));
  std::memcpy(v.data.data(), data, v.data.size());
  static_cast<PSServer*>(h)->SetVar(std::move(v));
}

int ps_server_var_meta(void* h, const char* name, int* dtype, int* ndim,
                       int64_t* dims8) {
  auto v = static_cast<PSServer*>(h)->ReadVar(name);
  if (!v) return 0;
  *dtype = v->dtype;
  *ndim = static_cast<int>(v->dims.size());
  for (size_t i = 0; i < v->dims.size() && i < 8; ++i) dims8[i] = v->dims[i];
  return 1;
}

int ps_server_read_var(void* h, const char* name, void* out, int64_t cap) {
  auto v = static_cast<PSServer*>(h)->ReadVar(name);
  if (!v || static_cast<int64_t>(v->data.size()) > cap) return 0;
  std::memcpy(out, v->data.data(), v->data.size());
  return 1;
}

void* ps_server_wait_grads(void* h) {
  auto* b = new GradBatch;
  b->vars = static_cast<PSServer*>(h)->WaitGrads();
  return b;
}
void ps_server_serve(void* h) { static_cast<PSServer*>(h)->Serve(); }

void* ps_server_pop_async(void* h, int timeout_ms) {
  auto v = static_cast<PSServer*>(h)->PopAsync(timeout_ms);
  if (!v) return nullptr;
  auto* b = new GradBatch;
  b->vars.push_back(std::move(v));
  return b;
}

int ps_server_poll_notify(void* h, char* out, int cap, int timeout_ms) {
  std::string dir;
  if (!static_cast<PSServer*>(h)->PollNotify(&dir, timeout_ms)) return 0;
  if (static_cast<int>(dir.size()) + 1 > cap) return 0;
  std::memcpy(out, dir.c_str(), dir.size() + 1);
  return 1;
}

int ps_server_pop_trace(void* h, char* out, int cap) {
  // drain ONE "name\x1fmeta\x1ftrainer" get-log entry (0 = empty);
  // non-blocking — the host runtime polls opportunistically
  std::string entry;
  if (!static_cast<PSServer*>(h)->PopTrace(&entry)) return 0;
  if (static_cast<int>(entry.size()) + 1 > cap) entry.resize(cap - 1);
  std::memcpy(out, entry.c_str(), entry.size() + 1);
  return 1;
}

int ps_batch_count(void* b) {
  return static_cast<int>(static_cast<GradBatch*>(b)->vars.size());
}
const char* ps_batch_name(void* b, int i) {
  return static_cast<GradBatch*>(b)->vars[i]->name.c_str();
}
int ps_batch_dtype(void* b, int i) {
  return static_cast<GradBatch*>(b)->vars[i]->dtype;
}
int ps_batch_ndim(void* b, int i) {
  return static_cast<int>(static_cast<GradBatch*>(b)->vars[i]->dims.size());
}
void ps_batch_dims(void* b, int i, int64_t* out) {
  const auto& d = static_cast<GradBatch*>(b)->vars[i]->dims;
  std::memcpy(out, d.data(), 8 * d.size());
}
int64_t ps_batch_nrows(void* b, int i) {
  return static_cast<GradBatch*>(b)->vars[i]->nrows;
}
const int64_t* ps_batch_rows(void* b, int i) {
  return static_cast<GradBatch*>(b)->vars[i]->rows.data();
}
const void* ps_batch_data(void* b, int i) {
  return static_cast<GradBatch*>(b)->vars[i]->data.data();
}
int64_t ps_batch_nbytes(void* b, int i) {
  return static_cast<int64_t>(static_cast<GradBatch*>(b)->vars[i]->data.size());
}
int ps_batch_trainer(void* b, int i) {
  return static_cast<GradBatch*>(b)->vars[i]->trainer_id;
}
void ps_batch_free(void* b) { delete static_cast<GradBatch*>(b); }

void* ps_client_create(const char* host, int port, int trainer_id) {
  return new PSClient(host, port, trainer_id);
}
void ps_client_destroy(void* h) { delete static_cast<PSClient*>(h); }
int ps_client_connect(void* h) {
  return static_cast<PSClient*>(h)->EnsureConnected();
}

int ps_client_send_var(void* h, const char* name, int dtype, int ndim,
                       const int64_t* dims, int64_t nrows, const int64_t* rows,
                       const void* data, int64_t nbytes) {
  VarBlob v;
  v.name = name;
  v.dtype = static_cast<uint8_t>(dtype);
  for (int i = 0; i < ndim; ++i) v.dims.push_back(dims[i]);
  v.nrows = nrows;
  if (nrows > 0) v.rows.assign(rows, rows + nrows);
  v.data.resize(nbytes);
  std::memcpy(v.data.data(), data, nbytes);
  return static_cast<PSClient*>(h)->SendVar(v);
}

// GET/PREFETCH return a blob handle read out via ps_batch_* on a 1-elem batch
void* ps_client_get_var(void* h, const char* name) {
  auto v = static_cast<PSClient*>(h)->GetVar(name);
  if (!v) return nullptr;
  auto* b = new GradBatch;
  b->vars.push_back(std::move(v));
  return b;
}

void* ps_client_prefetch(void* h, const char* table, const int64_t* ids,
                         int64_t n) {
  auto v = static_cast<PSClient*>(h)->Prefetch(table, ids, n);
  if (!v) return nullptr;
  auto* b = new GradBatch;
  b->vars.push_back(std::move(v));
  return b;
}

int ps_client_send_barrier(void* h) {
  return static_cast<PSClient*>(h)->Simple(kSendBarrier);
}
int ps_client_fetch_barrier(void* h) {
  return static_cast<PSClient*>(h)->Simple(kFetchBarrier);
}
int ps_client_complete(void* h) {
  return static_cast<PSClient*>(h)->Simple(kComplete);
}
int ps_client_checkpoint(void* h, const char* dir) {
  return static_cast<PSClient*>(h)->Checkpoint(dir);
}

}  // extern "C"
