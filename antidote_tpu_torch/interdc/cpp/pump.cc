// Native inter-DC stream pump: one epoll thread owns every subscription
// socket, parses the length-prefixed frames, and queues complete frames
// for the Python control thread to drain.
//
// This is the receive half of the inter-DC data plane: kernel reads and
// frame assembly run in native code, off the interpreter lock, and the
// application drains whole messages in batches.  The send half stays on
// the publisher's sendall path (one syscall per frame already).
//
// Framing (interdc/tcp.py): 5-byte header = uint32 BE length (including
// the kind byte) + 1 kind byte, then (length-1) payload bytes.
//
// Backpressure: when the queue holds more than QUEUE_CAP frames the
// loop stops reading (sockets stay readable, TCP flow control pushes
// back on the publisher) — a bounded high-water mark.
//
// Built by antidote_tpu_torch/native_build.py (g++ with the pinned flags,
// the source sha embedded as ANTIDOTE_SRC_SHA, read by pump_src_sha()).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <errno.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

constexpr size_t QUEUE_CAP = 65536;

struct Conn {
    long tag;
    std::vector<uint8_t> buf;  // partial frame bytes
};

struct Frame {
    long tag;
    uint8_t kind;
    std::string payload;
};

struct Pump {
    int epfd = -1;
    int wakefd = -1;  // eventfd: add/stop notifications
    std::thread thr;
    std::atomic<bool> stop{false};

    std::mutex mu;
    std::condition_variable cv;
    std::deque<Frame> queue;
    std::unordered_map<int, Conn> conns;  // guarded by mu (adds vs loop)
    std::deque<int> pending_adds;

    void loop();
};

// Dropping a connection (EOF, read error, corrupt frame) queues a
// sentinel frame (kind=0, empty payload) carrying the subscription tag,
// so Python LEARNS of the drop and can log + resubscribe with backoff —
// a silent close would permanently stall replication from that
// publisher.
constexpr uint8_t K_CONN_DROP = 0;

void close_conn(Pump* p, int fd) {
    epoll_ctl(p->epfd, EPOLL_CTL_DEL, fd, nullptr);
    ::close(fd);
    long tag = -1;
    {
        std::lock_guard<std::mutex> g(p->mu);
        auto it = p->conns.find(fd);
        if (it != p->conns.end()) {
            tag = it->second.tag;
            p->conns.erase(it);
        }
        if (tag >= 0) {
            Frame f;
            f.tag = tag;
            f.kind = K_CONN_DROP;
            p->queue.push_back(std::move(f));
        }
    }
    if (tag >= 0) p->cv.notify_one();
}

// parse complete frames out of c.buf, push to queue
void drain_buf(Pump* p, int fd, Conn& c) {
    size_t off = 0;
    for (;;) {
        if (c.buf.size() - off < 5) break;
        uint32_t n = (uint32_t(c.buf[off]) << 24) |
                     (uint32_t(c.buf[off + 1]) << 16) |
                     (uint32_t(c.buf[off + 2]) << 8) |
                     uint32_t(c.buf[off + 3]);
        if (n < 1 || n > (64u << 20)) {  // corrupt length: drop conn
            close_conn(p, fd);
            return;
        }
        if (c.buf.size() - off < 4 + n) break;
        Frame f;
        f.tag = c.tag;
        f.kind = c.buf[off + 4];
        f.payload.assign(reinterpret_cast<char*>(c.buf.data()) + off + 5,
                         n - 1);
        {
            std::lock_guard<std::mutex> g(p->mu);
            p->queue.push_back(std::move(f));
        }
        p->cv.notify_one();
        off += 4 + n;
    }
    if (off) c.buf.erase(c.buf.begin(), c.buf.begin() + off);
}

void Pump::loop() {
    epoll_event evs[64];
    uint8_t rdbuf[1 << 16];
    while (!stop.load(std::memory_order_relaxed)) {
        {   // register freshly added fds
            std::lock_guard<std::mutex> g(mu);
            while (!pending_adds.empty()) {
                int fd = pending_adds.front();
                pending_adds.pop_front();
                epoll_event ev{};
                ev.events = EPOLLIN;
                ev.data.fd = fd;
                epoll_ctl(epfd, EPOLL_CTL_ADD, fd, &ev);
            }
        }
        {   // backpressure: let TCP push back while Python catches up
            std::unique_lock<std::mutex> g(mu);
            if (queue.size() > QUEUE_CAP) {
                g.unlock();
                std::this_thread::sleep_for(std::chrono::milliseconds(1));
                continue;
            }
        }
        int nev = epoll_wait(epfd, evs, 64, 100);
        if (nev < 0) {
            if (errno == EINTR) continue;
            break;
        }
        for (int i = 0; i < nev; i++) {
            int fd = evs[i].data.fd;
            if (fd == wakefd) {
                uint64_t x;
                (void)!read(wakefd, &x, sizeof(x));
                continue;
            }
            Conn* c;
            {
                std::lock_guard<std::mutex> g(mu);
                auto it = conns.find(fd);
                if (it == conns.end()) continue;
                c = &it->second;
            }
            bool eof = false;
            for (;;) {
                ssize_t r = ::recv(fd, rdbuf, sizeof(rdbuf), MSG_DONTWAIT);
                if (r > 0) {
                    c->buf.insert(c->buf.end(), rdbuf, rdbuf + r);
                    if (r < (ssize_t)sizeof(rdbuf)) break;
                } else if (r == 0) {
                    eof = true;
                    break;
                } else {
                    if (errno == EAGAIN || errno == EWOULDBLOCK) break;
                    if (errno == EINTR) continue;
                    eof = true;
                    break;
                }
            }
            // deliver complete frames ALREADY received before acting on
            // EOF — the stream's last frames must not die in the buffer
            drain_buf(this, fd, *c);
            {
                std::lock_guard<std::mutex> g(mu);
                if (conns.find(fd) == conns.end()) continue;
            }
            if (eof) close_conn(this, fd);
        }
    }
}

}  // namespace

extern "C" {

void* pump_new() {
    auto* p = new Pump();
    p->epfd = epoll_create1(0);
    p->wakefd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = p->wakefd;
    if (p->epfd < 0 || p->wakefd < 0
        || epoll_ctl(p->epfd, EPOLL_CTL_ADD, p->wakefd, &ev) < 0) {
        // syscall failure (fd exhaustion, seccomp): report it so the
        // caller refuses to start instead of blackholing every
        // subscription handed to a dead loop
        if (p->epfd >= 0) ::close(p->epfd);
        if (p->wakefd >= 0) ::close(p->wakefd);
        delete p;
        return nullptr;
    }
    p->thr = std::thread([p] { p->loop(); });
    return p;
}

// takes OWNERSHIP of fd (caller must have detached it)
int pump_add(void* h, int fd, long tag) {
    auto* p = static_cast<Pump*>(h);
    {
        std::lock_guard<std::mutex> g(p->mu);
        p->conns[fd] = Conn{tag, {}};
        p->pending_adds.push_back(fd);
    }
    uint64_t one = 1;
    (void)!write(p->wakefd, &one, sizeof(one));
    return 0;
}

// drain one frame: returns payload length (>=0) and sets *tag/*kind;
// -1 = nothing within timeout_ms; -2 = payload larger than cap (frame
// stays queued; call again with a bigger buffer of *len_out bytes)
long pump_take(void* h, char* out, long cap, long* tag_out, int* kind_out,
               long* len_out, int timeout_ms) {
    auto* p = static_cast<Pump*>(h);
    std::unique_lock<std::mutex> g(p->mu);
    if (p->queue.empty()) {
        p->cv.wait_for(g, std::chrono::milliseconds(timeout_ms),
                       [p] { return !p->queue.empty(); });
        if (p->queue.empty()) return -1;
    }
    Frame& f = p->queue.front();
    *tag_out = f.tag;
    *kind_out = f.kind;
    *len_out = (long)f.payload.size();
    if ((long)f.payload.size() > cap) return -2;
    memcpy(out, f.payload.data(), f.payload.size());
    long n = (long)f.payload.size();
    p->queue.pop_front();
    return n;
}

// drain up to max_n frames in ONE crossing: payloads packed back to
// back into out, (tag, kind, len) triples into descs.  Returns the
// number of frames (0 after timeout), stopping early when the next
// frame would overflow cap (it stays queued for the next call).
long pump_take_batch(void* h, char* out, long cap, long* descs,
                     long max_n, int timeout_ms) {
    auto* p = static_cast<Pump*>(h);
    std::unique_lock<std::mutex> g(p->mu);
    if (p->queue.empty()) {
        p->cv.wait_for(g, std::chrono::milliseconds(timeout_ms),
                       [p] { return !p->queue.empty(); });
        if (p->queue.empty()) return 0;
    }
    long n = 0;
    long off = 0;
    while (n < max_n && !p->queue.empty()) {
        Frame& f = p->queue.front();
        if (off + (long)f.payload.size() > cap) break;
        memcpy(out + off, f.payload.data(), f.payload.size());
        descs[n * 3] = f.tag;
        descs[n * 3 + 1] = f.kind;
        descs[n * 3 + 2] = (long)f.payload.size();
        off += (long)f.payload.size();
        n++;
        p->queue.pop_front();
    }
    return n;
}

long pump_queued(void* h) {
    auto* p = static_cast<Pump*>(h);
    std::lock_guard<std::mutex> g(p->mu);
    return (long)p->queue.size();
}

void pump_free(void* h) {
    auto* p = static_cast<Pump*>(h);
    p->stop.store(true);
    uint64_t one = 1;
    (void)!write(p->wakefd, &one, sizeof(one));
    if (p->thr.joinable()) p->thr.join();
    std::vector<int> fds;
    {
        std::lock_guard<std::mutex> g(p->mu);
        for (auto& kv : p->conns) fds.push_back(kv.first);
        p->conns.clear();
        p->queue.clear();
    }
    for (int fd : fds) ::close(fd);
    ::close(p->wakefd);
    ::close(p->epfd);
    p->cv.notify_all();
    // The struct itself is deliberately quarantined (never deleted): a
    // concurrent pump()/take() on another thread may still be inside a
    // bounded cv wait on this handle, and freeing under it would be a
    // use-after-free.  One ~200-byte husk per fabric close, bounded by
    // fabric lifecycle count; the kernel resources above are released.
}

#ifndef ANTIDOTE_SRC_SHA
#define ANTIDOTE_SRC_SHA "unknown"
#endif

const char* pump_src_sha() { return ANTIDOTE_SRC_SHA; }

}  // extern "C"
