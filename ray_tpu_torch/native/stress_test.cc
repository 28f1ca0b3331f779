// Concurrency stress driver for the shared-memory object store and the
// serve dispatch ring.
//
// The port's copy of ray_tpu/native/stress_test.cc, against the port's
// own shm_store.cc and request_ring.cc, with the port's segment names
// (/ray_tpu_torch_stress_<pid>*, or a prefix given as the argument). Reference test strategy: the reference runs
// its C++ unit tests under TSAN/ASAN bazel configs (SURVEY.md §5 "race
// detection / sanitizers"). N threads hammer one store with
// create/seal/get/release/delete plus LRU-eviction pressure (objects are
// sized so the arena wraps several times). Three phases:
//
//   1. single-shard (auto-degraded small arena): the v1 shape — global
//      LRU, one index stripe, one free list.
//   2. forced 8-way sharding on the same small arena: hammers the
//      sharded create/seal/evict paths, the lock-free contains/release
//      probes, cross-shard eviction sweeps, and the all-region-locks
//      spanning allocator (every 64th object is bigger than one region).
//   3. the request ring at the slot size the port gives a GPT-2
//      deployment (a 1024-token prompt's frame, 4112 bytes), with
//      payloads from 96 bytes up to a full slot.
//
// Build from ray_tpu_torch/native with
//   g++ -O1 -g -std=c++17 -fsanitize=thread -fno-omit-frame-pointer \
//     -o build/stress_tsan shm_store.cc request_ring.cc stress_test.cc \
//     -lpthread -lrt
// (or -fsanitize=address) and run; a clean exit under the sanitizer is
// the pass condition (tests/test_torch_native_sanitize.py builds and
// runs both).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

extern "C" {
int ss_create_store(const char* name, uint64_t capacity, uint32_t table_cap,
                    uint32_t num_shards);
int64_t ss_create(int handle, const uint8_t* id, uint64_t size);
int ss_seal(int handle, const uint8_t* id);
int64_t ss_get(int handle, const uint8_t* id, uint64_t* size, double timeout);
int ss_contains(int handle, const uint8_t* id);
int ss_release(int handle, const uint8_t* id);
int ss_delete(int handle, const uint8_t* id);
uint64_t ss_evict(int handle, uint64_t nbytes);
int ss_detach(int handle);
int ss_unlink_store(const char* name);
uint64_t ss_data_offset(int handle);
uint64_t ss_map_size(int handle);
void ss_stats2(int handle, uint64_t* capacity, uint64_t* allocated,
               uint32_t* num_objects, uint64_t* referenced,
               uint64_t* lock_wait_ns, uint64_t* lock_contended,
               uint64_t* evicted_objects);
uint32_t ss_num_shards(int handle);
int ss_shard_stats(int handle, uint32_t shard, uint64_t* out);

// dispatch plane v2 (request_ring.cc)
int rr_open(const char* name, uint32_t table_cap, uint32_t slots,
            uint32_t slot_bytes);
int rr_detach(int h);
int rr_unlink(const char* name);
int rr_publish(int h, uint64_t version, const uint64_t* ids, uint32_t n);
int rr_mark_dead(int h, uint64_t id);
int rr_done(int h, uint64_t id, uint32_t gen);
int64_t rr_enqueue(int h, const uint8_t* payload, uint32_t len,
                   uint64_t deadline_ns, uint64_t client, uint32_t tag,
                   uint64_t* trace_out, uint64_t* rid_out,
                   uint32_t* gen_out);
int64_t rr_drain(int h, uint32_t ring, uint8_t* out, uint64_t cap,
                 uint32_t max_frames, uint64_t* nbytes_out);
int64_t rr_pending(int h, uint32_t ring);
void rr_stats(int h, uint64_t* out);
int rr_snapshot(int h, uint64_t* out, uint32_t cap_rows, uint64_t* ver_out);
uint32_t rr_table_cap(int h);
}

namespace {

constexpr int kThreads = 8;
constexpr int kItersPerThread = 2000;
constexpr uint64_t kObjectSize = 64 * 1024;
// arena holds ~32 objects; 8 threads x 2000 iterations wrap it ~500x
constexpr uint64_t kCapacity = 2 * 1024 * 1024;
// in the sharded phase (8 regions of 256 KB) this forces the spanning
// (all-region-locks) allocation path
constexpr uint64_t kBigObjectSize = 512 * 1024;

void make_id(uint8_t* id, int thread, int i) {
  std::memset(id, 0, 16);
  std::memcpy(id, &thread, sizeof(thread));
  std::memcpy(id + 4, &i, sizeof(i));
}

std::atomic<int> failures{0};

uint8_t* g_base = nullptr;

void worker(int handle, int thread, bool sharded) {
  uint8_t* base = g_base;
  uint64_t data_off = ss_data_offset(handle);
  uint8_t id[16];
  for (int i = 0; i < kItersPerThread; ++i) {
    make_id(id, thread, i);
    uint64_t want =
        (sharded && i % 64 == 0) ? kBigObjectSize : kObjectSize;
    int64_t off = ss_create(handle, id, want);
    if (off < 0) continue;  // full under pressure: acceptable
    std::memset(base + data_off + off, thread & 0xff, want);
    ss_seal(handle, id);
    ss_release(handle, id);

    // read back a recent object from another thread (may have been
    // evicted — both outcomes are legal, racing reads must be clean)
    uint8_t other[16];
    make_id(other, (thread + 1) % kThreads, i);
    uint64_t size = 0;
    int64_t got = ss_get(handle, other, &size, -1.0);
    if (got >= 0) {
      volatile uint8_t sink = base[data_off + got];
      (void)sink;
      if (size != kObjectSize && size != kBigObjectSize)
        failures.fetch_add(1);
      ss_release(handle, other);
    }
    // lock-free probes racing create/seal/evict on other threads' ids
    make_id(other, (thread + 3) % kThreads, i);
    (void)ss_contains(handle, other);
    if (i % 5 == 0) ss_release(handle, other);  // stale/absent: must be safe
    if (i % 16 == 0) ss_evict(handle, kObjectSize);
    if (i % 7 == 0) {
      make_id(other, thread, i / 2);
      ss_delete(handle, other);
    }
    if (i % 128 == 0) {  // stats readers racing the data plane
      uint64_t cap, alloc, ref, wait, cont, evd;
      uint32_t n;
      ss_stats2(handle, &cap, &alloc, &n, &ref, &wait, &cont, &evd);
      uint64_t row[8];
      for (uint32_t sh = 0; sh < ss_num_shards(handle); ++sh)
        ss_shard_stats(handle, sh, row);
    }
  }
}

int run_phase(const char* name, uint32_t num_shards, const char* label) {
  ss_unlink_store(name);
  int handle = ss_create_store(name, kCapacity, 4096, num_shards);
  if (handle < 0) {
    std::fprintf(stderr, "create_store(%s) failed\n", label);
    return 1;
  }
  // the store mmaps internally but does not export its base; map the
  // same shm object for the test's data reads/writes
  int fd = shm_open(name, O_RDWR, 0600);
  g_base = static_cast<uint8_t*>(mmap(nullptr, ss_map_size(handle),
                                      PROT_READ | PROT_WRITE, MAP_SHARED,
                                      fd, 0));
  close(fd);
  if (g_base == MAP_FAILED) {
    std::fprintf(stderr, "mmap(%s) failed\n", label);
    return 1;
  }
  bool sharded = ss_num_shards(handle) > 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back(worker, handle, t, sharded);
  }
  for (auto& th : threads) th.join();
  void* mapped = g_base;
  uint64_t mapped_size = ss_map_size(handle);
  ss_detach(handle);
  munmap(mapped, mapped_size);
  ss_unlink_store(name);
  if (failures.load() != 0) {
    std::fprintf(stderr, "corruption (%s): %d bad sizes\n", label,
                 failures.load());
    return 2;
  }
  std::printf("stress OK (%s): %d threads x %d iterations\n", label,
              kThreads, kItersPerThread);
  return 0;
}

// ---------------------------------------------------------------------
// request-ring phase: producers race rr_enqueue against batch-draining
// consumers while a chaos thread churns the replica snapshot
// (publish/mark_dead/stale dones). Pass conditions: no torn frames
// (payload bytes uniform), drained == successful enqueues (no frame
// lost or duplicated across version bumps), and the snapshot's
// in-flight counters balance to zero at quiesce.

struct RRFrameHdr {  // mirrors FrameHdr in request_ring.cc (56 bytes)
  uint64_t trace, rid, deadline_ns, enq_ns, client;
  uint32_t gen, tag, len, pad;
};
static_assert(sizeof(RRFrameHdr) == 56, "frame header ABI drift");

constexpr int kRRProducers = 6;
constexpr int kRRItersPerProducer = 4000;
constexpr uint32_t kRRTableCap = 4;
// serve/dispatch.py request_slot_bytes(1024): a 16-byte serve.llm
// header and 4 bytes per prompt token of GPT-2's 1024
constexpr uint32_t kRRSlotBytes = 4112;
constexpr uint32_t kRRMinPayload = 96;

std::atomic<uint64_t> rr_enq_ok{0};
std::atomic<uint64_t> rr_enq_rej{0};
std::atomic<uint64_t> rr_drained{0};
std::atomic<uint64_t> rr_torn{0};
std::atomic<bool> rr_producers_done{false};
std::atomic<bool> rr_chaos_stop{false};

void rr_producer(int h, int t) {
  std::vector<uint8_t> payload(kRRSlotBytes);
  for (int i = 0; i < kRRItersPerProducer; ++i) {
    // sizes cycle from kRRMinPayload to a full slot
    uint32_t len = kRRMinPayload +
        (uint32_t)((t * 977 + i * 131) % (kRRSlotBytes - kRRMinPayload + 1));
    std::memset(payload.data(), (uint8_t)((t * 131 + i) & 0xff), len);
    uint64_t trace = 0, rid = 0;
    uint32_t gen = 0;
    int64_t rc = rr_enqueue(h, payload.data(), len, 0, 0, 0,
                            &trace, &rid, &gen);
    if (rc >= 0)
      rr_enq_ok.fetch_add(1);
    else
      rr_enq_rej.fetch_add(1);  // FULL/NO_REPLICA under churn: legal
  }
}

void rr_consumer(int h, uint32_t ring0, uint32_t nrings) {
  std::vector<uint8_t> buf(64 * (sizeof(RRFrameHdr) + kRRSlotBytes));
  uint64_t nbytes = 0;
  while (true) {
    bool any = false;
    for (uint32_t r = ring0; r < ring0 + nrings; ++r) {
      int64_t n = rr_drain(h, r, buf.data(), buf.size(), 64, &nbytes);
      if (n <= 0) continue;
      any = true;
      uint64_t off = 0;
      for (int64_t k = 0; k < n; ++k) {
        RRFrameHdr hd;
        std::memcpy(&hd, buf.data() + off, sizeof(hd));
        off += sizeof(hd);
        const uint8_t* p = buf.data() + off;
        for (uint32_t b = 1; b < hd.len; ++b) {
          if (p[b] != p[0]) {
            rr_torn.fetch_add(1);
            break;
          }
        }
        off += hd.len;
        rr_done(h, hd.rid, hd.gen);  // stale after retire: dropped
        rr_drained.fetch_add(1);
      }
    }
    if (!any) {
      if (rr_producers_done.load()) {
        bool empty = true;  // exit only after the final sweep drains dry
        for (uint32_t r = ring0; r < ring0 + nrings; ++r)
          if (rr_pending(h, r) > 0) empty = false;
        if (empty) return;
      }
      std::this_thread::yield();
    }
  }
}

void rr_chaos(int h) {
  const uint64_t ids[8] = {11, 22, 33, 44, 55, 66, 77, 88};
  uint64_t version = 2;
  unsigned r = 12345;
  while (!rr_chaos_stop.load()) {
    r = r * 1664525u + 1013904223u;
    uint64_t set[kRRTableCap];
    uint32_t base = (r >> 8) & 7;  // rotating window: ids stay distinct
    for (uint32_t k = 0; k < kRRTableCap; ++k)
      set[k] = ids[(base + k) & 7];
    rr_publish(h, version++, set, kRRTableCap);
    r = r * 1664525u + 1013904223u;
    rr_mark_dead(h, ids[(r >> 16) & 7]);
    rr_done(h, ids[(r >> 20) & 7], 1);  // stale gen: must be a no-op
    uint64_t rows[5 * kRRTableCap];
    uint64_t ver = 0;
    rr_snapshot(h, rows, kRRTableCap, &ver);
    uint64_t stats[12];
    rr_stats(h, stats);
    std::this_thread::yield();
  }
}

int rr_run_phase(const char* name, const char* label) {
  rr_unlink(name);
  int h = rr_open(name, kRRTableCap, 256, kRRSlotBytes);
  if (h < 0) {
    std::fprintf(stderr, "rr_open(%s) failed\n", label);
    return 1;
  }
  const uint64_t initial[kRRTableCap] = {11, 22, 33, 44};
  rr_publish(h, 1, initial, kRRTableCap);
  std::vector<std::thread> threads;
  threads.emplace_back(rr_chaos, h);
  threads.emplace_back(rr_consumer, h, 0u, 2u);
  threads.emplace_back(rr_consumer, h, 2u, 2u);
  std::vector<std::thread> producers;
  for (int t = 0; t < kRRProducers; ++t)
    producers.emplace_back(rr_producer, h, t);
  for (auto& th : producers) th.join();
  rr_chaos_stop.store(true);
  threads[0].join();
  rr_producers_done.store(true);
  threads[1].join();
  threads[2].join();
  int rc = 0;
  if (rr_torn.load() != 0) {
    std::fprintf(stderr, "torn frames (%s): %lu\n", label,
                 (unsigned long)rr_torn.load());
    rc = 2;
  }
  if (rr_drained.load() != rr_enq_ok.load()) {
    std::fprintf(stderr, "frame leak (%s): enq_ok=%lu drained=%lu\n",
                 label, (unsigned long)rr_enq_ok.load(),
                 (unsigned long)rr_drained.load());
    rc = 2;
  }
  uint64_t rows[5 * kRRTableCap];
  uint64_t ver = 0;
  int n = rr_snapshot(h, rows, kRRTableCap, &ver);
  uint64_t inflight = 0;
  for (int i = 0; i < n; ++i)
    if (rows[i * 5 + 3]) inflight += rows[i * 5 + 2];
  if (inflight != 0) {
    std::fprintf(stderr, "inflight imbalance (%s): %lu at quiesce\n",
                 label, (unsigned long)inflight);
    rc = 2;
  }
  rr_detach(h);
  rr_unlink(name);
  if (rc == 0)
    std::printf("stress OK (%s): %d producers x %d iterations, "
                "%lu drained, %lu shed\n",
                label, kRRProducers, kRRItersPerProducer,
                (unsigned long)rr_drained.load(),
                (unsigned long)rr_enq_rej.load());
  return rc;
}

}  // namespace

// argv[1], if given, is the segments' name prefix; else
// /ray_tpu_torch_stress_<pid>, so that runs at the same time (two
// sanitizers, two checkouts on one host) never share a segment.
int main(int argc, char** argv) {
  char prefix[96];
  if (argc > 1)
    std::snprintf(prefix, sizeof(prefix), "%s", argv[1]);
  else
    std::snprintf(prefix, sizeof(prefix), "/ray_tpu_torch_stress_%d",
                  (int)getpid());
  char name[128];
  std::snprintf(name, sizeof(name), "%s", prefix);
  int rc = run_phase(name, 0, "single-shard");
  if (rc != 0) return rc;
  std::snprintf(name, sizeof(name), "%s_sharded", prefix);
  rc = run_phase(name, 8, "sharded");
  if (rc != 0) return rc;
  std::snprintf(name, sizeof(name), "%s_ring", prefix);
  rc = rr_run_phase(name, "request-ring");
  if (rc != 0) return rc;
  return 0;
}
