// shm_store.cc — per-node shared-memory immutable object store (v2: sharded).
//
// TPU-native equivalent of the reference's plasma store
// (src/ray/object_manager/plasma/{store.h,object_lifecycle_manager.h,
// plasma_allocator.h,eviction_policy.h}), redesigned for simplicity:
// instead of a store *server* process speaking a unix-socket flatbuffer
// protocol with fd passing, every process on the node maps one shared
// memory arena and manipulates the object index directly. Object
// creation/sealing/getting are plain in-memory operations — no RPC in
// the data path at all. The raylet owns the arena lifecycle; workers
// attach.
//
// v2 concurrency design (multi-client scaling): the v1 single
// process-shared mutex serialized every create/seal/get/evict across
// all writer processes. v2 splits it three ways, mirroring the
// reference's tiny-index-critical-section plasma design (Moritz et al.,
// OSDI '18) with per-shard heaps à la Hoard (Berger et al., ASPLOS '00):
//
//   - Index shards: the slot table is striped into `num_shards`
//     independent sub-tables, each with its own robust pshared mutex,
//     its own LRU list, and its own lock-wait/eviction counters. An
//     object's id hash picks its shard; creates/seals/gets of objects
//     in different shards never contend.
//   - Per-shard free lists: the data region is partitioned into one
//     region per shard, each with its own allocator mutex + address-
//     ordered first-fit free list. A create allocates from its home
//     region first, then steals from others one lock at a time. A
//     request larger than any single region's free run takes ALL
//     region locks in ascending order and allocates from a temporarily
//     merged view (blocks are routed back by start address, so the
//     merged remainder re-splits cleanly).
//   - Lock-free reads: `ss_contains` probes with atomic slot-state
//     loads and takes no lock at all; `ss_release` decrements the
//     refcount with a generation-checked CAS (refcount and generation
//     share one 64-bit word), so readers dropping references never
//     touch a mutex.
//
// Lock hierarchy (strictly one-way, validated by the TSAN stress gate):
//   cv_mutex -> index shard mutex -> region alloc mutex
// The sealed-broadcast condvar stays global but is only hit by blocking
// gets: sealers check an atomic waiter count (SC-fenced against the
// waiter's count-then-probe) and skip the cv_mutex entirely when nobody
// is parked.
//
// Layout of the arena:
//   [ Header(+shard/region state) | Slot[table_cap] | data region ... ]
//
// - Eviction: LRU over sealed, refcount==0 objects per shard, triggered
//   automatically when a create fails; a create's eviction sweep only
//   locks the shards it actually touches.
// - Blocking get: process-shared condvar broadcast on seal when waiters
//   are parked.
//
// Build: g++ -O2 -shared -fPIC -o libshm_store.so shm_store.cc -lpthread -lrt

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <thread>
#include <utility>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52415953544f5245ULL;  // "RAYSTORE"
constexpr uint32_t kVersion = 4;  // v4: primary-copy hint in Slot::job
// High bit of Slot::job marks the primary copy (ownership GC's
// authoritative location); the low 31 bits remain the job row + 1.
constexpr uint32_t kPrimaryBit = 0x80000000u;
constexpr uint64_t kAlign = 64;
constexpr uint32_t kIdSize = 16;
constexpr uint32_t kMaxShards = 16;
constexpr uint32_t kMaxJobs = 32;
// A data region below this is not worth slicing further: objects are
// large, and tiny regions would push every big create onto the
// all-locks spanning path. Small (test) stores auto-degrade to one
// shard — i.e. exactly the v1 behavior, including global LRU order.
constexpr uint64_t kMinRegionBytes = 128ULL << 20;

// Slot states.
enum : uint32_t { EMPTY = 0, CREATED = 1, SEALED = 2, TOMB = 3 };

// Error codes (mirrored in the python wrapper).
enum : int64_t {
  SS_OK = 0,
  SS_EXISTS = -1,
  SS_NOT_FOUND = -2,
  SS_NO_MEMORY = -3,
  SS_TABLE_FULL = -4,
  SS_TIMEOUT = -5,
  SS_NOT_SEALED = -6,
  SS_SYS = -7,
  SS_BAD_HANDLE = -8,
  SS_QUOTA = -9,
};

struct Slot {
  uint8_t id[kIdSize];  // 8-aligned; lock-free probes read it as two u64s
  uint64_t offset;      // data offset relative to data region base
  uint64_t size;        // user-visible data size
  uint64_t alloc_size;  // actual bytes taken from the allocator (>= size)
  uint32_t state;       // atomic: lock-free probes read it
  // LRU doubly-linked list (per shard), values are slot_index + 1 (0 = nil).
  uint32_t lru_prev;
  uint32_t lru_next;
  // lo 31 bits: creator job slot + 1 (0 = untagged); hi bit: primary-copy
  // hint (v4) — set by the raylet that pinned this object as the
  // authoritative copy, cleared on replicas pulled from other nodes.
  // Shard-locked. The Slot is exactly one cache line with no spare
  // field, and kMaxJobs=32 needs only 6 bits, so the flag rides here.
  uint32_t job;
  // hi 32 bits: generation, bumped on every tombstone/reuse; lo 32:
  // refcount. One atomic word so the lock-free release can
  // decrement-iff-same-incarnation with a single CAS.
  uint64_t refgen;
};
static_assert(sizeof(Slot) == 64, "one cache line per slot");

// One index stripe: a sub-range of the slot table plus its LRU list.
struct ShardState {
  pthread_mutex_t mutex;
  uint32_t lru_head;  // most-recently-used, slot_index + 1 (global index)
  uint32_t lru_tail;  // least-recently-used
  uint32_t num_objects;
  uint32_t _pad0;
  // Contention instrumentation (read under the shard mutex).
  uint64_t lock_wait_ns;
  uint64_t lock_contended;
  uint64_t lock_acquisitions;
  uint64_t evicted_objects;
  uint64_t evicted_bytes;
  uint8_t _pad[128 - sizeof(pthread_mutex_t) - 16 - 40];
};
static_assert(sizeof(ShardState) == 128, "pad shards to two cache lines");

// One allocator region: a sub-range of the data area with its own free
// list. Free blocks are routed by START address, so the per-region
// lists stay address-ordered and concatenate into one global order.
struct RegionState {
  pthread_mutex_t mutex;
  uint64_t free_head;  // data-relative offset of first free block, kNil = nil
  uint64_t allocated;  // bytes handed out charged to this region
  uint64_t base;       // data-relative region start
  uint64_t size;       // region bytes (last region absorbs the remainder)
  uint64_t lock_wait_ns;
  uint64_t lock_contended;
  uint8_t _pad[128 - sizeof(pthread_mutex_t) - 48];
};
static_assert(sizeof(RegionState) == 128, "pad regions to two cache lines");

// Per-job accounting row (v3). The table is lock-free: rows are claimed
// by CAS on `key` (first 8 bytes of the job id, 0 = free) and all byte
// counters are atomic fetch-add/sub, so creators in different processes
// never serialize on a job mutex. `used` is RESERVED before allocation
// (fetch_add, refunded on failure) — the quota check and the reservation
// are one atomic RMW, not a read-then-write across a lock release.
struct JobState {
  uint64_t key;            // atomic: job key; 0 = row free
  uint64_t quota;          // byte quota; 0 = unlimited
  uint64_t used;           // atomic: bytes currently allocated by the job
  uint64_t evicted_bytes;  // atomic: bytes evicted from the job's objects
  uint64_t quota_rejects;  // atomic: creates rejected with SS_QUOTA
  uint64_t num_objects;    // atomic
  uint8_t _pad[16];
};
static_assert(sizeof(JobState) == 64, "one cache line per job row");

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t table_cap;  // slots in use (= shard_cap * num_shards)
  uint64_t capacity;   // data region bytes
  uint64_t data_off;   // offset of data region from arena base
  uint32_t num_shards;
  uint32_t shard_cap;      // slots per shard
  uint64_t region_quant;   // nominal bytes per region
  uint32_t cv_waiters;     // atomic: blocking gets currently parked
  uint32_t _pad0;
  pthread_mutex_t cv_mutex;
  pthread_cond_t sealed_cv;
  ShardState shards[kMaxShards];
  RegionState regions[kMaxShards];
  JobState jobs[kMaxJobs];
};

struct FreeBlock {
  uint64_t size;
  uint64_t next;  // data-relative offset of next free block, ~0 = nil
};

constexpr uint64_t kNil = ~0ULL;

struct Store {
  uint8_t* base = nullptr;
  uint64_t map_size = 0;
  Header* hdr = nullptr;
  Slot* slots = nullptr;
  uint8_t* data = nullptr;
  bool used = false;
};

constexpr int kMaxHandles = 64;
Store g_stores[kMaxHandles];

inline uint64_t align_up(uint64_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

inline FreeBlock* fb(Store* s, uint64_t off) {
  return reinterpret_cast<FreeBlock*>(s->data + off);
}

inline uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ULL +
         static_cast<uint64_t>(ts.tv_nsec);
}

// Robust lock with contention accounting: the counters are only written
// AFTER the lock is held (stats readers hold it too), so they need no
// atomics of their own.
void lock_timed(pthread_mutex_t* m, uint64_t* wait_ns, uint64_t* contended) {
  int rc = pthread_mutex_trylock(m);
  if (rc == 0) return;
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(m);
    return;
  }
  uint64_t t0 = now_ns();
  rc = pthread_mutex_lock(m);
  if (rc == EOWNERDEAD) {
    // A process died holding the lock; mutations are ordered so
    // partially-applied states are benign (worst case: a leaked
    // allocation, reclaimed by eviction).
    pthread_mutex_consistent(m);
  }
  *wait_ns += now_ns() - t0;
  *contended += 1;
}

class ShardGuard {
 public:
  ShardGuard(Store* s, uint32_t shard) : sh_(&s->hdr->shards[shard]) {
    lock_timed(&sh_->mutex, &sh_->lock_wait_ns, &sh_->lock_contended);
    sh_->lock_acquisitions++;
  }
  ~ShardGuard() { pthread_mutex_unlock(&sh_->mutex); }

 private:
  ShardState* sh_;
};

class RegionGuard {
 public:
  RegionGuard(Store* s, uint32_t region) : rg_(&s->hdr->regions[region]) {
    lock_timed(&rg_->mutex, &rg_->lock_wait_ns, &rg_->lock_contended);
  }
  ~RegionGuard() { pthread_mutex_unlock(&rg_->mutex); }

 private:
  RegionState* rg_;
};

uint64_t hash_id(const uint8_t* id) {
  uint64_t h;
  memcpy(&h, id, 8);
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  return h;
}

inline uint32_t shard_of(Store* s, const uint8_t* id) {
  // high hash bits pick the shard, low bits the in-shard slot — the two
  // must not be correlated or every shard collapses onto a few buckets
  return static_cast<uint32_t>((hash_id(id) >> 32) % s->hdr->num_shards);
}

// --- per-job accounting (v3) ---

// Resolve the job row for `key`, claiming a free row when `create`.
// Returns the row index, or -1 (key 0 / unknown / table full — the job
// runs untracked, which keeps an overfull job table degrading to v2
// semantics instead of failing creates).
int job_slot(Store* s, uint64_t key, bool create) {
  if (key == 0) return -1;
  Header* h = s->hdr;
  for (uint32_t i = 0; i < kMaxJobs; ++i) {
    uint64_t k = __atomic_load_n(&h->jobs[i].key, __ATOMIC_ACQUIRE);
    if (k == key) return static_cast<int>(i);
    if (k == 0) {
      if (!create) return -1;
      uint64_t expect = 0;
      if (__atomic_compare_exchange_n(&h->jobs[i].key, &expect, key, false,
                                      __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE))
        return static_cast<int>(i);
      if (expect == key) return static_cast<int>(i);  // lost a benign race
      // row claimed by a different key between load and CAS: keep scanning
    }
  }
  return -1;
}

// Charge an object's bytes off its creator job when it leaves the store
// (delete / abort / eviction). Caller holds the object's shard mutex, so
// sl->job is stable; the job counters themselves are atomic.
inline uint32_t job_row_of(const Slot* sl) { return sl->job & ~kPrimaryBit; }

inline void job_uncharge(Store* s, Slot* sl, bool evicted) {
  if (job_row_of(sl) == 0) { sl->job = 0; return; }
  JobState* j = &s->hdr->jobs[job_row_of(sl) - 1];
  __atomic_fetch_sub(&j->used, sl->alloc_size, __ATOMIC_ACQ_REL);
  __atomic_fetch_sub(&j->num_objects, 1, __ATOMIC_ACQ_REL);
  if (evicted)
    __atomic_fetch_add(&j->evicted_bytes, sl->alloc_size, __ATOMIC_ACQ_REL);
  sl->job = 0;
}

// --- atomic slot field access (lock-free probe side) ---

inline uint32_t ld_state(const Slot* sl) {
  return __atomic_load_n(&sl->state, __ATOMIC_ACQUIRE);
}

inline void st_state(Slot* sl, uint32_t v) {
  __atomic_store_n(&sl->state, v, __ATOMIC_RELEASE);
}

inline bool id_eq(const Slot* sl, const uint8_t* id) {
  // two aligned u64 atomic loads: a concurrent reuse can tear between
  // the words, but the refgen generation check (release) / state
  // re-read (contains) bounds the damage to an advisory stale answer
  uint64_t a = __atomic_load_n(
      reinterpret_cast<const uint64_t*>(sl->id), __ATOMIC_RELAXED);
  uint64_t b = __atomic_load_n(
      reinterpret_cast<const uint64_t*>(sl->id + 8), __ATOMIC_RELAXED);
  uint64_t qa, qb;
  memcpy(&qa, id, 8);
  memcpy(&qb, id + 8, 8);
  return a == qa && b == qb;
}

inline void id_store(Slot* sl, const uint8_t* id) {
  uint64_t qa, qb;
  memcpy(&qa, id, 8);
  memcpy(&qb, id + 8, 8);
  __atomic_store_n(reinterpret_cast<uint64_t*>(sl->id), qa, __ATOMIC_RELAXED);
  __atomic_store_n(reinterpret_cast<uint64_t*>(sl->id + 8), qb,
                   __ATOMIC_RELAXED);
}

inline Slot* shard_base(Store* s, uint32_t shard) {
  return s->slots + static_cast<uint64_t>(shard) * s->hdr->shard_cap;
}

// Find slot holding `id` within its shard; caller holds the shard mutex.
// If `insert_pos` is non-null, sets it to the first usable (EMPTY/TOMB)
// slot on the probe path.
Slot* find_slot(Store* s, uint32_t shard, const uint8_t* id,
                Slot** insert_pos = nullptr) {
  uint32_t cap = s->hdr->shard_cap;
  Slot* base = shard_base(s, shard);
  uint64_t idx = hash_id(id) % cap;
  Slot* first_free = nullptr;
  for (uint32_t probe = 0; probe < cap; ++probe) {
    Slot* sl = &base[(idx + probe) % cap];
    uint32_t st = __atomic_load_n(&sl->state, __ATOMIC_RELAXED);
    if (st == EMPTY) {
      if (insert_pos) *insert_pos = first_free ? first_free : sl;
      return nullptr;
    }
    if (st == TOMB) {
      if (!first_free) first_free = sl;
      continue;
    }
    if (memcmp(sl->id, id, kIdSize) == 0) return sl;
  }
  if (insert_pos) *insert_pos = first_free;
  return nullptr;
}

// Lock-free probe (contains/release): atomic state loads, advisory by
// construction — any answer it returns was true at some instant.
Slot* probe_lockfree(Store* s, uint32_t shard, const uint8_t* id) {
  uint32_t cap = s->hdr->shard_cap;
  Slot* base = shard_base(s, shard);
  uint64_t idx = hash_id(id) % cap;
  for (uint32_t probe = 0; probe < cap; ++probe) {
    Slot* sl = &base[(idx + probe) % cap];
    uint32_t st = ld_state(sl);
    if (st == EMPTY) return nullptr;
    if (st == TOMB) continue;
    if (id_eq(sl, id)) return sl;
  }
  return nullptr;
}

// --- LRU list (per shard; only sealed objects participate) ---

void lru_unlink(Store* s, ShardState* sh, Slot* sl) {
  uint32_t self = static_cast<uint32_t>(sl - s->slots) + 1;
  if (sl->lru_prev)
    s->slots[sl->lru_prev - 1].lru_next = sl->lru_next;
  else if (sh->lru_head == self)
    sh->lru_head = sl->lru_next;
  if (sl->lru_next)
    s->slots[sl->lru_next - 1].lru_prev = sl->lru_prev;
  else if (sh->lru_tail == self)
    sh->lru_tail = sl->lru_prev;
  sl->lru_prev = sl->lru_next = 0;
}

void lru_push_front(Store* s, ShardState* sh, Slot* sl) {
  uint32_t self = static_cast<uint32_t>(sl - s->slots) + 1;
  sl->lru_prev = 0;
  sl->lru_next = sh->lru_head;
  if (sh->lru_head) s->slots[sh->lru_head - 1].lru_prev = self;
  sh->lru_head = self;
  if (!sh->lru_tail) sh->lru_tail = self;
}

// --- allocator (per-region free lists) ---

inline uint32_t region_of(Store* s, uint64_t off) {
  uint64_t r = off / s->hdr->region_quant;
  uint32_t n = s->hdr->num_shards;
  return r >= n ? n - 1 : static_cast<uint32_t>(r);
}

// First-fit within one region; caller holds the region mutex. On
// success returns the block offset and sets *granted to the actual
// bytes consumed (the whole block when the remainder is too small to
// split — the caller must record this so the full block is returned on
// free).
int64_t alloc_in_region(Store* s, RegionState* rg, uint64_t want,
                        uint64_t* granted) {
  uint64_t prev = kNil;
  uint64_t cur = rg->free_head;
  while (cur != kNil) {
    FreeBlock* blk = fb(s, cur);
    if (blk->size >= want) {
      uint64_t remain = blk->size - want;
      if (remain >= kAlign + sizeof(FreeBlock)) {
        uint64_t rest = cur + want;
        FreeBlock* rb = fb(s, rest);
        rb->size = remain;
        rb->next = blk->next;
        if (prev == kNil) rg->free_head = rest; else fb(s, prev)->next = rest;
      } else {
        if (prev == kNil) rg->free_head = blk->next;
        else fb(s, prev)->next = blk->next;
        want = blk->size;
      }
      rg->allocated += want;
      *granted = want;
      return static_cast<int64_t>(cur);
    }
    prev = cur;
    cur = blk->next;
  }
  return SS_NO_MEMORY;
}

// Address-ordered insert with neighbor coalescing; caller holds the
// region mutex. Blocks are routed here by start address, so coalescing
// within the list is always address-correct (a block may extend past
// its region's nominal end after a spanning allocation — ownership is
// by start, the boundary is only a routing hint).
void free_in_region(Store* s, RegionState* rg, uint64_t off, uint64_t size) {
  rg->allocated -= size;
  uint64_t prev = kNil, cur = rg->free_head;
  while (cur != kNil && cur < off) {
    prev = cur;
    cur = fb(s, cur)->next;
  }
  uint64_t next = cur;
  if (next != kNil && off + size == next) {  // merge with next
    size += fb(s, next)->size;
    next = fb(s, next)->next;
  }
  if (prev != kNil && prev + fb(s, prev)->size == off) {  // merge with prev
    fb(s, prev)->size += size;
    fb(s, prev)->next = next;
    return;
  }
  FreeBlock* blk = fb(s, off);
  blk->size = size;
  blk->next = next;
  if (prev == kNil) rg->free_head = off; else fb(s, prev)->next = off;
}

void region_free(Store* s, uint64_t off, uint64_t size) {
  uint32_t r = region_of(s, off);
  RegionGuard g(s, r);
  free_in_region(s, &s->hdr->regions[r], off, size);
}

// Slow path for requests no single region can satisfy: take ALL region
// locks in ascending order (deadlock-free by construction), allocate
// from the temporarily merged global view, and rebuild the per-region
// lists routed by start address.
int64_t alloc_spanning(Store* s, uint64_t want, uint64_t* granted) {
  Header* h = s->hdr;
  uint32_t n = h->num_shards;
  for (uint32_t r = 0; r < n; ++r) {
    RegionState* rg = &h->regions[r];
    lock_timed(&rg->mutex, &rg->lock_wait_ns, &rg->lock_contended);
  }
  // Per-region lists are address-ordered and keyed by block start, so
  // concatenating them in region order yields one global address order.
  std::vector<std::pair<uint64_t, uint64_t>> blocks;  // (off, size)
  for (uint32_t r = 0; r < n; ++r) {
    for (uint64_t cur = h->regions[r].free_head; cur != kNil;
         cur = fb(s, cur)->next) {
      uint64_t off = cur, size = fb(s, cur)->size;
      if (!blocks.empty() &&
          blocks.back().first + blocks.back().second == off) {
        blocks.back().second += size;  // coalesce across region seams
      } else {
        blocks.emplace_back(off, size);
      }
    }
  }
  int64_t out = SS_NO_MEMORY;
  for (auto& b : blocks) {
    if (b.second < want) continue;
    uint64_t take = want;
    uint64_t remain = b.second - want;
    if (remain < kAlign + sizeof(FreeBlock)) {
      take = b.second;
      remain = 0;
    }
    out = static_cast<int64_t>(b.first);
    *granted = take;
    h->regions[region_of(s, b.first)].allocated += take;
    b.first += take;
    b.second = remain;
    break;
  }
  // Rebuild the per-region lists (ordering preserved: blocks is global
  // address order, appends keep each list sorted).
  uint64_t heads[kMaxShards];
  uint64_t* tails[kMaxShards];
  for (uint32_t r = 0; r < n; ++r) {
    heads[r] = kNil;
    tails[r] = &heads[r];
  }
  for (auto& b : blocks) {
    if (b.second == 0) continue;
    FreeBlock* blk = fb(s, b.first);
    blk->size = b.second;
    blk->next = kNil;
    uint32_t r = region_of(s, b.first);
    *tails[r] = b.first;
    tails[r] = &blk->next;
  }
  for (uint32_t r = 0; r < n; ++r) h->regions[r].free_head = heads[r];
  for (uint32_t r = n; r-- > 0;) pthread_mutex_unlock(&h->regions[r].mutex);
  return out;
}

int64_t alloc_block(Store* s, uint64_t want, uint64_t* granted,
                    uint32_t home) {
  Header* h = s->hdr;
  want = align_up(want);
  uint32_t n = h->num_shards;
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t r = (home + i) % n;
    RegionGuard g(s, r);
    int64_t off = alloc_in_region(s, &h->regions[r], want, granted);
    if (off >= 0) return off;
  }
  if (n > 1) return alloc_spanning(s, want, granted);
  return SS_NO_MEMORY;
}

// Convert a just-tombstoned slot (and any tombstone run ending at it)
// back to EMPTY when the next probe slot is EMPTY — bounds probe-path
// degradation under create/delete churn. Shard-local ring; caller holds
// the shard mutex. Safe against lock-free probes: a probe that reads
// the fresh EMPTY stops exactly where it would have stopped at the run
// end (no live element sits beyond an EMPTY slot on its probe path).
void scrub_tombstones(Store* s, uint32_t shard, Slot* sl) {
  uint32_t cap = s->hdr->shard_cap;
  Slot* base = shard_base(s, shard);
  uint32_t idx = static_cast<uint32_t>(sl - base);
  if (__atomic_load_n(&base[(idx + 1) % cap].state, __ATOMIC_RELAXED) != EMPTY)
    return;
  for (uint32_t back = 0; back < cap; ++back) {
    Slot* cur = &base[(idx + cap - back) % cap];
    if (__atomic_load_n(&cur->state, __ATOMIC_RELAXED) != TOMB) break;
    st_state(cur, EMPTY);
  }
}

// Evict LRU sealed refcount==0 objects from ONE shard until at least
// `need` bytes were reclaimed (or nothing evictable remains in it).
// `job_filter` 0 evicts any evictable object; a job row index + 1
// restricts the sweep to that job's own objects — the quota path uses
// this so an over-quota job reclaims ITS evictable data first and can
// never push another tenant's objects out (referenced objects are
// additionally protected by the refcount==0 test, filter or not).
uint64_t evict_shard(Store* s, uint32_t shard, uint64_t need,
                     uint32_t job_filter = 0) {
  ShardGuard g(s, shard);
  ShardState* sh = &s->hdr->shards[shard];
  uint64_t evicted = 0;
  uint32_t cur = sh->lru_tail;
  while (cur && evicted < need) {
    Slot* sl = &s->slots[cur - 1];
    uint32_t next = sl->lru_prev;
    if ((job_filter == 0 || job_row_of(sl) == job_filter) &&
        __atomic_load_n(&sl->state, __ATOMIC_RELAXED) == SEALED &&
        (__atomic_load_n(&sl->refgen, __ATOMIC_ACQUIRE) & 0xffffffffULL) ==
            0) {
      lru_unlink(s, sh, sl);
      region_free(s, sl->offset, sl->alloc_size);
      evicted += sl->alloc_size;
      sh->evicted_objects++;
      sh->evicted_bytes += sl->alloc_size;
      job_uncharge(s, sl, /*evicted=*/true);
      // generation bump BEFORE tombstoning: a lock-free release racing
      // this eviction must fail its CAS, not resurrect the slot
      uint64_t gen = __atomic_load_n(&sl->refgen, __ATOMIC_RELAXED) >> 32;
      __atomic_store_n(&sl->refgen, (gen + 1) << 32, __ATOMIC_RELEASE);
      st_state(sl, TOMB);
      scrub_tombstones(s, shard, sl);
      sh->num_objects--;
    }
    cur = next;
  }
  return evicted;
}

// Wake blocking gets after a seal. SC fences pair with the waiter's
// count-then-probe so a seal either sees the parked waiter (and takes
// the cv_mutex to broadcast) or the waiter's re-probe sees the seal —
// the cv_mutex is never touched when nobody is blocked.
void wake_getters(Header* h) {
  __atomic_thread_fence(__ATOMIC_SEQ_CST);
  if (__atomic_load_n(&h->cv_waiters, __ATOMIC_SEQ_CST) == 0) return;
  int rc = pthread_mutex_lock(&h->cv_mutex);
  if (rc == EOWNERDEAD) pthread_mutex_consistent(&h->cv_mutex);
  pthread_cond_broadcast(&h->sealed_cv);
  pthread_mutex_unlock(&h->cv_mutex);
}

// Guards the process-local handle table (ctypes calls release the GIL, so
// two Python threads can attach concurrently).
pthread_mutex_t g_handle_mutex = PTHREAD_MUTEX_INITIALIZER;

int attach_common(const char* name, bool create, uint64_t capacity,
                  uint32_t table_cap, uint32_t num_shards) {
  pthread_mutex_lock(&g_handle_mutex);
  int handle = -1;
  for (int i = 0; i < kMaxHandles; ++i) {
    if (!g_stores[i].used) { handle = i; break; }
  }
  if (handle >= 0) g_stores[handle].used = true;  // reserve before the slow path
  pthread_mutex_unlock(&g_handle_mutex);
  if (handle < 0) return static_cast<int>(SS_BAD_HANDLE);
  auto fail = [&](int64_t code) {
    pthread_mutex_lock(&g_handle_mutex);
    g_stores[handle].used = false;
    pthread_mutex_unlock(&g_handle_mutex);
    return static_cast<int>(code);
  };

  int flags = create ? (O_RDWR | O_CREAT | O_EXCL) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return fail(SS_SYS);

  uint64_t hdr_bytes = align_up(sizeof(Header));
  uint64_t map_size;
  if (create) {
    uint64_t slots_bytes = align_up(sizeof(Slot) * static_cast<uint64_t>(table_cap));
    map_size = hdr_bytes + slots_bytes + capacity;
    if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
      close(fd);
      shm_unlink(name);
      return fail(SS_SYS);
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return fail(SS_SYS); }
    map_size = static_cast<uint64_t>(st.st_size);
  }

  // Pre-faulting the whole arena (MAP_POPULATE) trades creation latency
  // for put bandwidth: every client write otherwise eats first-touch
  // page faults on fresh allocations (measured ~25% of large-object put
  // bandwidth). Opt-in via RAY_TPU_STORE_PREFAULT=1: on virtualized
  // hosts with slow second-stage fault handling a multi-GB populate can
  // take minutes — longer than the daemon-ready deadline — while lazy
  // faulting amortizes invisibly across early puts.
  const char* prefault = getenv("RAY_TPU_STORE_PREFAULT");
  const bool want_populate =
      create && prefault && prefault[0] == '1';
  const int mmap_flags = MAP_SHARED | (want_populate ? MAP_POPULATE : 0);
  void* base = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, mmap_flags,
                    fd, 0);
  close(fd);
  if (base == MAP_FAILED) return fail(SS_SYS);

  Store* s = &g_stores[handle];
  s->base = static_cast<uint8_t*>(base);
  s->map_size = map_size;
  s->hdr = reinterpret_cast<Header*>(base);

  if (create) {
    Header* h = s->hdr;
    memset(h, 0, sizeof(Header));
    h->magic = kMagic;
    h->version = kVersion;
    h->capacity = capacity;
    h->data_off = hdr_bytes + align_up(sizeof(Slot) * static_cast<uint64_t>(table_cap));

    // Shard count: explicit request, else scaled to capacity so small
    // (test) stores keep exact v1 single-lock/global-LRU semantics.
    uint32_t nshards = num_shards;
    if (nshards == 0)
      nshards = static_cast<uint32_t>(capacity / kMinRegionBytes);
    if (nshards < 1) nshards = 1;
    if (nshards > kMaxShards) nshards = kMaxShards;
    uint32_t shard_cap = table_cap / nshards;
    if (shard_cap < 8) {  // keep probe rings useful on tiny tables
      nshards = table_cap / 8 ? table_cap / 8 : 1;
      if (nshards > kMaxShards) nshards = kMaxShards;
      shard_cap = table_cap / nshards;
    }
    h->num_shards = nshards;
    h->shard_cap = shard_cap;
    h->table_cap = shard_cap * nshards;
    h->region_quant = (capacity / nshards) & ~(kAlign - 1);
    if (h->region_quant < kAlign) h->region_quant = kAlign;

    pthread_mutexattr_t ma;
    pthread_mutexattr_init(&ma);
    pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->cv_mutex, &ma);
    for (uint32_t i = 0; i < nshards; ++i)
      pthread_mutex_init(&h->shards[i].mutex, &ma);
    for (uint32_t i = 0; i < nshards; ++i)
      pthread_mutex_init(&h->regions[i].mutex, &ma);
    pthread_mutexattr_destroy(&ma);

    pthread_condattr_t ca;
    pthread_condattr_init(&ca);
    pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
    pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
    pthread_cond_init(&h->sealed_cv, &ca);
    pthread_condattr_destroy(&ca);

    s->slots = reinterpret_cast<Slot*>(s->base + hdr_bytes);
    memset(s->slots, 0, sizeof(Slot) * table_cap);
    s->data = s->base + h->data_off;
    for (uint32_t r = 0; r < nshards; ++r) {
      RegionState* rg = &h->regions[r];
      rg->base = r * h->region_quant;
      rg->size = (r == nshards - 1) ? capacity - rg->base : h->region_quant;
      rg->free_head = rg->base;
      FreeBlock* blk = fb(s, rg->base);
      blk->size = rg->size;
      blk->next = kNil;
    }
  } else {
    Header* h = s->hdr;
    if (h->magic != kMagic || h->version != kVersion) {
      munmap(base, map_size);
      return fail(SS_SYS);
    }
    s->slots = reinterpret_cast<Slot*>(s->base + hdr_bytes);
    s->data = s->base + h->data_off;
  }
  s->used = true;
  return handle;
}

Store* get_store(int handle) {
  if (handle < 0 || handle >= kMaxHandles || !g_stores[handle].used) return nullptr;
  return &g_stores[handle];
}

}  // namespace

extern "C" {

// Create a new arena (raylet). `num_shards` 0 = scale with capacity.
// Returns handle >= 0 or negative error.
int ss_create_store(const char* name, uint64_t capacity, uint32_t table_cap,
                    uint32_t num_shards) {
  shm_unlink(name);  // drop any stale arena from a crashed prior session
  return attach_common(name, /*create=*/true, align_up(capacity), table_cap,
                       num_shards);
}

// Attach to an existing arena (worker). Returns handle >= 0 or negative error.
int ss_attach(const char* name) {
  return attach_common(name, /*create=*/false, 0, 0, 0);
}

// Allocate an object buffer, attributed to `job_key` (0 = untracked).
// Returns data-region-relative offset, or error. The new object has
// refcount 1 (the creator) and is invisible to get() until sealed.
// Allocation and eviction run BEFORE the index insert, so the only index
// critical section is the (tiny) slot write.
//
// Quota path: the job's `used` counter is RESERVED with one atomic
// fetch_add before any allocation happens — check-and-reserve is a
// single RMW, never a read followed by a write across a lock release
// (raylint's TOCTOU fixture encodes the forbidden shape). A job over
// its quota first reclaims its OWN evictable objects; it never triggers
// a global sweep, so no other tenant loses a byte to an offender.
int64_t ss_create_job(int handle, const uint8_t* id, uint64_t size,
                      uint64_t job_key) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  if (size == 0) size = kAlign;
  Header* h = s->hdr;
  uint32_t shard = shard_of(s, id);
  // advisory fast-out: don't evict live data to make room for a
  // duplicate create (the insert below re-checks authoritatively)
  {
    Slot* dup = probe_lockfree(s, shard, id);
    if (dup && id_eq(dup, id)) return SS_EXISTS;
  }
  int jrow = job_slot(s, job_key, /*create=*/true);
  JobState* job = jrow >= 0 ? &h->jobs[jrow] : nullptr;
  uint64_t want = align_up(size);
  uint64_t reserved = 0;
  if (job) {
    // Reserve before allocating. Quota 0 = unlimited (pure accounting).
    uint64_t prev = __atomic_fetch_add(&job->used, want, __ATOMIC_ACQ_REL);
    reserved = want;
    uint64_t quota = __atomic_load_n(&job->quota, __ATOMIC_ACQUIRE);
    if (quota > 0 && prev + want > quota) {
      // Over quota: reclaim this job's own evictable objects, then
      // re-check. The sweep only touches slots tagged with this job.
      uint64_t over = prev + want - quota;
      for (uint32_t i = 0; i < h->num_shards; ++i)
        evict_shard(s, (shard + i) % h->num_shards, over,
                    static_cast<uint32_t>(jrow) + 1);
      if (__atomic_load_n(&job->used, __ATOMIC_ACQUIRE) > quota) {
        __atomic_fetch_sub(&job->used, want, __ATOMIC_ACQ_REL);
        __atomic_fetch_add(&job->quota_rejects, 1, __ATOMIC_ACQ_REL);
        return SS_QUOTA;
      }
    }
  }
  auto refund = [&]() {
    if (job && reserved)
      __atomic_fetch_sub(&job->used, reserved, __ATOMIC_ACQ_REL);
  };
  uint64_t granted = 0;
  int64_t off = alloc_block(s, size, &granted, shard);
  // Evict until the allocation fits (not merely until `size` bytes were
  // reclaimed): freed blocks may not coalesce into a large-enough run.
  // Each sweep starts at the home shard and only locks the shards it
  // actually has to touch. A quota'd job reclaims its own objects first
  // (tenant-priority), then falls back to the global LRU like any
  // memory-pressured create.
  while (off == SS_NO_MEMORY) {
    uint64_t need = align_up(size);
    uint64_t freed = 0;
    if (job) {
      for (uint32_t i = 0; i < h->num_shards && freed < need; ++i)
        freed += evict_shard(s, (shard + i) % h->num_shards, need - freed,
                             static_cast<uint32_t>(jrow) + 1);
    }
    for (uint32_t i = 0; i < h->num_shards && freed < need; ++i)
      freed += evict_shard(s, (shard + i) % h->num_shards, need - freed);
    if (freed == 0) {
      refund();
      return SS_NO_MEMORY;
    }
    off = alloc_block(s, size, &granted, shard);
  }
  if (job && granted > reserved) {
    // whole-block grant: charge the real footprint, not the estimate
    __atomic_fetch_add(&job->used, granted - reserved, __ATOMIC_ACQ_REL);
    reserved = granted;
  }
  ShardGuard g(s, shard);
  Slot* insert = nullptr;
  if (find_slot(s, shard, id, &insert)) {
    region_free(s, static_cast<uint64_t>(off), granted);
    refund();
    return SS_EXISTS;
  }
  if (!insert) {
    region_free(s, static_cast<uint64_t>(off), granted);
    refund();
    return SS_TABLE_FULL;
  }
  id_store(insert, id);
  insert->offset = static_cast<uint64_t>(off);
  insert->size = size;
  insert->alloc_size = granted;
  insert->lru_prev = insert->lru_next = 0;
  insert->job = job ? static_cast<uint32_t>(jrow) + 1 : 0;
  if (job)
    __atomic_fetch_add(&job->num_objects, 1, __ATOMIC_ACQ_REL);
  uint64_t gen = __atomic_load_n(&insert->refgen, __ATOMIC_RELAXED) >> 32;
  __atomic_store_n(&insert->refgen, ((gen + 1) << 32) | 1, __ATOMIC_RELEASE);
  st_state(insert, CREATED);
  s->hdr->shards[shard].num_objects++;
  return off;
}

// v2-compatible create: untracked (no job attribution, no quota).
int64_t ss_create(int handle, const uint8_t* id, uint64_t size) {
  return ss_create_job(handle, id, size, 0);
}

// Seal a created object: becomes immutable and visible to get().
int ss_seal(int handle, const uint8_t* id) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  uint32_t shard = shard_of(s, id);
  {
    ShardGuard g(s, shard);
    Slot* sl = find_slot(s, shard, id);
    if (!sl) return SS_NOT_FOUND;
    if (__atomic_load_n(&sl->state, __ATOMIC_RELAXED) == SEALED)
      return SS_EXISTS;
    st_state(sl, SEALED);
    lru_push_front(s, &s->hdr->shards[shard], sl);
  }
  wake_getters(s->hdr);
  return SS_OK;
}

// Get a sealed object, incrementing its refcount and bumping LRU.
// Blocks up to timeout_s (<0: no wait; 0: forever) for the object to appear
// and be sealed. On success fills *size_out and returns the data offset.
int64_t ss_get(int handle, const uint8_t* id, uint64_t* size_out,
               double timeout_s) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  Header* h = s->hdr;
  uint32_t shard = shard_of(s, id);
  struct timespec deadline;
  if (timeout_s > 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += static_cast<time_t>(timeout_s);
    deadline.tv_nsec += static_cast<long>((timeout_s - static_cast<time_t>(timeout_s)) * 1e9);
    if (deadline.tv_nsec >= 1000000000L) {
      deadline.tv_sec += 1;
      deadline.tv_nsec -= 1000000000L;
    }
  }
  for (;;) {
    {
      ShardGuard g(s, shard);
      Slot* sl = find_slot(s, shard, id);
      if (sl && __atomic_load_n(&sl->state, __ATOMIC_RELAXED) == SEALED) {
        __atomic_fetch_add(&sl->refgen, 1, __ATOMIC_ACQ_REL);
        ShardState* sh = &h->shards[shard];
        lru_unlink(s, sh, sl);
        lru_push_front(s, sh, sl);
        *size_out = sl->size;
        return static_cast<int64_t>(sl->offset);
      }
      if (timeout_s < 0) return sl ? SS_NOT_SEALED : SS_NOT_FOUND;
    }
    // Park on the global sealed cv. The waiter count is published (SC)
    // BEFORE the re-probe; wake_getters fences symmetrically, so either
    // the sealer sees us parked or our re-probe sees the seal.
    __atomic_fetch_add(&h->cv_waiters, 1, __ATOMIC_SEQ_CST);
    int rc = pthread_mutex_lock(&h->cv_mutex);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&h->cv_mutex);
    __atomic_thread_fence(__ATOMIC_SEQ_CST);
    Slot* sl = probe_lockfree(s, shard, id);
    rc = 0;
    if (!(sl && ld_state(sl) == SEALED)) {
      if (timeout_s == 0) {
        rc = pthread_cond_wait(&h->sealed_cv, &h->cv_mutex);
      } else {
        rc = pthread_cond_timedwait(&h->sealed_cv, &h->cv_mutex, &deadline);
      }
      if (rc == EOWNERDEAD) {
        pthread_mutex_consistent(&h->cv_mutex);
        rc = 0;
      }
    }
    pthread_mutex_unlock(&h->cv_mutex);
    __atomic_fetch_sub(&h->cv_waiters, 1, __ATOMIC_SEQ_CST);
    if (rc == ETIMEDOUT) return SS_TIMEOUT;
  }
}

// 0 = absent, 1 = created (unsealed), 2 = sealed. Entirely lock-free.
int ss_contains(int handle, const uint8_t* id) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  Slot* sl = probe_lockfree(s, shard_of(s, id), id);
  if (!sl) return 0;
  return ld_state(sl) == SEALED ? 2 : 1;
}

// Drop one reference (creator after seal, or a getter when done).
// Lock-free: a generation-checked CAS on the packed (gen, refcount)
// word — if the slot was recycled between the probe and the CAS, the
// generation mismatch aborts the decrement instead of corrupting the
// new occupant's count.
int ss_release(int handle, const uint8_t* id) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  Slot* sl = probe_lockfree(s, shard_of(s, id), id);
  if (!sl) return SS_NOT_FOUND;
  uint64_t rg = __atomic_load_n(&sl->refgen, __ATOMIC_ACQUIRE);
  if (!id_eq(sl, id)) return SS_NOT_FOUND;  // recycled between probe and read
  uint64_t gen = rg >> 32;
  for (;;) {
    if ((rg >> 32) != gen) return SS_NOT_FOUND;  // our incarnation is gone
    if ((rg & 0xffffffffULL) == 0) return SS_OK;  // nothing left to drop
    if (__atomic_compare_exchange_n(&sl->refgen, &rg, rg - 1, false,
                                    __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE))
      return SS_OK;
  }
}

// Delete an object immediately (abort an unsealed create, or force-remove).
int ss_delete(int handle, const uint8_t* id) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  uint32_t shard = shard_of(s, id);
  ShardGuard g(s, shard);
  Slot* sl = find_slot(s, shard, id);
  if (!sl) return SS_NOT_FOUND;
  ShardState* sh = &s->hdr->shards[shard];
  if (__atomic_load_n(&sl->state, __ATOMIC_RELAXED) == SEALED)
    lru_unlink(s, sh, sl);
  region_free(s, sl->offset, sl->alloc_size);
  job_uncharge(s, sl, /*evicted=*/false);
  uint64_t gen = __atomic_load_n(&sl->refgen, __ATOMIC_RELAXED) >> 32;
  __atomic_store_n(&sl->refgen, (gen + 1) << 32, __ATOMIC_RELEASE);
  st_state(sl, TOMB);
  scrub_tombstones(s, shard, sl);
  sh->num_objects--;
  return SS_OK;
}

// --- ownership GC / recovery plane (v4) ---

// Set (flag!=0) or clear the primary-copy hint. The hint is advisory
// location metadata: the raylet marks objects it pinned on behalf of an
// owner as the authoritative copy; replicas pulled from peers stay
// unmarked, so loss sweeps and the drop_objects chaos fault can tell
// "this node held the only copy" from "this node held a cache".
int ss_set_primary(int handle, const uint8_t* id, int flag) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  uint32_t shard = shard_of(s, id);
  ShardGuard g(s, shard);
  Slot* sl = find_slot(s, shard, id);
  if (!sl) return SS_NOT_FOUND;
  if (flag)
    sl->job |= kPrimaryBit;
  else
    sl->job &= ~kPrimaryBit;
  return SS_OK;
}

// 1 = primary-copy hint set, 0 = not set; SS_NOT_FOUND when absent.
// Lock-free probe (advisory, like ss_contains).
int ss_is_primary(int handle, const uint8_t* id) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  Slot* sl = probe_lockfree(s, shard_of(s, id), id);
  if (!sl) return SS_NOT_FOUND;
  return (__atomic_load_n(&sl->job, __ATOMIC_RELAXED) & kPrimaryBit) ? 1 : 0;
}

// Current client reference count of the object (creator + getters with
// live buffer views), or SS_NOT_FOUND. The owner's GC uses this before
// a free-on-zero delete: force-deleting while a mapped view is live
// would yank memory out from under a zero-copy reader.
int64_t ss_refcount(int handle, const uint8_t* id) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  Slot* sl = probe_lockfree(s, shard_of(s, id), id);
  if (!sl) return SS_NOT_FOUND;
  uint64_t rg = __atomic_load_n(&sl->refgen, __ATOMIC_ACQUIRE);
  if (!id_eq(sl, id)) return SS_NOT_FOUND;
  return static_cast<int64_t>(rg & 0xffffffffULL);
}

// Enumerate sealed objects: writes up to `cap` ids (kIdSize bytes each)
// into `ids_out` and one flag byte per object into `flags_out`
// (bit0 = primary-copy hint, bit1 = referenced). Returns the count.
// Walks one shard lock at a time, so the listing is a consistent
// per-shard snapshot (good enough for chaos sweeps and diagnostics).
int ss_list_sealed(int handle, uint8_t* ids_out, uint8_t* flags_out,
                   int cap) {
  Store* s = get_store(handle);
  if (!s) return static_cast<int>(SS_BAD_HANDLE);
  Header* h = s->hdr;
  int n = 0;
  for (uint32_t i = 0; i < h->num_shards && n < cap; ++i) {
    ShardGuard g(s, i);
    Slot* base = shard_base(s, i);
    for (uint32_t j = 0; j < h->shard_cap && n < cap; ++j) {
      Slot* sl = &base[j];
      if (__atomic_load_n(&sl->state, __ATOMIC_RELAXED) != SEALED) continue;
      memcpy(ids_out + static_cast<uint64_t>(n) * kIdSize, sl->id, kIdSize);
      uint8_t flags = 0;
      if (sl->job & kPrimaryBit) flags |= 1;
      if ((__atomic_load_n(&sl->refgen, __ATOMIC_RELAXED) & 0xffffffffULL) > 0)
        flags |= 2;
      flags_out[n] = flags;
      ++n;
    }
  }
  return n;
}

// Evict at least `nbytes` of LRU sealed unreferenced data. Returns evicted.
uint64_t ss_evict(int handle, uint64_t nbytes) {
  Store* s = get_store(handle);
  if (!s) return 0;
  uint64_t evicted = 0;
  for (uint32_t i = 0; i < s->hdr->num_shards && evicted < nbytes; ++i)
    evicted += evict_shard(s, i, nbytes - evicted);
  return evicted;
}

void ss_stats(int handle, uint64_t* capacity, uint64_t* allocated,
              uint32_t* num_objects) {
  Store* s = get_store(handle);
  if (!s) { *capacity = *allocated = 0; *num_objects = 0; return; }
  Header* h = s->hdr;
  *capacity = h->capacity;
  uint64_t alloc = 0;
  uint32_t n = 0;
  for (uint32_t i = 0; i < h->num_shards; ++i) {
    ShardGuard g(s, i);
    n += h->shards[i].num_objects;
  }
  for (uint32_t i = 0; i < h->num_shards; ++i) {
    RegionGuard g(s, i);
    alloc += h->regions[i].allocated;
  }
  *allocated = alloc;
  *num_objects = n;
}

// ss_stats plus the UNEVICTABLE byte count and aggregate contention
// counters. `referenced` is bytes in unsealed objects or sealed objects
// some client still references; `allocated` additionally counts
// evictable garbage a later create would reclaim, so backpressure
// decisions must look at `referenced` (allocated-based throttling
// stalls on space that is actually free). `lock_wait_ns`/`lock_contended`
// sum the index-shard and alloc-region mutexes; `evicted_objects` sums
// LRU evictions since creation.
void ss_stats2(int handle, uint64_t* capacity, uint64_t* allocated,
               uint32_t* num_objects, uint64_t* referenced,
               uint64_t* lock_wait_ns, uint64_t* lock_contended,
               uint64_t* evicted_objects) {
  Store* s = get_store(handle);
  if (!s) {
    *capacity = *allocated = *referenced = 0;
    *lock_wait_ns = *lock_contended = *evicted_objects = 0;
    *num_objects = 0;
    return;
  }
  Header* h = s->hdr;
  *capacity = h->capacity;
  uint64_t alloc = 0, ref = 0, wait = 0, cont = 0, evd = 0;
  uint32_t n = 0;
  for (uint32_t i = 0; i < h->num_shards; ++i) {
    ShardGuard g(s, i);
    ShardState* sh = &h->shards[i];
    n += sh->num_objects;
    wait += sh->lock_wait_ns;
    cont += sh->lock_contended;
    evd += sh->evicted_objects;
    Slot* base = shard_base(s, i);
    for (uint32_t j = 0; j < h->shard_cap; ++j) {
      Slot* sl = &base[j];
      uint32_t st = __atomic_load_n(&sl->state, __ATOMIC_RELAXED);
      if (st == CREATED ||
          (st == SEALED &&
           (__atomic_load_n(&sl->refgen, __ATOMIC_RELAXED) & 0xffffffffULL) >
               0)) {
        ref += sl->alloc_size;
      }
    }
  }
  for (uint32_t i = 0; i < h->num_shards; ++i) {
    RegionGuard g(s, i);
    alloc += h->regions[i].allocated;
    wait += h->regions[i].lock_wait_ns;
    cont += h->regions[i].lock_contended;
  }
  *allocated = alloc;
  *num_objects = n;
  *referenced = ref;
  *lock_wait_ns = wait;
  *lock_contended = cont;
  *evicted_objects = evd;
}

uint32_t ss_num_shards(int handle) {
  Store* s = get_store(handle);
  return s ? s->hdr->num_shards : 0;
}

// Per-shard instrumentation row: [lock_wait_ns, lock_contended,
// lock_acquisitions, evicted_objects, evicted_bytes, num_objects,
// region_allocated, region_lock_wait_ns]. Returns SS_OK or an error.
int ss_shard_stats(int handle, uint32_t shard, uint64_t* out) {
  Store* s = get_store(handle);
  if (!s) return static_cast<int>(SS_BAD_HANDLE);
  Header* h = s->hdr;
  if (shard >= h->num_shards) return static_cast<int>(SS_NOT_FOUND);
  {
    ShardGuard g(s, shard);
    ShardState* sh = &h->shards[shard];
    out[0] = sh->lock_wait_ns;
    out[1] = sh->lock_contended;
    out[2] = sh->lock_acquisitions;
    out[3] = sh->evicted_objects;
    out[4] = sh->evicted_bytes;
    out[5] = sh->num_objects;
  }
  {
    RegionGuard g(s, shard);
    out[6] = h->regions[shard].allocated;
    out[7] = h->regions[shard].lock_wait_ns;
  }
  return static_cast<int>(SS_OK);
}

// Set (or clear, quota=0) the byte quota for `job_key`, claiming an
// accounting row if the job has none yet. Returns SS_OK, or
// SS_TABLE_FULL when all kMaxJobs rows are taken.
int ss_set_job_quota(int handle, uint64_t job_key, uint64_t quota) {
  Store* s = get_store(handle);
  if (!s) return static_cast<int>(SS_BAD_HANDLE);
  int jrow = job_slot(s, job_key, /*create=*/true);
  if (jrow < 0) return static_cast<int>(SS_TABLE_FULL);
  __atomic_store_n(&s->hdr->jobs[jrow].quota, quota, __ATOMIC_RELEASE);
  return static_cast<int>(SS_OK);
}

// Per-job accounting row: [quota, used, evicted_bytes, quota_rejects,
// num_objects]. SS_NOT_FOUND when the job has no row (never stored and
// never had a quota set).
int ss_job_stats(int handle, uint64_t job_key, uint64_t* out) {
  Store* s = get_store(handle);
  if (!s) return static_cast<int>(SS_BAD_HANDLE);
  int jrow = job_slot(s, job_key, /*create=*/false);
  if (jrow < 0) return static_cast<int>(SS_NOT_FOUND);
  JobState* j = &s->hdr->jobs[jrow];
  out[0] = __atomic_load_n(&j->quota, __ATOMIC_ACQUIRE);
  out[1] = __atomic_load_n(&j->used, __ATOMIC_ACQUIRE);
  out[2] = __atomic_load_n(&j->evicted_bytes, __ATOMIC_ACQUIRE);
  out[3] = __atomic_load_n(&j->quota_rejects, __ATOMIC_ACQUIRE);
  out[4] = __atomic_load_n(&j->num_objects, __ATOMIC_ACQUIRE);
  return static_cast<int>(SS_OK);
}

// List active job keys into `keys` (capacity `cap`); returns the count.
int ss_job_list(int handle, uint64_t* keys, int cap) {
  Store* s = get_store(handle);
  if (!s) return static_cast<int>(SS_BAD_HANDLE);
  int n = 0;
  for (uint32_t i = 0; i < kMaxJobs && n < cap; ++i) {
    uint64_t k = __atomic_load_n(&s->hdr->jobs[i].key, __ATOMIC_ACQUIRE);
    if (k != 0) keys[n++] = k;
  }
  return n;
}

// Evict at least `nbytes` of ONE job's sealed unreferenced data (its
// own objects only). Returns bytes evicted.
uint64_t ss_evict_job(int handle, uint64_t nbytes, uint64_t job_key) {
  Store* s = get_store(handle);
  if (!s) return 0;
  int jrow = job_slot(s, job_key, /*create=*/false);
  if (jrow < 0) return 0;
  uint64_t evicted = 0;
  for (uint32_t i = 0; i < s->hdr->num_shards && evicted < nbytes; ++i)
    evicted += evict_shard(s, i, nbytes - evicted,
                           static_cast<uint32_t>(jrow) + 1);
  return evicted;
}

// Parallel memcopy for large object payloads (reference: the plasma
// client's threaded memcopy, `src/ray/object_manager/plasma/client.cc`
// memcopy_threads — a single memcpy thread cannot saturate multi-channel
// DRAM, so big puts fan the copy out over chunks). Chunks are 64-byte
// aligned so no two threads share a cache line. `threads <= 0` picks
// a count from the hardware (bounded — put callers may be many
// concurrent processes, and oversubscribing thrashes).
void ss_memcpy_mt(void* dst, const void* src, uint64_t n, int threads) {
  constexpr uint64_t kMinChunk = 4ULL << 20;  // below this, plain memcpy
  if (threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    threads = static_cast<int>(hw > 8 ? 8 : (hw ? hw : 1));
  }
  uint64_t want = n / kMinChunk;
  if (static_cast<uint64_t>(threads) > want) threads = static_cast<int>(want);
  if (threads <= 1) {
    memcpy(dst, src, n);
    return;
  }
  // ceil division: floor would drop the tail whenever n/threads is
  // already 64-aligned and n isn't divisible by threads
  uint64_t chunk = ((n + threads - 1) / threads + 63) & ~63ULL;
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  uint64_t off = chunk;
  for (int t = 1; t < threads && off < n; ++t, off += chunk) {
    uint64_t len = off + chunk > n ? n - off : chunk;
    pool.emplace_back([=] {
      memcpy(static_cast<uint8_t*>(dst) + off,
             static_cast<const uint8_t*>(src) + off, len);
    });
  }
  memcpy(dst, src, chunk > n ? n : chunk);  // leader copies chunk 0 inline
  for (auto& th : pool) th.join();
}

// Byte offset of the data region from the start of the shm file (so Python
// can mmap the same file and compute zero-copy views).
uint64_t ss_data_offset(int handle) {
  Store* s = get_store(handle);
  return s ? s->hdr->data_off : 0;
}

uint64_t ss_map_size(int handle) {
  Store* s = get_store(handle);
  return s ? s->map_size : 0;
}

int ss_detach(int handle) {
  Store* s = get_store(handle);
  if (!s) return SS_BAD_HANDLE;
  munmap(s->base, s->map_size);
  pthread_mutex_lock(&g_handle_mutex);
  s->base = nullptr;
  s->used = false;
  pthread_mutex_unlock(&g_handle_mutex);
  return SS_OK;
}

int ss_unlink_store(const char* name) {
  return shm_unlink(name) == 0 ? SS_OK : static_cast<int>(SS_SYS);
}

}  // extern "C"
