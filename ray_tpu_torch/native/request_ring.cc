// request_ring.cc — zero-Python serve dispatch plane.
//
// A per-node shared-memory dispatch segment: per-replica bounded MPSC
// frame rings plus an embedded replica snapshot table. The three
// per-request costs the Python router used to pay — trace-id mint,
// deadline check, power-of-two replica choice — happen HERE, in native
// code, on raw frames; Python is entered once per BATCH when the
// engine/replica step drains its ring. The replica table is the
// controller-published `{version, replica ids, inflight counters}`
// snapshot: writers serialize on a robust process-shared mutex and flip
// a seqlock, readers are lock-free (seqlock copy for full snapshots,
// generation-checked CAS on the packed `gen<<32 | inflight` word for
// the inflight counters — the same ABA-safe idiom shm_store v2 uses
// for its slot refcounts).
//
// Layout (one shm segment per dispatch domain):
//
//   RingHeader                  magic/geometry, trace mint state,
//                               seqlock + published version, robust
//                               publish mutex, stats
//   ReplicaEntry[table_cap]     {id, gen<<32|inflight, alive} — the
//                               snapshot table; entry index == sub-ring
//                               index (stable for the entry's lifetime)
//   Ring[table_cap]             per-replica bounded MPSC ring:
//                               {head, tail} + Slot[slots]
//   Slot                        {seq, FrameHdr, payload[slot_bytes]}
//
// Rings are Vyukov bounded-MPMC queues used as MPSC (many client
// processes produce, the owning replica's drain loop consumes): a
// producer claims a slot by CAS on head gated by the slot's sequence
// word, writes the frame, then publishes with a release-store of the
// sequence — the consumer's acquire-load of the same word orders the
// payload read, so frames are never torn. Wakeups are NOT in here:
// enqueue returns a "ring was empty" flag and the Python wrapper posts
// an advisory FIFO token (the compiled-DAG channel idiom) so a parked
// drain loop unblocks without native code owning any fd.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545052494e4731ULL;  // "RTPRING1"
constexpr uint32_t kVersion = 1;
constexpr int kMaxHandles = 256;
constexpr uint32_t kMaxTableCap = 64;

// error codes surfaced to the ctypes layer (ray_tpu/serve/dispatch.py)
constexpr int64_t RR_FULL = -1;        // chosen replica's ring is full
constexpr int64_t RR_DEADLINE = -2;    // deadline already passed at mint
constexpr int64_t RR_TOO_BIG = -3;     // payload exceeds slot_bytes
constexpr int64_t RR_NO_REPLICA = -4;  // no alive replica in the table
constexpr int64_t RR_BAD = -5;         // bad handle / args / table full

// rr_enqueue success flag bits (returned value is flags >= 0)
constexpr int64_t RR_WAS_EMPTY = 1;  // ring went empty->nonempty: post a
                                     // wakeup token for the drain loop

// stats indices (rr_stats fills a 12-wide row in this order)
enum {
  ST_ENQUEUED = 0,
  ST_DRAINED = 1,
  ST_DRAIN_BATCHES = 2,
  ST_FULL = 3,
  ST_DEADLINE = 4,
  ST_TOO_BIG = 5,
  ST_NO_REPLICA = 6,
  ST_PUBLISHES = 7,
  ST_DONE_STALE = 8,    // rr_done dropped: generation moved (ABA guard)
  ST_CHOICE_RETRY = 9,  // pow-2 claim retried against a racing publish
  ST_LOCK_WAIT_NS = 10,
  ST_LOCK_CONTENDED = 11,
  ST_COUNT = 12,
};

struct FrameHdr {
  uint64_t trace;        // natively-minted trace id (seed<<32 | counter)
  uint64_t rid;          // chosen replica id (0 for direct enqueues)
  uint64_t deadline_ns;  // CLOCK_MONOTONIC ns; 0 = none
  uint64_t enq_ns;       // CLOCK_MONOTONIC ns at enqueue
  uint64_t client;       // opaque client cookie (response-ring routing)
  uint32_t gen;          // replica-entry generation the inflight++ hit
  uint32_t tag;          // payload discriminator (Python-defined)
  uint32_t len;          // payload bytes
  uint32_t pad;
};
static_assert(sizeof(FrameHdr) == 56, "frame header is part of the ABI");

struct Slot {
  uint64_t seq;  // Vyukov sequence word (atomic)
  FrameHdr hdr;
  // payload[slot_bytes] follows
};

struct RingCtl {
  uint64_t head;  // producers CAS-claim here
  uint64_t pad0[7];
  uint64_t tail;  // the consumer advances here
  uint64_t pad1[7];
};

struct ReplicaEntry {
  uint64_t id;      // stable replica id; 0 = slot never used
  uint64_t refgen;  // hi 32: generation, lo 32: inflight (packed word)
  uint32_t alive;   // 1 = routable
  uint32_t pad0;
  uint64_t pad1[5];
};
static_assert(sizeof(ReplicaEntry) == 64, "entry must be cache-line sized");

struct RingHeader {
  uint64_t magic;
  uint32_t version;
  uint32_t init_done;  // creator's release-store gates attachers
  uint32_t table_cap;
  uint32_t slots;       // per sub-ring, power of two
  uint32_t slot_bytes;  // payload capacity per slot
  uint32_t mode;        // Python-defined encoding (0 pickle, 1 raw llm)
  uint64_t trace_seed;  // hi 32 bits become the trace-id prefix
  uint64_t trace_counter;
  uint64_t table_seq;          // seqlock; odd = publish in progress
  uint64_t published_version;  // controller's replica-set version
  pthread_mutex_t pub_mutex;   // robust, serializes publishers
  uint64_t stats[ST_COUNT];
};

struct Handle {
  bool used;
  uint8_t* base;
  uint64_t map_size;
  char name[128];
};

Handle g_rings[kMaxHandles];
pthread_mutex_t g_handle_mutex = PTHREAD_MUTEX_INITIALIZER;

inline RingHeader* hdr_of(const Handle& h) {
  return reinterpret_cast<RingHeader*>(h.base);
}

inline uint64_t header_bytes() {
  // room for the header + alignment slack; pthread_mutex_t sizes vary
  return 512;
}

inline uint64_t slot_stride(const RingHeader* h) {
  return sizeof(Slot) + h->slot_bytes;  // 64 + slot_bytes
}

inline uint64_t ring_bytes(const RingHeader* h) {
  return sizeof(RingCtl) + static_cast<uint64_t>(h->slots) * slot_stride(h);
}

inline ReplicaEntry* entry(const Handle& h, uint32_t i) {
  return reinterpret_cast<ReplicaEntry*>(h.base + header_bytes()) + i;
}

inline RingCtl* ring_ctl(const Handle& h, uint32_t r) {
  RingHeader* hd = hdr_of(h);
  uint8_t* rings = h.base + header_bytes() +
                   static_cast<uint64_t>(hd->table_cap) * sizeof(ReplicaEntry);
  return reinterpret_cast<RingCtl*>(rings + static_cast<uint64_t>(r) *
                                                ring_bytes(hd));
}

inline Slot* ring_slot(const Handle& h, uint32_t r, uint64_t i) {
  RingHeader* hd = hdr_of(h);
  uint8_t* slots = reinterpret_cast<uint8_t*>(ring_ctl(h, r)) +
                   sizeof(RingCtl);
  return reinterpret_cast<Slot*>(slots + i * slot_stride(hd));
}

inline uint8_t* slot_payload(Slot* s) {
  return reinterpret_cast<uint8_t*>(s) + sizeof(Slot);
}

inline uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ULL +
         static_cast<uint64_t>(ts.tv_nsec);
}

inline void bump(RingHeader* h, int which, uint64_t n = 1) {
  __atomic_fetch_add(&h->stats[which], n, __ATOMIC_RELAXED);
}

// robust-mutex acquire with contention accounting (shm_store idiom): a
// publisher that died mid-publish leaves the mutex EOWNERDEAD — mark it
// consistent and finish the seqlock (readers were never blocked).
int lock_timed(RingHeader* h) {
  int rc = pthread_mutex_trylock(&h->pub_mutex);
  if (rc == EBUSY) {
    uint64_t t0 = now_ns();
    rc = pthread_mutex_lock(&h->pub_mutex);
    bump(h, ST_LOCK_WAIT_NS, now_ns() - t0);
    bump(h, ST_LOCK_CONTENDED);
  }
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->pub_mutex);
    // a dead publisher may have left the seqlock odd: close it so
    // readers stop spinning (the table is whatever the corpse wrote —
    // the next publish overwrites it wholesale)
    uint64_t seq = __atomic_load_n(&h->table_seq, __ATOMIC_ACQUIRE);
    if (seq & 1)
      __atomic_store_n(&h->table_seq, seq + 1, __ATOMIC_RELEASE);
    rc = 0;
  }
  return rc;
}

uint32_t round_pow2(uint32_t v) {
  uint32_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

// cheap per-thread xorshift for the pow-2 draw — replica choice is a
// load-balancing tiebreak, not a replayable decision (the Python
// router's seeded RNG covers chaos determinism on the fallback path)
inline uint64_t xorshift() {
  static __thread uint64_t state = 0;
  if (state == 0)
    state = now_ns() ^ (static_cast<uint64_t>(getpid()) << 32) ^
            reinterpret_cast<uintptr_t>(&state);
  state ^= state << 13;
  state ^= state >> 7;
  state ^= state << 17;
  return state;
}

int alloc_handle() {
  pthread_mutex_lock(&g_handle_mutex);
  int h = -1;
  for (int i = 0; i < kMaxHandles; ++i) {
    if (!g_rings[i].used) {
      g_rings[i].used = true;
      h = i;
      break;
    }
  }
  pthread_mutex_unlock(&g_handle_mutex);
  return h;
}

Handle* get_handle(int h) {
  if (h < 0 || h >= kMaxHandles || !g_rings[h].used) return nullptr;
  return &g_rings[h];
}

}  // namespace

extern "C" {

// Create the domain segment (or attach when it already exists — the
// creator races are resolved by O_EXCL + the init_done gate). Returns a
// process-local handle, or -1.
int rr_open(const char* name, uint32_t table_cap, uint32_t slots,
            uint32_t slot_bytes) {
  if (table_cap == 0 || table_cap > kMaxTableCap) return -1;
  slots = round_pow2(slots ? slots : 1024);
  slot_bytes = (slot_bytes + 63) & ~63u;  // keep slot stride aligned
  uint64_t per_ring = sizeof(RingCtl) +
                      static_cast<uint64_t>(slots) *
                          (sizeof(Slot) + slot_bytes);
  uint64_t map_size = header_bytes() + table_cap * sizeof(ReplicaEntry) +
                      table_cap * per_ring;

  bool creator = true;
  int fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) {
    if (errno != EEXIST) return -1;
    creator = false;
    fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return -1;
  }
  if (creator && ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return -1;
  }
  if (!creator) {
    // attacher: geometry comes from the segment, not the arguments
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < (off_t)header_bytes()) {
      close(fd);
      return -1;
    }
    map_size = static_cast<uint64_t>(st.st_size);
  }
  void* base = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                    fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;

  RingHeader* h = static_cast<RingHeader*>(base);
  if (creator) {
    std::memset(base, 0, header_bytes() + table_cap * sizeof(ReplicaEntry));
    h->magic = kMagic;
    h->version = kVersion;
    h->table_cap = table_cap;
    h->slots = slots;
    h->slot_bytes = slot_bytes;
    h->mode = 0;
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    h->trace_seed = (static_cast<uint64_t>(ts.tv_nsec) << 32) ^
                    (static_cast<uint64_t>(getpid()) << 16) ^
                    static_cast<uint64_t>(ts.tv_sec);
    if ((h->trace_seed >> 32) == 0) h->trace_seed |= 1ULL << 32;
    pthread_mutexattr_t mattr;
    pthread_mutexattr_init(&mattr);
    pthread_mutexattr_setpshared(&mattr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&mattr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->pub_mutex, &mattr);
    pthread_mutexattr_destroy(&mattr);
    // Vyukov rings: every slot's sequence word starts at its index
    Handle tmp{true, static_cast<uint8_t*>(base), map_size, {0}};
    for (uint32_t r = 0; r < table_cap; ++r) {
      RingCtl* ctl = ring_ctl(tmp, r);
      ctl->head = 0;
      ctl->tail = 0;
      for (uint32_t i = 0; i < slots; ++i)
        __atomic_store_n(&ring_slot(tmp, r, i)->seq, i, __ATOMIC_RELAXED);
    }
    __atomic_store_n(&h->init_done, 1u, __ATOMIC_RELEASE);
  } else {
    // wait for the creator's init to land (bounded)
    for (int spin = 0; spin < 200000; ++spin) {
      if (__atomic_load_n(&h->init_done, __ATOMIC_ACQUIRE)) break;
      sched_yield();
    }
    if (!__atomic_load_n(&h->init_done, __ATOMIC_ACQUIRE) ||
        h->magic != kMagic || h->version != kVersion) {
      munmap(base, map_size);
      return -1;
    }
  }

  int hi = alloc_handle();
  if (hi < 0) {
    munmap(base, map_size);
    return -1;
  }
  g_rings[hi].base = static_cast<uint8_t*>(base);
  g_rings[hi].map_size = map_size;
  std::snprintf(g_rings[hi].name, sizeof(g_rings[hi].name), "%s", name);
  return hi;
}

int rr_detach(int h) {
  Handle* hd = get_handle(h);
  if (!hd) return -1;
  munmap(hd->base, hd->map_size);
  pthread_mutex_lock(&g_handle_mutex);
  hd->used = false;
  hd->base = nullptr;
  pthread_mutex_unlock(&g_handle_mutex);
  return 0;
}

int rr_unlink(const char* name) { return shm_unlink(name); }

uint32_t rr_table_cap(int h) {
  Handle* hd = get_handle(h);
  return hd ? hdr_of(*hd)->table_cap : 0;
}

uint32_t rr_slots(int h) {
  Handle* hd = get_handle(h);
  return hd ? hdr_of(*hd)->slots : 0;
}

uint32_t rr_slot_bytes(int h) {
  Handle* hd = get_handle(h);
  return hd ? hdr_of(*hd)->slot_bytes : 0;
}

uint32_t rr_mode(int h) {
  Handle* hd = get_handle(h);
  return hd ? __atomic_load_n(&hdr_of(*hd)->mode, __ATOMIC_ACQUIRE) : 0;
}

int rr_set_mode(int h, uint32_t mode) {
  Handle* hd = get_handle(h);
  if (!hd) return -1;
  __atomic_store_n(&hdr_of(*hd)->mode, mode, __ATOMIC_RELEASE);
  return 0;
}

uint64_t rr_snapshot_version(int h) {
  Handle* hd = get_handle(h);
  if (!hd) return 0;
  return __atomic_load_n(&hdr_of(*hd)->published_version, __ATOMIC_ACQUIRE);
}

// Controller-side snapshot publish: replace the routable set with `ids`
// (length n). Surviving entries KEEP their generation and inflight
// count (the satellite's "preserve surviving counts" contract, enforced
// at the native layer too); departed entries get their generation
// bumped with inflight zeroed, so stale rr_done calls from requests
// dispatched before the publish are dropped by the gen check instead of
// corrupting a successor's count. Entry index doubles as the sub-ring
// index, so a reused slot hands its (possibly nonempty) ring to the new
// replica — stale frames are served by the successor rather than
// leaked.
int rr_publish(int h, uint64_t version, const uint64_t* ids, uint32_t n) {
  Handle* hd = get_handle(h);
  if (!hd || n > hdr_of(*hd)->table_cap) return (int)RR_BAD;
  RingHeader* H = hdr_of(*hd);
  if (lock_timed(H) != 0) return (int)RR_BAD;
  uint64_t seq = __atomic_load_n(&H->table_seq, __ATOMIC_RELAXED);
  __atomic_store_n(&H->table_seq, seq + 1, __ATOMIC_RELEASE);  // odd

  uint32_t cap = H->table_cap;
  // pass 1: keep survivors, retire the departed
  for (uint32_t i = 0; i < cap; ++i) {
    ReplicaEntry* e = entry(*hd, i);
    if (e->id == 0) continue;
    bool kept = false;
    for (uint32_t j = 0; j < n; ++j)
      if (ids[j] == e->id) {
        kept = true;
        break;
      }
    if (kept) {
      __atomic_store_n(&e->alive, 1u, __ATOMIC_RELEASE);
    } else if (__atomic_load_n(&e->alive, __ATOMIC_RELAXED)) {
      __atomic_store_n(&e->alive, 0u, __ATOMIC_RELEASE);
      uint64_t rg = __atomic_load_n(&e->refgen, __ATOMIC_ACQUIRE);
      __atomic_store_n(&e->refgen, ((rg >> 32) + 1) << 32,
                       __ATOMIC_RELEASE);
    }
  }
  // pass 2: place new ids into free (never-used or retired) slots
  int rc = 0;
  for (uint32_t j = 0; j < n; ++j) {
    bool present = false;
    for (uint32_t i = 0; i < cap; ++i)
      if (entry(*hd, i)->id == ids[j]) {
        present = true;
        break;
      }
    if (present) continue;
    int free_slot = -1;
    for (uint32_t i = 0; i < cap; ++i) {
      ReplicaEntry* e = entry(*hd, i);
      if (e->id == 0) {
        free_slot = (int)i;
        break;
      }
      if (free_slot < 0 && !__atomic_load_n(&e->alive, __ATOMIC_RELAXED))
        free_slot = (int)i;
    }
    if (free_slot < 0) {
      rc = (int)RR_BAD;  // table full of live entries
      break;
    }
    ReplicaEntry* e = entry(*hd, (uint32_t)free_slot);
    uint64_t rg = __atomic_load_n(&e->refgen, __ATOMIC_ACQUIRE);
    __atomic_store_n(&e->refgen, ((rg >> 32) + 1) << 32, __ATOMIC_RELEASE);
    __atomic_store_n(&e->id, ids[j], __ATOMIC_RELEASE);
    __atomic_store_n(&e->alive, 1u, __ATOMIC_RELEASE);
  }

  __atomic_store_n(&H->published_version, version, __ATOMIC_RELEASE);
  __atomic_store_n(&H->table_seq, seq + 2, __ATOMIC_RELEASE);  // even
  bump(H, ST_PUBLISHES);
  pthread_mutex_unlock(&H->pub_mutex);
  return rc;
}

// Client-observed death (ActorDiedError before the controller's next
// reconcile): drop the replica from routing NOW. Generation bump +
// inflight zero, same retirement as an unpublish.
int rr_mark_dead(int h, uint64_t id) {
  Handle* hd = get_handle(h);
  if (!hd || id == 0) return (int)RR_BAD;
  RingHeader* H = hdr_of(*hd);
  for (uint32_t i = 0; i < H->table_cap; ++i) {
    ReplicaEntry* e = entry(*hd, i);
    if (__atomic_load_n(&e->id, __ATOMIC_ACQUIRE) != id) continue;
    if (__atomic_load_n(&e->alive, __ATOMIC_ACQUIRE)) {
      __atomic_store_n(&e->alive, 0u, __ATOMIC_RELEASE);
      uint64_t rg = __atomic_load_n(&e->refgen, __ATOMIC_ACQUIRE);
      __atomic_store_n(&e->refgen, ((rg >> 32) + 1) << 32,
                       __ATOMIC_RELEASE);
    }
    return 0;
  }
  return (int)RR_BAD;
}

// Completion: decrement the replica's inflight count — but only while
// the entry is still in the generation the increment hit (`gen` rides
// the frame header). A completion that arrives after mark_dead /
// unpublish recycled the entry CAS-fails on the generation and is
// dropped: this is the native fix for the router's positional-index
// aliasing bug, enforced where the counters actually live.
int rr_done(int h, uint64_t id, uint32_t gen) {
  Handle* hd = get_handle(h);
  if (!hd || id == 0) return (int)RR_BAD;
  RingHeader* H = hdr_of(*hd);
  for (uint32_t i = 0; i < H->table_cap; ++i) {
    ReplicaEntry* e = entry(*hd, i);
    if (__atomic_load_n(&e->id, __ATOMIC_ACQUIRE) != id) continue;
    uint64_t rg = __atomic_load_n(&e->refgen, __ATOMIC_ACQUIRE);
    for (;;) {
      if ((rg >> 32) != gen) {
        bump(H, ST_DONE_STALE);
        return 0;  // generation moved: stale completion, drop it
      }
      if ((rg & 0xffffffffULL) == 0) return 0;  // already balanced
      if (__atomic_compare_exchange_n(&e->refgen, &rg, rg - 1, false,
                                      __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE))
        return 1;
    }
  }
  bump(H, ST_DONE_STALE);
  return 0;  // entry recycled for a different id: equally stale
}

namespace {

// Vyukov enqueue into sub-ring r; returns slot claimed (>=0) or RR_FULL.
// On success the caller owns the slot until it release-stores seq.
int64_t claim_slot(const Handle& hd, uint32_t r, Slot** out) {
  RingHeader* H = hdr_of(hd);
  RingCtl* ctl = ring_ctl(hd, r);
  uint64_t mask = H->slots - 1;
  uint64_t pos = __atomic_load_n(&ctl->head, __ATOMIC_RELAXED);
  for (;;) {
    Slot* s = ring_slot(hd, r, pos & mask);
    uint64_t seq = __atomic_load_n(&s->seq, __ATOMIC_ACQUIRE);
    int64_t dif = (int64_t)seq - (int64_t)pos;
    if (dif == 0) {
      if (__atomic_compare_exchange_n(&ctl->head, &pos, pos + 1, true,
                                      __ATOMIC_RELAXED, __ATOMIC_RELAXED)) {
        *out = s;
        return (int64_t)pos;
      }
    } else if (dif < 0) {
      return RR_FULL;
    } else {
      pos = __atomic_load_n(&ctl->head, __ATOMIC_RELAXED);
    }
  }
}

inline bool ring_empty(const Handle& hd, uint32_t r) {
  RingCtl* ctl = ring_ctl(hd, r);
  return __atomic_load_n(&ctl->tail, __ATOMIC_RELAXED) ==
         __atomic_load_n(&ctl->head, __ATOMIC_RELAXED);
}

}  // namespace

// The hot path: mint trace id, check the deadline, pick a replica
// (power-of-two choices over the snapshot's inflight counters), claim a
// frame slot and publish the payload — all in one native call, no GIL
// between steps. Returns flag bits >= 0 on success (RR_WAS_EMPTY means
// the drain loop may be parked — post its FIFO token); negative RR_*
// codes tell the Python wrapper to shed or fall back.
int64_t rr_enqueue(int h, const uint8_t* payload, uint32_t len,
                   uint64_t deadline_ns, uint64_t client, uint32_t tag,
                   uint64_t* out_trace, uint64_t* out_rid,
                   uint32_t* out_gen) {
  Handle* hd = get_handle(h);
  if (!hd) return RR_BAD;
  RingHeader* H = hdr_of(*hd);
  if (len > H->slot_bytes) {
    bump(H, ST_TOO_BIG);
    return RR_TOO_BIG;
  }
  uint64_t now = now_ns();
  if (deadline_ns && now > deadline_ns) {
    bump(H, ST_DEADLINE);
    return RR_DEADLINE;
  }

  // -- power-of-two replica choice over the live snapshot ---------------
  uint32_t cap = H->table_cap;
  uint32_t chosen = 0;
  uint32_t gen = 0;
  uint64_t rid = 0;
  for (int attempt = 0;; ++attempt) {
    if (attempt == 8) {
      bump(H, ST_NO_REPLICA);
      return RR_NO_REPLICA;
    }
    uint32_t cand[kMaxTableCap];
    uint32_t nc = 0;
    for (uint32_t i = 0; i < cap; ++i) {
      ReplicaEntry* e = entry(*hd, i);
      if (__atomic_load_n(&e->alive, __ATOMIC_ACQUIRE) &&
          __atomic_load_n(&e->id, __ATOMIC_ACQUIRE) != 0)
        cand[nc++] = i;
    }
    if (nc == 0) {
      bump(H, ST_NO_REPLICA);
      return RR_NO_REPLICA;
    }
    uint32_t pick;
    if (nc == 1) {
      pick = cand[0];
    } else {
      uint64_t r = xorshift();
      uint32_t ai = (uint32_t)(r % nc);
      uint32_t bi = (ai + 1 + (uint32_t)((r >> 32) % (nc - 1))) % nc;
      uint32_t a = cand[ai];
      uint32_t b = cand[bi];
      uint64_t ia = __atomic_load_n(&entry(*hd, a)->refgen,
                                    __ATOMIC_ACQUIRE) & 0xffffffffULL;
      uint64_t ib = __atomic_load_n(&entry(*hd, b)->refgen,
                                    __ATOMIC_ACQUIRE) & 0xffffffffULL;
      pick = (ia <= ib) ? a : b;
    }
    // inflight++ with generation check: if a publish/mark_dead recycled
    // the entry between the snapshot read and the CAS, retry the choice
    // instead of crediting a corpse (ABA-safe packed word)
    ReplicaEntry* e = entry(*hd, pick);
    uint64_t rg = __atomic_load_n(&e->refgen, __ATOMIC_ACQUIRE);
    if (!__atomic_load_n(&e->alive, __ATOMIC_ACQUIRE)) {
      bump(H, ST_CHOICE_RETRY);
      continue;
    }
    if (__atomic_compare_exchange_n(&e->refgen, &rg, rg + 1, false,
                                    __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE)) {
      chosen = pick;
      gen = (uint32_t)(rg >> 32);
      rid = __atomic_load_n(&e->id, __ATOMIC_ACQUIRE);
      break;
    }
    bump(H, ST_CHOICE_RETRY);
  }

  bool was_empty = ring_empty(*hd, chosen);
  Slot* s = nullptr;
  int64_t pos = claim_slot(*hd, chosen, &s);
  if (pos < 0) {
    // undo the inflight claim (gen-checked, like any completion)
    rr_done(h, rid, gen);
    bump(H, ST_FULL);
    return RR_FULL;
  }
  uint64_t trace = ((H->trace_seed >> 32) << 32) |
                   (__atomic_fetch_add(&H->trace_counter, 1,
                                       __ATOMIC_RELAXED) &
                    0xffffffffULL);
  s->hdr.trace = trace;
  s->hdr.rid = rid;
  s->hdr.deadline_ns = deadline_ns;
  s->hdr.enq_ns = now;
  s->hdr.client = client;
  s->hdr.gen = gen;
  s->hdr.tag = tag;
  s->hdr.len = len;
  s->hdr.pad = 0;
  if (len) std::memcpy(slot_payload(s), payload, len);
  __atomic_store_n(&s->seq, (uint64_t)pos + 1, __ATOMIC_RELEASE);
  bump(H, ST_ENQUEUED);
  if (out_trace) *out_trace = trace;
  if (out_rid) *out_rid = rid;
  if (out_gen) *out_gen = gen;
  return was_empty ? RR_WAS_EMPTY : 0;
}

// Direct enqueue into a specific sub-ring — the response path (a client
// response segment is a 1-entry domain whose only ring the replicas
// produce into) and tests. No replica choice, no inflight accounting;
// `trace` is caller-supplied so response frames correlate to requests.
int64_t rr_enqueue_to(int h, uint32_t ring, const uint8_t* payload,
                      uint32_t len, uint64_t trace, uint64_t client,
                      uint32_t tag) {
  Handle* hd = get_handle(h);
  if (!hd) return RR_BAD;
  RingHeader* H = hdr_of(*hd);
  if (ring >= H->table_cap) return RR_BAD;
  if (len > H->slot_bytes) {
    bump(H, ST_TOO_BIG);
    return RR_TOO_BIG;
  }
  bool was_empty = ring_empty(*hd, ring);
  Slot* s = nullptr;
  int64_t pos = claim_slot(*hd, ring, &s);
  if (pos < 0) {
    bump(H, ST_FULL);
    return RR_FULL;
  }
  s->hdr.trace = trace;
  s->hdr.rid = 0;
  s->hdr.deadline_ns = 0;
  s->hdr.enq_ns = now_ns();
  s->hdr.client = client;
  s->hdr.gen = 0;
  s->hdr.tag = tag;
  s->hdr.len = len;
  s->hdr.pad = 0;
  if (len) std::memcpy(slot_payload(s), payload, len);
  __atomic_store_n(&s->seq, (uint64_t)pos + 1, __ATOMIC_RELEASE);
  bump(H, ST_ENQUEUED);
  return was_empty ? RR_WAS_EMPTY : 0;
}

// Sub-ring index for a replica id (== its snapshot-table slot), -1 if
// the id is not in the table. The drain side resolves its ring once.
int rr_ring_of(int h, uint64_t id) {
  Handle* hd = get_handle(h);
  if (!hd || id == 0) return -1;
  RingHeader* H = hdr_of(*hd);
  for (uint32_t i = 0; i < H->table_cap; ++i)
    if (__atomic_load_n(&entry(*hd, i)->id, __ATOMIC_ACQUIRE) == id)
      return (int)i;
  return -1;
}

// Batch drain: pop up to max_frames frames from sub-ring `ring` into
// `out` as contiguous [FrameHdr][payload] records. ONE call per batch
// is the whole point — the Python consumer re-enters the interpreter
// once and iterates the batch with zero further synchronization.
// Returns the frame count; *out_bytes gets the bytes written.
int64_t rr_drain(int h, uint32_t ring, uint8_t* out, uint64_t cap,
                 uint32_t max_frames, uint64_t* out_bytes) {
  Handle* hd = get_handle(h);
  if (!hd) return RR_BAD;
  RingHeader* H = hdr_of(*hd);
  if (ring >= H->table_cap) return RR_BAD;
  RingCtl* ctl = ring_ctl(*hd, ring);
  uint64_t mask = H->slots - 1;
  uint64_t written = 0;
  uint32_t count = 0;
  while (count < max_frames) {
    uint64_t pos = __atomic_load_n(&ctl->tail, __ATOMIC_RELAXED);
    Slot* s = ring_slot(*hd, ring, pos & mask);
    uint64_t seq = __atomic_load_n(&s->seq, __ATOMIC_ACQUIRE);
    int64_t dif = (int64_t)seq - (int64_t)(pos + 1);
    if (dif < 0) break;  // empty
    if (dif > 0) continue;  // racing consumer advanced tail; reload
    if (written + sizeof(FrameHdr) + s->hdr.len > cap) break;
    if (!__atomic_compare_exchange_n(&ctl->tail, &pos, pos + 1, true,
                                     __ATOMIC_RELAXED, __ATOMIC_RELAXED))
      continue;
    std::memcpy(out + written, &s->hdr, sizeof(FrameHdr));
    written += sizeof(FrameHdr);
    if (s->hdr.len) {
      std::memcpy(out + written, slot_payload(s), s->hdr.len);
      written += s->hdr.len;
    }
    // slot free for the producers one lap ahead
    __atomic_store_n(&s->seq, pos + mask + 1, __ATOMIC_RELEASE);
    ++count;
  }
  if (count) {
    bump(H, ST_DRAINED, count);
    bump(H, ST_DRAIN_BATCHES);
  }
  if (out_bytes) *out_bytes = written;
  return count;
}

int64_t rr_pending(int h, uint32_t ring) {
  Handle* hd = get_handle(h);
  if (!hd) return RR_BAD;
  RingHeader* H = hdr_of(*hd);
  if (ring >= H->table_cap) return RR_BAD;
  RingCtl* ctl = ring_ctl(*hd, ring);
  uint64_t head = __atomic_load_n(&ctl->head, __ATOMIC_RELAXED);
  uint64_t tail = __atomic_load_n(&ctl->tail, __ATOMIC_RELAXED);
  return head >= tail ? (int64_t)(head - tail) : 0;
}

void rr_stats(int h, uint64_t* out) {
  Handle* hd = get_handle(h);
  if (!hd) {
    std::memset(out, 0, ST_COUNT * sizeof(uint64_t));
    return;
  }
  RingHeader* H = hdr_of(*hd);
  for (int i = 0; i < ST_COUNT; ++i)
    out[i] = __atomic_load_n(&H->stats[i], __ATOMIC_RELAXED);
}

// Seqlock snapshot read: rows of {id, gen, inflight, alive, ring} (5
// u64 each), consistent against a concurrent publish — readers retry
// while the sequence is odd or moved during the copy. Returns the row
// count; *out_version gets the published replica-set version.
int rr_snapshot(int h, uint64_t* out, uint32_t cap_rows,
                uint64_t* out_version) {
  Handle* hd = get_handle(h);
  if (!hd) return (int)RR_BAD;
  RingHeader* H = hdr_of(*hd);
  uint32_t cap = H->table_cap;
  for (int tries = 0; tries < 10000; ++tries) {
    uint64_t s0 = __atomic_load_n(&H->table_seq, __ATOMIC_ACQUIRE);
    if (s0 & 1) {
      sched_yield();
      continue;
    }
    uint32_t rows = 0;
    for (uint32_t i = 0; i < cap && rows < cap_rows; ++i) {
      ReplicaEntry* e = entry(*hd, i);
      uint64_t id = __atomic_load_n(&e->id, __ATOMIC_ACQUIRE);
      if (id == 0) continue;
      uint64_t rg = __atomic_load_n(&e->refgen, __ATOMIC_ACQUIRE);
      out[rows * 5 + 0] = id;
      out[rows * 5 + 1] = rg >> 32;
      out[rows * 5 + 2] = rg & 0xffffffffULL;
      out[rows * 5 + 3] = __atomic_load_n(&e->alive, __ATOMIC_ACQUIRE);
      out[rows * 5 + 4] = i;
      ++rows;
    }
    uint64_t v = __atomic_load_n(&H->published_version, __ATOMIC_ACQUIRE);
    uint64_t s1 = __atomic_load_n(&H->table_seq, __ATOMIC_ACQUIRE);
    if (s0 == s1) {
      if (out_version) *out_version = v;
      return (int)rows;
    }
  }
  return (int)RR_BAD;
}

}  // extern "C"
