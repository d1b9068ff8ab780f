// Shared-memory immutable object store — one per node, created by the node
// daemon, attached by every worker/driver on the host.
//
// TPU-native analog of the reference's Plasma store
// (/root/reference/src/ray/object_manager/plasma/: ObjectStore /
// ObjectLifecycleManager / EvictionPolicy / dlmalloc shm allocator).  Design
// deltas from the reference, chosen for the TPU process model:
//   - The store lives in one mmap'd POSIX shm segment shared by all local
//     processes; no broker socket / fd passing (plasma's fling.cc) — clients
//     address objects by (offset, size) inside the common mapping, so a get
//     is a pointer, not an IPC round trip.
//   - Synchronization is a single process-shared robust pthread mutex in the
//     segment header plus a monotonically increasing seal counter clients can
//     poll/futex on.  (Plasma serializes through its event loop instead.)
//   - Allocation is a first-fit free list with coalescing; eviction is LRU
//     over sealed, unpinned objects (plasma: eviction_policy.h LRUCache).
//
// Object lifecycle: CREATED -> SEALED (immutable) -> deleted/evicted.
// Pins (get) protect sealed objects from eviction; creators hold an implicit
// pin until seal+release.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <pthread.h>

extern "C" {

static const uint64_t kMagic = 0x5241595450553031ULL;  // "RAYTPU01"
static const uint32_t kIdLen = 20;

enum ObjState : uint32_t { FREE_SLOT = 0, CREATED = 1, SEALED = 2 };

struct ObjEntry {
  uint8_t id[kIdLen];
  uint32_t state;
  uint64_t offset;
  uint64_t size;
  uint64_t meta;       // small user metadata word (e.g. error flag)
  int32_t pins;
  uint64_t lru_tick;
};

struct FreeBlock {
  uint64_t offset;
  uint64_t size;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;       // bytes of the data arena
  uint64_t data_start;     // offset of arena from segment base
  uint32_t table_size;     // number of ObjEntry slots
  uint32_t max_free;       // capacity of free list
  pthread_mutex_t mutex;
  uint64_t seal_count;     // bumped on every seal (clients poll this)
  uint64_t lru_clock;
  uint64_t bytes_in_use;
  uint64_t leaked_bytes;   // blocks lost when the free list overflowed
  uint32_t num_objects;
  uint32_t num_free;       // free-list entries
  // followed by: ObjEntry[table_size], FreeBlock[max_free], data arena
};

static ObjEntry* table_of(Header* h) {
  return reinterpret_cast<ObjEntry*>(reinterpret_cast<char*>(h) + sizeof(Header));
}
static FreeBlock* freelist_of(Header* h) {
  return reinterpret_cast<FreeBlock*>(
      reinterpret_cast<char*>(table_of(h)) + sizeof(ObjEntry) * h->table_size);
}

// ---------------------------------------------------------------------------
// init / attach
// ---------------------------------------------------------------------------

// Required segment size for a store of `capacity` data bytes.
uint64_t store_segment_size(uint64_t capacity, uint32_t table_size,
                            uint32_t max_free) {
  return sizeof(Header) + sizeof(ObjEntry) * table_size +
         sizeof(FreeBlock) * max_free + capacity;
}

// Initialize a zeroed mapping as a store. Returns 0 on success.
int store_init(void* base, uint64_t capacity, uint32_t table_size,
               uint32_t max_free) {
  Header* h = static_cast<Header*>(base);
  memset(h, 0, sizeof(Header));
  h->capacity = capacity;
  h->table_size = table_size;
  h->max_free = max_free;
  h->data_start = sizeof(Header) + sizeof(ObjEntry) * table_size +
                  sizeof(FreeBlock) * max_free;
  memset(table_of(h), 0, sizeof(ObjEntry) * table_size);
  FreeBlock* fl = freelist_of(h);
  fl[0].offset = h->data_start;
  fl[0].size = capacity;
  h->num_free = 1;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  if (pthread_mutex_init(&h->mutex, &attr) != 0) return -1;
  pthread_mutexattr_destroy(&attr);
  __sync_synchronize();
  h->magic = kMagic;
  return 0;
}

int store_validate(void* base) {
  Header* h = static_cast<Header*>(base);
  return h->magic == kMagic ? 0 : -1;
}

static int lock(Header* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {
    // A holder died mid-operation; table stays usable (ops are idempotent
    // enough for our immutable objects), mark consistent and continue.
    pthread_mutex_consistent(&h->mutex);
    rc = 0;
  }
  return rc;
}
static void unlock(Header* h) { pthread_mutex_unlock(&h->mutex); }

// ---------------------------------------------------------------------------
// table / allocator helpers (mutex held)
// ---------------------------------------------------------------------------

static uint32_t hash_id(const uint8_t* id) {
  uint64_t x = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; i++) { x ^= id[i]; x *= 1099511628211ULL; }
  return static_cast<uint32_t>(x);
}

static ObjEntry* find_entry(Header* h, const uint8_t* id, int for_insert) {
  ObjEntry* t = table_of(h);
  uint32_t n = h->table_size;
  uint32_t start = hash_id(id) % n;
  ObjEntry* first_free = nullptr;
  for (uint32_t probe = 0; probe < n; probe++) {
    ObjEntry* e = &t[(start + probe) % n];
    if (e->state == FREE_SLOT) {
      if (!first_free) first_free = e;
      // open addressing without tombstones: FREE ends the probe chain only
      // if we never delete mid-chain; we compact on delete (see erase).
      break;
    }
    if (memcmp(e->id, id, kIdLen) == 0) return e;
  }
  return for_insert ? first_free : nullptr;
}

// Robin-hood-free deletion: re-insert the tail of the probe cluster.
static void erase_entry(Header* h, ObjEntry* e) {
  ObjEntry* t = table_of(h);
  uint32_t n = h->table_size;
  uint32_t idx = static_cast<uint32_t>(e - t);
  e->state = FREE_SLOT;
  uint32_t i = (idx + 1) % n;
  while (t[i].state != FREE_SLOT) {
    ObjEntry moved = t[i];
    t[i].state = FREE_SLOT;
    ObjEntry* dst = find_entry(h, moved.id, 1);
    *dst = moved;
    i = (i + 1) % n;
  }
}

static int free_insert(Header* h, uint64_t offset, uint64_t size) {
  FreeBlock* fl = freelist_of(h);
  uint32_t n = h->num_free;
  // find insertion point (keep sorted by offset) and coalesce
  uint32_t i = 0;
  while (i < n && fl[i].offset < offset) i++;
  // coalesce with previous
  if (i > 0 && fl[i - 1].offset + fl[i - 1].size == offset) {
    fl[i - 1].size += size;
    if (i < n && fl[i - 1].offset + fl[i - 1].size == fl[i].offset) {
      fl[i - 1].size += fl[i].size;
      memmove(&fl[i], &fl[i + 1], (n - i - 1) * sizeof(FreeBlock));
      h->num_free--;
    }
    return 0;
  }
  // coalesce with next
  if (i < n && offset + size == fl[i].offset) {
    fl[i].offset = offset;
    fl[i].size += size;
    return 0;
  }
  if (n >= h->max_free) return -1;  // fragmented beyond free-list capacity
  memmove(&fl[i + 1], &fl[i], (n - i) * sizeof(FreeBlock));
  fl[i].offset = offset;
  fl[i].size = size;
  h->num_free++;
  return 0;
}

// free_insert that records un-recordable blocks instead of silently
// dropping them (free-list overflow under heavy fragmentation).
static void free_or_leak(Header* h, uint64_t offset, uint64_t size) {
  if (free_insert(h, offset, size) != 0) h->leaked_bytes += size;
}

static uint64_t alloc_block(Header* h, uint64_t size) {
  FreeBlock* fl = freelist_of(h);
  for (uint32_t i = 0; i < h->num_free; i++) {
    if (fl[i].size >= size) {
      uint64_t off = fl[i].offset;
      fl[i].offset += size;
      fl[i].size -= size;
      if (fl[i].size == 0) {
        memmove(&fl[i], &fl[i + 1], (h->num_free - i - 1) * sizeof(FreeBlock));
        h->num_free--;
      }
      return off;
    }
  }
  return 0;  // 0 is never a valid data offset (header lives there)
}

// Evict least-recently-used sealed unpinned objects until `needed` bytes can
// be allocated. Returns 1 if progress was made.
static int evict_lru(Header* h, uint64_t needed) {
  int evicted_any = 0;
  for (;;) {
    // check if an allocation of `needed` would now succeed
    FreeBlock* fl = freelist_of(h);
    for (uint32_t i = 0; i < h->num_free; i++)
      if (fl[i].size >= needed) return 1;
    // find LRU victim
    ObjEntry* t = table_of(h);
    ObjEntry* victim = nullptr;
    for (uint32_t i = 0; i < h->table_size; i++) {
      ObjEntry* e = &t[i];
      if (e->state == SEALED && e->pins == 0 &&
          (!victim || e->lru_tick < victim->lru_tick))
        victim = e;
    }
    if (!victim) return evicted_any;
    free_or_leak(h, victim->offset, victim->size);
    h->bytes_in_use -= victim->size;
    h->num_objects--;
    erase_entry(h, victim);
    evicted_any = 1;
  }
}

// ---------------------------------------------------------------------------
// public object API (all lock internally)
// ---------------------------------------------------------------------------

// rc: 0 ok; -1 exists; -2 out of memory; -3 table full.  allow_evict=0 keeps
// LRU eviction out of the allocation path: primary copies must be spilled to
// disk by the raylet (request_spill), never silently dropped — reference
// semantics where the raylet pins primaries and plasma only evicts
// secondary copies (local_object_manager.h).
long long store_create(void* base, const uint8_t* id, uint64_t size,
                       uint64_t meta, int allow_evict) {
  Header* h = static_cast<Header*>(base);
  if (size == 0) size = 1;
  if (lock(h) != 0) return -4;
  ObjEntry* existing = find_entry(h, id, 0);
  if (existing) { unlock(h); return -1; }
  uint64_t off = alloc_block(h, size);
  if (!off && allow_evict) {
    evict_lru(h, size);
    off = alloc_block(h, size);
  }
  if (!off) { unlock(h); return -2; }
  ObjEntry* e = find_entry(h, id, 1);
  if (!e) { free_or_leak(h, off, size); unlock(h); return -3; }
  memcpy(e->id, id, kIdLen);
  e->state = CREATED;
  e->offset = off;
  e->size = size;
  e->meta = meta;
  e->pins = 1;  // creator pin
  e->lru_tick = ++h->lru_clock;
  h->bytes_in_use += size;
  h->num_objects++;
  unlock(h);
  return static_cast<long long>(off);
}

int store_seal(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  if (lock(h) != 0) return -4;
  ObjEntry* e = find_entry(h, id, 0);
  if (!e || e->state != CREATED) { unlock(h); return -1; }
  e->state = SEALED;
  e->pins -= 1;  // drop creator pin
  h->seal_count++;
  unlock(h);
  return 0;
}

// Sealed get: pins the object. out = {offset, size, meta}. rc 0 ok, -1 absent,
// -2 present but unsealed.
int store_get(void* base, const uint8_t* id, uint64_t* out) {
  Header* h = static_cast<Header*>(base);
  if (lock(h) != 0) return -4;
  ObjEntry* e = find_entry(h, id, 0);
  if (!e) { unlock(h); return -1; }
  if (e->state != SEALED) { unlock(h); return -2; }
  e->pins += 1;
  e->lru_tick = ++h->lru_clock;
  out[0] = e->offset;
  out[1] = e->size;
  out[2] = e->meta;
  unlock(h);
  return 0;
}

int store_release(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  if (lock(h) != 0) return -4;
  ObjEntry* e = find_entry(h, id, 0);
  if (!e || e->pins <= 0) { unlock(h); return -1; }
  e->pins -= 1;
  unlock(h);
  return 0;
}

int store_contains(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  if (lock(h) != 0) return -4;
  ObjEntry* e = find_entry(h, id, 0);
  int rc = (e && e->state == SEALED) ? 1 : 0;
  unlock(h);
  return rc;
}

// Delete a sealed object (refuses if pinned). rc 0 ok, -1 absent, -2 pinned.
int store_delete(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  if (lock(h) != 0) return -4;
  ObjEntry* e = find_entry(h, id, 0);
  if (!e) { unlock(h); return -1; }
  if (e->pins > 0) { unlock(h); return -2; }
  free_or_leak(h, e->offset, e->size);
  h->bytes_in_use -= e->size;
  h->num_objects--;
  erase_entry(h, e);
  unlock(h);
  return 0;
}

// Abort an in-progress create (creator died / failed serialization).
int store_abort(void* base, const uint8_t* id) {
  Header* h = static_cast<Header*>(base);
  if (lock(h) != 0) return -4;
  ObjEntry* e = find_entry(h, id, 0);
  if (!e || e->state != CREATED) { unlock(h); return -1; }
  free_or_leak(h, e->offset, e->size);
  h->bytes_in_use -= e->size;
  h->num_objects--;
  erase_entry(h, e);
  unlock(h);
  return 0;
}

uint64_t store_seal_count(void* base) {
  return static_cast<Header*>(base)->seal_count;
}

// Enumerate sealed objects for the spill manager's victim selection
// (reference: LocalObjectManager::SpillObjectsOfSize walks the plasma
// eviction policy's LRU list, local_object_manager.h).  Packs up to
// `max_entries` records of [id (20B) | size u64 | lru_tick u64 | pins i32]
// = 40 bytes each into out_buf, LRU order not guaranteed (caller sorts by
// lru_tick).  Returns the number of entries written.
uint32_t store_list(void* base, uint8_t* out_buf, uint32_t max_entries) {
  Header* h = static_cast<Header*>(base);
  if (lock(h) != 0) return 0;
  ObjEntry* t = table_of(h);
  uint32_t written = 0;
  for (uint32_t i = 0; i < h->table_size && written < max_entries; i++) {
    ObjEntry* e = &t[i];
    if (e->state != SEALED) continue;
    uint8_t* rec = out_buf + written * 40;
    memcpy(rec, e->id, kIdLen);
    memcpy(rec + 20, &e->size, 8);
    memcpy(rec + 28, &e->lru_tick, 8);
    memcpy(rec + 36, &e->pins, 4);
    written++;
  }
  unlock(h);
  return written;
}

void store_stats(void* base, uint64_t* out) {
  Header* h = static_cast<Header*>(base);
  lock(h);
  out[0] = h->capacity;
  out[1] = h->bytes_in_use;
  out[2] = h->num_objects;
  out[3] = h->num_free;
  out[4] = h->leaked_bytes;
  unlock(h);
}

}  // extern "C"
