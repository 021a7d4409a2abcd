// shm_ring.cc — POSIX shared-memory MPSC ring buffer for DataLoader worker
// transport (the port's own copy of paddle_tpu/io/native/shm_ring.cc,
// built by paddle_tpu_torch/io/shm_ring.py into build/paddle_tpu_torch/).
//
// Worker processes serialize numpy batches straight into a shared-memory
// ring; the main process consumes them without pipe writes, pickling
// through a multiprocessing.Queue feeder thread, or per-batch shm segment
// churn.
//
// Design: single ring, many producers (workers), one consumer (main process).
//  - A global counting semaphore `sem_free` bounds outstanding tickets to
//    n_slots, so slot (ticket % n_slots) is guaranteed recycled before a
//    producer claims it.
//  - Producers claim a monotonically increasing ticket with an atomic
//    fetch-add, memcpy their payload into the slot, then post that slot's
//    per-slot semaphore.
//  - The consumer consumes tickets strictly in order, waiting on the per-slot
//    semaphore (this tolerates producers committing out of ticket order), and
//    posts `sem_free` once a slot's bytes are copied out.
// Messages larger than one slot are chunked by the Python layer; chunk
// payloads of one message occupy that producer's consecutive tickets.
//
// Exposed as a plain C ABI for ctypes.
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <semaphore.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x52494e47;  // "RING"

struct RingHeader {
  uint32_t magic;
  uint32_t n_slots;
  uint64_t slot_bytes;   // payload capacity per slot, 8-byte aligned
  uint64_t write_ticket; // atomic: next ticket to hand to a producer
  uint32_t stopped;      // atomic flag: wake + fail producers on shutdown
  uint32_t _pad;
  sem_t sem_free;        // counts free slots
};

struct SlotHeader {
  uint64_t nbytes;  // valid payload bytes in this slot
};

struct Handle {
  RingHeader* hdr;
  size_t map_bytes;
  char name[256];
  bool owner;
};

sem_t* slot_sems(RingHeader* h) {
  return reinterpret_cast<sem_t*>(reinterpret_cast<char*>(h) +
                                  sizeof(RingHeader));
}

size_t slot_stride(const RingHeader* h) {
  return sizeof(SlotHeader) + h->slot_bytes;
}

char* slot_at(RingHeader* h, uint64_t ticket) {
  char* base = reinterpret_cast<char*>(slot_sems(h)) +
               static_cast<size_t>(h->n_slots) * sizeof(sem_t);
  return base + (ticket % h->n_slots) * slot_stride(h);
}

int timed_wait(sem_t* s, int timeout_ms) {
  int r;
  if (timeout_ms < 0) {
    while ((r = sem_wait(s)) == -1 && errno == EINTR) {
    }
    return r;
  }
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += static_cast<long>(timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  while ((r = sem_timedwait(s, &ts)) == -1 && errno == EINTR) {
  }
  return r;
}

size_t map_bytes_for(uint64_t slot_bytes, uint32_t n_slots) {
  return sizeof(RingHeader) + static_cast<size_t>(n_slots) * sizeof(sem_t) +
         static_cast<size_t>(n_slots) * (sizeof(SlotHeader) + slot_bytes);
}

}  // namespace

extern "C" {

// Create a fresh ring; unlinks any stale segment of the same name first.
// Returns an opaque handle, or null on failure.
void* ring_create(const char* name, uint64_t slot_bytes, uint32_t n_slots) {
  if (n_slots == 0 || slot_bytes == 0) return nullptr;
  slot_bytes = (slot_bytes + 7) & ~uint64_t(7);  // keep payloads 8-aligned
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = map_bytes_for(slot_bytes, n_slots);
  if (ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* h = static_cast<RingHeader*>(mem);
  std::memset(mem, 0, sizeof(RingHeader));
  h->n_slots = n_slots;
  h->slot_bytes = slot_bytes;
  if (sem_init(&h->sem_free, /*pshared=*/1, n_slots) != 0) {
    munmap(mem, bytes);
    shm_unlink(name);
    return nullptr;
  }
  sem_t* sems = slot_sems(h);
  for (uint32_t i = 0; i < n_slots; ++i) {
    if (sem_init(&sems[i], /*pshared=*/1, 0) != 0) {
      munmap(mem, bytes);
      shm_unlink(name);
      return nullptr;
    }
  }
  __atomic_store_n(&h->magic, kMagic, __ATOMIC_RELEASE);
  auto* handle = new Handle{};
  handle->hdr = h;
  handle->map_bytes = bytes;
  std::strncpy(handle->name, name, sizeof(handle->name) - 1);
  handle->owner = true;
  return handle;
}

// Attach to an existing ring by name (worker side). Null on failure.
void* ring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(RingHeader)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = static_cast<RingHeader*>(mem);
  if (__atomic_load_n(&h->magic, __ATOMIC_ACQUIRE) != kMagic ||
      map_bytes_for(h->slot_bytes, h->n_slots) !=
          static_cast<size_t>(st.st_size)) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* handle = new Handle{};
  handle->hdr = h;
  handle->map_bytes = static_cast<size_t>(st.st_size);
  std::strncpy(handle->name, name, sizeof(handle->name) - 1);
  handle->owner = false;
  return handle;
}

uint64_t ring_slot_bytes(void* hv) {
  return static_cast<Handle*>(hv)->hdr->slot_bytes;
}

uint32_t ring_n_slots(void* hv) {
  return static_cast<Handle*>(hv)->hdr->n_slots;
}

// Producer: block until a slot is free, claim the next ticket.
// Returns 0 and writes *ticket_out on success; -1 on timeout; -2 if stopped.
int ring_producer_acquire(void* hv, uint64_t* ticket_out, int timeout_ms) {
  auto* h = static_cast<Handle*>(hv)->hdr;
  if (__atomic_load_n(&h->stopped, __ATOMIC_ACQUIRE)) return -2;
  if (timed_wait(&h->sem_free, timeout_ms) != 0) return -1;
  if (__atomic_load_n(&h->stopped, __ATOMIC_ACQUIRE)) return -2;
  *ticket_out = __atomic_fetch_add(&h->write_ticket, 1, __ATOMIC_ACQ_REL);
  return 0;
}

// Payload pointer for a claimed/owned ticket.
char* ring_payload(void* hv, uint64_t ticket) {
  auto* h = static_cast<Handle*>(hv)->hdr;
  return slot_at(h, ticket) + sizeof(SlotHeader);
}

// Producer: publish `nbytes` of payload written at ring_payload(ticket).
void ring_producer_commit(void* hv, uint64_t ticket, uint64_t nbytes) {
  auto* h = static_cast<Handle*>(hv)->hdr;
  reinterpret_cast<SlotHeader*>(slot_at(h, ticket))->nbytes = nbytes;
  sem_post(&slot_sems(h)[ticket % h->n_slots]);
}

// Consumer: wait for `ticket` (the consumer's own in-order counter) to be
// committed. Returns 0 and writes *nbytes_out; -1 on timeout.
int ring_consumer_wait(void* hv, uint64_t ticket, uint64_t* nbytes_out,
                       int timeout_ms) {
  auto* h = static_cast<Handle*>(hv)->hdr;
  if (timed_wait(&slot_sems(h)[ticket % h->n_slots], timeout_ms) != 0)
    return -1;
  *nbytes_out = reinterpret_cast<SlotHeader*>(slot_at(h, ticket))->nbytes;
  return 0;
}

// Consumer: recycle the slot after copying its bytes out.
void ring_consumer_release(void* hv) {
  sem_post(&static_cast<Handle*>(hv)->hdr->sem_free);
}

// Wake every producer blocked in acquire and make future acquires fail fast.
void ring_stop(void* hv) {
  auto* h = static_cast<Handle*>(hv)->hdr;
  __atomic_store_n(&h->stopped, 1, __ATOMIC_RELEASE);
  for (uint32_t i = 0; i < h->n_slots; ++i) sem_post(&h->sem_free);
}

void ring_close(void* hv, int unlink) {
  auto* handle = static_cast<Handle*>(hv);
  munmap(handle->hdr, handle->map_bytes);
  if (unlink) shm_unlink(handle->name);
  delete handle;
}

}  // extern "C"
