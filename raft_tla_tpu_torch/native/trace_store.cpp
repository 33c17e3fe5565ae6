// Native predecessor-trace store — TLC's trace file rebuilt as an in-memory
// open-addressing hash map (SURVEY §2.4 R5).
//
// TLC reconstructs counterexamples from a disk-backed trace of (fingerprint
// -> predecessor fingerprint) records [TLC semantics — external].  Here the
// engine streams one compacted (fp, parent fp, action id) triple per newly
// discovered state off the device each batch; this store ingests those
// batches at memcpy-like rates so the host-side bookkeeping never throttles
// the device pipeline.  Python binds via ctypes (native/__init__.py loads
// the .so; engine/trace.py wraps it) — no pybind11 dependency.
//
// Layout: open addressing, linear probing, power-of-two capacity, grow at
// 70% load.  First insert wins (BFS reaches a state first along a shortest
// path; later duplicates arrive only from in-flight batches of the same
// level and must not overwrite the shortest-path parent).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Entry {
    uint64_t fp;
    uint64_t parent;
    int32_t action;
    uint8_t used;
};

struct Store {
    Entry* slots;
    uint64_t capacity;   // power of two
    uint64_t size;
};

// splitmix64: decorrelates slot index from the engine's own fingerprint
// mixing so pathological fp batches cannot cluster probes.
inline uint64_t mix(uint64_t x) {
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
}

void grow(Store* s);

inline void insert_one(Store* s, uint64_t fp, uint64_t parent,
                       int32_t action) {
    uint64_t mask = s->capacity - 1;
    uint64_t i = mix(fp) & mask;
    while (s->slots[i].used) {
        if (s->slots[i].fp == fp) return;  // first insert wins
        i = (i + 1) & mask;
    }
    s->slots[i] = Entry{fp, parent, action, 1};
    s->size++;
    if (s->size * 10 >= s->capacity * 7) grow(s);
}

void grow(Store* s) {
    Entry* old = s->slots;
    uint64_t old_cap = s->capacity;
    s->capacity <<= 1;
    s->slots = static_cast<Entry*>(calloc(s->capacity, sizeof(Entry)));
    s->size = 0;
    for (uint64_t i = 0; i < old_cap; i++)
        if (old[i].used)
            insert_one(s, old[i].fp, old[i].parent, old[i].action);
    free(old);
}

}  // namespace

extern "C" {

void* ts_create(uint64_t initial_capacity) {
    uint64_t cap = 1024;
    while (cap < initial_capacity) cap <<= 1;
    Store* s = static_cast<Store*>(malloc(sizeof(Store)));
    s->slots = static_cast<Entry*>(calloc(cap, sizeof(Entry)));
    s->capacity = cap;
    s->size = 0;
    return s;
}

void ts_destroy(void* h) {
    Store* s = static_cast<Store*>(h);
    free(s->slots);
    free(s);
}

uint64_t ts_size(void* h) { return static_cast<Store*>(h)->size; }

void ts_add_batch(void* h, const uint64_t* fps, const uint64_t* parents,
                  const int32_t* actions, uint64_t n) {
    Store* s = static_cast<Store*>(h);
    for (uint64_t k = 0; k < n; k++)
        insert_one(s, fps[k], parents[k], actions[k]);
}

int ts_get(void* h, uint64_t fp, uint64_t* parent, int32_t* action) {
    Store* s = static_cast<Store*>(h);
    uint64_t mask = s->capacity - 1;
    uint64_t i = mix(fp) & mask;
    while (s->slots[i].used) {
        if (s->slots[i].fp == fp) {
            *parent = s->slots[i].parent;
            *action = s->slots[i].action;
            return 1;
        }
        i = (i + 1) & mask;
    }
    return 0;
}

// Bulk export for checkpointing: writes up to `cap` triples; returns the
// number written (== size when cap is sufficient).
uint64_t ts_export(void* h, uint64_t* fps, uint64_t* parents,
                   int32_t* actions, uint64_t cap) {
    Store* s = static_cast<Store*>(h);
    uint64_t k = 0;
    for (uint64_t i = 0; i < s->capacity && k < cap; i++) {
        if (s->slots[i].used) {
            fps[k] = s->slots[i].fp;
            parents[k] = s->slots[i].parent;
            actions[k] = s->slots[i].action;
            k++;
        }
    }
    return k;
}

}  // extern "C"
