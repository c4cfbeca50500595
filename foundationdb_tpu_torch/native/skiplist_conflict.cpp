// Native CPU conflict set: a versioned skip list over byte-string keyspace.
//
// This is the CPU baseline the CUDA kernels are measured against — the same
// role the versioned skip list plays in the reference
// (fdbserver/SkipList.cpp behind fdbserver/ConflictSet.h:28
// newConflictSet()). Independent, idiomatic implementation of the same data
// structure family: a skip list whose nodes are range boundaries; each node
// stores the max commit version of the half-open gap to its successor, so
//
//   query_max([a,b))   = descend towers to the gap containing `a`,
//                        then walk gaps until `b` taking the max;
//   insert_range at v  = ensure boundary nodes for a and b (splitting gaps,
//                        inheriting the split gap's version), raise gaps;
//   GC                 = amortized sweep from a cursor (the reference's
//                        removalKey scheme, SkipList.cpp:665): flatten gaps
//                        below the horizon and unlink redundant boundaries.
//
// Exposed as a C ABI for ctypes (foundationdb_tpu_torch/conflict/native.py):
// csn_create / csn_destroy / csn_resolve (one whole commit batch per call).
//
// Batch semantics mirror conflict/api.py (and the reference ConflictBatch):
// too-old filter → history check → in-order intra-batch check → merge
// committed writes at `now` → advance GC horizon.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

using Version = int64_t;

struct Key {
  const uint8_t* p = nullptr;
  uint32_t len = 0;
  bool operator<(const Key& o) const {
    uint32_t m = len < o.len ? len : o.len;
    int c = m ? std::memcmp(p, o.p, m) : 0;
    if (c) return c < 0;
    return len < o.len;
  }
  bool operator==(const Key& o) const {
    return len == o.len && (len == 0 || std::memcmp(p, o.p, len) == 0);
  }
};

constexpr int kMaxLevel = 20;

struct Node {
  Version gap;  // max version of [key, next[0]->key)
  uint32_t len;
  int level;
  uint8_t* bytes;
  Node* next[1];  // variable length: [level+1]

  Key key() const { return Key{bytes, len}; }

  static Node* make(const Key& k, int level) {
    Node* n = (Node*)std::malloc(sizeof(Node) + level * sizeof(Node*));
    n->gap = 0;
    n->len = k.len;
    n->level = level;
    n->bytes = (uint8_t*)std::malloc(k.len ? k.len : 1);
    if (k.len) std::memcpy(n->bytes, k.p, k.len);
    for (int l = 0; l <= level; l++) n->next[l] = nullptr;
    return n;
  }
  void destroy() {
    std::free(bytes);
    std::free(this);
  }
};

class VersionedSkipList {
 public:
  VersionedSkipList() : rng_(0x2545F4914F6CDD1Dull), count_(1) {
    head_ = Node::make(Key{nullptr, 0}, kMaxLevel);
  }
  ~VersionedSkipList() {
    Node* n = head_;
    while (n) {
      Node* nx = n->next[0];
      n->destroy();
      n = nx;
    }
  }

  Version query_max(const Key& begin, const Key& end) const {
    Node* n = pred(begin);
    Version best = n->gap;
    for (Node* c = n->next[0]; c && c->key() < end; c = c->next[0]) {
      if (c->gap > best) best = c->gap;
    }
    return best;
  }

  void insert_range(const Key& begin, const Key& end, Version now) {
    ensure_boundary(end);
    Node* b = ensure_boundary(begin);
    for (Node* c = b; c && c->key() < end; c = c->next[0]) {
      if (c->gap < now) c->gap = now;
    }
  }

  // Amortized GC from a persistent cursor; visits up to `budget` nodes.
  void sweep(Version oldest, int budget) {
    Node* prev = cursor_valid_ ? pred(Key{cursor_.data(), (uint32_t)cursor_.size()})
                               : head_;
    for (int i = 0; i < budget; i++) {
      Node* n = prev->next[0];
      if (!n) {
        if (head_->gap < oldest) head_->gap = 0;
        cursor_valid_ = false;  // wrapped
        return;
      }
      if (n->gap < oldest) n->gap = 0;
      if (prev->gap < oldest) prev->gap = 0;
      if (prev->gap == n->gap) {
        unlink(n);
        n->destroy();
        count_--;
      } else {
        prev = n;
      }
    }
    Key k = prev->key();
    cursor_.assign(k.p, k.p + k.len);
    cursor_valid_ = true;
  }

  size_t count() const { return count_; }

 private:
  Node* head_;
  uint64_t rng_;
  size_t count_;
  std::basic_string<uint8_t> cursor_;
  bool cursor_valid_ = false;

  uint64_t next_rand() {  // xorshift64*
    rng_ ^= rng_ >> 12;
    rng_ ^= rng_ << 25;
    rng_ ^= rng_ >> 27;
    return rng_ * 0x2545F4914F6CDD1Dull;
  }
  int random_level() {
    uint64_t r = next_rand();
    int l = 0;
    while ((r & 3) == 0 && l < kMaxLevel) {  // p = 1/4 per level
      l++;
      r >>= 2;
    }
    return l;
  }

  // Last node with key <= k (head if none).
  Node* pred(const Key& k) const {
    Node* n = head_;
    for (int l = kMaxLevel; l >= 0; l--) {
      while (n->next[l] && !(k < n->next[l]->key())) n = n->next[l];
    }
    return n;
  }

  Node* ensure_boundary(const Key& k) {
    Node* update[kMaxLevel + 1];
    Node* n = head_;
    for (int l = kMaxLevel; l >= 0; l--) {
      while (n->next[l] && n->next[l]->key() < k) n = n->next[l];
      update[l] = n;
    }
    Node* at = n->next[0];
    if (at && at->key() == k) return at;
    int lvl = random_level();
    Node* nn = Node::make(k, lvl);
    nn->gap = update[0]->gap;  // splitting the predecessor's gap
    for (int l = 0; l <= lvl; l++) {
      nn->next[l] = update[l]->next[l];
      update[l]->next[l] = nn;
    }
    count_++;
    return nn;
  }

  void unlink(Node* n) {
    Key k = n->key();
    Node* u = head_;
    for (int l = kMaxLevel; l >= 0; l--) {
      while (u->next[l] && u->next[l]->key() < k) u = u->next[l];
      if (u->next[l] == n) u->next[l] = n->next[l];
    }
  }
};

struct ConflictSetN {
  VersionedSkipList list;
  Version oldest = 0;
};

}  // namespace

extern "C" {

void* csn_create() { return new ConflictSetN(); }
void csn_destroy(void* cs) { delete static_cast<ConflictSetN*>(cs); }
void csn_set_oldest(void* cs, int64_t v) {
  static_cast<ConflictSetN*>(cs)->oldest = v;
}
int64_t csn_count(void* cs) {
  return (int64_t)static_cast<ConflictSetN*>(cs)->list.count();
}

// Resolve one commit batch.
//  keys: concatenated key bytes; key i = keys[offsets[i]..offsets[i+1])
//  reads / writes: (begin_key_idx, end_key_idx, txn_idx) triples, grouped by
//    txn in batch order
//  snapshots: per-txn read snapshot
//  verdicts out: 0 = committed, 1 = conflict, 2 = too old
void csn_resolve(void* csv, const uint8_t* keys, const uint64_t* offsets,
                 const int32_t* reads, int32_t n_reads, const int32_t* writes,
                 int32_t n_writes, const int64_t* snapshots, int32_t n_txns,
                 int64_t now, int64_t new_oldest, uint8_t* verdicts) {
  auto* cs = static_cast<ConflictSetN*>(csv);
  auto key_at = [&](int32_t i) {
    return Key{keys + offsets[i], (uint32_t)(offsets[i + 1] - offsets[i])};
  };

  std::vector<uint8_t> has_reads(n_txns, 0);
  for (int i = 0; i < n_reads; i++) has_reads[reads[3 * i + 2]] = 1;
  for (int t = 0; t < n_txns; t++)
    verdicts[t] = (has_reads[t] && snapshots[t] < cs->oldest) ? 2 : 0;

  for (int i = 0; i < n_reads; i++) {
    int32_t t = reads[3 * i + 2];
    if (verdicts[t]) continue;
    Key b = key_at(reads[3 * i]), e = key_at(reads[3 * i + 1]);
    if (b < e && cs->list.query_max(b, e) > snapshots[t]) verdicts[t] = 1;
  }

  {  // intra-batch: earlier committed writes vs later reads, in order
    VersionedSkipList mini;
    int ri = 0, wi = 0;
    for (int t = 0; t < n_txns; t++) {
      if (verdicts[t] == 0) {
        for (int i = ri; i < n_reads && reads[3 * i + 2] == t; i++) {
          Key b = key_at(reads[3 * i]), e = key_at(reads[3 * i + 1]);
          if (b < e && mini.query_max(b, e) > 0) {
            verdicts[t] = 1;
            break;
          }
        }
      }
      while (ri < n_reads && reads[3 * ri + 2] == t) ri++;
      if (verdicts[t] == 0) {
        for (; wi < n_writes && writes[3 * wi + 2] == t; wi++) {
          Key b = key_at(writes[3 * wi]), e = key_at(writes[3 * wi + 1]);
          if (b < e) mini.insert_range(b, e, 1);
        }
      } else {
        while (wi < n_writes && writes[3 * wi + 2] == t) wi++;
      }
    }
  }

  int committed_writes = 0;
  for (int i = 0; i < n_writes; i++) {
    int32_t t = writes[3 * i + 2];
    if (verdicts[t] != 0) continue;
    Key b = key_at(writes[3 * i]), e = key_at(writes[3 * i + 1]);
    if (b < e) {
      cs->list.insert_range(b, e, now);
      committed_writes++;
    }
  }

  if (new_oldest > cs->oldest) cs->oldest = new_oldest;
  // amortized GC, budget proportional to batch size (reference removeBefore
  // budget: 3× write count + 10, SkipList.cpp:1199)
  cs->list.sweep(cs->oldest, committed_writes * 6 + 10);
}

}  // extern "C"
