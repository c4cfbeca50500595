// Native durable B-tree key-value store — the disk-resident IKeyValueStore
// engine (the role sqlite's custom btree plays in the reference:
// fdbserver/KeyValueStoreSQLite.actor.cpp over fdbserver/sqlite/, rebuilt
// as an own copy-on-write paged B-tree instead of a ported sqlite).
//
// Design:
// - 4 KiB pages; two alternating meta slots at file offsets 0 and 4096
//   carrying (epoch, root page, page count, live bytes, crc). Commit =
//   write all dirty (freshly allocated) pages + fsync, then write the next
//   meta slot + fsync: the flip is atomic — a crash recovers the previous
//   epoch's tree intact (shadow paging; no WAL needed).
// - Copy-on-write path copying: every modified page gets a fresh page id;
//   parents are rewritten up to the root. Pages are never updated in
//   place, so torn writes can only hit pages unreachable from the durable
//   root.
// - Deletion (clear_range) removes keys without rebalancing (underflowed
//   pages are tolerated; empty subtrees are unlinked). Space is reclaimed
//   by vacuum(): rewrite the live tree compactly when garbage dominates.
// - Values larger than a page go to overflow page chains.
//
// C ABI (ctypes): bt_open/bt_close/bt_set/bt_clear_range/bt_commit/
// bt_get/bt_range_open/bt_cursor_next/bt_cursor_close/bt_stats/bt_vacuum.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint32_t PAGE_SIZE = 32768;
constexpr uint32_t META_MAGIC = 0xFDB7B7EE;
constexpr uint16_t T_LEAF = 1, T_INTERNAL = 2, T_OVERFLOW = 3;
// payload capacity of a page after the header
constexpr uint32_t CAP = PAGE_SIZE - 8;
// the reference caps keys at 10 KB (error 2102 key_too_large); here the
// bound also guarantees any 3 separators + children fit one internal page
constexpr uint32_t MAX_KEY = 8192;

static uint32_t crc32sw(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Page {
  uint16_t type = T_LEAF;
  // leaf: keys[i] -> (value inline | overflow chain)
  // internal: keys[i] separates children[i] (< key) and children[i+1]
  std::vector<std::string> keys;
  std::vector<std::string> vals;       // leaf: inline values ('' if ovf)
  std::vector<uint64_t> ovf;           // leaf: overflow head page (0=inline)
  std::vector<uint64_t> children;      // internal
  std::string ovf_data;                // overflow: chunk
  uint64_t ovf_next = 0;               // overflow: next page in chain

  size_t bytes() const {
    size_t n = 16;
    for (auto& k : keys) n += k.size() + 12;
    if (type == T_LEAF)
      for (auto& v : vals) n += v.size() + 12;
    else
      n += children.size() * 8;
    return n;
  }

  std::string serialize() const {
    std::string out;
    auto put16 = [&](uint16_t v) { out.append((char*)&v, 2); };
    auto put32 = [&](uint32_t v) { out.append((char*)&v, 4); };
    auto put64 = [&](uint64_t v) { out.append((char*)&v, 8); };
    auto putb = [&](const std::string& b) {
      put32((uint32_t)b.size());
      out += b;
    };
    put16(type);
    put16((uint16_t)keys.size());
    if (type == T_OVERFLOW) {
      put64(ovf_next);
      putb(ovf_data);
    } else if (type == T_LEAF) {
      for (size_t i = 0; i < keys.size(); i++) {
        putb(keys[i]);
        put64(ovf[i]);
        putb(vals[i]);
      }
    } else {
      for (auto c : children) put64(c);
      for (auto& k : keys) putb(k);
    }
    return out;
  }

  static Page deserialize(const uint8_t* buf, size_t len) {
    Page p;
    size_t pos = 0;
    auto get16 = [&]() { uint16_t v; memcpy(&v, buf + pos, 2); pos += 2; return v; };
    auto get32 = [&]() { uint32_t v; memcpy(&v, buf + pos, 4); pos += 4; return v; };
    auto get64 = [&]() { uint64_t v; memcpy(&v, buf + pos, 8); pos += 8; return v; };
    auto getb = [&]() {
      uint32_t n = get32();
      std::string s((const char*)buf + pos, n);
      pos += n;
      return s;
    };
    p.type = get16();
    uint16_t n = get16();
    if (p.type == T_OVERFLOW) {
      p.ovf_next = get64();
      p.ovf_data = getb();
    } else if (p.type == T_LEAF) {
      for (uint16_t i = 0; i < n; i++) {
        p.keys.push_back(getb());
        p.ovf.push_back(get64());
        p.vals.push_back(getb());
      }
    } else {
      for (uint16_t i = 0; i < n + 1; i++) p.children.push_back(get64());
      for (uint16_t i = 0; i < n; i++) p.keys.push_back(getb());
    }
    (void)len;
    return p;
  }
};

struct BTree {
  int fd = -1;
  uint64_t epoch = 0;
  uint64_t root = 0;       // 0 = empty tree
  uint64_t page_count = 2; // pages 0,1 are meta slots
  uint64_t live_bytes = 0;
  std::unordered_map<uint64_t, std::shared_ptr<Page>> cache;
  std::unordered_map<uint64_t, std::shared_ptr<Page>> dirty;
  std::string last_err;

  // -- meta ------------------------------------------------------------------

  bool read_meta() {
    uint8_t buf[PAGE_SIZE];
    uint64_t best_epoch = 0;
    bool found = false;
    for (int slot = 0; slot < 2; slot++) {
      ssize_t r = pread(fd, buf, PAGE_SIZE, (off_t)slot * PAGE_SIZE);
      if (r < 44) continue;
      uint32_t magic, crc;
      uint64_t e, rt, pc, lb;
      memcpy(&magic, buf, 4);
      memcpy(&e, buf + 4, 8);
      memcpy(&rt, buf + 12, 8);
      memcpy(&pc, buf + 20, 8);
      memcpy(&lb, buf + 28, 8);
      memcpy(&crc, buf + 36, 4);
      if (magic != META_MAGIC || crc != crc32sw(buf, 36)) continue;
      if (!found || e > best_epoch) {
        best_epoch = e;
        epoch = e;
        root = rt;
        page_count = pc;
        live_bytes = lb;
        found = true;
      }
    }
    return found;
  }

  bool write_meta() {
    uint8_t buf[44];
    epoch++;
    memcpy(buf, &META_MAGIC, 4);
    memcpy(buf + 4, &epoch, 8);
    memcpy(buf + 12, &root, 8);
    memcpy(buf + 20, &page_count, 8);
    memcpy(buf + 28, &live_bytes, 8);
    uint32_t crc = crc32sw(buf, 36);
    memcpy(buf + 36, &crc, 4);
    off_t off = (off_t)(epoch % 2) * PAGE_SIZE;
    if (pwrite(fd, buf, 44, off) != 44) return false;
    return fsync(fd) == 0;
  }

  // -- page io ---------------------------------------------------------------

  std::shared_ptr<Page> load(uint64_t id) {
    auto it = dirty.find(id);
    if (it != dirty.end()) return it->second;
    it = cache.find(id);
    if (it != cache.end()) return it->second;
    std::vector<uint8_t> buf(PAGE_SIZE);
    ssize_t r = pread(fd, buf.data(), PAGE_SIZE, (off_t)id * PAGE_SIZE);
    if (r <= 0) return nullptr;
    uint32_t stored_crc, len;
    memcpy(&len, buf.data(), 4);
    memcpy(&stored_crc, buf.data() + 4, 4);
    if (len > PAGE_SIZE - 8 || crc32sw(buf.data() + 8, len) != stored_crc)
      return nullptr;
    auto p = std::make_shared<Page>(Page::deserialize(buf.data() + 8, len));
    if (cache.size() > 8192) cache.clear();  // crude but safe (all clean)
    cache[id] = p;
    return p;
  }

  uint64_t alloc(std::shared_ptr<Page> p) {
    uint64_t id = page_count++;
    dirty[id] = std::move(p);
    return id;
  }

  bool flush_dirty() {
    std::vector<uint8_t> buf(PAGE_SIZE, 0);
    for (auto& [id, p] : dirty) {
      std::string body = p->serialize();
      if (body.size() > PAGE_SIZE - 8) {
        last_err = "page body overflow";
        return false;
      }
      uint32_t len = (uint32_t)body.size();
      uint32_t crc = crc32sw((const uint8_t*)body.data(), body.size());
      memcpy(buf.data(), &len, 4);
      memcpy(buf.data() + 4, &crc, 4);
      memcpy(buf.data() + 8, body.data(), body.size());
      memset(buf.data() + 8 + body.size(), 0, PAGE_SIZE - 8 - body.size());
      if (pwrite(fd, buf.data(), PAGE_SIZE, (off_t)id * PAGE_SIZE) !=
          (ssize_t)PAGE_SIZE) {
        last_err = "pwrite failed";
        return false;
      }
      cache[id] = p;
    }
    dirty.clear();
    return true;
  }

  // -- overflow values -------------------------------------------------------

  uint64_t write_overflow(const std::string& value) {
    // chunks stored back-to-front so each page links to the next
    size_t chunk = PAGE_SIZE - 64;
    uint64_t next = 0;
    size_t n = value.size();
    size_t nchunks = (n + chunk - 1) / chunk;
    for (size_t i = nchunks; i-- > 0;) {
      auto p = std::make_shared<Page>();
      p->type = T_OVERFLOW;
      p->ovf_next = next;
      p->ovf_data = value.substr(i * chunk, chunk);
      next = alloc(p);
    }
    return next;
  }

  bool read_overflow(uint64_t head, std::string& out) {
    out.clear();
    while (head) {
      auto p = load(head);
      if (!p || p->type != T_OVERFLOW) return false;
      out += p->ovf_data;
      head = p->ovf_next;
    }
    return true;
  }

  // -- tree ops (copy-on-write) ----------------------------------------------

  struct InsertResult {
    uint64_t page = 0;
    bool split = false;
    std::string split_key;
    uint64_t right = 0;
  };

  static constexpr size_t SPLIT_BYTES = CAP - 512;

  InsertResult insert(uint64_t node, const std::string& key,
                      const std::string& value) {
    InsertResult res;
    if (node == 0) {
      auto leaf = std::make_shared<Page>();
      leaf->type = T_LEAF;
      store_kv(*leaf, 0, key, value, true);
      res.page = alloc(leaf);
      return res;
    }
    auto old_p = load(node);
    auto p = std::make_shared<Page>(*old_p);  // COW copy
    if (p->type == T_LEAF) {
      auto it = std::lower_bound(p->keys.begin(), p->keys.end(), key);
      size_t idx = it - p->keys.begin();
      bool is_new = (it == p->keys.end() || *it != key);
      if (!is_new) {
        live_bytes -= p->keys[idx].size() + p->vals[idx].size();
        p->vals.erase(p->vals.begin() + idx);
        p->ovf.erase(p->ovf.begin() + idx);
        p->keys.erase(p->keys.begin() + idx);
      }
      store_kv(*p, idx, key, value, true);
      live_bytes += key.size() + value.size();
      maybe_split_leaf(p, res);
      return res;
    }
    // internal
    auto it = std::upper_bound(p->keys.begin(), p->keys.end(), key);
    size_t ci = it - p->keys.begin();
    InsertResult child = insert(p->children[ci], key, value);
    p->children[ci] = child.page;
    if (child.split) {
      p->keys.insert(p->keys.begin() + ci, child.split_key);
      p->children.insert(p->children.begin() + ci + 1, child.right);
    }
    maybe_split_internal(p, res);
    return res;
  }

  void store_kv(Page& leaf, size_t idx, const std::string& key,
                const std::string& value, bool fresh) {
    (void)fresh;
    leaf.keys.insert(leaf.keys.begin() + idx, key);
    if (value.size() <= 1024) {
      leaf.vals.insert(leaf.vals.begin() + idx, value);
      leaf.ovf.insert(leaf.ovf.begin() + idx, 0);
    } else {
      leaf.vals.insert(leaf.vals.begin() + idx, std::string());
      leaf.ovf.insert(leaf.ovf.begin() + idx, write_overflow(value));
    }
  }

  void maybe_split_leaf(std::shared_ptr<Page>& p, InsertResult& res) {
    if (p->bytes() <= SPLIT_BYTES || p->keys.size() < 2) {
      res.page = alloc(p);
      return;
    }
    size_t mid = p->keys.size() / 2;
    auto right = std::make_shared<Page>();
    right->type = T_LEAF;
    right->keys.assign(p->keys.begin() + mid, p->keys.end());
    right->vals.assign(p->vals.begin() + mid, p->vals.end());
    right->ovf.assign(p->ovf.begin() + mid, p->ovf.end());
    p->keys.resize(mid);
    p->vals.resize(mid);
    p->ovf.resize(mid);
    res.split = true;
    res.split_key = right->keys.front();
    res.right = alloc(right);
    res.page = alloc(p);
  }

  void maybe_split_internal(std::shared_ptr<Page>& p, InsertResult& res) {
    if (p->bytes() <= SPLIT_BYTES || p->keys.size() < 3) {
      res.page = alloc(p);
      return;
    }
    size_t mid = p->keys.size() / 2;
    auto right = std::make_shared<Page>();
    right->type = T_INTERNAL;
    right->keys.assign(p->keys.begin() + mid + 1, p->keys.end());
    right->children.assign(p->children.begin() + mid + 1, p->children.end());
    res.split = true;
    res.split_key = p->keys[mid];
    p->keys.resize(mid);
    p->children.resize(mid + 1);
    res.right = alloc(right);
    res.page = alloc(p);
  }

  void set(const std::string& key, const std::string& value) {
    InsertResult r = insert(root, key, value);
    if (r.split) {
      auto nr = std::make_shared<Page>();
      nr->type = T_INTERNAL;
      nr->keys = {r.split_key};
      nr->children = {r.page, r.right};
      root = alloc(nr);
    } else {
      root = r.page;
    }
  }

  // returns new page id, or 0 if the subtree became empty
  uint64_t clear(uint64_t node, const std::string& b, const std::string& e) {
    if (node == 0) return 0;
    auto old_p = load(node);
    auto p = std::make_shared<Page>(*old_p);
    if (p->type == T_LEAF) {
      size_t lo = std::lower_bound(p->keys.begin(), p->keys.end(), b) -
                  p->keys.begin();
      size_t hi = std::lower_bound(p->keys.begin(), p->keys.end(), e) -
                  p->keys.begin();
      if (lo == hi) return node;  // untouched: keep the old page
      for (size_t i = lo; i < hi; i++)
        live_bytes -= p->keys[i].size() + p->vals[i].size();
      p->keys.erase(p->keys.begin() + lo, p->keys.begin() + hi);
      p->vals.erase(p->vals.begin() + lo, p->vals.begin() + hi);
      p->ovf.erase(p->ovf.begin() + lo, p->ovf.begin() + hi);
      if (p->keys.empty()) return 0;
      return alloc(p);
    }
    size_t lo = std::upper_bound(p->keys.begin(), p->keys.end(), b) -
                p->keys.begin();
    size_t hi = std::lower_bound(p->keys.begin(), p->keys.end(), e) -
                p->keys.begin();
    // children [lo..hi] may intersect [b, e)
    bool changed = false;
    std::vector<uint64_t> nc(p->children);
    for (size_t i = lo; i <= hi && i < p->children.size(); i++) {
      uint64_t c = clear(p->children[i], b, e);
      if (c != p->children[i]) changed = true;
      nc[i] = c;
    }
    if (!changed) return node;
    // rebuild, dropping empty children and their separators
    std::vector<uint64_t> children;
    std::vector<std::string> keys;
    for (size_t i = 0; i < nc.size(); i++) {
      if (nc[i] == 0) continue;
      if (!children.empty()) {
        // separator between previous kept child and this one: the last
        // separator with index < i that is >= previous kept child
        keys.push_back(p->keys[i - 1]);
      }
      children.push_back(nc[i]);
    }
    if (children.empty()) return 0;
    if (children.size() == 1) return children[0];  // collapse level
    p->children = std::move(children);
    p->keys = std::move(keys);
    return alloc(p);
  }

  void clear_range(const std::string& b, const std::string& e) {
    root = clear(root, b, e);
  }

  bool get(const std::string& key, std::string& out) {
    uint64_t node = root;
    while (node) {
      auto p = load(node);
      if (!p) return false;
      if (p->type == T_LEAF) {
        auto it = std::lower_bound(p->keys.begin(), p->keys.end(), key);
        if (it == p->keys.end() || *it != key) return false;
        size_t i = it - p->keys.begin();
        if (p->ovf[i]) return read_overflow(p->ovf[i], out);
        out = p->vals[i];
        return true;
      }
      auto it = std::upper_bound(p->keys.begin(), p->keys.end(), key);
      node = p->children[it - p->keys.begin()];
    }
    return false;
  }
};

struct Cursor {
  BTree* bt;
  // stack of (page id, child index)
  std::vector<std::pair<uint64_t, size_t>> stack;
  std::string end;
  std::string cur_key, cur_val;
  bool done = false;

  void descend_to(uint64_t node, const std::string& begin) {
    while (node) {
      auto p = bt->load(node);
      if (!p) { done = true; return; }
      if (p->type == T_LEAF) {
        size_t i = std::lower_bound(p->keys.begin(), p->keys.end(), begin) -
                   p->keys.begin();
        stack.push_back({node, i});
        return;
      }
      size_t ci = std::upper_bound(p->keys.begin(), p->keys.end(), begin) -
                  p->keys.begin();
      stack.push_back({node, ci});
      node = p->children[ci];
    }
    done = true;
  }

  bool next() {
    while (!done && !stack.empty()) {
      auto& [node, idx] = stack.back();
      auto p = bt->load(node);
      if (!p) { done = true; return false; }
      if (p->type == T_LEAF) {
        if (idx < p->keys.size()) {
          if (!end.empty() && p->keys[idx] >= end) { done = true; return false; }
          cur_key = p->keys[idx];
          if (p->ovf[idx]) bt->read_overflow(p->ovf[idx], cur_val);
          else cur_val = p->vals[idx];
          idx++;
          return true;
        }
        stack.pop_back();
        if (!stack.empty()) stack.back().second++;
        continue;
      }
      if (idx < p->children.size()) {
        uint64_t child = p->children[idx];
        // descend leftmost into the child
        uint64_t n2 = child;
        while (true) {
          auto cp = bt->load(n2);
          if (!cp) { done = true; return false; }
          if (cp->type == T_LEAF) { stack.push_back({n2, 0}); break; }
          stack.push_back({n2, 0});
          n2 = cp->children[0];
        }
        continue;
      }
      stack.pop_back();
      if (!stack.empty()) stack.back().second++;
    }
    done = true;
    return false;
  }
};

}  // namespace

extern "C" {

void* bt_open(const char* path) {
  auto* bt = new BTree();
  bt->fd = open(path, O_RDWR | O_CREAT, 0644);
  if (bt->fd < 0) {
    delete bt;
    return nullptr;
  }
  if (!bt->read_meta()) {
    // fresh file: epoch 0, empty tree (first commit writes slot 1)
    bt->epoch = 0;
    bt->root = 0;
    bt->page_count = 2;
    bt->live_bytes = 0;
  }
  return bt;
}

void bt_close(void* h) {
  auto* bt = (BTree*)h;
  if (bt->fd >= 0) close(bt->fd);
  delete bt;
}

int bt_set(void* h, const uint8_t* k, int klen, const uint8_t* v, int vlen) {
  auto* bt = (BTree*)h;
  if ((uint32_t)klen > MAX_KEY) return -100;  // key_too_large
  bt->set(std::string((const char*)k, klen), std::string((const char*)v, vlen));
  return 0;
}

int bt_clear_range(void* h, const uint8_t* b, int blen, const uint8_t* e,
                   int elen) {
  auto* bt = (BTree*)h;
  bt->clear_range(std::string((const char*)b, blen),
                  std::string((const char*)e, elen));
  return 0;
}

int bt_commit(void* h) {
  auto* bt = (BTree*)h;
  if (!bt->flush_dirty()) return -1;
  if (fsync(bt->fd) != 0) return -2;
  if (!bt->write_meta()) return -3;
  return 0;
}

// returns value length, or -1 if absent; value copied into out (cap bytes)
int64_t bt_get(void* h, const uint8_t* k, int klen, uint8_t* out,
               int64_t cap) {
  auto* bt = (BTree*)h;
  std::string v;
  if (!bt->get(std::string((const char*)k, klen), v)) return -1;
  if ((int64_t)v.size() <= cap && out) memcpy(out, v.data(), v.size());
  return (int64_t)v.size();
}

void* bt_range_open(void* h, const uint8_t* b, int blen, const uint8_t* e,
                    int elen) {
  auto* bt = (BTree*)h;
  auto* c = new Cursor();
  c->bt = bt;
  c->end = std::string((const char*)e, elen);
  c->descend_to(bt->root, std::string((const char*)b, blen));
  return c;
}

// 1 = produced a row (copied); 0 = exhausted; -1 = buffers too small —
// the row is HELD in the cursor: grow the buffers and call
// bt_cursor_current, never silently truncated.
int bt_cursor_next(void* hc, uint8_t* kout, int64_t kcap, int64_t* klen,
                   uint8_t* vout, int64_t vcap, int64_t* vlen) {
  auto* c = (Cursor*)hc;
  if (!c->next()) return 0;
  *klen = (int64_t)c->cur_key.size();
  *vlen = (int64_t)c->cur_val.size();
  if ((int64_t)c->cur_key.size() > kcap || (int64_t)c->cur_val.size() > vcap)
    return -1;
  memcpy(kout, c->cur_key.data(), c->cur_key.size());
  memcpy(vout, c->cur_val.data(), c->cur_val.size());
  return 1;
}

// re-copy the row held after a -1 from bt_cursor_next
int bt_cursor_current(void* hc, uint8_t* kout, int64_t kcap, int64_t* klen,
                      uint8_t* vout, int64_t vcap, int64_t* vlen) {
  auto* c = (Cursor*)hc;
  *klen = (int64_t)c->cur_key.size();
  *vlen = (int64_t)c->cur_val.size();
  if ((int64_t)c->cur_key.size() > kcap || (int64_t)c->cur_val.size() > vcap)
    return -1;
  memcpy(kout, c->cur_key.data(), c->cur_key.size());
  memcpy(vout, c->cur_val.data(), c->cur_val.size());
  return 1;
}

void bt_cursor_close(void* hc) { delete (Cursor*)hc; }

void bt_stats(void* h, uint64_t* epoch, uint64_t* pages, uint64_t* live) {
  auto* bt = (BTree*)h;
  *epoch = bt->epoch;
  *pages = bt->page_count;
  *live = bt->live_bytes;
}

// rewrite the live tree compactly into a new file; caller renames it over
int bt_vacuum_to(void* h, const char* new_path) {
  auto* nb = (BTree*)bt_open(new_path);
  if (!nb) return -1;
  auto* c = (Cursor*)bt_range_open(h, (const uint8_t*)"", 0, (const uint8_t*)"", 0);
  while (c->next()) nb->set(c->cur_key, c->cur_val);
  bt_cursor_close(c);
  int rc = bt_commit(nb);
  bt_close(nb);
  return rc;
}

}  // extern "C"
