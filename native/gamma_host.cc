// libgamma_host — native host-side runtime for gamma_tpu.
//
// Re-derivation of the reference's host storage stack:
//   * StorageManager/Segment/Block + AsyncWriter
//     (storage/storage_manager.{h,cc}, storage/segment.{h,cc},
//      storage/async_writer.cc:51-110 — coalesced pwrite thread):
//     here each segment is an mmap'd file; writes are memcpys into the
//     mapping and a background sync thread issues coalesced msync ranges,
//     playing the AsyncWriter role.  Readers see writes immediately
//     (shared mapping) — the single-writer/multi-reader publish contract
//     is the atomic `items` counter, exactly like the reference's
//     `cur_size_` (storage/segment.h:21-120).
//   * BitmapManager (util/bitmap_manager.{h,cc}): file-backed bitmap at
//     bit granularity with atomic word updates.
//   * libcuckoo key->docid map (table/table.h:185): sharded-lock string
//     hash map with binary dump/load.
//
// C ABI only — bound from Python via ctypes (gamma_tpu/native/__init__.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

// The block store needs only three zstd entry points, all stable ABI.
// Where the development header is not installed (a runtime-only libzstd),
// declare them here and link against libzstd.so.1 directly.
#if __has_include(<zstd.h>)
#include <zstd.h>
#else
extern "C" {
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
}
#endif

#include <list>
#include <utility>

#define API extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------
// Segment: one mmap'd file: header | fixed rows | string heap
// ---------------------------------------------------------------------

struct SegHeader {
  uint64_t magic;        // 'GSEG'
  uint64_t item_size;
  uint64_t capacity;     // max items
  std::atomic<uint64_t> items;      // published item count
  uint64_t str_cap;      // string heap bytes
  std::atomic<uint64_t> str_used;   // published heap bytes used
  uint64_t version;
  uint64_t pad;
};
static_assert(sizeof(SegHeader) == 64, "header layout");

constexpr uint64_t kMagic = 0x4753454755ULL;

struct Segment {
  int fd = -1;
  uint8_t* base = nullptr;   // whole mapping
  size_t map_len = 0;
  SegHeader* hdr = nullptr;
  uint8_t* rows = nullptr;
  uint8_t* heap = nullptr;

  bool open(const std::string& path, uint64_t item_size, uint64_t capacity,
            uint64_t str_cap) {
    bool fresh = ::access(path.c_str(), F_OK) != 0;
    fd = ::open(path.c_str(), O_RDWR | O_CREAT, 0644);
    if (fd < 0) return false;
    map_len = sizeof(SegHeader) + item_size * capacity + str_cap;
    if (fresh && ::ftruncate(fd, (off_t)map_len) != 0) return false;
    struct stat st;
    if (::fstat(fd, &st) != 0) return false;
    if ((size_t)st.st_size < map_len &&
        ::ftruncate(fd, (off_t)map_len) != 0)
      return false;
    base = (uint8_t*)::mmap(nullptr, map_len, PROT_READ | PROT_WRITE,
                            MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) { base = nullptr; return false; }
    hdr = (SegHeader*)base;
    rows = base + sizeof(SegHeader);
    heap = rows + item_size * capacity;
    if (fresh || hdr->magic != kMagic) {
      hdr->magic = kMagic;
      hdr->item_size = item_size;
      hdr->capacity = capacity;
      hdr->items.store(0);
      hdr->str_cap = str_cap;
      hdr->str_used.store(0);
      hdr->version = 1;
    }
    return true;
  }
  void close_() {
    if (base) { ::msync(base, map_len, MS_SYNC); ::munmap(base, map_len); }
    if (fd >= 0) ::close(fd);
    base = nullptr; fd = -1;
  }
};

// ---------------------------------------------------------------------
// StorageManager: ordered list of segments + async sync thread
// ---------------------------------------------------------------------

struct Storage {
  std::string dir, name;
  uint64_t item_size, seg_items, str_cap_per_seg;
  std::vector<Segment*> segs;
  std::mutex grow_mu;

  // async writer analog: background msync of dirty segments
  std::thread syncer;
  std::mutex sync_mu;
  std::condition_variable sync_cv;
  std::atomic<bool> stop{false};
  std::atomic<bool> dirty{false};

  std::string seg_path(size_t i) const {
    return dir + "/" + name + ".seg" + std::to_string(i);
  }

  bool ensure_seg(size_t i) {
    std::lock_guard<std::mutex> g(grow_mu);
    while (segs.size() <= i) {
      auto* s = new Segment();
      if (!s->open(seg_path(segs.size()), item_size, seg_items,
                   str_cap_per_seg)) {
        delete s;
        return false;
      }
      segs.push_back(s);
    }
    return true;
  }

  uint64_t total_items() {
    // grow_mu: ensure_seg's push_back can reallocate the vector
    std::lock_guard<std::mutex> g(grow_mu);
    uint64_t n = 0;
    for (auto* s : segs) n += s->hdr->items.load();
    return n;
  }

  void run_syncer() {
    std::unique_lock<std::mutex> lk(sync_mu);
    while (!stop.load()) {
      sync_cv.wait_for(lk, std::chrono::milliseconds(200));
      if (dirty.exchange(false)) {
        std::vector<Segment*> snapshot;
        {
          std::lock_guard<std::mutex> g(grow_mu);
          snapshot = segs;   // copy under lock: push_back reallocates
        }
        for (auto* s : snapshot)
          ::msync(s->base, s->map_len, MS_ASYNC);   // coalesced flush
      }
    }
  }
};

Storage* as_storage(void* h) { return (Storage*)h; }

// ---------------------------------------------------------------------
// Bitmap
// ---------------------------------------------------------------------

struct Bitmap {
  int fd = -1;
  std::atomic<uint64_t>* words = nullptr;
  size_t nwords = 0, map_len = 0;

  bool open(const std::string& path, uint64_t nbits) {
    nwords = (nbits + 63) / 64;
    map_len = nwords * 8;
    fd = ::open(path.c_str(), O_RDWR | O_CREAT, 0644);
    if (fd < 0) return false;
    struct stat st;
    if (::fstat(fd, &st) != 0) return false;
    if ((size_t)st.st_size < map_len &&
        ::ftruncate(fd, (off_t)map_len) != 0)
      return false;
    void* p = ::mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED,
                     fd, 0);
    if (p == MAP_FAILED) return false;
    words = (std::atomic<uint64_t>*)p;
    return true;
  }
};

// ---------------------------------------------------------------------
// ZStore: zstd block-compressed row store
//
// The compressed-block role of the reference's storage compressors
// (storage/compress/compressor_zstd.h for table blocks,
//  compressor_zfp.h for vector blocks) married to its Block + LRUCache
// read path (storage/block.h:36, storage/lru_cache.h:332): rows append
// into a raw tail; each full block of `rows_per_block` rows is sealed as
// one zstd frame appended to the data file (and never touched again);
// reads decompress whole blocks into a small LRU.  Point updates of
// sealed rows go to an overlay map (applied on read, persisted at sync)
// so no frame is ever rewritten.
//
// Durability: sealed frames are written immediately (write-behind by the
// OS); `gzb_sync` rewrites the tail + overlay sidecars and fsyncs — the
// barrier the engine takes before its commit marker.  Reopen replays
// frames until the first short/corrupt one (a torn final frame from a
// crash is discarded), then the synced tail/overlay.
// ---------------------------------------------------------------------

struct ZFrameHdr {
  uint32_t magic;
  uint32_t comp_len;
  uint64_t block_idx;
};
constexpr uint32_t kZMagic = 0x5A424C4BU;  // 'ZBLK'

struct ZStore {
  std::string dir, name;
  uint64_t row_bytes = 0, rows_per_block = 0;
  int fd = -1;                       // sealed-frame data file
  uint64_t data_len = 0;             // bytes of valid frames
  struct Blk { uint64_t comp_off, comp_len; };
  std::vector<Blk> blocks;           // sealed, each rows_per_block rows
  std::vector<uint8_t> tail;         // raw rows, < rows_per_block
  std::unordered_map<uint64_t, std::vector<uint8_t>> overlay;  // row → raw
  // decompressed-block LRU (reference: per-block LRUCache)
  size_t cache_cap = 32;
  std::list<uint64_t> lru;           // front = most recent
  std::unordered_map<uint64_t,
      std::pair<std::list<uint64_t>::iterator,
                std::vector<uint8_t>>> cache;
  uint64_t hits = 0, misses = 0;
  std::mutex mu;

  uint64_t block_bytes() const { return row_bytes * rows_per_block; }
  std::string data_path() const { return dir + "/" + name + ".zblk"; }
  std::string tail_path() const { return dir + "/" + name + ".ztail"; }
  std::string ovl_path() const { return dir + "/" + name + ".zovl"; }

  bool open_() {
    fd = ::open(data_path().c_str(), O_RDWR | O_CREAT, 0644);
    if (fd < 0) return false;
    // replay frames; stop at the first torn one
    uint64_t off = 0;
    for (;;) {
      ZFrameHdr h;
      if (::pread(fd, &h, sizeof h, (off_t)off) != (ssize_t)sizeof h) break;
      if (h.magic != kZMagic || h.block_idx != blocks.size()) break;
      struct stat st;
      ::fstat(fd, &st);
      if (off + sizeof h + h.comp_len > (uint64_t)st.st_size) break;
      blocks.push_back({off + sizeof h, h.comp_len});
      off += sizeof h + h.comp_len;
    }
    data_len = off;
    ::ftruncate(fd, (off_t)data_len);  // drop torn frame bytes
    // synced tail
    FILE* tf = ::fopen(tail_path().c_str(), "rb");
    if (tf) {
      uint64_t nrows = 0;
      if (::fread(&nrows, 8, 1, tf) == 1 && nrows < rows_per_block) {
        tail.resize(nrows * row_bytes);
        if (::fread(tail.data(), 1, tail.size(), tf) != tail.size())
          tail.clear();
      }
      ::fclose(tf);
    }
    // synced overlay
    FILE* of = ::fopen(ovl_path().c_str(), "rb");
    if (of) {
      uint64_t cnt = 0;
      if (::fread(&cnt, 8, 1, of) == 1) {
        std::vector<uint8_t> buf(row_bytes);
        for (uint64_t i = 0; i < cnt; i++) {
          uint64_t row;
          if (::fread(&row, 8, 1, of) != 1) break;
          if (::fread(buf.data(), 1, row_bytes, of) != row_bytes) break;
          overlay[row] = buf;
        }
      }
      ::fclose(of);
    }
    return true;
  }

  uint64_t rows() const {
    return blocks.size() * rows_per_block + tail.size() / row_bytes;
  }

  void seal_tail() {  // caller holds mu; tail is exactly one block
    uint64_t bb = block_bytes();
    std::vector<uint8_t> comp(ZSTD_compressBound(bb));
    size_t cl = ZSTD_compress(comp.data(), comp.size(), tail.data(), bb, 1);
    ZFrameHdr h{kZMagic, (uint32_t)cl, blocks.size()};
    ::pwrite(fd, &h, sizeof h, (off_t)data_len);
    ::pwrite(fd, comp.data(), cl, (off_t)(data_len + sizeof h));
    blocks.push_back({data_len + sizeof h, (uint64_t)cl});
    data_len += sizeof h + cl;
    tail.clear();
  }

  // decompressed block bytes (cache fill); caller holds mu
  const std::vector<uint8_t>& get_block(uint64_t bi) {
    auto it = cache.find(bi);
    if (it != cache.end()) {
      hits++;
      lru.splice(lru.begin(), lru, it->second.first);
      return it->second.second;
    }
    misses++;
    std::vector<uint8_t> comp(blocks[bi].comp_len);
    ::pread(fd, comp.data(), comp.size(), (off_t)blocks[bi].comp_off);
    std::vector<uint8_t> raw(block_bytes());
    ZSTD_decompress(raw.data(), raw.size(), comp.data(), comp.size());
    while (cache.size() >= cache_cap && !lru.empty()) {
      cache.erase(lru.back());
      lru.pop_back();
    }
    lru.push_front(bi);
    auto res = cache.emplace(bi,
        std::make_pair(lru.begin(), std::move(raw)));
    return res.first->second.second;
  }
};

// ---------------------------------------------------------------------
// Key map: sharded string -> int64
// ---------------------------------------------------------------------

struct KeyMap {
  static constexpr int kShards = 64;
  struct Shard {
    std::mutex mu;
    std::unordered_map<std::string, int64_t> m;
  };
  Shard shards[kShards];

  static size_t shard_of(const char* k, int len) {
    size_t h = 1469598103934665603ULL;
    for (int i = 0; i < len; i++) h = (h ^ (uint8_t)k[i]) * 1099511628211ULL;
    return h & (kShards - 1);
  }
};

}  // namespace

// ============================ storage ================================

API void* gsm_open(const char* dir, const char* name, int64_t item_size,
                   int64_t segment_items, int64_t str_bytes_per_seg) {
  auto* s = new Storage();
  s->dir = dir;
  s->name = name;
  s->item_size = (uint64_t)item_size;
  s->seg_items = (uint64_t)segment_items;
  s->str_cap_per_seg = (uint64_t)str_bytes_per_seg;
  ::mkdir(dir, 0755);
  // reopen any existing segments
  for (size_t i = 0;; i++) {
    if (::access(s->seg_path(i).c_str(), F_OK) != 0) break;
    if (!s->ensure_seg(i)) { delete s; return nullptr; }
  }
  if (s->segs.empty() && !s->ensure_seg(0)) { delete s; return nullptr; }
  s->syncer = std::thread([s] { s->run_syncer(); });
  return s;
}

API int64_t gsm_size(void* h) { return (int64_t)as_storage(h)->total_items(); }

API int64_t gsm_add(void* h, const void* data, int64_t n_items) {
  auto* s = as_storage(h);
  const uint8_t* src = (const uint8_t*)data;
  int64_t first = -1, done = 0;
  while (done < n_items) {
    size_t si = 0;
    uint64_t base_items = 0;
    // find the tail segment
    for (;; si++) {
      if (!s->ensure_seg(si)) return -1;
      uint64_t it = s->segs[si]->hdr->items.load();
      if (it < s->seg_items) { break; }
      base_items += s->seg_items;
    }
    Segment* seg = s->segs[si];
    uint64_t it = seg->hdr->items.load();
    uint64_t room = s->seg_items - it;
    uint64_t take = std::min<uint64_t>(room, (uint64_t)(n_items - done));
    std::memcpy(seg->rows + it * s->item_size, src + done * s->item_size,
                take * s->item_size);
    if (first < 0) first = (int64_t)(base_items + it);
    seg->hdr->items.store(it + take);  // publish
    done += (int64_t)take;
  }
  s->dirty.store(true);
  s->sync_cv.notify_one();
  return first;
}

API int gsm_get_range(void* h, int64_t start, int64_t count, void* out) {
  auto* s = as_storage(h);
  uint8_t* dst = (uint8_t*)out;
  while (count > 0) {
    size_t si = (size_t)(start / (int64_t)s->seg_items);
    uint64_t off = (uint64_t)(start % (int64_t)s->seg_items);
    if (si >= s->segs.size()) return -1;
    Segment* seg = s->segs[si];
    uint64_t have = seg->hdr->items.load();
    if (off >= have) return -1;
    uint64_t take = std::min<uint64_t>(have - off, (uint64_t)count);
    take = std::min<uint64_t>(take, s->seg_items - off);
    std::memcpy(dst, seg->rows + off * s->item_size, take * s->item_size);
    dst += take * s->item_size;
    start += (int64_t)take;
    count -= (int64_t)take;
  }
  return 0;
}

API int gsm_update(void* h, int64_t id, const void* data) {
  auto* s = as_storage(h);
  size_t si = (size_t)(id / (int64_t)s->seg_items);
  uint64_t off = (uint64_t)(id % (int64_t)s->seg_items);
  if (si >= s->segs.size()) return -1;
  Segment* seg = s->segs[si];
  if (off >= seg->hdr->items.load()) return -1;
  std::memcpy(seg->rows + off * s->item_size, data, s->item_size);
  s->dirty.store(true);
  s->sync_cv.notify_one();
  return 0;
}

// string heap: handle = (seg << 40) | offset ; layout [u32 len][bytes]
API int64_t gsm_add_str(void* h, const char* str, int64_t len) {
  auto* s = as_storage(h);
  if (4 + (uint64_t)len > s->str_cap_per_seg) return -1;  // can never fit
  for (size_t si = 0;; si++) {
    if (!s->ensure_seg(si)) return -1;
    Segment* seg = s->segs[si];
    uint64_t used = seg->hdr->str_used.load();
    if (used + 4 + (uint64_t)len <= seg->hdr->str_cap) {
      uint32_t l32 = (uint32_t)len;
      std::memcpy(seg->heap + used, &l32, 4);
      std::memcpy(seg->heap + used + 4, str, (size_t)len);
      seg->hdr->str_used.store(used + 4 + (uint64_t)len);
      s->dirty.store(true);
      return (int64_t)(((uint64_t)si << 40) | used);
    }
  }
}

API int64_t gsm_get_str(void* h, int64_t handle, char* out, int64_t cap) {
  auto* s = as_storage(h);
  size_t si = (size_t)((uint64_t)handle >> 40);
  uint64_t off = (uint64_t)handle & ((1ULL << 40) - 1);
  if (si >= s->segs.size()) return -1;
  Segment* seg = s->segs[si];
  uint32_t len;
  std::memcpy(&len, seg->heap + off, 4);
  int64_t n = std::min<int64_t>(len, cap);
  std::memcpy(out, seg->heap + off + 4, (size_t)n);
  return (int64_t)len;
}

// batch string ops: one ctypes crossing for a whole column restore/flush
// (the per-row gsm_get_str path costs a Python call + 256-byte buffer per
// row — minutes at 10M rows)
API int64_t gsm_get_strs(void* h, const int64_t* handles, int64_t n,
                         char* out, int64_t cap, int64_t* lens) {
  auto* s = as_storage(h);
  int64_t need = 0;
  for (int64_t i = 0; i < n; i++) {
    size_t si = (size_t)((uint64_t)handles[i] >> 40);
    uint64_t off = (uint64_t)handles[i] & ((1ULL << 40) - 1);
    if (si >= s->segs.size()) { lens[i] = -1; continue; }
    Segment* seg = s->segs[si];
    uint32_t len;
    std::memcpy(&len, seg->heap + off, 4);
    lens[i] = (int64_t)len;
    if (need + (int64_t)len <= cap)
      std::memcpy(out + need, seg->heap + off + 4, len);
    need += (int64_t)len;
  }
  return need;  // > cap → caller re-calls with a bigger buffer
}

API int gsm_add_strs(void* h, const char* buf, const int64_t* lens,
                     int64_t n, int64_t* handles_out) {
  int64_t off = 0;
  for (int64_t i = 0; i < n; i++) {
    handles_out[i] = gsm_add_str(h, buf + off, lens[i]);
    if (handles_out[i] < 0) return -1;
    off += lens[i];
  }
  return 0;
}

API int gsm_sync(void* h) {
  auto* s = as_storage(h);
  for (auto* seg : s->segs) ::msync(seg->base, seg->map_len, MS_SYNC);
  return 0;
}

API int gsm_truncate(void* h, int64_t n_items) {
  auto* s = as_storage(h);
  for (size_t si = 0; si < s->segs.size(); si++) {
    int64_t lo = (int64_t)(si * s->seg_items);
    uint64_t keep = (uint64_t)std::max<int64_t>(
        0, std::min<int64_t>(n_items - lo, (int64_t)s->seg_items));
    s->segs[si]->hdr->items.store(keep);
  }
  return 0;
}

API void gsm_close(void* h) {
  auto* s = as_storage(h);
  s->stop.store(true);
  s->sync_cv.notify_one();
  if (s->syncer.joinable()) s->syncer.join();
  for (auto* seg : s->segs) { seg->close_(); delete seg; }
  delete s;
}

// ===================== zstd block store ==============================

API void* gzb_open(const char* dir, const char* name, int64_t row_bytes,
                   int64_t rows_per_block, int64_t cache_blocks) {
  auto* z = new ZStore();
  z->dir = dir;
  z->name = name;
  z->row_bytes = (uint64_t)row_bytes;
  z->rows_per_block = (uint64_t)rows_per_block;
  if (cache_blocks > 0) z->cache_cap = (size_t)cache_blocks;
  ::mkdir(dir, 0755);
  if (!z->open_()) { delete z; return nullptr; }
  return z;
}

API int64_t gzb_rows(void* h) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  return (int64_t)z->rows();
}

API int gzb_add(void* h, const void* data, int64_t n_rows) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  const uint8_t* src = (const uint8_t*)data;
  uint64_t left = (uint64_t)n_rows;
  while (left) {
    uint64_t tail_rows = z->tail.size() / z->row_bytes;
    uint64_t take = std::min(left, z->rows_per_block - tail_rows);
    size_t old = z->tail.size();
    z->tail.resize(old + take * z->row_bytes);
    std::memcpy(z->tail.data() + old, src, take * z->row_bytes);
    src += take * z->row_bytes;
    left -= take;
    if (z->tail.size() == z->block_bytes()) z->seal_tail();
  }
  return 0;
}

API int gzb_get(void* h, int64_t start, int64_t count, void* out) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  if (start < 0 || (uint64_t)(start + count) > z->rows()) return -1;
  uint8_t* dst = (uint8_t*)out;
  uint64_t rb = z->row_bytes, rpb = z->rows_per_block;
  uint64_t row = (uint64_t)start, left = (uint64_t)count;
  while (left) {
    uint64_t bi = row / rpb, in = row % rpb;
    uint64_t take = std::min(left, rpb - in);
    if (bi < z->blocks.size()) {
      const auto& raw = z->get_block(bi);
      std::memcpy(dst, raw.data() + in * rb, take * rb);
    } else {
      std::memcpy(dst, z->tail.data() + in * rb, take * rb);
    }
    dst += take * rb;
    row += take;
    left -= take;
  }
  // overlay patch: one pass over the (small) overlay map
  if (!z->overlay.empty()) {
    uint64_t s = (uint64_t)start, e = (uint64_t)(start + count);
    for (const auto& kv : z->overlay) {
      if (kv.first >= s && kv.first < e)
        std::memcpy((uint8_t*)out + (kv.first - s) * rb,
                    kv.second.data(), rb);
    }
  }
  return 0;
}

API int gzb_update(void* h, int64_t row, const void* data) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  if (row < 0 || (uint64_t)row >= z->rows()) return -1;
  uint64_t sealed = z->blocks.size() * z->rows_per_block;
  if ((uint64_t)row >= sealed) {   // tail row: write in place
    std::memcpy(z->tail.data() + ((uint64_t)row - sealed) * z->row_bytes,
                data, z->row_bytes);
  } else {                          // sealed: overlay, applied on read
    auto& slot = z->overlay[(uint64_t)row];
    slot.assign((const uint8_t*)data, (const uint8_t*)data + z->row_bytes);
  }
  return 0;
}

API int gzb_truncate(void* h, int64_t n_rows) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  if ((uint64_t)n_rows >= z->rows()) return 0;
  uint64_t rpb = z->rows_per_block, rb = z->row_bytes;
  uint64_t kb = (uint64_t)n_rows / rpb, rem = (uint64_t)n_rows % rpb;
  for (auto it = z->overlay.begin(); it != z->overlay.end();) {
    if (it->first >= (uint64_t)n_rows) it = z->overlay.erase(it);
    else ++it;
  }
  if (kb < z->blocks.size()) {
    // the partial block's kept rows become the new tail
    std::vector<uint8_t> kept;
    if (rem) {
      const auto& raw = z->get_block(kb);
      kept.assign(raw.begin(), raw.begin() + rem * rb);
      // sealed rows melted back into the tail: fold their overlay in
      for (const auto& kv : z->overlay) {
        if (kv.first >= kb * rpb && kv.first < kb * rpb + rem)
          std::memcpy(kept.data() + (kv.first - kb * rpb) * rb,
                      kv.second.data(), rb);
      }
      for (auto it = z->overlay.begin(); it != z->overlay.end();) {
        if (it->first >= kb * rpb) it = z->overlay.erase(it);
        else ++it;
      }
    }
    uint64_t cut = z->blocks[kb].comp_off - sizeof(ZFrameHdr);
    z->blocks.resize(kb);
    z->data_len = cut;
    ::ftruncate(z->fd, (off_t)cut);
    z->cache.clear();
    z->lru.clear();
    z->tail = std::move(kept);
  } else {
    z->tail.resize(rem * rb);
  }
  return 0;
}

API int gzb_sync(void* h) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  // tail + overlay sidecars: write tmp, rename (atomic vs crash)
  std::string tp = z->tail_path() + ".tmp";
  FILE* tf = ::fopen(tp.c_str(), "wb");
  if (!tf) return -1;
  uint64_t nrows = z->tail.size() / z->row_bytes;
  ::fwrite(&nrows, 8, 1, tf);
  ::fwrite(z->tail.data(), 1, z->tail.size(), tf);
  ::fflush(tf);
  ::fsync(::fileno(tf));
  ::fclose(tf);
  ::rename(tp.c_str(), z->tail_path().c_str());
  std::string op = z->ovl_path() + ".tmp";
  FILE* of = ::fopen(op.c_str(), "wb");
  if (!of) return -1;
  uint64_t cnt = z->overlay.size();
  ::fwrite(&cnt, 8, 1, of);
  for (const auto& kv : z->overlay) {
    ::fwrite(&kv.first, 8, 1, of);
    ::fwrite(kv.second.data(), 1, z->row_bytes, of);
  }
  ::fflush(of);
  ::fsync(::fileno(of));
  ::fclose(of);
  ::rename(op.c_str(), z->ovl_path().c_str());
  return ::fsync(z->fd);
}

API int64_t gzb_comp_bytes(void* h) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  return (int64_t)(z->data_len + z->tail.size()
                   + z->overlay.size() * (8 + z->row_bytes));
}

API int gzb_set_cache_blocks(void* h, int64_t n) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  z->cache_cap = (size_t)std::max<int64_t>(1, n);
  while (z->cache.size() > z->cache_cap && !z->lru.empty()) {
    z->cache.erase(z->lru.back());
    z->lru.pop_back();
  }
  return 0;
}

API int64_t gzb_cache_stats(void* h, int64_t* misses_out) {
  auto* z = (ZStore*)h;
  std::lock_guard<std::mutex> g(z->mu);
  if (misses_out) *misses_out = (int64_t)z->misses;
  return (int64_t)z->hits;
}

API void gzb_close(void* h) {
  auto* z = (ZStore*)h;
  gzb_sync(h);
  if (z->fd >= 0) ::close(z->fd);
  delete z;
}

// ============================ bitmap =================================

API void* gbm_open(const char* path, int64_t nbits) {
  auto* b = new Bitmap();
  if (!b->open(path, (uint64_t)nbits)) { delete b; return nullptr; }
  return b;
}
API int gbm_set(void* h, int64_t bit) {
  auto* b = (Bitmap*)h;
  if ((size_t)(bit / 64) >= b->nwords) return -1;
  b->words[bit / 64].fetch_or(1ULL << (bit % 64));
  return 0;
}
API int gbm_unset(void* h, int64_t bit) {
  auto* b = (Bitmap*)h;
  if ((size_t)(bit / 64) >= b->nwords) return -1;
  b->words[bit / 64].fetch_and(~(1ULL << (bit % 64)));
  return 0;
}
API int gbm_test(void* h, int64_t bit) {
  auto* b = (Bitmap*)h;
  if ((size_t)(bit / 64) >= b->nwords) return 0;
  return (b->words[bit / 64].load() >> (bit % 64)) & 1;
}
API int64_t gbm_count(void* h) {
  auto* b = (Bitmap*)h;
  int64_t c = 0;
  for (size_t i = 0; i < b->nwords; i++)
    c += __builtin_popcountll(b->words[i].load());
  return c;
}
API int gbm_fill_bytes(void* h, uint8_t* out, int64_t nbits) {
  // export as one byte per bit (numpy bool) for fast mask building
  auto* b = (Bitmap*)h;
  int64_t lim = std::min<int64_t>(nbits, (int64_t)b->nwords * 64);
  for (int64_t i = 0; i < lim; i += 64) {
    uint64_t w = b->words[i / 64].load();
    int64_t n = std::min<int64_t>(64, lim - i);
    for (int64_t j = 0; j < n; j++) out[i + j] = (w >> j) & 1;
  }
  return 0;
}
API int gbm_sync(void* h) {
  auto* b = (Bitmap*)h;
  return ::msync((void*)b->words, b->map_len, MS_SYNC);
}
API void gbm_close(void* h) {
  auto* b = (Bitmap*)h;
  if (b->words) { ::msync((void*)b->words, b->map_len, MS_SYNC);
                  ::munmap((void*)b->words, b->map_len); }
  if (b->fd >= 0) ::close(b->fd);
  delete b;
}

// ============================ key map ================================

API void* gkm_new() { return new KeyMap(); }
API void gkm_free(void* h) { delete (KeyMap*)h; }

API int64_t gkm_put(void* h, const char* key, int64_t len, int64_t docid) {
  auto* km = (KeyMap*)h;
  auto& sh = km->shards[KeyMap::shard_of(key, (int)len)];
  std::lock_guard<std::mutex> g(sh.mu);
  auto it = sh.m.find(std::string(key, (size_t)len));
  int64_t old = it == sh.m.end() ? -1 : it->second;
  sh.m[std::string(key, (size_t)len)] = docid;
  return old;
}
API int64_t gkm_get(void* h, const char* key, int64_t len) {
  auto* km = (KeyMap*)h;
  auto& sh = km->shards[KeyMap::shard_of(key, (int)len)];
  std::lock_guard<std::mutex> g(sh.mu);
  auto it = sh.m.find(std::string(key, (size_t)len));
  return it == sh.m.end() ? -1 : it->second;
}
API int64_t gkm_del(void* h, const char* key, int64_t len) {
  auto* km = (KeyMap*)h;
  auto& sh = km->shards[KeyMap::shard_of(key, (int)len)];
  std::lock_guard<std::mutex> g(sh.mu);
  auto it = sh.m.find(std::string(key, (size_t)len));
  if (it == sh.m.end()) return -1;
  int64_t v = it->second;
  sh.m.erase(it);
  return v;
}
API int64_t gkm_size(void* h) {
  auto* km = (KeyMap*)h;
  int64_t n = 0;
  for (auto& sh : km->shards) {
    std::lock_guard<std::mutex> g(sh.mu);
    n += (int64_t)sh.m.size();
  }
  return n;
}
API int gkm_dump(void* h, const char* path) {
  auto* km = (KeyMap*)h;
  FILE* f = ::fopen(path, "wb");
  if (!f) return -1;
  for (auto& sh : km->shards) {
    std::lock_guard<std::mutex> g(sh.mu);
    for (auto& kv : sh.m) {
      uint32_t l = (uint32_t)kv.first.size();
      ::fwrite(&l, 4, 1, f);
      ::fwrite(kv.first.data(), 1, l, f);
      ::fwrite(&kv.second, 8, 1, f);
    }
  }
  ::fclose(f);
  return 0;
}
API int gkm_load(void* h, const char* path) {
  FILE* f = ::fopen(path, "rb");
  if (!f) return -1;
  std::vector<char> buf;
  for (;;) {
    uint32_t l;
    if (::fread(&l, 4, 1, f) != 1) break;
    buf.resize(l);
    if (::fread(buf.data(), 1, l, f) != l) break;
    int64_t v;
    if (::fread(&v, 8, 1, f) != 1) break;
    gkm_put(h, buf.data(), (int64_t)l, v);
  }
  ::fclose(f);
  return 0;
}
