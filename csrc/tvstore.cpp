// tvstore — tpuvec native snapshot storage engine.
//
// The reference delegates persistence to the bundled SQLite C library
// (shadow tables under WAL journaling, /root/reference/src/shadow.rs).
// tpuvec's authoritative state lives in device memory; persistence is an explicit
// snapshot of named n-d arrays. This engine provides the native runtime
// path for that: a single-file columnar format written with buffered IO
// and read back zero-copy via mmap, with per-section CRC32C integrity
// (the analogue of PRAGMA integrity_check at the storage layer).
//
// File layout (little-endian):
//   [0]  header: magic "TPVS" | u32 version | u64 section_count
//                | u64 directory_offset | u64 file_crc_of_directory
//   [..] section data blobs, each 64-byte aligned
//   [dir] directory: per section
//         u16 name_len | name bytes | u8 dtype | u8 ndim
//         | u64 shape[ndim] | u64 byte_len | u64 offset | u32 crc32
//
// C ABI only (loaded from Python via ctypes). Thread-compatible: one
// writer/reader handle per thread.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53565054;  // "TPVS"
constexpr uint32_t kVersion = 1;
constexpr size_t kAlign = 64;

// CRC32 (IEEE, zlib-compatible), slice-by-1 table.
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int j = 0; j < 8; ++j) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32_buf(const void* data, size_t len, uint32_t seed = 0) {
  crc_init();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  const uint8_t* p = static_cast<const uint8_t*>(data);
  for (size_t i = 0; i < len; ++i) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Section {
  std::string name;
  uint8_t dtype = 0;
  std::vector<uint64_t> shape;
  uint64_t byte_len = 0;
  uint64_t offset = 0;
  uint32_t crc = 0;
};

struct Writer {
  FILE* f = nullptr;
  std::string path;       // final path
  std::string tmp_path;   // staging path (atomic rename on finish)
  uint64_t pos = 0;
  std::vector<Section> sections;
  std::string error;
};

struct Reader {
  int fd = -1;
  void* map = MAP_FAILED;
  size_t map_len = 0;
  std::vector<Section> sections;
  std::string error;
};

thread_local std::string g_error;

void put_u16(std::string& b, uint16_t v) { b.append(reinterpret_cast<char*>(&v), 2); }
void put_u32(std::string& b, uint32_t v) { b.append(reinterpret_cast<char*>(&v), 4); }
void put_u64(std::string& b, uint64_t v) { b.append(reinterpret_cast<char*>(&v), 8); }

}  // namespace

extern "C" {

const char* tvs_last_error() { return g_error.c_str(); }

// ---------------------------------------------------------------- writer

void* tvs_writer_open(const char* path) {
  auto* w = new Writer();
  w->path = path;
  w->tmp_path = std::string(path) + ".tmp";
  w->f = fopen(w->tmp_path.c_str(), "wb");
  if (!w->f) {
    g_error = "cannot open " + w->tmp_path;
    delete w;
    return nullptr;
  }
  // placeholder header: magic, version, count, dir_offset, dir_crc
  char hdr[4 + 4 + 8 + 8 + 8] = {0};
  memcpy(hdr, &kMagic, 4);
  memcpy(hdr + 4, &kVersion, 4);
  fwrite(hdr, 1, sizeof(hdr), w->f);
  w->pos = sizeof(hdr);
  return w;
}

int tvs_writer_add(void* handle, const char* name, uint8_t dtype,
                   uint8_t ndim, const uint64_t* shape, const void* data,
                   uint64_t byte_len) {
  auto* w = static_cast<Writer*>(handle);
  // pad to alignment
  size_t pad = (kAlign - (w->pos % kAlign)) % kAlign;
  if (pad) {
    char zeros[kAlign] = {0};
    if (fwrite(zeros, 1, pad, w->f) != pad) { g_error = "write failed"; return -1; }
    w->pos += pad;
  }
  Section s;
  s.name = name;
  s.dtype = dtype;
  s.shape.assign(shape, shape + ndim);
  s.byte_len = byte_len;
  s.offset = w->pos;
  s.crc = crc32_buf(data, byte_len);
  if (fwrite(data, 1, byte_len, w->f) != byte_len) {
    g_error = "write failed";
    return -1;
  }
  w->pos += byte_len;
  w->sections.push_back(std::move(s));
  return 0;
}

int tvs_writer_finish(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  std::string dir;
  for (const auto& s : w->sections) {
    put_u16(dir, static_cast<uint16_t>(s.name.size()));
    dir.append(s.name);
    dir.push_back(static_cast<char>(s.dtype));
    dir.push_back(static_cast<char>(s.shape.size()));
    for (uint64_t d : s.shape) put_u64(dir, d);
    put_u64(dir, s.byte_len);
    put_u64(dir, s.offset);
    put_u32(dir, s.crc);
  }
  uint64_t dir_offset = w->pos;
  uint64_t count = w->sections.size();
  uint64_t dir_crc = crc32_buf(dir.data(), dir.size());
  int rc = 0;
  if (fwrite(dir.data(), 1, dir.size(), w->f) != dir.size()) rc = -1;
  if (rc == 0) {
    fseek(w->f, 8, SEEK_SET);
    fwrite(&count, 8, 1, w->f);
    fwrite(&dir_offset, 8, 1, w->f);
    fwrite(&dir_crc, 8, 1, w->f);  // stored in 8 bytes, upper 4 zero
  }
  if (fflush(w->f) != 0) rc = -1;
  if (rc == 0) rc = fsync(fileno(w->f));
  fclose(w->f);
  if (rc == 0) rc = rename(w->tmp_path.c_str(), w->path.c_str());
  if (rc != 0) {
    g_error = "finish failed";
    unlink(w->tmp_path.c_str());
  }
  delete w;
  return rc;
}

void tvs_writer_abort(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  fclose(w->f);
  unlink(w->tmp_path.c_str());
  delete w;
}

// ---------------------------------------------------------------- reader

void* tvs_reader_open(const char* path) {
  auto* r = new Reader();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) {
    g_error = std::string("cannot open ") + path;
    delete r;
    return nullptr;
  }
  struct stat st;
  fstat(r->fd, &st);
  r->map_len = static_cast<size_t>(st.st_size);
  r->map = mmap(nullptr, r->map_len, PROT_READ, MAP_SHARED, r->fd, 0);
  if (r->map == MAP_FAILED) {
    g_error = "mmap failed";
    close(r->fd);
    delete r;
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(r->map);
  uint32_t magic, version;
  uint64_t count, dir_offset, dir_crc;
  if (r->map_len < 32) { g_error = "truncated file"; goto fail; }
  memcpy(&magic, base, 4);
  memcpy(&version, base + 4, 4);
  memcpy(&count, base + 8, 8);
  memcpy(&dir_offset, base + 16, 8);
  memcpy(&dir_crc, base + 24, 8);
  if (magic != kMagic) { g_error = "bad magic"; goto fail; }
  if (version != kVersion) { g_error = "unsupported version"; goto fail; }
  if (dir_offset > r->map_len) { g_error = "corrupt directory offset"; goto fail; }
  if (crc32_buf(base + dir_offset, r->map_len - dir_offset) !=
      static_cast<uint32_t>(dir_crc)) {
    g_error = "directory CRC mismatch";
    goto fail;
  }
  {
    const uint8_t* p = base + dir_offset;
    const uint8_t* end = base + r->map_len;
    for (uint64_t i = 0; i < count; ++i) {
      Section s;
      uint16_t nl;
      // Every field is bounds-checked before the read: a truncated or
      // CRC-colliding directory must fail cleanly, never read past the mmap.
      if (p + 2 > end) { g_error = "corrupt directory"; goto fail; }
      memcpy(&nl, p, 2); p += 2;
      if (p + nl + 2 > end) { g_error = "corrupt directory"; goto fail; }
      s.name.assign(reinterpret_cast<const char*>(p), nl); p += nl;
      s.dtype = *p++;
      uint8_t ndim = *p++;
      if (ndim > 8) { g_error = "corrupt directory"; goto fail; }
      if (p + 8 * static_cast<size_t>(ndim) + 20 > end) {
        g_error = "corrupt directory"; goto fail;
      }
      s.shape.resize(ndim);
      for (int j = 0; j < ndim; ++j) { memcpy(&s.shape[j], p, 8); p += 8; }
      memcpy(&s.byte_len, p, 8); p += 8;
      memcpy(&s.offset, p, 8); p += 8;
      memcpy(&s.crc, p, 4); p += 4;
      if (s.offset > r->map_len || s.byte_len > r->map_len - s.offset) {
        g_error = "corrupt section"; goto fail;
      }
      r->sections.push_back(std::move(s));
    }
  }
  return r;
fail:
  if (r->map != MAP_FAILED) munmap(r->map, r->map_len);
  if (r->fd >= 0) close(r->fd);
  delete r;
  return nullptr;
}

uint64_t tvs_reader_count(void* handle) {
  return static_cast<Reader*>(handle)->sections.size();
}

// Fills the caller's buffers with section i's metadata.
int tvs_reader_info(void* handle, uint64_t i, char* name_out,
                    uint64_t name_cap, uint8_t* dtype_out, uint8_t* ndim_out,
                    uint64_t* shape_out /* at least 8 */, uint64_t* len_out) {
  auto* r = static_cast<Reader*>(handle);
  if (i >= r->sections.size()) { g_error = "index out of range"; return -1; }
  const Section& s = r->sections[i];
  if (s.name.size() + 1 > name_cap) { g_error = "name buffer too small"; return -1; }
  memcpy(name_out, s.name.c_str(), s.name.size() + 1);
  *dtype_out = s.dtype;
  *ndim_out = static_cast<uint8_t>(s.shape.size());
  for (size_t j = 0; j < s.shape.size() && j < 8; ++j) shape_out[j] = s.shape[j];
  *len_out = s.byte_len;
  return 0;
}

// Returns a pointer into the mmap (zero-copy); verifies CRC when verify != 0.
const void* tvs_reader_data(void* handle, uint64_t i, int verify) {
  auto* r = static_cast<Reader*>(handle);
  if (i >= r->sections.size()) { g_error = "index out of range"; return nullptr; }
  const Section& s = r->sections[i];
  const uint8_t* p = static_cast<const uint8_t*>(r->map) + s.offset;
  if (verify && crc32_buf(p, s.byte_len) != s.crc) {
    g_error = "section CRC mismatch: " + s.name;
    return nullptr;
  }
  return p;
}

void tvs_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  munmap(r->map, r->map_len);
  close(r->fd);
  delete r;
}

}  // extern "C"
