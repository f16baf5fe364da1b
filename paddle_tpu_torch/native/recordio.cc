// RecordIO chunk engine: framing, CRC32, compression (a copy of
// paddle_tpu/native/recordio.cc; the same file format, byte for byte).
//
// Capability analog of the reference recordio subsystem
// (paddle/fluid/recordio/{header,chunk,writer,scanner}.{h,cc}) with an
// original on-disk format designed for this framework:
//
//   file  := chunk*
//   chunk := header payload
//   header (32 bytes, little-endian):
//     u32 magic       0x54505552 ("RUPT")
//     u32 version     1
//     u32 compressor  0=raw, 1=deflate(zlib)
//     u32 num_records
//     u32 raw_len     payload length after decompression
//     u32 stored_len  payload length on disk
//     u32 crc32       of the RAW (uncompressed) payload
//     u32 reserved    0
//   payload := (u32 len, bytes)*   -- one per record, concatenated
//
// The reference compresses with snappy/gzip; here zlib's deflate is the
// compressed mode. CRC is computed over the raw payload
// so corruption is caught after decompression too.
//
// Exposed as a C ABI for ctypes. All
// functions return 0 on success, negative on failure; rupt_last_error
// returns a static message for the calling thread.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x54505552u;
constexpr uint32_t kVersion = 1u;
// writer flushes a chunk once its payload passes this budget; scanner
// rejects header lengths above 4x it (corrupt-header allocation guard)
constexpr size_t kChunkByteBudget = 256u << 20;
constexpr size_t kMaxChunkLen = 1u << 30;

thread_local std::string g_error;

int fail(const std::string& msg) {
  g_error = msg;
  return -1;
}

struct ChunkHeader {
  uint32_t magic, version, compressor, num_records;
  uint32_t raw_len, stored_len, crc, reserved;
};

static_assert(sizeof(ChunkHeader) == 32, "header must be 32 bytes");

struct Writer {
  FILE* f = nullptr;
  uint32_t compressor = 1;
  uint32_t max_records = 1000;
  std::vector<uint8_t> payload;
  uint32_t num_records = 0;

  int flush_chunk() {
    if (num_records == 0) return 0;
    if (payload.size() > UINT32_MAX)
      return fail("chunk payload exceeds 4GB");  // u32 header fields
    uint32_t crc = crc32(0L, payload.data(), payload.size());
    std::vector<uint8_t> stored;
    uint32_t comp = compressor;
    if (comp == 1) {
      uLongf bound = compressBound(payload.size());
      stored.resize(bound);
      if (compress2(stored.data(), &bound, payload.data(), payload.size(),
                    Z_DEFAULT_COMPRESSION) != Z_OK)
        return fail("deflate failed");
      stored.resize(bound);
      if (stored.size() >= payload.size()) {  // incompressible: store raw
        stored = payload;
        comp = 0;
      }
    } else {
      stored = payload;
    }
    ChunkHeader h = {kMagic, kVersion, comp, num_records,
                     static_cast<uint32_t>(payload.size()),
                     static_cast<uint32_t>(stored.size()), crc, 0};
    if (fwrite(&h, sizeof(h), 1, f) != 1 ||
        (stored.size() &&
         fwrite(stored.data(), 1, stored.size(), f) != stored.size()))
      return fail("short write");
    payload.clear();
    num_records = 0;
    return 0;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<uint8_t> raw;     // decompressed current chunk payload
  size_t off = 0;               // cursor into raw
  uint32_t remaining = 0;       // records left in current chunk

  // returns 0 ok, 1 eof, -1 error
  int load_chunk() {
    ChunkHeader h;
    size_t n = fread(&h, 1, sizeof(h), f);
    if (n == 0) return 1;
    if (n != sizeof(h)) return fail("truncated chunk header");
    if (h.magic != kMagic) return fail("bad magic: not a recordio file");
    if (h.version != kVersion) return fail("unsupported recordio version");
    if (h.stored_len > kMaxChunkLen || h.raw_len > kMaxChunkLen)
      return fail("chunk length exceeds sanity bound: corrupt header");
    std::vector<uint8_t> stored(h.stored_len);
    if (h.stored_len &&
        fread(stored.data(), 1, h.stored_len, f) != h.stored_len)
      return fail("truncated chunk payload");
    if (h.compressor == 0) {
      raw = std::move(stored);
    } else if (h.compressor == 1) {
      raw.resize(h.raw_len);
      uLongf out_len = h.raw_len;
      if (uncompress(raw.data(), &out_len, stored.data(), stored.size())
              != Z_OK || out_len != h.raw_len)
        return fail("inflate failed");
    } else {
      return fail("unknown compressor");
    }
    if (crc32(0L, raw.data(), raw.size()) != h.crc)
      return fail("crc mismatch: corrupt chunk");
    off = 0;
    remaining = h.num_records;
    return 0;
  }
};

}  // namespace

extern "C" {

const char* rupt_last_error() { return g_error.c_str(); }

void* rupt_writer_open(const char* path, uint32_t compressor,
                       uint32_t max_records) {
  FILE* f = fopen(path, "wb");
  if (!f) {
    fail(std::string("cannot open for write: ") + path);
    return nullptr;
  }
  Writer* w = new Writer();
  w->f = f;
  w->compressor = compressor;
  w->max_records = max_records ? max_records : 1000;
  return w;
}

int rupt_writer_append(void* handle, const uint8_t* data, uint32_t len) try {
  Writer* w = static_cast<Writer*>(handle);
  uint32_t len_le = len;
  const uint8_t* lp = reinterpret_cast<const uint8_t*>(&len_le);
  w->payload.insert(w->payload.end(), lp, lp + 4);
  w->payload.insert(w->payload.end(), data, data + len);
  // flush on byte budget too, not just record count: u32 header fields
  // cap a chunk at 4GB, and huge chunks hurt scan memory anyway
  if (++w->num_records >= w->max_records ||
      w->payload.size() >= kChunkByteBudget)
    return w->flush_chunk();
  return 0;
} catch (const std::exception& e) {
  return fail(e.what());   // bad_alloc etc. must not cross the C ABI
}

int rupt_writer_close(void* handle) try {
  Writer* w = static_cast<Writer*>(handle);
  int rc = w->flush_chunk();
  if (fclose(w->f) != 0 && rc == 0) rc = fail("close failed");
  delete w;
  return rc;
} catch (const std::exception& e) {
  return fail(e.what());
}

void* rupt_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    fail(std::string("cannot open for read: ") + path);
    return nullptr;
  }
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// next record: 0 ok (*out/*len borrowed until next call), 1 eof, -1 error
int rupt_scanner_next(void* handle, const uint8_t** out,
                      uint32_t* len) try {
  Scanner* s = static_cast<Scanner*>(handle);
  while (s->remaining == 0) {
    int rc = s->load_chunk();
    if (rc != 0) return rc;
  }
  if (s->off + 4 > s->raw.size()) return fail("corrupt record framing");
  uint32_t rec_len;
  memcpy(&rec_len, s->raw.data() + s->off, 4);
  s->off += 4;
  if (s->off + rec_len > s->raw.size())
    return fail("corrupt record framing");
  *out = s->raw.data() + s->off;
  *len = rec_len;
  s->off += rec_len;
  s->remaining--;
  return 0;
} catch (const std::exception& e) {
  return fail(e.what());   // bad_alloc etc. must not cross the C ABI
}

void rupt_scanner_close(void* handle) {
  Scanner* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

}  // extern "C"
