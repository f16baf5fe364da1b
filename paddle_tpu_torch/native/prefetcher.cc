// Parallel RecordIO prefetcher (a copy of paddle_tpu/native/
// prefetcher.cc): the native data-loader half of the runtime (capability analog of the reference's C++ reader stack —
// operators/reader/create_double_buffer_reader_op.cc's background
// thread + blocking queue, and the multi-file open_files pattern —
// rebuilt as a work-stealing, multi-threaded chunk loader).
//
// Why native: the Python scanner decompresses and CRC-checks chunks
// under the GIL, so a multi-file pipeline cannot use more than one
// core. Here N worker threads claim files from an atomic cursor, run
// the chunk engine (framing + CRC32 + inflate, shared with
// recordio.cc) and push records into ONE bounded blocking queue the
// Python side drains — IO, CRC and decompression scale across cores
// with zero GIL involvement.
//
// C ABI (ctypes):
//   rupt_prefetcher_open(paths, n_paths, n_threads, capacity, loop)
//       -> handle (NULL + rupt_pf_last_error on failure); capacity
//          counts CHUNKS in flight (default 64)
//   rupt_prefetcher_next_chunk(handle, &ptr, &len, &nrec)
//       -> 0 one whole decompressed chunk payload (len-prefixed
//            records, exactly the on-disk payload layout; ptr valid
//            until the NEXT call; single-consumer contract),
//          1 end-of-data, -1 error
//   rupt_prefetcher_close(handle)
// Hand-off is per CHUNK, not per record: a per-record FFI+lock
// crossing measured SLOWER than the serial python scanner for small
// records; one crossing per ~hundreds of records amortizes both.
// Records keep file order WITHIN a file; global order across files is
// nondeterministic (parallel by design).

#include <malloc.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x54505552u;
constexpr size_t kMaxChunkLen = 1u << 30;

thread_local std::string g_pf_error;

struct ChunkHeader {
  uint32_t magic, version, compressor, num_records;
  uint32_t raw_len, stored_len, crc, reserved;
};
static_assert(sizeof(ChunkHeader) == 32, "header must be 32 bytes");

// Scan one file chunk by chunk, invoking sink(payload, num_records)
// per decompressed+verified chunk. Returns empty string on success.
std::string scan_file(
    const std::string& path,
    const std::function<bool(std::string&&, uint32_t)>& sink) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return "cannot open " + path;
  std::string err;
  std::vector<uint8_t> stored, raw;
  for (;;) {
    ChunkHeader h;
    size_t n = std::fread(&h, 1, sizeof(h), f);
    if (n == 0) break;                       // clean EOF
    if (n != sizeof(h)) { err = "truncated header in " + path; break; }
    if (h.magic != kMagic) { err = "bad magic in " + path; break; }
    if (h.version != 1) {
      err = "unsupported recordio version in " + path;
      break;
    }
    if (h.raw_len > kMaxChunkLen || h.stored_len > kMaxChunkLen) {
      err = "oversized chunk in " + path;
      break;
    }
    stored.resize(h.stored_len);
    if (std::fread(stored.data(), 1, h.stored_len, f) != h.stored_len) {
      err = "truncated chunk in " + path;
      break;
    }
    const uint8_t* payload = stored.data();
    size_t payload_len = h.stored_len;
    if (h.compressor == 1) {
      raw.resize(h.raw_len);
      uLongf out_len = h.raw_len;
      if (uncompress(raw.data(), &out_len, stored.data(),
                     h.stored_len) != Z_OK || out_len != h.raw_len) {
        err = "inflate failed in " + path;
        break;
      }
      payload = raw.data();
      payload_len = h.raw_len;
    } else if (h.compressor != 0) {
      err = "unknown compressor in " + path;
      break;
    }
    uLong crc = crc32(0L, payload, payload_len);
    if ((uint32_t)crc != h.crc) { err = "crc mismatch in " + path; break; }
    if (!sink(std::string((const char*)payload, payload_len),
              h.num_records)) {
      std::fclose(f);
      return "";                             // consumer asked to stop
    }
  }
  std::fclose(f);
  return err;
}

// ---- native decode stage ---------------------------------------------
// Record layout for decode_mode 1: two concatenated .npy blobs — a
// uint8 CHW image of img_elems elements and one int64 label (the
// repo's _encode_sample format with a u8 image slot). Workers
// normalize to float32 ((x/255 - mean[c]) * inv_std[c]) while the
// chunk is hot in cache — the per-record augmentation/normalization
// work the reference runs in its decoder threads
// (operators/reader/..., reader/decorator.py xmap_readers) — and emit
// a chunk of [n*img_elems f32 images][n int64 labels].

// minimal .npy v1 framing: returns the payload offset or 0 on error
static size_t npy_data_offset(const uint8_t* p, size_t len) {
  if (len < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) return 0;
  uint16_t hlen;
  std::memcpy(&hlen, p + 8, 2);
  size_t off = 10 + (size_t)hlen;
  return off <= len ? off : 0;
}

struct DecodeSpec {
  bool enabled = false;
  uint32_t channels = 0, hw = 0;          // img_elems = channels * hw
  std::vector<float> mean, inv_std;
};

static std::string decode_chunk(const DecodeSpec& d, const std::string& in,
                                uint32_t nrec, std::string* out) {
  const size_t img_elems = (size_t)d.channels * d.hw;
  // labels block starts 8-byte aligned (odd nrec*img_elems would
  // otherwise make the int64 pointer misaligned — UB, and an unaligned
  // numpy view on the Python side)
  const size_t label_off = ((nrec * img_elems * 4) + 7) & ~size_t(7);
  out->resize(label_off + nrec * 8);
  float* imgs = (float*)out->data();
  int64_t* labels = (int64_t*)(out->data() + label_off);
  const uint8_t* p = (const uint8_t*)in.data();
  size_t off = 0, len = in.size();
  for (uint32_t r = 0; r < nrec; ++r) {
    if (off + 4 > len) return "truncated record length";
    uint32_t rlen;
    std::memcpy(&rlen, p + off, 4);
    off += 4;
    if (off + rlen > len) return "truncated record";
    const uint8_t* rec = p + off;
    // record = u32 nslots, then per slot u32 len + .npy blob
    // (recordio.py _encode_sample)
    if (rlen < 12) return "record too short";
    uint32_t nslots, len1, len2;
    std::memcpy(&nslots, rec, 4);
    if (nslots != 2) return "image record needs exactly 2 slots";
    std::memcpy(&len1, rec + 4, 4);
    if (8 + (size_t)len1 + 4 > rlen) return "bad image slot length";
    const uint8_t* blob1 = rec + 8;
    std::memcpy(&len2, rec + 8 + len1, 4);
    if (12 + (size_t)len1 + len2 > rlen) return "bad label slot length";
    const uint8_t* blob2 = rec + 12 + len1;
    size_t h1 = npy_data_offset(blob1, len1);
    // exact-size check doubles as the dtype contract: a float32 image
    // slot is 4x bigger and must error, not be read as u8 garbage
    if (!h1 || h1 + img_elems != len1) return "bad image npy framing";
    const uint8_t* px = blob1 + h1;
    float* dst = imgs + (size_t)r * img_elems;
    for (uint32_t c = 0; c < d.channels; ++c) {
      const float m = d.mean[c], is = d.inv_std[c];
      const uint8_t* src = px + (size_t)c * d.hw;
      float* dc = dst + (size_t)c * d.hw;
      for (uint32_t i = 0; i < d.hw; ++i)
        dc[i] = ((float)src[i] * (1.0f / 255.0f) - m) * is;
    }
    size_t h2 = npy_data_offset(blob2, len2);
    if (!h2 || h2 + 8 > len2) return "bad label npy framing";
    std::memcpy(&labels[r], blob2 + h2, 8);
    off += rlen;
  }
  return "";
}

struct Prefetcher {
  std::vector<std::string> paths;
  uint32_t capacity;
  bool loop;
  DecodeSpec decode;

  std::mutex mu;
  std::condition_variable not_full, not_empty;
  std::deque<std::pair<std::string, uint32_t>> queue;   // payload, nrec
  std::atomic<size_t> next_file{0};
  std::atomic<uint32_t> live_workers{0};
  bool stopping = false;
  std::string error;                         // guarded by mu
  std::vector<std::thread> workers;
  std::string current;                       // last record handed out

  // Blocking dequeue shared by both hand-off ABIs: waits for data,
  // drains already-decoded chunks BEFORE surfacing a failed file's
  // error (successfully-read records must not be lost to an unrelated
  // file's IOError), returns 0 with the popped chunk, 1 at clean end,
  // -1 with the error surfaced.
  int pop_chunk(std::string* payload, uint32_t* nrec) {
    std::unique_lock<std::mutex> lk(mu);
    not_empty.wait(lk, [this] {
      return !queue.empty() || live_workers.load() == 0 || stopping;
    });
    if (queue.empty()) {
      if (!error.empty()) {
        g_pf_error = error;
        return -1;
      }
      return 1;
    }
    *payload = std::move(queue.front().first);
    *nrec = queue.front().second;
    queue.pop_front();
    not_full.notify_one();
    return 0;
  }

  void worker() {
    for (;;) {
      size_t raw = next_file.fetch_add(1);
      size_t i;
      if (loop) {
        // endless epochs: the cursor grows monotonically and the
        // index wraps by modulo (a reset-the-cursor CAS scheme
        // compares against a stale value and never fires — it
        // deadlocked after one epoch)
        i = raw % paths.size();
      } else {
        if (raw >= paths.size()) break;
        i = raw;
      }
      std::string decode_err;
      auto sink = [this, &decode_err](std::string&& payload,
                                      uint32_t nrec) {
        if (decode.enabled) {
          std::string out;
          decode_err = decode_chunk(decode, payload, nrec, &out);
          if (!decode_err.empty()) return false;
          payload = std::move(out);
        }
        std::unique_lock<std::mutex> lk(mu);
        not_full.wait(lk, [this] {
          return stopping || queue.size() < capacity;
        });
        if (stopping) return false;
        queue.emplace_back(std::move(payload), nrec);
        not_empty.notify_one();
        return true;
      };
      std::string err = scan_file(paths[i], sink);
      // a decode failure stops the sink with scan_file reporting clean
      // consumer-stop; surface the real cause
      if (err.empty() && !decode_err.empty())
        err = decode_err + " in " + paths[i];
      if (!err.empty()) {
        std::unique_lock<std::mutex> lk(mu);
        if (error.empty()) error = err;
        stopping = true;
        not_empty.notify_all();
        not_full.notify_all();
        break;
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stopping) break;
      }
    }
    if (live_workers.fetch_sub(1) == 1) {
      std::unique_lock<std::mutex> lk(mu);
      not_empty.notify_all();                // drain-side wakeup at end
    }
  }
};

}  // namespace

extern "C" {

const char* rupt_pf_last_error() { return g_pf_error.c_str(); }

static void* open_common(const char** paths, uint32_t n_paths,
                         uint32_t n_threads, uint32_t capacity,
                         int loop, DecodeSpec decode) {
  if (n_paths == 0) {
    g_pf_error = "no input files";
    return nullptr;
  }
  // Decoded chunks are tens of MB; glibc serves allocations that big
  // with mmap and RETURNS them on free, so every chunk pays
  // mmap+munmap under the kernel's address-space lock plus a fresh
  // page-fault sweep on first touch — measured ~3x slowdown of the
  // whole pipeline. Raising the threshold keeps the buffers on the
  // (warm, reused) heap. Process-wide, idempotent, harmless for the
  // small allocations everything else makes.
  mallopt(M_MMAP_THRESHOLD, 256 * 1024 * 1024);
  mallopt(M_TRIM_THRESHOLD, 256 * 1024 * 1024);
  auto* p = new Prefetcher();
  for (uint32_t i = 0; i < n_paths; ++i) p->paths.emplace_back(paths[i]);
  p->capacity = capacity ? capacity : 64;
  p->loop = loop != 0;
  p->decode = std::move(decode);
  if (n_threads == 0) n_threads = 4;
  // clamp in loop mode too: with more workers than files the cursor's
  // modulo wrap would hand the SAME file to two workers concurrently,
  // duplicating in-flight records within an epoch
  if (n_threads > n_paths) n_threads = n_paths;
  p->live_workers = n_threads;
  for (uint32_t t = 0; t < n_threads; ++t)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

void* rupt_prefetcher_open(const char** paths, uint32_t n_paths,
                           uint32_t n_threads, uint32_t capacity,
                           int loop) {
  return open_common(paths, n_paths, n_threads, capacity, loop,
                     DecodeSpec{});
}

// Image-decode variant: workers additionally parse each record's two
// .npy slots (u8 CHW image of channels*hw elements + one int64 label)
// and emit normalized float32 chunks ([n*channels*hw f32][n i64]).
void* rupt_prefetcher_open_image(const char** paths, uint32_t n_paths,
                                 uint32_t n_threads, uint32_t capacity,
                                 int loop, uint32_t channels,
                                 uint32_t hw, const float* mean,
                                 const float* std_dev) {
  DecodeSpec d;
  d.enabled = true;
  d.channels = channels;
  d.hw = hw;
  for (uint32_t c = 0; c < channels; ++c) {
    d.mean.push_back(mean ? mean[c] : 0.0f);
    float s = std_dev ? std_dev[c] : 1.0f;
    d.inv_std.push_back(s != 0.0f ? 1.0f / s : 1.0f);
  }
  return open_common(paths, n_paths, n_threads, capacity, loop,
                     std::move(d));
}

int rupt_prefetcher_next_chunk(void* handle, const uint8_t** out,
                               uint32_t* len, uint32_t* nrec) {
  auto* p = (Prefetcher*)handle;
  int rc = p->pop_chunk(&p->current, nrec);
  if (rc != 0) return rc;
  *out = (const uint8_t*)p->current.data();
  *len = (uint32_t)p->current.size();
  return 0;
}

// Ownership-transfer variant of next_chunk: the chunk buffer is moved
// onto the heap and handed to the caller, who frees it with
// rupt_chunk_free when done — the zero-copy path (the consumer-side
// 38 MB-per-chunk copy measured as the drain's serial bottleneck).
int rupt_prefetcher_take_chunk(void* handle, const uint8_t** out,
                               void** free_handle, uint32_t* len,
                               uint32_t* nrec) {
  auto* p = (Prefetcher*)handle;
  auto s = std::make_unique<std::string>();
  int rc = p->pop_chunk(s.get(), nrec);
  if (rc != 0) return rc;
  *out = (const uint8_t*)s->data();
  *len = (uint32_t)s->size();
  *free_handle = s.release();
  return 0;
}

void rupt_chunk_free(void* free_handle) {
  delete (std::string*)free_handle;
}

void rupt_prefetcher_close(void* handle) {
  auto* p = (Prefetcher*)handle;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->stopping = true;
    p->not_full.notify_all();
    p->not_empty.notify_all();
  }
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
