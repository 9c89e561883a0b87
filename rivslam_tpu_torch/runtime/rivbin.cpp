// rivbin — native runtime: memory-mapped radar sequence container and a
// double-buffered prefetching frame loader.
//
// A copy of rivslam_tpu/runtime/rivbin.cpp for the PyTorch port. It is the
// replacement for the runtime role the reference
// delegates to ROS: rosbag storage + topic plumbing + nodelet pipelining
// (bag_player.py, preprocessing ingest). The container stores ragged
// per-frame radar targets and the IMU stream in one mmap-able file; the
// loader pads frames to a fixed capacity on background threads so the
// Python side consumes ready-made fixed-shape buffers without touching
// the decode path (host CPU work overlaps device compute).
//
// File layout (little endian):
//   header: magic "RIVB" u32 | version u32 | num_frames u64 | num_targets u64
//           | num_imu u64
// version 1 (raw, fully mmap-able):
//   frame index: (stamp f64, offset u64, count u64) * num_frames
//   targets: xyz f32[num_targets*3] | doppler f32[num_targets]
//            | intensity f32[num_targets]
//   imu: stamps f64[num_imu] | acc f32[num_imu*3] | gyr f32[num_imu*3]
// version 2 (per-frame LZ4-block-compressed chunks — the role chunked
// bz2/lz4 compression plays in the reference's rosbags; decompression
// happens on the prefetch worker threads so it overlaps device compute):
//   frame index: (stamp f64, count u64, chunk_off u64, csize u64) * n
//   chunks: concatenated LZ4 blocks; chunk i decompresses to
//           xyz f32[count*3] | doppler f32[count] | intensity f32[count]
//           (csize == raw size means the chunk is stored uncompressed)
//   imu: stamps f64[num_imu] | acc f32[num_imu*3] | gyr f32[num_imu*3]
//
// The LZ4 block codec below is an original implementation of the public
// LZ4 block format (greedy 4-byte-hash matcher), cross-validated in tests
// against the independent pure-python decoder in io/lz4f.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x42564952;  // "RIVB"
constexpr uint32_t kVersion = 1;
constexpr uint32_t kVersionLz4 = 2;

// ------------------------------------------------------------ LZ4 block
// Original implementation of the LZ4 block format. Format rules honored:
// token = (lit_len << 4) | (match_len - 4), 15 in a nibble extends with
// 0xFF bytes; 2-byte LE match offset in [1, 65535]; the final sequence is
// literals-only; no match starts within the last 12 bytes and none ends
// within the last 5.

inline uint32_t lz4_read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t lz4_hash(uint32_t v) { return (v * 2654435761u) >> 19; }
constexpr size_t kHashSize = 1u << 13;

// worst-case compressed size for n input bytes
inline size_t lz4_bound(size_t n) { return n + n / 255 + 16; }

size_t lz4_compress(const uint8_t* src, size_t n, uint8_t* dst) {
  uint8_t* op = dst;
  if (n == 0) return 0;
  std::vector<int64_t> table(kHashSize, -1);
  const int64_t mflimit = (int64_t)n - 12;  // no match may START after this
  const int64_t matchlimit = (int64_t)n - 5;  // ... or END after this
  int64_t anchor = 0, p = 0;

  auto emit = [&](int64_t lit_len, int64_t match_len, int64_t offset) {
    // match_len < 0 => final literal-only sequence
    const int64_t ml = match_len >= 0 ? match_len - 4 : 0;
    uint8_t token = (uint8_t)((lit_len >= 15 ? 15 : lit_len) << 4);
    token |= (uint8_t)(ml >= 15 ? 15 : ml);
    *op++ = token;
    for (int64_t r = lit_len - 15; r >= 0; r -= 255)
      *op++ = (uint8_t)(r >= 255 ? 255 : r);
    std::memcpy(op, src + anchor, lit_len);
    op += lit_len;
    if (match_len < 0) return;
    *op++ = (uint8_t)(offset & 0xFF);
    *op++ = (uint8_t)(offset >> 8);
    for (int64_t r = ml - 15; r >= 0; r -= 255)
      *op++ = (uint8_t)(r >= 255 ? 255 : r);
  };

  while (p <= mflimit) {
    const uint32_t h = lz4_hash(lz4_read32(src + p)) & (kHashSize - 1);
    const int64_t cand = table[h];
    table[h] = p;
    if (cand >= 0 && p - cand <= 65535 &&
        lz4_read32(src + cand) == lz4_read32(src + p)) {
      int64_t len = 4;
      while (p + len <= matchlimit && src[cand + len] == src[p + len]) ++len;
      emit(p - anchor, len, p - cand);
      p += len;
      anchor = p;
    } else {
      ++p;
    }
  }
  emit((int64_t)n - anchor, -1, 0);
  return (size_t)(op - dst);
}

// returns bytes written to dst (== rsize on success) or 0 on corruption
size_t lz4_decompress(const uint8_t* src, size_t csize, uint8_t* dst,
                      size_t rsize) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + csize;
  uint8_t* op = dst;
  uint8_t* oend = dst + rsize;
  while (ip < iend) {
    const uint8_t token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return 0;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return 0;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // final literal-only sequence
    if (ip + 2 > iend) return 0;
    const int64_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return 0;
    int64_t ml = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return 0;
        b = *ip++;
        ml += b;
      } while (b == 255);
    }
    if (op + ml > oend) return 0;
    const uint8_t* match = op - offset;
    for (int64_t i = 0; i < ml; ++i) op[i] = match[i];  // overlap-safe
    op += ml;
  }
  return (size_t)(op - dst);
}

#pragma pack(push, 1)
struct Header {
  uint32_t magic;
  uint32_t version;
  uint64_t num_frames;
  uint64_t num_targets;
  uint64_t num_imu;
};
struct FrameIndex {
  double stamp;
  uint64_t offset;
  uint64_t count;
};
struct FrameIndexV2 {
  double stamp;
  uint64_t count;
  uint64_t chunk_off;  // into the chunk region
  uint64_t csize;      // == count*20 means stored raw
};
#pragma pack(pop)

struct Sequence {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  Header hdr{};
  const FrameIndex* index = nullptr;        // v1
  const FrameIndexV2* index2 = nullptr;     // v2
  const uint8_t* chunks = nullptr;          // v2
  const float* xyz = nullptr;
  const float* doppler = nullptr;
  const float* intensity = nullptr;
  const double* imu_stamps = nullptr;
  const float* imu_acc = nullptr;
  const float* imu_gyr = nullptr;
  // owned copies used when the mmap'd section is misaligned for its type
  // (v2 IMU follows the byte-granular chunk region; v1 can land on a
  // 4-mod-8 offset when num_targets is odd) — dereferencing a misaligned
  // double* is UB (SIGBUS on strict-alignment targets, UBSan findings).
  std::vector<double> imu_stamps_own;
  std::vector<float> imu_acc_own, imu_gyr_own;
  // index of the most recent frame whose chunk failed to decode, -1 if none
  std::atomic<int64_t> corrupt_frame{-1};

  double stamp(int64_t i) const {
    return hdr.version == kVersion ? index[i].stamp : index2[i].stamp;
  }
  int64_t count(int64_t i) const {
    return hdr.version == kVersion ? (int64_t)index[i].count
                                   : (int64_t)index2[i].count;
  }
};

// copy the first n targets of frame i (unpadded) into the caller buffers,
// decompressing the chunk when the container is v2
bool frame_targets(const Sequence* s, int64_t i, int64_t n, float* xyz,
                   float* doppler, float* intensity) {
  if (s->hdr.version == kVersion) {
    const FrameIndex& fi = s->index[i];
    std::memcpy(xyz, s->xyz + fi.offset * 3, n * 3 * sizeof(float));
    std::memcpy(doppler, s->doppler + fi.offset, n * sizeof(float));
    std::memcpy(intensity, s->intensity + fi.offset, n * sizeof(float));
    return true;
  }
  const FrameIndexV2& fi = s->index2[i];
  const int64_t cnt = (int64_t)fi.count;
  const size_t rsize = (size_t)cnt * 20;  // 12 xyz + 4 dop + 4 intensity
  if (cnt == 0) return true;
  const uint8_t* raw;
  std::vector<uint8_t> scratch;
  if (fi.csize == rsize) {
    raw = s->chunks + fi.chunk_off;  // stored uncompressed
  } else {
    scratch.resize(rsize);
    if (lz4_decompress(s->chunks + fi.chunk_off, fi.csize, scratch.data(),
                       rsize) != rsize)
      return false;
    raw = scratch.data();
  }
  std::memcpy(xyz, raw, n * 3 * sizeof(float));
  std::memcpy(doppler, raw + cnt * 12, n * sizeof(float));
  std::memcpy(intensity, raw + cnt * 16, n * sizeof(float));
  return true;
}

struct Frame {
  double stamp;
  std::vector<float> xyz;        // capacity*3, padded with zeros
  std::vector<float> doppler;    // capacity
  std::vector<float> intensity;  // capacity
  std::vector<uint8_t> mask;     // capacity
  int64_t index;
};

// Prefetching loader: worker threads pad frames ahead of the consumer.
struct Loader {
  Sequence* seq = nullptr;
  int64_t capacity = 0;
  int64_t next_to_schedule = 0;
  int64_t next_to_emit = 0;
  size_t max_queue = 8;
  std::deque<Frame> ready;  // sorted by index on emit
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int64_t> scheduled{0};
  double last_emitted_stamp = -1.0;
  bool emitted_any = false;

  void worker() {
    for (;;) {
      int64_t i;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() ||
                 (next_to_schedule < (int64_t)seq->hdr.num_frames &&
                  ready.size() + (scheduled - next_to_emit - ready.size()) <
                      max_queue);
        });
        if (stop.load()) return;
        if (next_to_schedule >= (int64_t)seq->hdr.num_frames) return;
        i = next_to_schedule++;
        scheduled++;
      }
      Frame f = pad_frame(i);
      {
        std::unique_lock<std::mutex> lk(mu);
        // insert keeping index order
        auto it = ready.begin();
        while (it != ready.end() && it->index < f.index) ++it;
        ready.insert(it, std::move(f));
      }
      cv_ready.notify_all();
    }
  }

  Frame pad_frame(int64_t i) const {
    Frame f;
    f.index = i;
    f.stamp = seq->stamp(i);
    f.xyz.assign(capacity * 3, 0.f);
    f.doppler.assign(capacity, 0.f);
    f.intensity.assign(capacity, 0.f);
    f.mask.assign(capacity, 0);
    const int64_t n = std::min<int64_t>(seq->count(i), capacity);
    // v2: LZ4 decode runs here, on the prefetch worker, off the consumer.
    // On chunk corruption the mask stays all-zero (no fake points at the
    // origin) and the sequence records the frame for the caller to raise.
    if (frame_targets(seq, i, n, f.xyz.data(), f.doppler.data(),
                      f.intensity.data())) {
      std::memset(f.mask.data(), 1, n);
    } else {
      seq->corrupt_frame.store(i);
    }
    return f;
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- container

void* rivbin_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Sequence();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->size = st.st_size;
  std::memcpy(&s->hdr, s->base, sizeof(Header));
  if (s->hdr.magic != kMagic ||
      (s->hdr.version != kVersion && s->hdr.version != kVersionLz4)) {
    munmap(base, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  const uint8_t* p = s->base + sizeof(Header);
  if (s->hdr.version == kVersion) {
    s->index = reinterpret_cast<const FrameIndex*>(p);
    p += sizeof(FrameIndex) * s->hdr.num_frames;
    s->xyz = reinterpret_cast<const float*>(p);
    p += sizeof(float) * 3 * s->hdr.num_targets;
    s->doppler = reinterpret_cast<const float*>(p);
    p += sizeof(float) * s->hdr.num_targets;
    s->intensity = reinterpret_cast<const float*>(p);
    p += sizeof(float) * s->hdr.num_targets;
  } else {
    s->index2 = reinterpret_cast<const FrameIndexV2*>(p);
    p += sizeof(FrameIndexV2) * s->hdr.num_frames;
    s->chunks = p;
    uint64_t chunk_bytes = 0;
    for (uint64_t i = 0; i < s->hdr.num_frames; ++i)
      chunk_bytes += s->index2[i].csize;
    p += chunk_bytes;
  }
  const uint64_t m = s->hdr.num_imu;
  if (reinterpret_cast<uintptr_t>(p) % alignof(double) == 0) {
    s->imu_stamps = reinterpret_cast<const double*>(p);
    s->imu_acc = reinterpret_cast<const float*>(p + sizeof(double) * m);
    s->imu_gyr = reinterpret_cast<const float*>(p + sizeof(double) * m +
                                                sizeof(float) * 3 * m);
  } else {
    // misaligned IMU section: copy into owned aligned storage (memcpy is
    // alignment-safe); the IMU stream is small next to the target data
    s->imu_stamps_own.resize(m);
    s->imu_acc_own.resize(3 * m);
    s->imu_gyr_own.resize(3 * m);
    std::memcpy(s->imu_stamps_own.data(), p, sizeof(double) * m);
    std::memcpy(s->imu_acc_own.data(), p + sizeof(double) * m,
                sizeof(float) * 3 * m);
    std::memcpy(s->imu_gyr_own.data(),
                p + sizeof(double) * m + sizeof(float) * 3 * m,
                sizeof(float) * 3 * m);
    s->imu_stamps = s->imu_stamps_own.data();
    s->imu_acc = s->imu_acc_own.data();
    s->imu_gyr = s->imu_gyr_own.data();
  }
  return s;
}

void rivbin_close(void* handle) {
  auto* s = static_cast<Sequence*>(handle);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

int64_t rivbin_num_frames(void* handle) {
  return static_cast<Sequence*>(handle)->hdr.num_frames;
}
int64_t rivbin_num_imu(void* handle) {
  return static_cast<Sequence*>(handle)->hdr.num_imu;
}
double rivbin_frame_stamp(void* handle, int64_t i) {
  return static_cast<Sequence*>(handle)->stamp(i);
}
int64_t rivbin_frame_count(void* handle, int64_t i) {
  return static_cast<Sequence*>(handle)->count(i);
}
int64_t rivbin_format_version(void* handle) {
  return static_cast<Sequence*>(handle)->hdr.version;
}

// copy frame i padded to capacity into caller buffers
void rivbin_read_frame(void* handle, int64_t i, int64_t capacity, float* xyz,
                       float* doppler, float* intensity, uint8_t* mask) {
  auto* s = static_cast<Sequence*>(handle);
  const int64_t n = std::min<int64_t>(s->count(i), capacity);
  std::memset(xyz, 0, capacity * 3 * sizeof(float));
  std::memset(doppler, 0, capacity * sizeof(float));
  std::memset(intensity, 0, capacity * sizeof(float));
  std::memset(mask, 0, capacity);
  if (frame_targets(s, i, n, xyz, doppler, intensity))
    std::memset(mask, 1, n);
  else
    s->corrupt_frame.store(i);
}

// index of the most recent frame whose v2 chunk failed LZ4 decode, or -1.
// Readers leave a corrupt frame fully masked out; callers poll this to
// turn the silent-skip into a hard error.
int64_t rivbin_corrupt_frame(void* handle) {
  return static_cast<Sequence*>(handle)->corrupt_frame.load();
}

// masked IMU window (t0, t1]; returns number of samples written
int64_t rivbin_imu_between(void* handle, double t0, double t1,
                           int64_t capacity, double* stamps, float* acc,
                           float* gyr) {
  auto* s = static_cast<Sequence*>(handle);
  const int64_t m = s->hdr.num_imu;
  // binary search lower bound for t0
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (s->imu_stamps[mid] <= t0)
      lo = mid + 1;
    else
      hi = mid;
  }
  int64_t k = 0;
  for (int64_t i = lo; i < m && k < capacity && s->imu_stamps[i] <= t1; ++i) {
    stamps[k] = s->imu_stamps[i];
    std::memcpy(acc + k * 3, s->imu_acc + i * 3, 3 * sizeof(float));
    std::memcpy(gyr + k * 3, s->imu_gyr + i * 3, 3 * sizeof(float));
    ++k;
  }
  return k;
}

// writer: one-shot serialization from flat arrays
int rivbin_write(const char* path, int64_t num_frames, const double* stamps,
                 const int64_t* offsets /* num_frames+1 */, const float* xyz,
                 const float* doppler, const float* intensity, int64_t num_imu,
                 const double* imu_stamps, const float* imu_acc,
                 const float* imu_gyr) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const int64_t num_targets = offsets[num_frames];
  Header hdr{kMagic, kVersion, (uint64_t)num_frames, (uint64_t)num_targets,
             (uint64_t)num_imu};
  fwrite(&hdr, sizeof(hdr), 1, f);
  for (int64_t i = 0; i < num_frames; ++i) {
    FrameIndex fi{stamps[i], (uint64_t)offsets[i],
                  (uint64_t)(offsets[i + 1] - offsets[i])};
    fwrite(&fi, sizeof(fi), 1, f);
  }
  fwrite(xyz, sizeof(float), num_targets * 3, f);
  fwrite(doppler, sizeof(float), num_targets, f);
  fwrite(intensity, sizeof(float), num_targets, f);
  fwrite(imu_stamps, sizeof(double), num_imu, f);
  fwrite(imu_acc, sizeof(float), num_imu * 3, f);
  fwrite(imu_gyr, sizeof(float), num_imu * 3, f);
  fclose(f);
  return 0;
}

// writer: version-2 container with per-frame LZ4-compressed target chunks.
// Incompressible chunks are stored raw (csize == count*20 marks that).
int rivbin_write_lz4(const char* path, int64_t num_frames,
                     const double* stamps,
                     const int64_t* offsets /* num_frames+1 */,
                     const float* xyz, const float* doppler,
                     const float* intensity, int64_t num_imu,
                     const double* imu_stamps, const float* imu_acc,
                     const float* imu_gyr) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const int64_t num_targets = offsets[num_frames];
  Header hdr{kMagic, kVersionLz4, (uint64_t)num_frames, (uint64_t)num_targets,
             (uint64_t)num_imu};
  fwrite(&hdr, sizeof(hdr), 1, f);
  // compress all chunks first so the index can be written up front
  std::vector<FrameIndexV2> index(num_frames);
  std::vector<std::vector<uint8_t>> chunks(num_frames);
  std::vector<uint8_t> raw, comp;
  uint64_t off = 0;
  for (int64_t i = 0; i < num_frames; ++i) {
    const int64_t o = offsets[i];
    const int64_t n = offsets[i + 1] - o;
    const size_t rsize = (size_t)n * 20;
    raw.resize(rsize);
    std::memcpy(raw.data(), xyz + o * 3, n * 12);
    std::memcpy(raw.data() + n * 12, doppler + o, n * 4);
    std::memcpy(raw.data() + n * 16, intensity + o, n * 4);
    comp.resize(lz4_bound(rsize));
    const size_t csize = lz4_compress(raw.data(), rsize, comp.data());
    if (csize > 0 && csize < rsize) {
      chunks[i].assign(comp.data(), comp.data() + csize);
    } else {
      chunks[i] = raw;  // incompressible: store raw
    }
    index[i] = FrameIndexV2{stamps[i], (uint64_t)n, off,
                            (uint64_t)chunks[i].size()};
    off += chunks[i].size();
  }
  fwrite(index.data(), sizeof(FrameIndexV2), num_frames, f);
  for (int64_t i = 0; i < num_frames; ++i)
    fwrite(chunks[i].data(), 1, chunks[i].size(), f);
  fwrite(imu_stamps, sizeof(double), num_imu, f);
  fwrite(imu_acc, sizeof(float), num_imu * 3, f);
  fwrite(imu_gyr, sizeof(float), num_imu * 3, f);
  fclose(f);
  return 0;
}

// raw LZ4 block codec exports (tested against the independent pure-python
// decoder in io/lz4f.py)
int64_t rivbin_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t dst_cap) {
  if ((int64_t)lz4_bound(n) > dst_cap) return -1;
  return (int64_t)lz4_compress(src, (size_t)n, dst);
}
int64_t rivbin_lz4_decompress(const uint8_t* src, int64_t csize, uint8_t* dst,
                              int64_t rsize) {
  return (int64_t)lz4_decompress(src, (size_t)csize, dst, (size_t)rsize);
}

// ------------------------------------------------------------------ loader

void* rivbin_loader_create(void* handle, int64_t capacity, int threads,
                           int max_queue) {
  auto* l = new Loader();
  l->seq = static_cast<Sequence*>(handle);
  l->capacity = capacity;
  l->max_queue = max_queue > 0 ? max_queue : 8;
  const int n = threads > 0 ? threads : 2;
  for (int i = 0; i < n; ++i)
    l->workers.emplace_back([l] { l->worker(); });
  return l;
}

// blocking: next frame in order; returns frame index or -1 at end
int64_t rivbin_loader_next(void* loader, float* xyz, float* doppler,
                           float* intensity, uint8_t* mask, double* stamp) {
  auto* l = static_cast<Loader*>(loader);
  std::unique_lock<std::mutex> lk(l->mu);
  if (l->next_to_emit >= (int64_t)l->seq->hdr.num_frames) return -1;
  const int64_t want = l->next_to_emit;
  l->cv_ready.wait(lk, [&] {
    return !l->ready.empty() && l->ready.front().index == want;
  });
  Frame f = std::move(l->ready.front());
  l->ready.pop_front();
  l->next_to_emit++;
  lk.unlock();
  l->cv_space.notify_all();
  std::memcpy(xyz, f.xyz.data(), f.xyz.size() * sizeof(float));
  std::memcpy(doppler, f.doppler.data(), f.doppler.size() * sizeof(float));
  std::memcpy(intensity, f.intensity.data(), f.intensity.size() * sizeof(float));
  std::memcpy(mask, f.mask.data(), f.mask.size());
  *stamp = f.stamp;
  return f.index;
}

// blocking: next frame in order, plus its IMU window aligned natively.
// The window is (prev_frame_stamp, stamp] (first frame: stamp-0.1), padded to
// imu_capacity; dts are successive differences clamped to [1e-4, 0.05]
// (utility_radar.h imuDeque consumption semantics — samples more than 50 ms
// apart are treated as 50 ms so one dropout cannot blow up preintegration).
// Returns frame index or -1 at end; *imu_count gets the sample count.
int64_t rivbin_loader_next_aligned(void* loader, float* xyz, float* doppler,
                                   float* intensity, uint8_t* mask,
                                   double* stamp, int64_t imu_capacity,
                                   double* imu_dts, float* imu_acc,
                                   float* imu_gyr, uint8_t* imu_mask,
                                   int64_t* imu_count) {
  auto* l = static_cast<Loader*>(loader);
  const int64_t idx =
      rivbin_loader_next(loader, xyz, doppler, intensity, mask, stamp);
  if (idx < 0) return idx;
  const double t1 = *stamp;
  double t0;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    t0 = l->emitted_any ? l->last_emitted_stamp : t1 - 0.1;
    l->last_emitted_stamp = t1;
    l->emitted_any = true;
  }
  std::memset(imu_dts, 0, imu_capacity * sizeof(double));
  std::memset(imu_acc, 0, imu_capacity * 3 * sizeof(float));
  std::memset(imu_gyr, 0, imu_capacity * 3 * sizeof(float));
  std::memset(imu_mask, 0, imu_capacity);
  std::vector<double> stamps(imu_capacity, 0.0);
  const int64_t k = rivbin_imu_between(l->seq, t0, t1, imu_capacity,
                                       stamps.data(), imu_acc, imu_gyr);
  double prev = t0;
  for (int64_t i = 0; i < k; ++i) {
    double dt = stamps[i] - prev;
    if (dt < 1e-4) dt = 1e-4;
    if (dt > 0.05) dt = 0.05;
    imu_dts[i] = dt;
    imu_mask[i] = 1;
    prev = stamps[i];
  }
  *imu_count = k;
  return idx;
}

void rivbin_loader_destroy(void* loader) {
  auto* l = static_cast<Loader*>(loader);
  l->stop.store(true);
  l->cv_space.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

// ------------------------------------------------------------- TUM / ATE
// Native trajectory evaluator: the rpg-style protocol of eval/ate.py
// (TUM parse -> nearest-stamp association, gps_traj_align.cpp `associate`
// semantics -> Horn closed-form SE(3) alignment -> ATE stats) in C++ for
// post-run scoring outside the Python process. Cross-validated against
// eval/ate.py in tests/test_native_runtime.py.

namespace {

struct TumTraj {
  std::vector<double> t;
  std::vector<double> xyz;  // 3 per row
};

bool load_tum(const char* path, TumTraj* out) {
  FILE* f = fopen(path, "r");
  if (!f) return false;
  char line[512];
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == '#' || line[0] == '\n') continue;
    double t, x, y, z, qx, qy, qz, qw;
    if (sscanf(line, "%lf %lf %lf %lf %lf %lf %lf %lf", &t, &x, &y, &z, &qx,
               &qy, &qz, &qw) >= 4) {
      out->t.push_back(t);
      out->xyz.push_back(x);
      out->xyz.push_back(y);
      out->xyz.push_back(z);
    }
  }
  fclose(f);
  return !out->t.empty();
}

// dominant eigenvector of the symmetric 4x4 N by shifted power iteration
void dominant_eigvec4(const double N[4][4], double q[4]) {
  double shift = 0.0;  // Gershgorin bound makes N + shift*I PSD-dominant
  for (int i = 0; i < 4; ++i) {
    double row = 0.0;
    for (int j = 0; j < 4; ++j) row += std::fabs(N[i][j]);
    shift = std::max(shift, row);
  }
  double v[4] = {1.0, 0.1, 0.2, 0.3};
  for (int it = 0; it < 200; ++it) {
    double w[4];
    for (int i = 0; i < 4; ++i) {
      w[i] = shift * v[i];
      for (int j = 0; j < 4; ++j) w[i] += N[i][j] * v[j];
    }
    double n = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + w[3] * w[3]);
    for (int i = 0; i < 4; ++i) v[i] = w[i] / n;
  }
  for (int i = 0; i < 4; ++i) q[i] = v[i];
}

}  // namespace

// out[6] = {n_pairs, rmse, mean, median, max, std}; returns 0 on success.
// ATE after closed-form SE(3) alignment (Horn quaternion method — the same
// optimum as eval/ate.py's Umeyama SVD without scale).
int rivbin_tum_ate(const char* est_path, const char* gt_path, double max_dt,
                   double* out) {
  TumTraj est, gt;
  if (!load_tum(est_path, &est)) return -1;
  if (!load_tum(gt_path, &gt)) return -2;
  // nearest-stamp association (tools.associate_by_stamp semantics)
  std::vector<std::pair<int64_t, int64_t>> pairs;
  int64_t j = 0;
  const int64_t m = (int64_t)gt.t.size();
  for (int64_t i = 0; i < (int64_t)est.t.size(); ++i) {
    const double t = est.t[i];
    while (j + 1 < m && std::fabs(gt.t[j + 1] - t) <= std::fabs(gt.t[j] - t))
      ++j;
    if (std::fabs(gt.t[j] - t) <= max_dt) pairs.emplace_back(i, j);
  }
  const int64_t n = (int64_t)pairs.size();
  if (n < 3) return -3;

  double mu_e[3] = {0, 0, 0}, mu_g[3] = {0, 0, 0};
  for (auto& pr : pairs)
    for (int k = 0; k < 3; ++k) {
      mu_e[k] += est.xyz[3 * pr.first + k] / n;
      mu_g[k] += gt.xyz[3 * pr.second + k] / n;
    }
  // Horn's S_ab = sum (est_c)_a (gt_c)_b — first index est, second gt; the
  // dominant eigenvector of N then rotates est into gt
  double M[3][3] = {{0}};
  for (auto& pr : pairs)
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        M[r][c] += (est.xyz[3 * pr.first + r] - mu_e[r]) *
                   (gt.xyz[3 * pr.second + c] - mu_g[c]);
  // Horn's N matrix; its dominant eigenvector is the optimal quaternion
  const double Sxx = M[0][0], Sxy = M[0][1], Sxz = M[0][2];
  const double Syx = M[1][0], Syy = M[1][1], Syz = M[1][2];
  const double Szx = M[2][0], Szy = M[2][1], Szz = M[2][2];
  const double N4[4][4] = {
      {Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx},
      {Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz},
      {Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy},
      {Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz},
  };
  double q[4];
  dominant_eigvec4(N4, q);
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  const double R[3][3] = {
      {1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)},
      {2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)},
      {2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)},
  };
  double tr[3];
  for (int r = 0; r < 3; ++r)
    tr[r] = mu_g[r] - (R[r][0] * mu_e[0] + R[r][1] * mu_e[1] + R[r][2] * mu_e[2]);

  std::vector<double> err(n);
  double sum = 0.0, sum2 = 0.0, mx = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double* e = &est.xyz[3 * pairs[i].first];
    const double* g = &gt.xyz[3 * pairs[i].second];
    double d2 = 0.0;
    for (int r = 0; r < 3; ++r) {
      const double a =
          R[r][0] * e[0] + R[r][1] * e[1] + R[r][2] * e[2] + tr[r] - g[r];
      d2 += a * a;
    }
    err[i] = std::sqrt(d2);
    sum += err[i];
    sum2 += d2;
    mx = std::max(mx, err[i]);
  }
  std::sort(err.begin(), err.end());
  const double mean = sum / n;
  out[0] = (double)n;
  out[1] = std::sqrt(sum2 / n);
  out[2] = mean;
  out[3] = (n % 2) ? err[n / 2] : 0.5 * (err[n / 2 - 1] + err[n / 2]);
  out[4] = mx;
  out[5] = std::sqrt(std::max(0.0, sum2 / n - mean * mean));
  return 0;
}

}  // extern "C"
