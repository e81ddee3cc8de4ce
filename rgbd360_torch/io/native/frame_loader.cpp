// Native data-loader for the rgbd360 spherical-capture `.bin` wire format
// (reference include/Frame360.h:333-345 serialize, :231-266 loadFrame;
// cv::Mat record layout per
// OpenNI2_Grabber/third_party/cvSerialization/cvmat_serialization.h:23-55),
// plus a threaded in-order prefetcher so sequence apps overlap file IO +
// parsing with device compute. A copy of
// rgbd360_tpu/io/native/frame_loader.cpp; mirrors io/boost_archive.py, whose
// Python reader remains the reference implementation and the host fallback.
//
// Built by rgbd360_torch/io/native_loader.py with:
//   g++ -O2 -shared -fPIC -pthread frame_loader.cpp -o frame_loader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kSignature[] = "serialization::archive";
constexpr int kNumSensors = 8;

// error codes shared with the ctypes binding
enum {
  kOk = 0,
  kErrOpen = 1,
  kErrTruncated = 2,
  kErrSignature = 3,
  kErrShape = 4,
  kErrType = 5,
  kErrExhausted = 6,
};

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;

  bool take(void* out, size_t len) {
    if (pos + len > n) return false;
    std::memcpy(out, p + pos, len);
    pos += len;
    return true;
  }
  const uint8_t* view(size_t len) {
    if (pos + len > n) return nullptr;
    const uint8_t* v = p + pos;
    pos += len;
    return v;
  }
};

struct MatHeader {
  int32_t cols, rows;
  uint64_t elem_size, elem_type;
};

bool read_mat_header(Cursor& cur, MatHeader* m) {
  return cur.take(&m->cols, 4) && cur.take(&m->rows, 4) &&
         cur.take(&m->elem_size, 8) && cur.take(&m->elem_type, 8);
}

int parse_buffer(const uint8_t* buf, size_t len, int h, int w, uint8_t* rgb,
                 uint16_t* depth, uint64_t* ts) {
  Cursor cur{buf, len};
  uint64_t sig_len = 0;
  if (!cur.take(&sig_len, 8) || sig_len != sizeof(kSignature) - 1)
    return kErrSignature;
  const uint8_t* sig = cur.view(sig_len);
  if (!sig || std::memcmp(sig, kSignature, sig_len) != 0) return kErrSignature;
  uint16_t version = 0;
  if (!cur.take(&version, 2)) return kErrTruncated;
  if (version >= 3 && !cur.view(4)) return kErrTruncated;  // primitive sizes
  if (!cur.view(9)) return kErrTruncated;  // one-time cv::Mat class metadata

  const size_t rgb_bytes = size_t(h) * w * 3;
  const size_t depth_elems = size_t(h) * w;
  for (int s = 0; s < kNumSensors; ++s) {
    MatHeader m;
    if (!read_mat_header(cur, &m)) return kErrTruncated;
    if (m.rows != h || m.cols != w) return kErrShape;
    if (m.elem_type != 16 || m.elem_size != 3) return kErrType;  // CV_8UC3
    const uint8_t* data = cur.view(rgb_bytes);
    if (!data) return kErrTruncated;
    std::memcpy(rgb + s * rgb_bytes, data, rgb_bytes);

    if (!read_mat_header(cur, &m)) return kErrTruncated;
    if (m.rows != h || m.cols != w) return kErrShape;
    if (m.elem_type != 2 || m.elem_size != 2) return kErrType;  // CV_16UC1
    data = cur.view(depth_elems * 2);
    if (!data) return kErrTruncated;
    std::memcpy(depth + s * depth_elems, data, depth_elems * 2);
  }

  // timestamp: 1 x num_digits CV_8U decimal-digit matrix, MSD first
  // (OpenNI2_Grabber/FrameRGBD/SerializeFrameRGBD.h:46-88); the bundled
  // samples carry an empty 0x0 matrix. The element size/type and digit
  // count come from the FILE and must be validated before they size the
  // view — an elem_size of 0 would otherwise make the bounds check pass
  // while the digit loop reads past the buffer.
  MatHeader m;
  uint64_t t = 0;
  // The header itself is mandatory (the Python reference reader raises on a
  // stream that ends after the sensor mats); only its PAYLOAD may be empty.
  if (!read_mat_header(cur, &m)) return kErrTruncated;
  if (m.rows > 0 && m.cols > 0) {
    if (m.elem_size != 1 || m.rows != 1 || m.cols > 20) return kErrType;
    const uint8_t* digits = cur.view(size_t(m.rows) * m.cols);
    if (!digits) return kErrTruncated;
    for (int i = 0; i < m.rows * m.cols; ++i) t = t * 10 + digits[i];
  }
  *ts = t;
  return kOk;
}

int parse_file(const std::string& path, int h, int w, uint8_t* rgb,
               uint16_t* depth, uint64_t* ts) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return kErrOpen;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len > 0 ? size_t(len) : 0);
  size_t got = buf.empty() ? 0 : std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) return kErrTruncated;
  return parse_buffer(buf.data(), buf.size(), h, w, rgb, depth, ts);
}

struct Slot {
  std::vector<uint8_t> rgb;
  std::vector<uint16_t> depth;
  uint64_t ts = 0;
  int status = kOk;
};

struct Prefetcher {
  std::vector<std::string> paths;
  int h, w, max_ahead;
  std::atomic<size_t> next_fetch{0};
  size_t next_deliver = 0;
  std::mutex mu;
  std::condition_variable cv_done, cv_space;
  std::map<size_t, Slot> done;
  std::vector<std::thread> workers;
  std::atomic<bool> stopping{false};

  void worker() {
    for (;;) {
      size_t i = next_fetch.fetch_add(1);
      if (i >= paths.size() || stopping.load()) return;
      {
        // bound read-ahead so memory stays O(queue depth)
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stopping.load() || i < next_deliver + size_t(max_ahead);
        });
        if (stopping.load()) return;
      }
      Slot slot;
      slot.rgb.resize(size_t(kNumSensors) * h * w * 3);
      slot.depth.resize(size_t(kNumSensors) * h * w);
      slot.status =
          parse_file(paths[i], h, w, slot.rgb.data(), slot.depth.data(), &slot.ts);
      {
        std::lock_guard<std::mutex> lk(mu);
        done.emplace(i, std::move(slot));
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int rgbd360_parse_frame(const char* path, int h, int w, uint8_t* rgb,
                        uint16_t* depth, uint64_t* ts) {
  return parse_file(path, h, w, rgb, depth, ts);
}

void* rgbd360_prefetcher_create(const char* const* paths, int n, int h, int w,
                                int threads, int max_ahead) {
  auto* p = new Prefetcher;
  p->paths.assign(paths, paths + n);
  p->h = h;
  p->w = w;
  p->max_ahead = max_ahead > 0 ? max_ahead : 4;
  int nt = threads > 0 ? threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

int rgbd360_prefetcher_next(void* handle, uint8_t* rgb, uint16_t* depth,
                            uint64_t* ts) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->next_deliver >= p->paths.size()) return kErrExhausted;
  size_t want = p->next_deliver;
  p->cv_done.wait(lk, [&] { return p->done.count(want) > 0; });
  Slot slot = std::move(p->done[want]);
  p->done.erase(want);
  ++p->next_deliver;
  lk.unlock();
  p->cv_space.notify_all();
  if (slot.status != kOk) return slot.status;
  std::memcpy(rgb, slot.rgb.data(), slot.rgb.size());
  std::memcpy(depth, slot.depth.data(), slot.depth.size() * 2);
  *ts = slot.ts;
  return kOk;
}

void rgbd360_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stopping.store(true);
  p->next_fetch.store(p->paths.size());
  p->cv_space.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
