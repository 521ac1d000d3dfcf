// Native frame loader: PNG + PGM/PPM decode + background prefetch ring.
//
// The reference's frame IO is cv2.imread — OpenCV C++ — feeding the Python
// loop. This is the framework's equivalent runtime component:
// a C++ decoder plus a pthread prefetcher that overlaps disk IO and decode
// with device compute, exposed to Python via ctypes (no pybind11 in this
// environment).
//
// Formats:
//  - PNG, 8-bit, color types 0 (gray) / 2 (RGB) / 6 (RGBA, alpha dropped),
//    non-interlaced, all 5 scanline filters (None/Sub/Up/Average/Paeth);
//    IDAT inflate via zlib. This is the KITTI image format — real dataset
//    frames flow through the prefetch ring with no cv2 anywhere.
//  - binary PGM (P5) and PPM (P6), 8-bit, with comment support.
// Build: g++ -O2 -shared -fPIC frameloader.cpp -o libframeloader.so
//        -lpthread -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  std::vector<uint8_t> data;
  int w = 0, h = 0, channels = 0;
  bool ok = false;
};

// Skip whitespace and '#' comments in a PNM header.
const uint8_t* skip_ws(const uint8_t* p, const uint8_t* end) {
  while (p < end) {
    if (*p == '#') {
      while (p < end && *p != '\n') ++p;
    } else if (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') {
      ++p;
    } else {
      break;
    }
  }
  return p;
}

const uint8_t* read_int(const uint8_t* p, const uint8_t* end, int* out) {
  p = skip_ws(p, end);
  long long v = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    if (v > 100000000) {  // no sane PNM dimension/maxval; avoid overflow
      *out = -1;
      while (p < end && *p >= '0' && *p <= '9') ++p;
      return p;
    }
    ++p;
    any = true;
  }
  *out = any ? static_cast<int>(v) : -1;
  return p;
}

Image decode_pnm(const uint8_t* buf, size_t len) {
  Image img;
  const uint8_t* end = buf + len;
  if (len < 10 || buf[0] != 'P') return img;
  int channels;
  if (buf[1] == '5') {
    channels = 1;
  } else if (buf[1] == '6') {
    channels = 3;
  } else {
    return img;
  }
  const uint8_t* p = buf + 2;
  int w, h, maxval;
  p = read_int(p, end, &w);
  p = read_int(p, end, &h);
  p = read_int(p, end, &maxval);
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 255 || p >= end) return img;
  ++p;  // single whitespace after maxval
  size_t need = static_cast<size_t>(w) * h * channels;
  if (static_cast<size_t>(end - p) < need) return img;
  img.data.assign(p, p + need);
  img.w = w;
  img.h = h;
  img.channels = channels;
  img.ok = true;
  return img;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

Image decode_png(const uint8_t* buf, size_t len) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  Image img;
  if (len < 8 + 25 || std::memcmp(buf, kSig, 8) != 0) return img;
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = -1, interlace = -1;
  std::vector<uint8_t> idat;
  bool saw_ihdr = false, saw_iend = false;
  while (pos + 8 <= len && !saw_iend) {
    uint32_t clen = be32(buf + pos);
    if (pos + 12 + size_t(clen) > len) return img;
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (clen != 13) return img;
      w = be32(data);
      h = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
      saw_ihdr = true;
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + clen);
    } else if (!std::memcmp(type, "IEND", 4)) {
      saw_iend = true;
    }
    pos += 12 + clen;  // len + type + data + crc (crc not verified)
  }
  if (!saw_ihdr || idat.empty() || w == 0 || h == 0) return img;
  if (bit_depth != 8 || interlace != 0) return img;  // KITTI scope
  int in_ch;
  if (color_type == 0) in_ch = 1;        // gray
  else if (color_type == 2) in_ch = 3;   // RGB
  else if (color_type == 6) in_ch = 4;   // RGBA
  else return img;                       // palette/gray+alpha unsupported
  if (w > 100000u || h > 100000u) return img;

  const size_t stride = size_t(w) * in_ch;
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return img;
  }

  // Undo per-scanline filters in place (prev row = fully reconstructed).
  std::vector<uint8_t> out(size_t(h) * stride);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = out.data() + size_t(y) * stride;
    const uint8_t* up = y ? dst - stride : nullptr;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= size_t(in_ch) ? dst[i - in_ch] : 0;  // left
      int b = up ? up[i] : 0;                           // above
      int c = (up && i >= size_t(in_ch)) ? up[i - in_ch] : 0;  // up-left
      int x = src[i];
      switch (filter) {
        case 0: break;
        case 1: x += a; break;
        case 2: x += b; break;
        case 3: x += (a + b) / 2; break;
        case 4: x += paeth(a, b, c); break;
        default: return img;
      }
      dst[i] = static_cast<uint8_t>(x);
    }
  }

  int out_ch = in_ch == 4 ? 3 : in_ch;  // drop alpha
  img.w = static_cast<int>(w);
  img.h = static_cast<int>(h);
  img.channels = out_ch;
  if (in_ch == out_ch) {
    img.data = std::move(out);
  } else {
    img.data.resize(size_t(h) * w * 3);
    for (size_t px = 0, n = size_t(h) * w; px < n; ++px) {
      img.data[px * 3 + 0] = out[px * 4 + 0];
      img.data[px * 3 + 1] = out[px * 4 + 1];
      img.data[px * 3 + 2] = out[px * 4 + 2];
    }
  }
  img.ok = true;
  return img;
}

Image decode_any(const uint8_t* buf, size_t len) {
  if (len >= 8 && buf[0] == 137 && buf[1] == 'P' && buf[2] == 'N' &&
      buf[3] == 'G') {
    return decode_png(buf, len);
  }
  return decode_pnm(buf, len);
}

Image load_file(const char* path) {
  Image img;
  FILE* f = std::fopen(path, "rb");
  if (!f) return img;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz <= 0) {
    std::fclose(f);
    return img;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(sz));
  size_t rd = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (rd != buf.size()) return img;
  return decode_any(buf.data(), buf.size());
}

struct Loader {
  std::vector<std::string> paths;
  size_t ring_capacity;
  std::vector<Image> ring;
  size_t head = 0;  // next slot to consume
  size_t count = 0; // filled slots
  size_t produced = 0;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::thread worker;
  std::atomic<bool> stop{false};

  Loader(std::vector<std::string> p, size_t cap)
      : paths(std::move(p)), ring_capacity(cap), ring(cap) {
    worker = std::thread([this] { run(); });
  }

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    if (worker.joinable()) worker.join();
  }

  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); ++i) {
      Image img = load_file(paths[i].c_str());
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [this] {
        return count < ring_capacity || stop.load();
      });
      if (stop.load()) return;
      ring[(head + count) % ring_capacity] = std::move(img);
      ++count;
      ++produced;
      cv_data.notify_one();
    }
  }

  // Returns: 1 ok, 0 decode failure, -1 end of stream.
  int next(uint8_t* out, int* w, int* h, int* channels, size_t out_cap) {
    std::unique_lock<std::mutex> lk(mu);
    cv_data.wait(lk, [this] {
      return count > 0 || produced == paths.size();
    });
    if (count == 0) return -1;
    Image img = std::move(ring[head]);
    head = (head + 1) % ring_capacity;
    --count;
    cv_space.notify_one();
    lk.unlock();
    if (!img.ok) return 0;
    *w = img.w;
    *h = img.h;
    *channels = img.channels;
    if (img.data.size() > out_cap) return 0;
    std::memcpy(out, img.data.data(), img.data.size());
    return 1;
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n, int ring_capacity) {
  std::vector<std::string> p(paths, paths + n);
  if (ring_capacity < 1) ring_capacity = 1;  // ring(0) would modulo-by-zero
  return new Loader(std::move(p), static_cast<size_t>(ring_capacity));
}

int loader_next(void* handle, uint8_t* out, long out_cap, int* w, int* h,
                int* channels) {
  return static_cast<Loader*>(handle)->next(out, w, h, channels,
                                            static_cast<size_t>(out_cap));
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int decode_pnm_buffer(const uint8_t* buf, long len, uint8_t* out,
                      long out_cap, int* w, int* h, int* channels) {
  Image img = decode_pnm(buf, static_cast<size_t>(len));
  if (!img.ok || static_cast<long>(img.data.size()) > out_cap) return 0;
  *w = img.w;
  *h = img.h;
  *channels = img.channels;
  std::memcpy(out, img.data.data(), img.data.size());
  return 1;
}

// PNG or PNM, auto-detected by magic bytes.
int decode_image_buffer(const uint8_t* buf, long len, uint8_t* out,
                        long out_cap, int* w, int* h, int* channels) {
  Image img = decode_any(buf, static_cast<size_t>(len));
  if (!img.ok || static_cast<long>(img.data.size()) > out_cap) return 0;
  *w = img.w;
  *h = img.h;
  *channels = img.channels;
  std::memcpy(out, img.data.data(), img.data.size());
  return 1;
}

}  // extern "C"
