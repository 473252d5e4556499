// Host batch loader: threaded PNG/JPEG decode, edge-aligned bilinear
// resize and padded-batch placement, bound through a plain C interface
// (ctypes; see ursonet_torch/data/native_loader.py). Plain C++17 on zlib,
// with no libjpeg and no libpng.
//
// The port's counterpart of native/host_loader.cpp, which the card's
// machine cannot build (it has no JPEG or PNG headers). It computes what
// that file computes: one call fills a uint8 batch [N, H, W, 3] from N
// file paths on a pool of std::threads (decode at native size, resize to
// the content window, write at the pad offset, zero elsewhere), the
// resize/pad64/square geometry of ops/image.resize_image.
//
//   * PNG: 8-bit gray, RGB and RGBA, not interlaced, any of the five row
//     filters, every chunk's CRC checked, IDAT inflated by zlib. Anything
//     else fails the file (what ursonet_torch/data/png.py reads).
//   * JPEG: the decoder of jpeg_codec.h (libjpeg-turbo's pixels for
//     baseline files); a gray file expands to RGB, as libjpeg's
//     out_color_space = JCS_RGB does.
//   * to_rgb drops alpha and replicates gray.
//   * resize_into is native/host_loader.cpp's float32 arithmetic and its
//     truncating store, expression for expression. Built with
//     -ffp-contract=off (ops/cuda_build.py), so no multiply-add is fused
//     and every pixel equals native/host_loader.cpp's and the numpy copy
//     in data/native_loader.py::load_batch_plain.
//
// Built with g++ at first use by ursonet_torch/ops/cuda_build.py (-lz
// -pthread).

#include "jpeg_codec.h"

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // interleaved, c channels
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  out->clear();
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0)
    out->insert(out->end(), buf, buf + got);
  bool ok = !std::ferror(f);
  std::fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// PNG decode (zlib)

const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// The five PNG row filters undone in place: `row` holds the filtered bytes
// of one row, `prev` the reconstructed row above (zeros for the first).
bool unfilter_row(int type, uint8_t* row, const uint8_t* prev, size_t stride,
                  int bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < stride; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (size_t i = 0; i < stride; ++i) row[i] += prev[i];
      return true;
    case 3:
      for (size_t i = 0; i < stride; ++i) {
        int a = i >= size_t(bpp) ? row[i - bpp] : 0;
        row[i] += uint8_t((a + prev[i]) >> 1);
      }
      return true;
    case 4:
      for (size_t i = 0; i < stride; ++i) {
        int a = 0, c = 0;
        if (i >= size_t(bpp)) {
          a = row[i - bpp];
          c = prev[i - bpp];
        }
        int b = prev[i];
        int p = a + b - c;
        int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        row[i] += uint8_t(pred);
      }
      return true;
    default:
      return false;
  }
}

bool decode_png(const std::vector<uint8_t>& d, Image* out) {
  size_t pos = 8;
  bool have_header = false, have_end = false;
  uint32_t width = 0, height = 0;
  int channels = 0;
  std::vector<uint8_t> idat;
  while (pos < d.size()) {
    if (d.size() - pos < 12) return false;  // truncated chunk
    uint32_t n = be32(&d[pos]);
    if (n > d.size() - pos - 12) return false;
    const uint8_t* kind = &d[pos + 4];
    const uint8_t* body = kind + 4;
    uLong crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, kind, uInt(n) + 4);
    if (crc != be32(body + n)) return false;
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (n != 13) return false;
      width = be32(body);
      height = be32(body + 4);
      int depth = body[8], ctype = body[9];
      if (depth != 8 || body[10] != 0 || body[11] != 0 || body[12] != 0)
        return false;  // 8-bit, deflate, standard filters, not interlaced
      channels = ctype == 0 ? 1 : ctype == 2 ? 3 : ctype == 6 ? 4 : 0;
      if (channels == 0 || width == 0 || height == 0) return false;
      if (uint64_t(width) * height * channels > (uint64_t(1) << 32))
        return false;
      have_header = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + n);
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      have_end = true;
      break;
    }
    pos += 12 + size_t(n);
  }
  if (!have_header || !have_end) return false;
  const size_t stride = size_t(width) * channels;
  const size_t raw_size = size_t(height) * (1 + stride);
  // one byte more than the image needs: a stream that fills it is too long
  std::vector<uint8_t> raw(raw_size + 1);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int rc = inflate(&zs, Z_FINISH);
  size_t produced = zs.total_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || produced != raw_size) return false;

  out->h = int(height);
  out->w = int(width);
  out->c = channels;
  out->data.resize(size_t(height) * stride);
  std::vector<uint8_t> zero(stride, 0);
  for (size_t y = 0; y < height; ++y) {
    const uint8_t* src = raw.data() + y * (1 + stride);
    uint8_t* row = out->data.data() + y * stride;
    std::memcpy(row, src + 1, stride);
    const uint8_t* prev = y ? row - stride : zero.data();
    if (!unfilter_row(src[0], row, prev, stride, channels)) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// JPEG decode (jpeg_codec.h)

bool decode_jpeg(const std::vector<uint8_t>& d, Image* out) {
  try {
    Decoder dec(d.data(), d.size());
    dec.parse_headers(false);
    dec.idct_all();
    out->h = dec.height;
    out->w = dec.width;
    out->c = int(dec.comps.size());
    out->data.resize(size_t(out->h) * out->w * out->c);
    dec.write(out->data.data());
    return true;
  } catch (const std::exception&) {
    return false;
  }
}

bool decode_file(const char* path, Image* out) {
  std::vector<uint8_t> d;
  if (!read_file(path, &d)) return false;
  if (d.size() >= 2 && d[0] == 0xFF && d[1] == 0xD8) return decode_jpeg(d, out);
  if (d.size() >= 8 && std::memcmp(d.data(), kPngSignature, 8) == 0)
    return decode_png(d, out);
  return false;
}

// RGBA -> RGB drops alpha, gray -> RGB replicates (native/host_loader.cpp
// to_rgb).
void to_rgb(Image* img) {
  if (img->c == 3) return;
  std::vector<uint8_t> rgb(size_t(img->h) * img->w * 3);
  const uint8_t* src = img->data.data();
  uint8_t* dst = rgb.data();
  size_t n = size_t(img->h) * img->w;
  if (img->c == 4) {
    for (size_t i = 0; i < n; ++i) {
      dst[3 * i] = src[4 * i];
      dst[3 * i + 1] = src[4 * i + 1];
      dst[3 * i + 2] = src[4 * i + 2];
    }
  } else if (img->c == 1) {
    for (size_t i = 0; i < n; ++i) {
      dst[3 * i] = dst[3 * i + 1] = dst[3 * i + 2] = src[i];
    }
  }
  img->data.swap(rgb);
  img->c = 3;
}

// Edge-aligned bilinear resize (sample centers at (i+0.5)*scale-0.5), RGB
// u8 -> u8, into a strided destination (the padded batch tensor): the
// arithmetic of native/host_loader.cpp resize_into, store truncated.
void resize_into(const Image& src, uint8_t* dst, int dst_h, int dst_w,
                 int row_stride /*bytes*/, float fy, float fx) {
  std::vector<int> x0(dst_w), x1(dst_w);
  std::vector<float> wx(dst_w);
  for (int j = 0; j < dst_w; ++j) {
    float xs = (j + 0.5f) * fx - 0.5f;
    int x = int(floorf(xs));
    float t = xs - x;
    if (x < 0) { x = 0; t = 0.f; }
    if (x >= src.w - 1) { x = src.w - 1; t = 0.f; }
    x0[j] = x;
    x1[j] = x + 1 < src.w ? x + 1 : src.w - 1;
    wx[j] = t;
  }
  for (int i = 0; i < dst_h; ++i) {
    float ys = (i + 0.5f) * fy - 0.5f;
    int y = int(floorf(ys));
    float ty = ys - y;
    if (y < 0) { y = 0; ty = 0.f; }
    if (y >= src.h - 1) { y = src.h - 1; ty = 0.f; }
    int y1 = y + 1 < src.h ? y + 1 : src.h - 1;
    const uint8_t* r0 = src.data.data() + size_t(y) * src.w * 3;
    const uint8_t* r1 = src.data.data() + size_t(y1) * src.w * 3;
    uint8_t* drow = dst + size_t(i) * row_stride;
    for (int j = 0; j < dst_w; ++j) {
      const float tx = wx[j];
      const uint8_t* a = r0 + 3 * x0[j];
      const uint8_t* b = r0 + 3 * x1[j];
      const uint8_t* c = r1 + 3 * x0[j];
      const uint8_t* d = r1 + 3 * x1[j];
      for (int k = 0; k < 3; ++k) {
        float top = a[k] + (b[k] - a[k]) * tx;
        float bot = c[k] + (d[k] - c[k]) * tx;
        float v = top + (bot - top) * ty;
        drow[3 * j + k] = uint8_t(v);  // truncate, as the JAX native route
      }
    }
  }
}

}  // namespace

extern "C" {

// Fill out[n, out_h, out_w, 3] (zeroed here) with the decoded images
// resized to (content_h, content_w) and placed at (top, left), on
// min(nthreads, n) threads. Returns 0 on success, else the 1-based index
// of a path that failed (workers stop at the first failure they see).
int ursonet_load_batch(const char** paths, int n, uint8_t* out, int out_h,
                       int out_w, int content_h, int content_w, int top,
                       int left, int nthreads) {
  const size_t img_bytes = size_t(out_h) * out_w * 3;
  std::memset(out, 0, img_bytes * n);
  std::atomic<int> next(0), failed(0);
  if (nthreads < 1) nthreads = 1;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      Image img;
      if (!decode_file(paths[i], &img)) {
        failed.store(i + 1);
        return;
      }
      to_rgb(&img);
      uint8_t* dst = out + img_bytes * i + (size_t(top) * out_w + left) * 3;
      resize_into(img, dst, content_h, content_w, out_w * 3,
                  float(img.h) / content_h, float(img.w) / content_w);
    }
  };
  std::vector<std::thread> ts;
  int nt = nthreads < n ? nthreads : n;
  for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return failed.load();
}

// One image decoded at its native size into out (cap bytes) as RGB u8,
// *h and *w set: 0 on success, 1 if it does not decode, 2 if out is too
// small.
int ursonet_decode(const char* path, uint8_t* out, long cap, int* h, int* w) {
  Image img;
  if (!decode_file(path, &img)) return 1;
  to_rgb(&img);
  long need = long(img.h) * img.w * 3;
  if (need > cap) return 2;
  std::memcpy(out, img.data.data(), size_t(need));
  *h = img.h;
  *w = img.w;
  return 0;
}

}  // extern "C"
