// Baseline JPEG codec for the host, bound through a plain C interface
// (ctypes; see ursonet_torch/data/jpeg.py). Plain C++17, no libjpeg.
//
// The codec itself is in jpeg_codec.h, shared with host_loader.cpp.

#include "jpeg_codec.h"

#include <cstdio>
#include <exception>

namespace {

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

// Header of a JPEG: height, width and the components (1 or 3) of what
// ursonet_jpeg_decode writes. 0 on success, 1 with a message in err.
int ursonet_jpeg_info(const uint8_t* data, size_t n, int* h, int* w, int* c,
                      char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse_headers(true);
    *h = d.height;
    *w = d.width;
    *c = int(d.comps.size());
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decode into out ([h, w] gray or [h, w, 3] RGB, out_size bytes).
int ursonet_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out,
                        size_t out_size, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse_headers(false);
    if (size_t(d.height) * d.width * d.comps.size() != out_size)
      fail("output buffer of the wrong size");
    d.idct_all();
    d.write(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Encode an [h, w] gray image. Returns the file's length, written to out
// when it fits in cap bytes; -1 with a message in err on failure.
int64_t ursonet_jpeg_encode_gray(const uint8_t* px, int h, int w,
                                 int quality, uint8_t* out, size_t cap,
                                 char* err, int errlen) {
  try {
    std::vector<uint8_t> o = encode_gray(px, h, w, quality);
    if (o.size() <= cap) std::memcpy(out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// Encode an [h, w, 3] RGB image (YCbCr 4:2:0), as ursonet_jpeg_encode_gray.
int64_t ursonet_jpeg_encode_rgb(const uint8_t* px, int h, int w, int quality,
                                uint8_t* out, size_t cap, char* err,
                                int errlen) {
  try {
    std::vector<uint8_t> o = encode_rgb(px, h, w, quality);
    if (o.size() <= cap) std::memcpy(out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
