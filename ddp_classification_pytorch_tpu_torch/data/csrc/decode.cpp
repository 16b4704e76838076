// Decode-only entry point of the native dataplane: one JPEG or PNG file to
// HWC uint8 RGB, for the item route (a transform that the batch call does
// not run: cdr's rotation, cifar's padded crop, the PLC dataset's items).
//
// The dataplane's source is included unchanged, so this file reaches its
// decoder (`decode_image`, in the source's anonymous namespace) and decodes
// exactly as the batch call does: libjpeg (RGB out) or libpng (palette,
// grey and 16-bit expanded, alpha stripped), dispatched on magic bytes.
// Built with -DDP_NO_PNG where libpng is absent, as the dataplane is.
//
//   g++ -O3 -std=c++17 -shared -fPIC -I<repo> -o libdecode.so \
//       decode.cpp -ljpeg -lpng -lpthread

#include "native/dataplane.cpp"

#include <cstdlib>
#include <cstring>

extern "C" {

// Decode `path` into a buffer this library allocates (*out, w*h*3 bytes,
// released with dpx_free). 0 on success, -1 if the file does not decode,
// -2 if the buffer cannot be allocated.
int dpx_decode(const char* path, uint8_t** out, int* w, int* h) {
  std::vector<uint8_t> buf;
  int ww = 0, hh = 0;
  if (!decode_image(path, buf, ww, hh)) return -1;
  uint8_t* p = static_cast<uint8_t*>(std::malloc(buf.size()));
  if (p == nullptr) return -2;
  std::memcpy(p, buf.data(), buf.size());
  *out = p;
  *w = ww;
  *h = hh;
  return 0;
}

void dpx_free(uint8_t* p) { std::free(p); }

}  // extern "C"
