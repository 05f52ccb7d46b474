// What the port's tools add to the decode pool of loader.cc (a verbatim
// copy of the JAX package's, kept unchanged): JPEG encoding through
// libjpeg.  Built into the same shared library as loader.cc
// (data/native_loader.py), C API for ctypes.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>

#include <csetjmp>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

}  // namespace

extern "C" {

// Encode an (h, w, 3) RGB image as a baseline JPEG at `quality` with
// libjpeg's defaults (4:2:0 chroma, islow DCT), what PIL's
// `save(..., "JPEG", quality=q)` asks of the same library.  *out receives
// a malloc'd buffer for gvx_free; returns its size, or -1 on failure.
long gvx_encode_jpeg(const uint8_t* rgb, int h, int w, int quality,
                     uint8_t** out) {
  jpeg_compress_struct cinfo;
  JpegErr err;
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    std::free(buf);
    *out = nullptr;
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &size);
  cinfo.image_width = JDIMENSION(w);
  cinfo.image_height = JDIMENSION(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + size_t(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = buf;
  return long(size);
}

void gvx_free(void* p) { std::free(p); }

}  // extern "C"
