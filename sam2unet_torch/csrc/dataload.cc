// Native host data loading: JPEG decode (libjpeg) and a separable
// taps-resize fused with the letterbox placement and the ImageNet
// normalization. The port's copy of the JAX package's csrc/dataload.cc.
//
// The resize weights are not computed here: Python passes the taps of
// sam2unet_torch/ops/resize_np.py (torch's and PIL's coordinate rules), and
// this file only runs the gather-accumulate, so the native pipeline gives
// the numpy path's numbers.
//
// C interface, through ctypes (sam2unet_torch/data/native_loader.py), built
// with g++ -ljpeg at first use by sam2unet_torch/ops/build.py. Every function
// returns 0 on success, negative on failure. No globals; ctypes calls
// release the GIL, so the loader's worker threads run them in parallel.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_silence(j_common_ptr, int) {}

}  // namespace

extern "C" {

// Parse header only: fills (h, w). Returns 0 on success.
int dl_jpeg_info(const uint8_t* buf, size_t n, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  err.mgr.emit_message = jpeg_silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Full decode to RGB8 HWC. out must hold h*w*3 bytes (from dl_jpeg_info).
int dl_jpeg_decode(const uint8_t* buf, size_t n, uint8_t* out, int out_cap) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  err.mgr.emit_message = jpeg_silence;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;  // PIL .convert("RGB") equivalence
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  if (cinfo.output_components != 3 || out_cap < w * h * 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Separable taps-resize of RGB8 (h, w, 3) to (nh, nw), fused with
// letterbox placement at (top, left) inside a (size, size) fp32 NHWC
// canvas and per-channel normalization out = (x/255 - mean) / std.
// Taps: idx_h (nh, th) int32 rows into the source; w_h (nh, th) fp32
// weights (rows sum to 1); likewise idx_w/w_w for width. The caller
// pre-fills the canvas with the normalized-zero value (0-mean)/std —
// data/transforms.py::letterbox pads with zeros BEFORE normalize.
int dl_letterbox_norm(const uint8_t* rgb, int h, int w,
                      const int32_t* idx_h, const float* w_h, int nh, int th,
                      const int32_t* idx_w, const float* w_w, int nw, int tw,
                      int size, int top, int left,
                      const float* mean, const float* stdv, float* out) {
  if (nh <= 0 || nw <= 0 || top + nh > size || left + nw > size) return -1;
  // pass 1: width resize at source height -> (h, nw, 3) fp32 in [0,1]
  std::vector<float> mid(static_cast<size_t>(h) * nw * 3);
  constexpr float kInv255 = 1.0f / 255.0f;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rgb + static_cast<size_t>(y) * w * 3;
    float* dst = mid.data() + static_cast<size_t>(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      const int32_t* ti = idx_w + static_cast<size_t>(x) * tw;
      const float* tv = w_w + static_cast<size_t>(x) * tw;
      for (int t = 0; t < tw; ++t) {
        const uint8_t* p = src + ti[t] * 3;
        const float wt = tv[t];
        acc0 += wt * p[0];
        acc1 += wt * p[1];
        acc2 += wt * p[2];
      }
      dst[x * 3 + 0] = acc0 * kInv255;
      dst[x * 3 + 1] = acc1 * kInv255;
      dst[x * 3 + 2] = acc2 * kInv255;
    }
  }
  // pass 2: height resize + normalize into the letterbox window
  const float inv_std[3] = {1.f / stdv[0], 1.f / stdv[1], 1.f / stdv[2]};
  for (int y = 0; y < nh; ++y) {
    float* dst = out + (static_cast<size_t>(top + y) * size + left) * 3;
    const int32_t* ti = idx_h + static_cast<size_t>(y) * th;
    const float* tv = w_h + static_cast<size_t>(y) * th;
    for (int x = 0; x < nw; ++x) {
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
      for (int t = 0; t < th; ++t) {
        const float* p = mid.data() + (static_cast<size_t>(ti[t]) * nw + x) * 3;
        const float wt = tv[t];
        acc0 += wt * p[0];
        acc1 += wt * p[1];
        acc2 += wt * p[2];
      }
      dst[x * 3 + 0] = (acc0 - mean[0]) * inv_std[0];
      dst[x * 3 + 1] = (acc1 - mean[1]) * inv_std[1];
      dst[x * 3 + 2] = (acc2 - mean[2]) * inv_std[2];
    }
  }
  return 0;
}

}  // extern "C"
