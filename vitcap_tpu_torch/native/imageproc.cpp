// Native host image pipeline for vitcap_tpu_torch: fused JPEG decode (libjpeg,
// with DCT-domain scaled decode) + PIL-compatible antialiased bicubic
// resize + center crop, emitting uint8 HWC rows for the device feed.
//
// The reference's predict path decodes with cv2/PIL and resizes with
// torchvision (reference src/data_layer/transform.py:106-136 +
// uni_pipeline.py:1233-1265).  This module reproduces the same math
// (bicubic a=-0.5, antialias support scaling, uint8 quantization between
// the horizontal and vertical passes exactly like PIL's two-pass
// ImagingResample) at native speed, and exploits libjpeg's M/8 DCT
// scaling so large images never get fully decoded.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 imageproc.cpp -o libimageproc.so -ljpeg
// (vitcap_tpu_torch/native/__init__.py, at first use).
// ctypes binding: vitcap_tpu_torch/data/native_image.py; a payload libjpeg
// refuses (a PNG) is decoded by PIL there.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrMgr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
    ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
    longjmp(e->jb, 1);
}

// Pick the smallest libjpeg scale_num/8 whose SHORT side stays >= min_short
// (0 => full size).  Mirrors PIL Image.draft semantics but never
// undershoots the resize target, so the following bicubic pass is always a
// downscale (antialiased) or identity.
void choose_scale(jpeg_decompress_struct* cinfo, int min_short) {
    cinfo->scale_denom = 8;
    if (min_short <= 0) {
        cinfo->scale_num = 8;
        return;
    }
    int w = cinfo->image_width, h = cinfo->image_height;
    int short_side = w < h ? w : h;
    for (int num = 1; num <= 8; num++) {
        // libjpeg output dim = ceil(dim * num / 8)
        long scaled = (long(short_side) * num + 7) / 8;
        if (scaled >= min_short) {
            cinfo->scale_num = num;
            return;
        }
    }
    cinfo->scale_num = 8;
}

bool start_decompress(jpeg_decompress_struct* cinfo, ErrMgr* err,
                      const unsigned char* buf, size_t len, int min_short) {
    cinfo->err = jpeg_std_error(&err->pub);
    err->pub.error_exit = err_exit;
    jpeg_create_decompress(cinfo);
    jpeg_mem_src(cinfo, const_cast<unsigned char*>(buf),
                 static_cast<unsigned long>(len));
    if (jpeg_read_header(cinfo, TRUE) != JPEG_HEADER_OK) return false;
    cinfo->out_color_space = JCS_RGB;
    choose_scale(cinfo, min_short);
    cinfo->dct_method = JDCT_ISLOW;  // match PIL's default quality
    jpeg_calc_output_dimensions(cinfo);
    return true;
}

// PIL bicubic kernel (a = -0.5), support 2.0 (Resampling.BICUBIC).
inline double bicubic(double x) {
    x = std::fabs(x);
    if (x < 1.0) return ((1.5 * x - 2.5) * x) * x + 1.0;
    if (x < 2.0) return (((-0.5 * x) + 2.5) * x - 4.0) * x + 2.0;
    return 0.0;
}

// PIL precompute_coeffs (Resample.c): per output pixel in [o0, o1), the
// source window [xmin, xmax) and normalized weights.  filterscale =
// max(in/out, 1) gives the antialias widening on downscale.
struct Coeffs {
    std::vector<int> xmin, xcount;
    std::vector<double> k;  // ksize per output pixel
    int ksize;
};

Coeffs precompute(int in_size, int out_size, int o0, int o1) {
    Coeffs c;
    double scale = double(in_size) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 2.0 * filterscale;
    c.ksize = int(std::ceil(support)) * 2 + 1;
    int n = o1 - o0;
    c.xmin.resize(n);
    c.xcount.resize(n);
    c.k.assign(size_t(n) * c.ksize, 0.0);
    double ss = 1.0 / filterscale;
    for (int i = 0; i < n; i++) {
        double center = (o0 + i + 0.5) * scale;
        int xmin = int(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = int(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        double* kk = &c.k[size_t(i) * c.ksize];
        double wsum = 0.0;
        for (int x = xmin; x < xmax; x++) {
            double w = bicubic((x - center + 0.5) * ss);
            kk[x - xmin] = w;
            wsum += w;
        }
        if (wsum != 0.0)
            for (int x = 0; x < xmax - xmin; x++) kk[x] /= wsum;
        c.xmin[i] = xmin;
        c.xcount[i] = xmax - xmin;
    }
    return c;
}

// PIL's exact fixed-point pipeline (Resample.c): coefficients quantized to
// int32 at PRECISION_BITS, accumulated in int32 with a pre-added half,
// floor-shifted back.  Reproducing it bit-for-bit makes the native path
// byte-identical to the PIL fallback.
constexpr int PRECISION_BITS = 32 - 8 - 2;

inline int32_t fixcoef(double k) {
    return k < 0 ? int32_t(-0.5 + k * (1 << PRECISION_BITS))
                 : int32_t(0.5 + k * (1 << PRECISION_BITS));
}

inline uint8_t clip8(int32_t in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return uint8_t(in >> PRECISION_BITS);
}

std::vector<int32_t> fixcoeffs(const Coeffs& c, int n) {
    std::vector<int32_t> kk(size_t(n) * c.ksize);
    for (size_t i = 0; i < kk.size(); i++) kk[i] = fixcoef(c.k[i]);
    return kk;
}

}  // namespace

extern "C" {

// Scaled output dims for this JPEG at the scale vc_jpeg_decode would pick.
// Returns 0 on success, nonzero on parse error.
int vc_jpeg_dims(const unsigned char* buf, size_t len, int min_short,
                 int* w, int* h) {
    jpeg_decompress_struct cinfo;
    ErrMgr err;
    if (setjmp(err.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    if (!start_decompress(&cinfo, &err, buf, len, min_short)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    *w = cinfo.output_width;
    *h = cinfo.output_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode into caller buffer of (h * w * 3) bytes (dims from vc_jpeg_dims
// with the same min_short).  Returns 0 on success.
int vc_jpeg_decode(const unsigned char* buf, size_t len, int min_short,
                   unsigned char* out, int w, int h) {
    jpeg_decompress_struct cinfo;
    ErrMgr err;
    if (setjmp(err.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    if (!start_decompress(&cinfo, &err, buf, len, min_short)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    if (int(cinfo.output_width) != w || int(cinfo.output_height) != h) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    jpeg_start_decompress(&cinfo);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + size_t(cinfo.output_scanline) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// PIL-compatible bicubic resize of src (sh x sw x 3) to (rh x rw),
// materializing only the crop window [cy, cy+ch) x [cx, cx+cw) into dst
// (ch x cw x 3).  Two passes with a uint8 intermediate, like PIL's
// ImagingResample (horizontal first, quantize, then vertical).
void vc_resize_bicubic_crop(const unsigned char* src, int sw, int sh,
                            int rw, int rh, int cx, int cy, int cw, int ch,
                            unsigned char* dst) {
    // horizontal pass: all sh rows, output columns [cx, cx+cw)
    Coeffs hc = precompute(sw, rw, cx, cx + cw);
    std::vector<int32_t> hk = fixcoeffs(hc, cw);
    std::vector<uint8_t> tmp(size_t(sh) * cw * 3);
    const int32_t half = 1 << (PRECISION_BITS - 1);
    for (int y = 0; y < sh; y++) {
        const unsigned char* srow = src + size_t(y) * sw * 3;
        uint8_t* trow = &tmp[size_t(y) * cw * 3];
        for (int i = 0; i < cw; i++) {
            const int32_t* kk = &hk[size_t(i) * hc.ksize];
            int x0 = hc.xmin[i], cnt = hc.xcount[i];
            int32_t r = half, g = half, b = half;
            const unsigned char* sp = srow + size_t(x0) * 3;
            for (int x = 0; x < cnt; x++) {
                int32_t w = kk[x];
                r += w * sp[0];
                g += w * sp[1];
                b += w * sp[2];
                sp += 3;
            }
            trow[i * 3 + 0] = clip8(r);
            trow[i * 3 + 1] = clip8(g);
            trow[i * 3 + 2] = clip8(b);
        }
    }
    // vertical pass: output rows [cy, cy+ch), row-major axpy accumulation
    Coeffs vc = precompute(sh, rh, cy, cy + ch);
    std::vector<int32_t> vk = fixcoeffs(vc, ch);
    std::vector<int32_t> acc(size_t(cw) * 3);
    for (int j = 0; j < ch; j++) {
        const int32_t* kk = &vk[size_t(j) * vc.ksize];
        int y0 = vc.xmin[j], cnt = vc.xcount[j];
        std::fill(acc.begin(), acc.end(), half);
        for (int y = 0; y < cnt; y++) {
            int32_t w = kk[y];
            const uint8_t* trow = &tmp[size_t(y0 + y) * cw * 3];
            for (int i = 0; i < cw * 3; i++) acc[i] += w * trow[i];
        }
        uint8_t* drow = dst + size_t(j) * cw * 3;
        for (int i = 0; i < cw * 3; i++) drow[i] = clip8(acc[i]);
    }
}

}  // extern "C"
