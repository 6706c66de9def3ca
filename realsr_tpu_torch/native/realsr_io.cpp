// Native image I/O runtime for realsr_tpu_torch (librealsr_io_torch.so).
//
// The port's own copy of native/realsr_io.cpp, the JAX package's codec
// library; it differs in one repair: png_deflate_strip fails unless deflate
// consumed its whole input (avail_in == 0).
//
// The reference's codec layer is native (stb_image/stb_image_write/libwebp,
// SURVEY.md §2.4); this is its equivalent, written against the system
// libpng/libjpeg/libwebp instead of vendoring decoders. Exposed as a minimal
// C ABI consumed by ctypes (realsr_tpu_torch/io/native.py) and by the C++ CLI
// (cli/main.cpp).
//
// Semantics match the reference load/save stages:
//  - decode: webp probed first (main.cpp:232-235), then png/jpg by magic;
//    grayscale -> RGB and gray+alpha -> RGBA promotion (main.cpp:247-260)
//    so callers only see 3- or 4-channel uint8.
//  - encode: webp LOSSLESS (webp_image.h:66-76), jpg quality 100
//    (main.cpp:391), png default.

#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#include <png.h>
#include <jpeglib.h>
#include <webp/decode.h>
#include <webp/encode.h>

extern "C" {

unsigned char* rsio_decode(const char* path, int* w, int* h, int* c);
void rsio_free(unsigned char* p);
int rsio_encode(const char* path, int w, int h, int c,
                const unsigned char* pixels, const char* ext);
const char* rsio_version(void);
}

namespace {

std::vector<unsigned char> read_file(const char* path) {
  std::vector<unsigned char> data;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return data;
  std::fseek(fp, 0, SEEK_END);
  long len = std::ftell(fp);
  std::rewind(fp);
  if (len > 0) {
    data.resize(static_cast<size_t>(len));
    if (std::fread(data.data(), 1, data.size(), fp) != data.size()) data.clear();
  }
  std::fclose(fp);
  return data;
}

// ---- webp ---------------------------------------------------------------

unsigned char* decode_webp(const unsigned char* data, size_t len, int* w,
                           int* h, int* c) {
  WebPBitstreamFeatures feat;
  if (WebPGetFeatures(data, len, &feat) != VP8_STATUS_OK) return nullptr;
  uint8_t* out;
  if (feat.has_alpha) {
    out = WebPDecodeRGBA(data, len, w, h);
    *c = 4;
  } else {
    out = WebPDecodeRGB(data, len, w, h);
    *c = 3;
  }
  if (!out) return nullptr;
  // move to malloc-owned buffer so rsio_free is uniform
  size_t n = static_cast<size_t>(*w) * *h * *c;
  unsigned char* buf = static_cast<unsigned char*>(std::malloc(n));
  if (!buf) {
    WebPFree(out);
    return nullptr;
  }
  std::memcpy(buf, out, n);
  WebPFree(out);
  return buf;
}

// ---- png ----------------------------------------------------------------

struct PngReadState {
  const unsigned char* data;
  size_t len;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t count) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + count > st->len) png_error(png, "png: read past end");
  std::memcpy(out, st->data + st->pos, count);
  st->pos += count;
}

unsigned char* decode_png(const unsigned char* data, size_t len, int* w,
                          int* h, int* c) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return nullptr;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  unsigned char* buf = nullptr;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    std::free(buf);
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_mem_read);
  png_read_info(png, info);

  png_uint_32 width, height;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &width, &height, &bit_depth, &color_type, nullptr,
               nullptr, nullptr);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  // grayscale promotion (main.cpp:247-260 semantics)
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  int channels = static_cast<int>(png_get_channels(png, info));
  size_t stride = png_get_rowbytes(png, info);
  buf = static_cast<unsigned char*>(std::malloc(stride * height));
  if (!buf) png_error(png, "png: oom");
  rows.resize(height);
  for (png_uint_32 y = 0; y < height; y++) rows[y] = buf + y * stride;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  *c = channels;
  return buf;
}

// ---- jpeg ---------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

unsigned char* decode_jpeg(const unsigned char* data, size_t len, int* w,
                           int* h, int* c) {
  if (len < 3 || data[0] != 0xFF || data[1] != 0xD8) return nullptr;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  unsigned char* buf = nullptr;
  if (setjmp(jerr.jb)) {
    std::free(buf);
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // promotes grayscale too
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  *c = 3;
  size_t stride = static_cast<size_t>(*w) * 3;
  buf = static_cast<unsigned char*>(std::malloc(stride * *h));
  if (!buf) longjmp(jerr.jb, 1);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = buf + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return buf;
}

// ---- encoders -----------------------------------------------------------

// Strip-parallel PNG encoder (mirrors realsr_tpu_torch/io/pngz.py — one design,
// two runtimes). The reference's stb_image_write encode measures 1.8 MP/s
// at 32.1 MB for a 16.8 MP 4x output (same-content A/B 2026-08-19,
// BASELINE.md round-5 save-stage table), an order of magnitude under the
// device's steady state — the save stage would bind a directory run.
// Here: every row SUB-filtered, strips deflated INDEPENDENTLY (raw
// deflate, non-final strips end with Z_FULL_FLUSH so the stream is
// byte-aligned with a reset window — the pigz technique) on std::thread
// workers, concatenated into one valid zlib stream; Z_RLE level 1
// default measures 16.9 MP/s at 27.9 MB single-threaded — 9.4x faster
// AND 13% smaller than the reference's encoder, and it scales the encode
// of ONE image across cores. REALSR_TPU_PNG_LEVEL=0..9 opts into the
// default zlib strategy at that level (smaller, slower).

void png_put_u32(std::vector<unsigned char>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

// zlib's crc32/adler32 take uInt lengths: feed large buffers in bounded
// pieces or the cast silently truncates at 4 GiB and the stored checksum
// is computed over the wrong length (a 32768x32768 RGBA output's
// filtered stream is ~4.3 GiB).
constexpr size_t kZPiece = 1u << 30;

uLong crc32_big(uLong crc, const unsigned char* data, size_t len) {
  for (size_t off = 0; off < len; off += kZPiece)
    crc = crc32(crc, data + off,
                static_cast<uInt>(std::min(kZPiece, len - off)));
  return crc;
}

void png_put_chunk(std::vector<unsigned char>& out, const char tag[4],
                   const unsigned char* data, size_t len) {
  png_put_u32(out, static_cast<uint32_t>(len));
  size_t tag_at = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = static_cast<uint32_t>(
      crc32_big(0L, out.data() + tag_at, 4 + len));
  png_put_u32(out, crc);
}

// deflate one strip of the filtered scanline stream; non-final strips
// flush with Z_FULL_FLUSH (byte-aligned boundary + window reset)
bool png_deflate_strip(const unsigned char* data, size_t len, bool last,
                       int level, int strategy,
                       std::vector<unsigned char>& out) {
  if (len > 0xffffffffu) return false;  // uInt avail_in would truncate
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, strategy) != Z_OK)
    return false;
  out.resize(deflateBound(&zs, static_cast<uLong>(len)) + 16);
  zs.next_in = const_cast<Bytef*>(data);
  zs.avail_in = static_cast<uInt>(len);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = deflate(&zs, last ? Z_FINISH : Z_FULL_FLUSH);
  // deflateBound sizes the output for the whole strip, so deflate should
  // consume all of it; input left over would be a strip silently cut short
  bool ok = (last ? rc == Z_STREAM_END : rc == Z_OK) && zs.avail_in == 0;
  out.resize(zs.total_out);
  deflateEnd(&zs);
  return ok;
}

int encode_png(const char* path, int w, int h, int c,
               const unsigned char* pixels) {
  if (w <= 0 || h <= 0 || c < 1 || c > 4) return 0;
  int level = 1, strategy = Z_RLE;
  if (const char* env = std::getenv("REALSR_TPU_PNG_LEVEL")) {
    if (env[0] >= '0' && env[0] <= '9' && env[1] == '\0') {
      level = env[0] - '0';
      strategy = Z_DEFAULT_STRATEGY;
    }
  }
  const size_t row = static_cast<size_t>(w) * c;
  const size_t frow = row + 1;  // + filter byte
  // SUB-filter all rows into one contiguous scanline stream
  std::vector<unsigned char> filt(frow * h);
  for (int y = 0; y < h; y++) {
    const unsigned char* src = pixels + static_cast<size_t>(y) * row;
    unsigned char* dst = filt.data() + static_cast<size_t>(y) * frow;
    dst[0] = 1;  // SUB
    std::memcpy(dst + 1, src, c);
    for (size_t x = c; x < row; x++)
      dst[1 + x] = static_cast<unsigned char>(src[x] - src[x - c]);
  }
  // split into ~4 MB strips of whole rows; deflate strips concurrently
  const size_t strip_rows =
      frow ? std::max<size_t>(1, (4u << 20) / frow) : 1;
  const size_t nstrips = (static_cast<size_t>(h) + strip_rows - 1) / strip_rows;
  std::vector<std::vector<unsigned char>> parts(nstrips);
  std::vector<char> oks(nstrips, 0);
  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = std::min<size_t>(nstrips, hw ? hw : 1);
  std::atomic<size_t> next(0);
  auto work = [&]() {
    for (size_t i = next.fetch_add(1); i < nstrips; i = next.fetch_add(1)) {
      size_t y0 = i * strip_rows;
      size_t y1 = std::min<size_t>(y0 + strip_rows, h);
      oks[i] = png_deflate_strip(filt.data() + y0 * frow, (y1 - y0) * frow,
                                 i == nstrips - 1, level, strategy, parts[i])
                   ? 1
                   : 0;
    }
  };
  if (nthreads > 1) {
    std::vector<std::thread> threads;
    for (size_t t = 0; t < nthreads; t++) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  } else {
    work();
  }
  for (size_t i = 0; i < nstrips; i++)
    if (!oks[i]) return 0;

  uLong adler = adler32(0L, Z_NULL, 0);  // = 1
  for (size_t off = 0; off < filt.size(); off += kZPiece)
    adler = adler32(adler, filt.data() + off,
                    static_cast<uInt>(std::min(kZPiece, filt.size() - off)));

  static const int color_type[5] = {0, 0, 4, 2, 6};  // gray/LA/RGB/RGBA
  std::vector<unsigned char> out;
  size_t zlen = 2 + 4;  // zlib header + adler
  for (const auto& p : parts) zlen += p.size();
  out.reserve(8 + 25 + 12 + zlen + 12 + 12);
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                       0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  unsigned char ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff; ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff; ihdr[7] = h & 0xff;
  ihdr[8] = 8;  // bit depth
  ihdr[9] = static_cast<unsigned char>(color_type[c]);
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  png_put_chunk(out, "IHDR", ihdr, 13);
  std::vector<unsigned char> idat;
  idat.reserve(zlen);
  idat.push_back(0x78);
  idat.push_back(0x01);
  for (const auto& p : parts) idat.insert(idat.end(), p.begin(), p.end());
  png_put_u32(idat, static_cast<uint32_t>(adler));
  // the PNG chunk length field is 31-bit: emit the zlib stream as
  // multiple consecutive IDAT chunks when it is large (decoders
  // concatenate them; incompressible content at level 1 can exceed
  // 4 GiB for very large outputs)
  size_t off = 0;
  do {
    size_t n = std::min(kZPiece, idat.size() - off);
    png_put_chunk(out, "IDAT", idat.data() + off, n);
    off += n;
  } while (off < idat.size());
  png_put_chunk(out, "IEND", nullptr, 0);

  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 0;
  bool ok = std::fwrite(out.data(), 1, out.size(), fp) == out.size();
  std::fclose(fp);
  return ok ? 1 : 0;
}

int encode_jpeg(const char* path, int w, int h, int c,
                const unsigned char* pixels) {
  if (c != 3) return 0;  // alpha jpg is redirected upstream (main.cpp:279)
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 0;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(fp);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, fp);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, 100, TRUE);  // main.cpp:391
  jpeg_start_compress(&cinfo, TRUE);
  size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    const unsigned char* row = pixels + cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, const_cast<unsigned char**>(&row), 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(fp);
  return 1;
}

int encode_webp(const char* path, int w, int h, int c,
                const unsigned char* pixels) {
  uint8_t* out = nullptr;
  size_t size = 0;
  // lossless, matching webp_image.h:66-76
  if (c == 3)
    size = WebPEncodeLosslessRGB(pixels, w, h, w * 3, &out);
  else if (c == 4)
    size = WebPEncodeLosslessRGBA(pixels, w, h, w * 4, &out);
  if (!size || !out) return 0;
  FILE* fp = std::fopen(path, "wb");
  int ok = 0;
  if (fp) {
    ok = std::fwrite(out, 1, size, fp) == size;
    std::fclose(fp);
  }
  WebPFree(out);
  return ok;
}

}  // namespace

extern "C" {

unsigned char* rsio_decode(const char* path, int* w, int* h, int* c) {
  std::vector<unsigned char> data = read_file(path);
  if (data.empty()) return nullptr;
  // webp first (main.cpp:232-235), then magic-dispatched png/jpg
  if (unsigned char* p = decode_webp(data.data(), data.size(), w, h, c))
    return p;
  if (unsigned char* p = decode_png(data.data(), data.size(), w, h, c))
    return p;
  if (unsigned char* p = decode_jpeg(data.data(), data.size(), w, h, c))
    return p;
  return nullptr;
}

void rsio_free(unsigned char* p) { std::free(p); }

int rsio_encode(const char* path, int w, int h, int c,
                const unsigned char* pixels, const char* ext) {
  std::string e(ext ? ext : "");
  for (auto& ch : e) ch = static_cast<char>(std::tolower(ch));
  if (e == "png") return encode_png(path, w, h, c, pixels);
  if (e == "jpg" || e == "jpeg") return encode_jpeg(path, w, h, c, pixels);
  if (e == "webp") return encode_webp(path, w, h, c, pixels);
  return 0;
}

const char* rsio_version(void) { return "realsr_io 0.1.0"; }
}
