// Host input pipeline: RecordIO scan + JPEG decode + augment + batch.
//
// The port's own copy of mxnet_tpu/native/io_core.cc, with the same
// arithmetic and the same seeded draws, so both fill a batch with the
// same bits.  An mmap'd .rec file, a persistent worker pool decoding a
// batch's samples in parallel with libjpeg, and augment (resize-shorter,
// random or center crop, mirror, mean/std) fused into the float32 NCHW
// fill of the caller's buffer.  A flat C ABI (opaque handle, plain C
// types) bound with ctypes by native/__init__.py; no Python in here.
//
// Built with -DMXIO_NO_JPEG where libjpeg's headers are missing: RAWN
// records then decode as before, and a batch holding any other payload
// fails with an error that names the missing decoder.
//
// Record framing (must match recordio.py byte for byte):
//   [u32 magic=0xced7230a][u32 len(29bit)] payload pad-to-4
// Payload: IRHeader {u32 flag, f32 label, u64 id, u64 id2}
//   then flag>0 ? flag*f32 labels : (scalar label in header)
//   then image bytes: a JPEG stream, or "RAWN" + u8 ndim + ndim*u32 shape
//   + raw uint8 pixels (recordio.py pack_img without PIL).

#include <cstddef>
#include <cstdio>
#ifndef MXIO_NO_JPEG
#include <jpeglib.h>
#endif

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct Header {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};

#ifndef MXIO_NO_JPEG
// ---------------------------------------------------------------------------
// libjpeg with error-longjmp (default handler exit()s the process)
// ---------------------------------------------------------------------------
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG stream to RGB u8 (h, w, 3).  Returns false on corrupt data.
// ``min_side_hint`` > 0 engages libjpeg's DCT-domain scaled decode: the
// largest 1/2^k scale whose output still keeps a 2x oversampling margin
// over the hint (the downstream bilinear resize needs headroom to stay
// visually equivalent to a full-resolution decode).  Decoding 1/2-scale
// reads ~1/4 of the DCT work — the big per-image cost on the host.
bool DecodeJpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                int* oh, int* ow, int min_side_hint = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;   // libjpeg upsamples grayscale for us
  if (min_side_hint > 0) {
    const int min_side = std::min(static_cast<int>(cinfo.image_height),
                                  static_cast<int>(cinfo.image_width));
    int denom = 1;
    while (denom < 8 && min_side / (denom * 2) >= min_side_hint * 2)
      denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned>(denom);
    // the fast-path decode also takes the fast IDCT: ~1-2 LSB pixel
    // difference, meaningful decode-time cut; the exact path (hint==0,
    // the parity-tested configuration) keeps ISLOW
    cinfo.dct_method = JDCT_IFAST;
  }
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  out->resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data() +
        static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *oh = h;
  *ow = w;
  return true;
}
#endif  // MXIO_NO_JPEG

// Bilinear resize RGB u8 (ih,iw,3) -> (oh,ow,3), align-corners=false
// (pixel-center sampling, the convention PIL/OpenCV use).
void ResizeBilinear(const uint8_t* src, int ih, int iw,
                    std::vector<uint8_t>* dst, int oh, int ow) {
  dst->resize(static_cast<size_t>(oh) * ow * 3);
  const float sy = static_cast<float>(ih) / oh;
  const float sx = static_cast<float>(iw) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    y0 = y0 < 0 ? 0 : (y0 >= ih ? ih - 1 : y0);
    y1 = y1 < 0 ? 0 : (y1 >= ih ? ih - 1 : y1);
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      x0 = x0 < 0 ? 0 : (x0 >= iw ? iw - 1 : x0);
      x1 = x1 < 0 ? 0 : (x1 >= iw ? iw - 1 : x1);
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(static_cast<size_t>(y0) * iw + x0) * 3 + c];
        float v01 = src[(static_cast<size_t>(y0) * iw + x1) * 3 + c];
        float v10 = src[(static_cast<size_t>(y1) * iw + x0) * 3 + c];
        float v11 = src[(static_cast<size_t>(y1) * iw + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        (*dst)[(static_cast<size_t>(y) * ow + x) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

struct Iter {
  // config
  int batch, c, h, w, resize, label_width, nthreads;
  int decode_hint = 0;   // >0: DCT-scaled decode floor (min output side)
  bool rand_crop, rand_mirror, shuffle, round_batch;
  uint64_t seed;
  float mean[3], stdv[3];

  // file
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_len = 0;
  std::vector<size_t> offsets;

  // epoch state
  std::vector<uint32_t> order;
  size_t cursor = 0;       // batch index within epoch
  size_t n_batches = 0;
  uint64_t epoch = 0;

  // worker pool
  std::vector<std::thread> pool;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  bool stopping = false;
  int job_gen = 0;
  std::atomic<int> next_sample{0};
  int n_samples_job = 0;
  std::atomic<int> done_count{0};
  // per-job views
  const uint32_t* sel = nullptr;
  float* out_data = nullptr;
  float* out_label = nullptr;
  std::atomic<bool> job_failed{false};
  std::atomic<bool> no_decoder{false};

  std::string last_error;

  ~Iter() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_work.notify_all();
    for (auto& t : pool) t.join();
    if (base) munmap(const_cast<uint8_t*>(base), file_len);
    if (fd >= 0) close(fd);
  }

  bool DecodeOne(int i, uint64_t sample_seed);
  void WorkerLoop();
  int Next(float* data, float* label, std::vector<uint32_t>* sel_buf);
  void Reset();
};

void Iter::WorkerLoop() {
  int seen_gen = 0;
  for (;;) {
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_work.wait(lk, [&] { return stopping || job_gen != seen_gen; });
      if (stopping) return;
      seen_gen = job_gen;
    }
    for (;;) {
      int i = next_sample.fetch_add(1);
      if (i >= n_samples_job) break;
      uint64_t ss = seed * 0x9e3779b97f4a7c15ULL + epoch * 0x100000001b3ULL +
                    static_cast<uint64_t>(sel[i]) * 1099511628211ULL + i;
      if (!DecodeOne(i, ss)) job_failed.store(true);
      done_count.fetch_add(1);
    }
    cv_done.notify_one();
  }
}

bool Iter::DecodeOne(int i, uint64_t sample_seed) {
  const size_t off = offsets[sel[i]];
  if (off + 8 > file_len) return false;
  uint32_t magic, lrec;
  std::memcpy(&magic, base + off, 4);
  std::memcpy(&lrec, base + off + 4, 4);
  if (magic != kMagic) return false;
  const size_t len = lrec & ((1u << 29) - 1);
  if (off + 8 + len > file_len) return false;
  const uint8_t* payload = base + off + 8;

  Header hdr;
  if (len < sizeof(Header)) return false;
  std::memcpy(&hdr, payload, sizeof(Header));
  const uint8_t* img = payload + sizeof(Header);
  size_t img_len = len - sizeof(Header);

  // labels
  float* lab = out_label + static_cast<size_t>(i) * label_width;
  for (int k = 0; k < label_width; ++k) lab[k] = 0.f;
  if (hdr.flag > 0) {
    const size_t nlab = hdr.flag;
    if (img_len < nlab * 4) return false;
    for (int k = 0; k < label_width && k < static_cast<int>(nlab); ++k)
      std::memcpy(&lab[k], img + 4 * k, 4);
    img += nlab * 4;
    img_len -= nlab * 4;
  } else {
    lab[0] = hdr.label;
  }

  // pixels
  std::vector<uint8_t> rgb;
  int ih = 0, iw = 0;
  if (img_len >= 5 && std::memcmp(img, "RAWN", 4) == 0) {
    int ndim = img[4];
    if (ndim < 2 || ndim > 3) return false;
    uint32_t shp[3] = {0, 0, 1};
    if (img_len < 5 + 4u * ndim) return false;
    std::memcpy(shp, img + 5, 4 * ndim);
    ih = shp[0];
    iw = shp[1];
    const int ch = ndim == 3 ? shp[2] : 1;
    const uint8_t* px = img + 5 + 4 * ndim;
    if (img_len < 5 + 4u * ndim + static_cast<size_t>(ih) * iw * ch)
      return false;
    rgb.resize(static_cast<size_t>(ih) * iw * 3);
    for (size_t p = 0; p < static_cast<size_t>(ih) * iw; ++p)
      for (int cc = 0; cc < 3; ++cc)
        rgb[p * 3 + cc] = px[p * ch + (cc < ch ? cc : ch - 1)];
  } else {
#ifdef MXIO_NO_JPEG
    no_decoder.store(true);
    return false;
#else
    if (!DecodeJpeg(img, img_len, &rgb, &ih, &iw, decode_hint))
      return false;
#endif
  }

  // resize shorter side
  std::vector<uint8_t> tmp;
  auto resize_shorter = [&](int size) {
    int nh, nw;
    if (ih < iw) {
      nh = size;
      nw = std::max(1, static_cast<int>(std::lround(
          static_cast<double>(iw) * size / ih)));
    } else {
      nw = size;
      nh = std::max(1, static_cast<int>(std::lround(
          static_cast<double>(ih) * size / iw)));
    }
    ResizeBilinear(rgb.data(), ih, iw, &tmp, nh, nw);
    rgb.swap(tmp);
    ih = nh;
    iw = nw;
  };
  if (resize > 0) resize_shorter(resize);
  if (ih < h || iw < w) resize_shorter(std::max(h, w));

  // crop
  std::mt19937_64 rng(sample_seed);
  int top, left;
  if (rand_crop) {
    top = static_cast<int>(rng() % static_cast<uint64_t>(ih - h + 1));
    left = static_cast<int>(rng() % static_cast<uint64_t>(iw - w + 1));
  } else {
    top = (ih - h) / 2;
    left = (iw - w) / 2;
  }
  const bool mirror = rand_mirror && (rng() & 1);

  // fused crop+mirror+normalize into float32 CHW
  float* dst = out_data + static_cast<size_t>(i) * c * h * w;
  for (int cc = 0; cc < c; ++cc) {
    const float m = mean[cc], s = stdv[cc];
    float* plane = dst + static_cast<size_t>(cc) * h * w;
    for (int y = 0; y < h; ++y) {
      const uint8_t* row =
          rgb.data() + (static_cast<size_t>(top + y) * iw + left) * 3 + cc;
      float* drow = plane + static_cast<size_t>(y) * w;
      if (mirror) {
        for (int x = 0; x < w; ++x)
          drow[x] = (static_cast<float>(row[(w - 1 - x) * 3]) - m) / s;
      } else {
        for (int x = 0; x < w; ++x)
          drow[x] = (static_cast<float>(row[x * 3]) - m) / s;
      }
    }
  }
  return true;
}

int Iter::Next(float* data, float* label, std::vector<uint32_t>* sel_buf) {
  if (cursor >= n_batches) return -1;
  const size_t n = order.size();
  const size_t lo = cursor * batch;
  size_t hi = lo + batch;
  int pad = 0;
  sel_buf->clear();
  if (hi > n) {
    pad = static_cast<int>(hi - n);
    hi = n;
  }
  for (size_t k = lo; k < hi; ++k) sel_buf->push_back(order[k]);
  for (int k = 0; k < pad; ++k)
    sel_buf->push_back(order[k % n]);   // round_batch: wrap to the front

  {
    std::lock_guard<std::mutex> lk(mu);
    sel = sel_buf->data();
    out_data = data;
    out_label = label;
    n_samples_job = batch;
    next_sample.store(0);
    done_count.store(0);
    job_failed.store(false);
    no_decoder.store(false);
    ++job_gen;
  }
  cv_work.notify_all();
  {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return done_count.load() >= n_samples_job; });
  }
  ++cursor;
  if (job_failed.load()) {
    last_error = no_decoder.load()
        ? "a record in the batch holds an encoded image, and this io core "
          "was built without a JPEG decoder (libjpeg's jpeglib.h was "
          "missing at build time)"
        : "corrupt record or undecodable image in batch";
    return -2;
  }
  return pad;
}

void Iter::Reset() {
  ++epoch;
  cursor = 0;
  if (shuffle) {
    std::mt19937_64 rng(seed + epoch * 0x9e3779b97f4a7c15ULL);
    for (size_t k = order.size(); k > 1; --k) {
      size_t j = rng() % k;
      std::swap(order[k - 1], order[j]);
    }
  }
}

}  // namespace

extern "C" {

void* MXIOCreate(const char* rec_path, const char* idx_path,
                 int batch, int c, int h, int w, int resize,
                 int rand_crop, int rand_mirror, int shuffle,
                 int round_batch, uint64_t seed,
                 const float* mean, const float* stdv, int label_width,
                 int part_index, int num_parts, int nthreads,
                 int decode_hint, char* err, int err_len) {
  auto fail = [&](const std::string& msg) -> void* {
    std::snprintf(err, err_len, "%s", msg.c_str());
    return nullptr;
  };
  auto it = std::unique_ptr<Iter>(new Iter());
  it->batch = batch;
  it->c = c;
  it->h = h;
  it->w = w;
  it->resize = resize;
  it->label_width = label_width;
  it->rand_crop = rand_crop;
  it->rand_mirror = rand_mirror;
  it->shuffle = shuffle;
  it->round_batch = round_batch;
  it->seed = seed;
  it->decode_hint = decode_hint;
  for (int k = 0; k < 3; ++k) {
    it->mean[k] = mean ? mean[k] : 0.f;
    it->stdv[k] = stdv ? stdv[k] : 1.f;
  }
  if (c < 1 || c > 3) return fail("c must be 1..3");

  it->fd = open(rec_path, O_RDONLY);
  if (it->fd < 0) return fail(std::string("cannot open ") + rec_path);
  struct stat st;
  if (fstat(it->fd, &st) != 0 || st.st_size == 0)
    return fail("empty or unstatable rec file");
  it->file_len = st.st_size;
  void* m = mmap(nullptr, it->file_len, PROT_READ, MAP_PRIVATE, it->fd, 0);
  if (m == MAP_FAILED) return fail("mmap failed");
  it->base = static_cast<const uint8_t*>(m);

  // offsets: from the .idx sidecar when given, else a linear scan
  if (idx_path && idx_path[0]) {
    FILE* f = fopen(idx_path, "r");
    if (!f) return fail(std::string("cannot open ") + idx_path);
    char line[256];
    while (fgets(line, sizeof line, f)) {
      const char* tab = strchr(line, '\t');
      if (tab) it->offsets.push_back(strtoull(tab + 1, nullptr, 10));
    }
    fclose(f);
  } else {
    size_t pos = 0;
    while (pos + 8 <= it->file_len) {
      uint32_t magic, lrec;
      std::memcpy(&magic, it->base + pos, 4);
      std::memcpy(&lrec, it->base + pos + 4, 4);
      if (magic != kMagic) return fail("bad record magic during scan");
      size_t len = lrec & ((1u << 29) - 1);
      it->offsets.push_back(pos);
      pos += 8 + len + (4 - len % 4) % 4;
    }
  }
  if (it->offsets.empty()) return fail("no records in file");

  // distributed shard (reference: part_index/num_parts)
  const size_t nrec = it->offsets.size();
  const size_t shard = nrec / num_parts;
  const size_t lo = static_cast<size_t>(part_index) * shard;
  const size_t hi = part_index == num_parts - 1 ? nrec : lo + shard;
  it->offsets.assign(it->offsets.begin() + lo, it->offsets.begin() + hi);

  it->order.resize(it->offsets.size());
  std::iota(it->order.begin(), it->order.end(), 0);
  it->n_batches = it->order.size() / batch;
  if (it->round_batch && it->order.size() % batch) ++it->n_batches;
  it->epoch = static_cast<uint64_t>(-1);   // Reset() bumps to 0
  it->Reset();

  const int nt = nthreads > 0 ? nthreads : 4;
  it->nthreads = nt;
  for (int t = 0; t < nt; ++t)
    it->pool.emplace_back(&Iter::WorkerLoop, it.get());
  return it.release();
}

int64_t MXIONumSamples(void* h) {
  return static_cast<Iter*>(h)->order.size();
}

int64_t MXIONumBatches(void* h) {
  return static_cast<Iter*>(h)->n_batches;
}

// Fill one batch.  Returns pad count (>=0), -1 at epoch end, -2 on error.
int MXIONext(void* h, float* data, float* label) {
  thread_local std::vector<uint32_t> sel_buf;
  return static_cast<Iter*>(h)->Next(data, label, &sel_buf);
}

int MXIOHasJpeg() {
#ifdef MXIO_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

const char* MXIOLastError(void* h) {
  return static_cast<Iter*>(h)->last_error.c_str();
}

void MXIOReset(void* h) { static_cast<Iter*>(h)->Reset(); }

void MXIODestroy(void* h) { delete static_cast<Iter*>(h); }

}  // extern "C"
