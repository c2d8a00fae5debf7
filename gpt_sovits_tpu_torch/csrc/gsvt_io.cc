// gsvt_io — native IO kernels for the training data pipeline.
//
// The reference leans on torch DataLoader's native worker pool for feeding
// its trainers (AR/data/data_module.py, module/data_utils.py). This
// framework's equivalent is a small C++ library doing the IO-bound parts
// (WAV/NPY decode, batch assembly) with a std::thread pool, exposed via a
// plain C ABI consumed through ctypes (gpt_sovits_tpu_torch/native.py, which
// builds it with g++ on first use).
//
// All functions return 0 on success, negative error codes otherwise.
// Buffers are caller-allocated numpy arrays; lengths are element counts.

#include <algorithm>
#include <atomic>
#include <functional>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Wav {
  std::vector<float> samples;  // mono-downmixed
  int sr = 0;
};

int read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t rd = fread(out.data(), 1, static_cast<size_t>(n), f);
  fclose(f);
  return rd == static_cast<size_t>(n) ? 0 : -2;
}

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Minimal RIFF/WAVE parser: PCM16/24/32 + float32, any channel count
// (downmixed to mono). Mirrors dsp/audio_io.py:_parse_wav.
int parse_wav(const std::vector<uint8_t>& data, Wav& wav) {
  if (data.size() < 12 || memcmp(data.data(), "RIFF", 4) != 0 || memcmp(data.data() + 8, "WAVE", 4) != 0)
    return -3;
  size_t pos = 12;
  int fmt_tag = -1, n_ch = 0, bits = 0;
  const uint8_t* raw = nullptr;
  size_t raw_len = 0;
  while (pos + 8 <= data.size()) {
    const uint8_t* cid = data.data() + pos;
    uint32_t size = rd_u32(data.data() + pos + 4);
    const uint8_t* body = data.data() + pos + 8;
    if (pos + 8 + size > data.size()) size = static_cast<uint32_t>(data.size() - pos - 8);
    if (memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
      fmt_tag = rd_u16(body);
      n_ch = rd_u16(body + 2);
      wav.sr = static_cast<int>(rd_u32(body + 4));
      bits = rd_u16(body + 14);
      if (fmt_tag == 0xFFFE) fmt_tag = (bits == 32) ? 3 : 1;  // extensible
    } else if (memcmp(cid, "data", 4) == 0) {
      raw = body;
      raw_len = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (fmt_tag < 0 || !raw || n_ch <= 0) return -4;
  size_t bytes_per = static_cast<size_t>(bits) / 8;
  size_t n_frames = raw_len / (bytes_per * n_ch);
  wav.samples.resize(n_frames);
  const double inv_ch = 1.0 / n_ch;
  for (size_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < n_ch; ++c) {
      const uint8_t* p = raw + (i * n_ch + c) * bytes_per;
      double v;
      if (fmt_tag == 3 && bits == 32) {
        float fv;
        memcpy(&fv, p, 4);
        v = fv;
      } else if (bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = s / 32768.0;
      } else if (bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else if (bits == 24) {
        int32_t s = p[0] | (p[1] << 8) | (p[2] << 16);
        if (s & 0x800000) s -= 0x1000000;
        v = s / 8388608.0;
      } else if (bits == 8) {
        v = (p[0] - 128.0) / 128.0;
      } else {
        return -5;
      }
      acc += v;
    }
    wav.samples[i] = static_cast<float>(acc * inv_ch);
  }
  return 0;
}

// Minimal NPY v1/v2 parser for C-contiguous little-endian f32/f16 arrays.
int parse_npy_f32(const std::vector<uint8_t>& data, std::vector<float>& out, int64_t* shape01) {
  if (data.size() < 10 || memcmp(data.data(), "\x93NUMPY", 6) != 0) return -6;
  int major = data[6];
  size_t hlen, hofs;
  if (major == 1) {
    hlen = rd_u16(data.data() + 8);
    hofs = 10;
  } else {
    hlen = rd_u32(data.data() + 8);
    hofs = 12;
  }
  std::string hdr(reinterpret_cast<const char*>(data.data() + hofs), hlen);
  bool f16 = hdr.find("<f2") != std::string::npos;
  if (!f16 && hdr.find("<f4") == std::string::npos) return -7;
  if (hdr.find("'fortran_order': False") == std::string::npos) return -8;
  size_t sp = hdr.find("'shape': (");
  if (sp == std::string::npos) return -9;
  long d0 = 0, d1 = 1;
  if (sscanf(hdr.c_str() + sp, "'shape': (%ld, %ld", &d0, &d1) < 1) return -9;
  if (hdr.find("()", sp) != std::string::npos) return -9;
  shape01[0] = d0;
  shape01[1] = d1;
  size_t n = static_cast<size_t>(d0) * static_cast<size_t>(d1);
  const uint8_t* body = data.data() + hofs + hlen;
  out.resize(n);
  if (f16) {
    for (size_t i = 0; i < n; ++i) {
      uint16_t h = rd_u16(body + 2 * i);
      // f16 -> f32
      uint32_t sign = (h & 0x8000u) << 16;
      uint32_t exp = (h >> 10) & 0x1F;
      uint32_t man = h & 0x3FF;
      uint32_t bitsf;
      if (exp == 0) {
        if (man == 0) {
          bitsf = sign;
        } else {
          exp = 127 - 15 + 1;
          while (!(man & 0x400)) {
            man <<= 1;
            --exp;
          }
          man &= 0x3FF;
          bitsf = sign | (exp << 23) | (man << 13);
        }
      } else if (exp == 31) {
        bitsf = sign | 0x7F800000u | (man << 13);
      } else {
        bitsf = sign | ((exp - 15 + 127) << 23) | (man << 13);
      }
      float fv;
      memcpy(&fv, &bitsf, 4);
      out[i] = fv;
    }
  } else {
    memcpy(out.data(), body, n * 4);
  }
  return 0;
}

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n <= 1 || n_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  int nt = std::min(n, n_threads);
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Decode a batch of WAV files in parallel into a strided f32 buffer.
//   out: (n, max_len) row-major, zero-padded; lengths[i] = samples written;
//   srs[i] = sample rate. status[i] per-file error code.
int gsvt_wav_batch(const char** paths, int n, float* out, int64_t max_len,
                   int64_t* lengths, int32_t* srs, int32_t* status, int n_threads) {
  parallel_for(n, n_threads, [&](int i) {
    std::vector<uint8_t> data;
    Wav wav;
    int rc = read_file(paths[i], data);
    if (rc == 0) rc = parse_wav(data, wav);
    status[i] = rc;
    if (rc != 0) {
      lengths[i] = 0;
      srs[i] = 0;
      return;
    }
    int64_t m = std::min<int64_t>(static_cast<int64_t>(wav.samples.size()), max_len);
    memcpy(out + static_cast<size_t>(i) * max_len, wav.samples.data(), static_cast<size_t>(m) * 4);
    if (m < max_len) memset(out + static_cast<size_t>(i) * max_len + m, 0, static_cast<size_t>(max_len - m) * 4);
    lengths[i] = m;
    srs[i] = wav.sr;
  });
  return 0;
}

// Decode a batch of 1D/2D f32|f16 .npy files in parallel into a strided
// (n, max_rows, cols) f32 buffer (zero-padded rows). rows[i] out.
int gsvt_npy_batch(const char** paths, int n, float* out, int64_t max_rows,
                   int64_t cols, int64_t* rows, int32_t* status, int n_threads) {
  parallel_for(n, n_threads, [&](int i) {
    std::vector<uint8_t> data;
    std::vector<float> arr;
    int64_t shape[2] = {0, 1};
    int rc = read_file(paths[i], data);
    if (rc == 0) rc = parse_npy_f32(data, arr, shape);
    if (rc == 0 && shape[1] != cols) rc = -10;
    status[i] = rc;
    float* dst = out + static_cast<size_t>(i) * max_rows * cols;
    if (rc != 0) {
      rows[i] = 0;
      memset(dst, 0, static_cast<size_t>(max_rows * cols) * 4);
      return;
    }
    int64_t m = std::min<int64_t>(shape[0], max_rows);
    memcpy(dst, arr.data(), static_cast<size_t>(m * cols) * 4);
    if (m < max_rows) memset(dst + m * cols, 0, static_cast<size_t>((max_rows - m) * cols) * 4);
    rows[i] = m;
  });
  return 0;
}

int gsvt_version() { return 1; }
}
