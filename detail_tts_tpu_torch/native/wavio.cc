// Native host-side audio decode for the training data pipeline.
//
// The reference pipeline spends its host time in per-item torchaudio
// load + resample inside 16 worker processes (train.py:95-103,
// dataset_24k.py:120-128).  This library does the same work in C++ —
// RIFF/WAVE parsing (PCM16/24/32, float32) and Kaiser-windowed polyphase
// resampling — callable from the prefetch threads via ctypes with the GIL
// released, so one process saturates the loader without worker processes.
//
// C ABI:
//   long dtts_load_wav(path, target_sr, &data, &len) -> 0 ok / negative error
//   void dtts_free(float*)
//   long dtts_resample(in, in_len, sr_in, sr_out, &out, &out_len)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

double bessel_i0(double x) {
  // series expansion; converges quickly for the beta range we use
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-12 * sum) break;
  }
  return sum;
}

long gcd_long(long a, long b) { return b == 0 ? a : gcd_long(b, a % b); }

// Polyphase rational resampler (scipy.signal.resample_poly semantics:
// up by L, FIR low-pass, down by M; Kaiser window beta=5.0, 10*max(L,M)
// half-width).
std::vector<float> resample_poly(const float* in, long n, long sr_in,
                                 long sr_out) {
  if (sr_in == sr_out) return std::vector<float>(in, in + n);
  long g = gcd_long(sr_in, sr_out);
  long up = sr_out / g, down = sr_in / g;

  long max_rate = up > down ? up : down;
  double f_c = 1.0 / (2.0 * max_rate);  // cutoff in input-rate units
  long half_len = 10 * max_rate;
  long taps = 2 * half_len + 1;

  const double beta = 5.0;
  const double i0b = bessel_i0(beta);
  std::vector<double> h(taps);
  for (long i = 0; i < taps; ++i) {
    double m = static_cast<double>(i) - half_len;
    double sinc = (m == 0.0) ? 2.0 * f_c
                             : std::sin(2.0 * M_PI * f_c * m) / (M_PI * m);
    double r = m / half_len;
    double w = bessel_i0(beta * std::sqrt(1.0 - r * r)) / i0b;
    h[i] = static_cast<double>(up) * sinc * w;
  }

  long out_n = (n * up + down - 1) / down;
  std::vector<float> out(out_n);

  // y[j] = sum_i x[i] * h[j*down - i*up + half_len]
  for (long j = 0; j < out_n; ++j) {
    long t = j * down;  // position in upsampled grid
    // h index k = t - i*up + half_len must lie in [0, taps)
    long i_min = (t + half_len - (taps - 1) + up - 1) / up;
    long i_max = (t + half_len) / up;
    if (i_min < 0) i_min = 0;
    if (i_max >= n) i_max = n - 1;
    double acc = 0.0;
    for (long i = i_min; i <= i_max; ++i) {
      acc += static_cast<double>(in[i]) * h[t - i * up + half_len];
    }
    out[j] = static_cast<float>(acc);
  }
  return out;
}

struct Wav {
  std::vector<float> samples;  // mono
  long sr = 0;
};

int parse_wav(const char* path, Wav* wav) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) ||
      std::fread(&riff_size, 4, 1, f) != 1 ||
      std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4)) {
    std::fclose(f);
    return -2;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  bool got_fmt = false;
  while (true) {
    char id[4];
    uint32_t size;
    if (std::fread(id, 1, 4, f) != 4 || std::fread(&size, 4, 1, f) != 1) break;
    if (!std::memcmp(id, "fmt ", 4)) {
      uint8_t buf[40];
      uint32_t take = size < 40 ? size : 40;
      if (std::fread(buf, 1, take, f) != take) break;
      if (size > take) std::fseek(f, size - take, SEEK_CUR);
      std::memcpy(&fmt, buf + 0, 2);
      std::memcpy(&channels, buf + 2, 2);
      std::memcpy(&sr, buf + 4, 4);
      std::memcpy(&bits, buf + 14, 2);
      if (fmt == 0xFFFE && size >= 26) {  // WAVE_FORMAT_EXTENSIBLE
        std::memcpy(&fmt, buf + 24, 2);
      }
      got_fmt = true;
    } else if (!std::memcmp(id, "data", 4)) {
      if (!got_fmt || channels == 0) {
        std::fclose(f);
        return -3;
      }
      std::vector<uint8_t> raw(size);
      size_t got = std::fread(raw.data(), 1, size, f);
      raw.resize(got);  // tolerate truncated files (the test asset is one)
      long bytes_per = bits / 8;
      long frames = static_cast<long>(raw.size()) / (bytes_per * channels);
      wav->samples.resize(frames);
      wav->sr = sr;
      for (long i = 0; i < frames; ++i) {
        const uint8_t* p = raw.data() + i * bytes_per * channels;  // ch 0
        float v = 0.f;
        if (fmt == 3 && bits == 32) {
          std::memcpy(&v, p, 4);
        } else if (fmt == 1 && bits == 16) {
          int16_t s;
          std::memcpy(&s, p, 2);
          v = s / 32768.0f;
        } else if (fmt == 1 && bits == 24) {
          int32_t s = (p[0] << 8) | (p[1] << 16) |
                      (static_cast<int32_t>(static_cast<int8_t>(p[2])) << 24);
          v = (s >> 8) / 8388608.0f;
        } else if (fmt == 1 && bits == 32) {
          int32_t s;
          std::memcpy(&s, p, 4);
          v = s / 2147483648.0f;
        } else {
          std::fclose(f);
          return -4;  // unsupported encoding
        }
        wav->samples[i] = v;
      }
      std::fclose(f);
      return 0;
    } else {
      std::fseek(f, (size + 1) & ~1u, SEEK_CUR);  // chunks are 2-aligned
    }
  }
  std::fclose(f);
  return -5;
}

}  // namespace

extern "C" {

long dtts_load_wav(const char* path, long target_sr, float** out_data,
                   long* out_len) {
  Wav wav;
  int rc = parse_wav(path, &wav);
  if (rc != 0) return rc;
  std::vector<float> res =
      (target_sr > 0 && wav.sr != target_sr)
          ? resample_poly(wav.samples.data(),
                          static_cast<long>(wav.samples.size()), wav.sr,
                          target_sr)
          : std::move(wav.samples);
  float* buf = static_cast<float*>(std::malloc(res.size() * sizeof(float)));
  if (!buf) return -6;
  std::memcpy(buf, res.data(), res.size() * sizeof(float));
  *out_data = buf;
  *out_len = static_cast<long>(res.size());
  return 0;
}

long dtts_resample(const float* in, long in_len, long sr_in, long sr_out,
                   float** out_data, long* out_len) {
  std::vector<float> res = resample_poly(in, in_len, sr_in, sr_out);
  float* buf = static_cast<float*>(std::malloc(res.size() * sizeof(float)));
  if (!buf) return -6;
  std::memcpy(buf, res.data(), res.size() * sizeof(float));
  *out_data = buf;
  *out_len = static_cast<long>(res.size());
  return 0;
}

void dtts_free(float* p) { std::free(p); }

}  // extern "C"
