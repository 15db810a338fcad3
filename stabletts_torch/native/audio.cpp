// Native audio loader: WAV + FLAC decode + windowed-sinc resampling.
//
// Host-side data-path replacement for the reference's torchaudio loader
// (reference: utils/audio.py:59-74, vocoders/vocos/dataset.py:40-48), used by
// the training dataloaders so audio IO never bottlenecks the device.
//
// Formats: RIFF/WAVE with PCM16, PCM24, PCM32 or IEEE float32, any channel
// count (channel 0 is taken, matching the reference's mono conversion), and
// FLAC (decoder in flac.cpp). Length queries parse headers only — no sample
// decode.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" int64_t stabletts_flac_decode(const uint8_t* data, int64_t size,
                                         float* out, int64_t max_out,
                                         int* out_sr);

namespace {

struct WavData {
  std::vector<float> samples;  // mono, [-1, 1]
  int sample_rate = 0;
};

struct WavHeader {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint32_t sample_rate = 0;
  long data_pos = 0;
  uint64_t data_size = 0;  // clamped to bytes actually present
  uint64_t n_frames = 0;
};

// Parses RIFF chunks up to (and including) locating the data chunk; leaves
// the file positioned at the first data byte. Decodes nothing.
bool parse_wav_header(FILE* f, WavHeader* h) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) != 0 ||
      std::fread(&riff_size, 4, 1, f) != 1 || std::fread(wave, 1, 4, f) != 4 ||
      std::memcmp(wave, "WAVE", 4) != 0) {
    return false;
  }
  bool got_fmt = false;
  while (true) {
    char id[4];
    uint32_t size;
    if (std::fread(id, 1, 4, f) != 4 || std::fread(&size, 4, 1, f) != 1)
      return false;
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[40];
      uint32_t n = size < sizeof(buf) ? size : sizeof(buf);
      if (std::fread(buf, 1, n, f) != n) return false;
      if (size > n) std::fseek(f, size - n, SEEK_CUR);
      h->format = buf[0] | (buf[1] << 8);
      h->channels = buf[2] | (buf[3] << 8);
      std::memcpy(&h->sample_rate, buf + 4, 4);
      h->bits = buf[14] | (buf[15] << 8);
      if (h->format == 0xFFFE && size >= 40) std::memcpy(&h->format, buf + 24, 2);
      got_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0 && got_fmt) {
      // validate the fmt fields before any arithmetic: a malformed header
      // with channels==0 or bits<8 would otherwise divide by zero (SIGFPE
      // kills the process, bypassing the Python-side failure fallback)
      if (h->channels == 0 ||
          (h->bits != 8 && h->bits != 16 && h->bits != 24 && h->bits != 32)) {
        return false;
      }
      const bool fmt_ok = (h->format == 1 && (h->bits == 16 || h->bits == 24 ||
                                              h->bits == 32)) ||
                          (h->format == 3 && h->bits == 32);
      if (!fmt_ok || h->sample_rate == 0) return false;
      // clamp a corrupt chunk size to the bytes actually left in the file so
      // the decode buffer can't throw bad_alloc through the extern-C boundary
      const long data_pos = std::ftell(f);
      std::fseek(f, 0, SEEK_END);
      const long file_end = std::ftell(f);
      std::fseek(f, data_pos, SEEK_SET);
      if (data_pos < 0 || file_end < data_pos) return false;
      const uint64_t avail = static_cast<uint64_t>(file_end - data_pos);
      h->data_pos = data_pos;
      h->data_size = size < avail ? size : avail;
      h->n_frames = h->data_size / (static_cast<uint32_t>(h->bits / 8) * h->channels);
      return true;
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
}

bool decode_wav(FILE* f, const WavHeader& h, WavData* out) {
  const uint32_t bytes_per = h.bits / 8;
  std::vector<uint8_t> raw(h.n_frames * bytes_per * h.channels);
  if (std::fread(raw.data(), 1, raw.size(), f) != raw.size()) return false;
  out->samples.resize(h.n_frames);
  out->sample_rate = static_cast<int>(h.sample_rate);
  const uint8_t* p = raw.data();
  const uint32_t stride = bytes_per * h.channels;
  for (uint64_t i = 0; i < h.n_frames; ++i, p += stride) {
    float v = 0.0f;
    if (h.format == 1 && h.bits == 16) {
      int16_t s;
      std::memcpy(&s, p, 2);
      v = s / 32768.0f;
    } else if (h.format == 1 && h.bits == 24) {
      // assemble in unsigned then convert: `p[2] << 24` on a promoted int
      // is signed-overflow UB whenever the sample is negative; the final
      // /256 (not >>8) keeps the narrowing fully defined too
      const uint32_t u = (static_cast<uint32_t>(p[0]) << 8) |
                         (static_cast<uint32_t>(p[1]) << 16) |
                         (static_cast<uint32_t>(p[2]) << 24);
      const int32_t s = static_cast<int32_t>(u) / 256;
      v = s / 8388608.0f;
    } else if (h.format == 1 && h.bits == 32) {
      int32_t s;
      std::memcpy(&s, p, 4);
      v = s / 2147483648.0f;
    } else {  // format == 3 && bits == 32, guaranteed by parse_wav_header
      std::memcpy(&v, p, 4);
    }
    out->samples[i] = v;
  }
  return true;
}

bool read_all(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  buf->resize(n);
  const bool ok = std::fread(buf->data(), 1, n, f) == static_cast<size_t>(n);
  std::fclose(f);
  return ok;
}

enum class Container { kWav, kFlac, kUnknown };

Container sniff(FILE* f) {
  char magic[4];
  if (std::fread(magic, 1, 4, f) != 4) return Container::kUnknown;
  std::fseek(f, 0, SEEK_SET);
  if (std::memcmp(magic, "RIFF", 4) == 0) return Container::kWav;
  if (std::memcmp(magic, "fLaC", 4) == 0) return Container::kFlac;
  return Container::kUnknown;
}

// Full decode of either container, mono channel 0.
bool parse_audio(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  const Container kind = sniff(f);
  if (kind == Container::kWav) {
    WavHeader h;
    const bool ok = parse_wav_header(f, &h) && decode_wav(f, h, out);
    std::fclose(f);
    return ok;
  }
  std::fclose(f);
  if (kind != Container::kFlac) return false;
  std::vector<uint8_t> buf;
  if (!read_all(path, &buf)) return false;
  int sr = 0;
  const int64_t total =
      stabletts_flac_decode(buf.data(), buf.size(), nullptr, 0, &sr);
  if (total <= 0 || sr <= 0) return false;
  out->samples.resize(total);
  out->sample_rate = sr;
  const int64_t n =
      stabletts_flac_decode(buf.data(), buf.size(), out->samples.data(), total, &sr);
  if (n <= 0) return false;
  out->samples.resize(n);
  return true;
}

int64_t resampled_len(uint64_t n, int sr_in, int sr_out) {
  if (sr_in == sr_out) return static_cast<int64_t>(n);
  return static_cast<int64_t>(n * (static_cast<double>(sr_out) / sr_in));
}

// Windowed-sinc resampler (Hann window, half-width 16 output-rate zero
// crossings) — comparable quality to torchaudio's kaiser resampler.
void resample_sinc(const std::vector<float>& in, int sr_in, int sr_out,
                   std::vector<float>* out) {
  if (sr_in == sr_out) {
    *out = in;
    return;
  }
  const double ratio = static_cast<double>(sr_out) / sr_in;
  const double cutoff = ratio < 1.0 ? ratio : 1.0;  // anti-alias for downsample
  const int kZeros = 16;
  const double half_width = kZeros / cutoff;  // in input samples
  const int64_t n_out = static_cast<int64_t>(in.size() * ratio);
  out->assign(n_out, 0.0f);
  const int64_t n_in = static_cast<int64_t>(in.size());
  for (int64_t j = 0; j < n_out; ++j) {
    const double t = j / ratio;  // position in input samples
    const int64_t lo = static_cast<int64_t>(std::ceil(t - half_width));
    const int64_t hi = static_cast<int64_t>(std::floor(t + half_width));
    double acc = 0.0;
    for (int64_t i = std::max<int64_t>(lo, 0); i <= std::min(hi, n_in - 1); ++i) {
      const double d = (i - t) * cutoff;
      double w;
      if (d == 0.0) {
        w = 1.0;
      } else {
        const double pd = M_PI * d;
        w = std::sin(pd) / pd;
      }
      const double win = 0.5 + 0.5 * std::cos(M_PI * (i - t) / half_width);
      acc += in[i] * w * win;
    }
    (*out)[j] = static_cast<float>(acc * cutoff);
  }
}

}  // namespace

extern "C" {

// Load + mono + resample. Returns the number of samples written (<= max_len),
// 0 on failure, or -needed when the buffer is too small (nothing written) so
// callers can distinguish truncation from success and retry with a bigger
// buffer. `out_sr` receives the source sample rate.
int64_t stabletts_load_wav(const char* path, int target_sr, float* out,
                           int64_t max_len, int* out_sr) {
  WavData wav;
  if (!parse_audio(path, &wav)) return 0;
  if (out_sr) *out_sr = wav.sample_rate;
  std::vector<float> res;
  if (wav.sample_rate != target_sr) {
    resample_sinc(wav.samples, wav.sample_rate, target_sr, &res);
  } else {
    res = std::move(wav.samples);
  }
  const int64_t n = static_cast<int64_t>(res.size());
  if (n > max_len) return -n;
  std::memcpy(out, res.data(), n * sizeof(float));
  return n;
}

// Query post-resample length from headers only (no sample decode): WAV uses
// the fmt/data chunk sizes, FLAC uses STREAMINFO total_samples. Returns 0 on
// failure or when the header does not carry a length (rare streamed FLAC).
int64_t stabletts_wav_length(const char* path, int target_sr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 0;
  const Container kind = sniff(f);
  if (kind == Container::kWav) {
    WavHeader h;
    const bool ok = parse_wav_header(f, &h);
    std::fclose(f);
    if (!ok) return 0;
    return resampled_len(h.n_frames, static_cast<int>(h.sample_rate), target_sr);
  }
  if (kind != Container::kFlac) {
    std::fclose(f);
    return 0;
  }
  // STREAMINFO is within the first kilobytes; reading 64 KiB covers even
  // pathological metadata orderings without pulling the whole file
  std::vector<uint8_t> head(65536);
  const size_t n = std::fread(head.data(), 1, head.size(), f);
  std::fclose(f);
  int sr = 0;
  const int64_t total = stabletts_flac_decode(head.data(), n, nullptr, 0, &sr);
  if (total <= 0 || sr <= 0) return 0;
  return resampled_len(static_cast<uint64_t>(total), sr, target_sr);
}

// Random-crop segment loader for the vocoder dataloader: loads, resamples,
// zero-pads to segment_len if short, and crops at start_frac in [0, 1).
int stabletts_load_segment(const char* path, int target_sr, int64_t segment_len,
                           double start_frac, float* out) {
  WavData wav;
  if (!parse_audio(path, &wav)) return 0;
  std::vector<float> res;
  if (wav.sample_rate != target_sr) {
    resample_sinc(wav.samples, wav.sample_rate, target_sr, &res);
  } else {
    res = std::move(wav.samples);
  }
  if (static_cast<int64_t>(res.size()) < segment_len) {
    res.resize(segment_len, 0.0f);
  }
  const int64_t max_start = static_cast<int64_t>(res.size()) - segment_len;
  const int64_t start = static_cast<int64_t>(start_frac * (max_start + 1));
  std::memcpy(out, res.data() + std::min(start, max_start), segment_len * sizeof(float));
  return 1;
}

}  // extern "C"
