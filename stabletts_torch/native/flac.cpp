// Native FLAC decoder (no third-party code; written from the public FLAC
// format spec, RFC 9639).
//
// The reference decodes flac via torchaudio's ffmpeg backend (reference:
// utils/audio.py:59-74); neither ffmpeg nor libFLAC exists in this image, so
// the data layer carries its own decoder. Scope: everything the format
// allows for audio recovery — all subframe types (constant / verbatim /
// fixed 0-4 / LPC to order 32), both Rice residual methods incl. escape
// partitions, all four channel assignments, wasted bits, variable blocksize
// streams. CRCs are consumed but not verified (a corrupt file yields
// garbage samples, not a crash; callers treat short output as failure).
//
// Build: part of libstabletts_native.so (see stabletts_tpu/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// MSB-first bit reader over a whole-file buffer.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed from data[byte], 0..7
  bool fail = false;

  bool eof() const { return byte >= size; }

  uint64_t bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte >= size) {
        fail = true;
        return 0;
      }
      const int avail = 8 - bit;
      const int take = n < avail ? n : avail;
      const int shift = avail - take;
      v = (v << take) | ((data[byte] >> shift) & ((1u << take) - 1));
      bit += take;
      n -= take;
      if (bit == 8) {
        bit = 0;
        ++byte;
      }
    }
    return v;
  }

  int64_t sbits(int n) {  // two's-complement signed read
    const uint64_t v = bits(n);
    const uint64_t sign = 1ull << (n - 1);
    return static_cast<int64_t>((v ^ sign)) - static_cast<int64_t>(sign);
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (!fail && bits(1) == 0) {
      ++q;
      if (q > (1u << 24)) {  // corrupt stream guard
        fail = true;
        return 0;
      }
    }
    return q;
  }

  void align() {
    if (bit != 0) {
      bit = 0;
      ++byte;
    }
  }
};

// UTF-8-style coded number in frame headers (up to 36 bits / 7 bytes).
uint64_t read_coded_number(BitReader* br) {
  const uint32_t b0 = static_cast<uint32_t>(br->bits(8));
  int n_extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) {
    return b0;
  } else if ((b0 & 0xE0) == 0xC0) {
    n_extra = 1; v = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    n_extra = 2; v = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    n_extra = 3; v = b0 & 0x07;
  } else if ((b0 & 0xFC) == 0xF8) {
    n_extra = 4; v = b0 & 0x03;
  } else if ((b0 & 0xFE) == 0xFC) {
    n_extra = 5; v = b0 & 0x01;
  } else if (b0 == 0xFE) {
    n_extra = 6; v = 0;
  } else {
    br->fail = true;
    return 0;
  }
  for (int i = 0; i < n_extra; ++i) {
    const uint32_t b = static_cast<uint32_t>(br->bits(8));
    if ((b & 0xC0) != 0x80) {
      br->fail = true;
      return 0;
    }
    v = (v << 6) | (b & 0x3F);
  }
  return v;
}

int64_t rice_decode(BitReader* br, int param) {
  const uint32_t q = br->unary();
  const uint64_t u = (static_cast<uint64_t>(q) << param) | br->bits(param);
  return static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
}

// Residual section of a fixed/LPC subframe into out[order..block_size).
bool read_residual(BitReader* br, int block_size, int order, int64_t* out) {
  const int method = static_cast<int>(br->bits(2));
  if (method > 1) return false;
  const int param_bits = method == 0 ? 4 : 5;
  const int escape = method == 0 ? 0x0F : 0x1F;
  const int part_order = static_cast<int>(br->bits(4));
  const int n_parts = 1 << part_order;
  if (block_size % n_parts != 0) return false;
  const int part_len = block_size >> part_order;
  if (part_len <= 0 || (part_order == 0 ? block_size - order : part_len - order) < 0)
    return false;
  int idx = order;
  for (int p = 0; p < n_parts; ++p) {
    const int n = (p == 0) ? part_len - order : part_len;
    const int param = static_cast<int>(br->bits(param_bits));
    if (param == escape) {
      const int raw_bits = static_cast<int>(br->bits(5));
      for (int i = 0; i < n; ++i)
        out[idx++] = raw_bits == 0 ? 0 : br->sbits(raw_bits);
    } else {
      for (int i = 0; i < n; ++i) out[idx++] = rice_decode(br, param);
    }
    if (br->fail) return false;
  }
  return true;
}

// One subframe into out[0..block_size), samples at bps bits.
bool read_subframe(BitReader* br, int block_size, int bps,
                   std::vector<int64_t>* out_vec) {
  out_vec->assign(block_size, 0);
  int64_t* out = out_vec->data();
  if (br->bits(1) != 0) return false;  // padding bit must be 0
  const int type = static_cast<int>(br->bits(6));
  int wasted = 0;
  if (br->bits(1) == 1) wasted = 1 + static_cast<int>(br->unary());
  if (br->fail || wasted >= bps) return false;
  const int ebps = bps - wasted;

  if (type == 0) {  // constant
    const int64_t v = br->sbits(ebps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block_size; ++i) out[i] = br->sbits(ebps);
  } else if (type >= 8 && type <= 12) {  // fixed predictor
    const int order = type - 8;
    if (order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br->sbits(ebps);
    if (!read_residual(br, block_size, order, out)) return false;
    for (int i = order; i < block_size; ++i) {
      switch (order) {
        case 0: break;
        case 1: out[i] += out[i - 1]; break;
        case 2: out[i] += 2 * out[i - 1] - out[i - 2]; break;
        case 3: out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4:
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
          break;
      }
    }
  } else if (type >= 32) {  // LPC, order 1..32
    const int order = (type & 0x1F) + 1;
    if (order > block_size) return false;
    for (int i = 0; i < order; ++i) out[i] = br->sbits(ebps);
    const int precision = static_cast<int>(br->bits(4)) + 1;
    if (precision == 16) return false;  // 0b1111 is invalid
    const int shift = static_cast<int>(br->sbits(5));
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br->sbits(precision);
    if (!read_residual(br, block_size, order, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * out[i - 1 - j];
      out[i] += acc >> shift;
    }
  } else {
    return false;  // reserved subframe type
  }
  if (br->fail) return false;
  if (wasted > 0)
    for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
  return true;
}

const uint32_t kBlockSizes[16] = {0,   192,  576,  1152, 2304, 4608, 0,    0,
                                  256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const uint32_t kSampleRates[16] = {0,     88200, 176400, 192000, 8000, 16000,
                                   22050, 24000, 32000,  44100,  48000, 96000,
                                   0,     0,     0,      0};

}  // namespace

// Decodes the whole stream. Returns n_samples decoded (channel 0 / downmix
// source is selected by the caller — we emit channel 0 to match the
// reference's mono conversion, reference: utils/audio.py:68-69), or -1 on
// parse failure before any sample. out may be null (header/length probe:
// returns STREAMINFO total samples without decoding).
extern "C" int64_t stabletts_flac_decode(const uint8_t* data, int64_t size,
                                         float* out, int64_t max_out,
                                         int* out_sr) {
  BitReader br{data, static_cast<size_t>(size)};
  if (br.bits(32) != 0x664C6143u) return -1;  // "fLaC"
  // metadata blocks; STREAMINFO is mandatory and first
  uint32_t sample_rate = 0;
  int channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false, have_streaminfo = false;
  while (!last && !br.fail) {
    last = br.bits(1) != 0;
    const int type = static_cast<int>(br.bits(7));
    const uint32_t len = static_cast<uint32_t>(br.bits(24));
    if (type == 0 && len >= 34) {  // STREAMINFO
      br.bits(16);  // min blocksize
      br.bits(16);  // max blocksize
      br.bits(24);  // min framesize
      br.bits(24);  // max framesize
      sample_rate = static_cast<uint32_t>(br.bits(20));
      channels = static_cast<int>(br.bits(3)) + 1;
      bps = static_cast<int>(br.bits(5)) + 1;
      total_samples = br.bits(36);
      // fields above consume 18 bytes; the rest is md5 (16) + any extension
      for (uint32_t i = 18; i < len; ++i) br.bits(8);
      have_streaminfo = true;
    } else {
      for (uint32_t i = 0; i < len; ++i) br.bits(8);
    }
  }
  if (br.fail || !have_streaminfo || sample_rate == 0) return -1;
  if (out_sr) *out_sr = static_cast<int>(sample_rate);
  if (out == nullptr) return static_cast<int64_t>(total_samples);

  int64_t written = 0;
  std::vector<int64_t> ch[8];
  while (written < max_out && !br.eof()) {
    br.align();
    // frame sync: 0b11111111_111110 + reserved
    const uint32_t sync = static_cast<uint32_t>(br.bits(14));
    if (br.fail) break;
    if (sync != 0x3FFE) break;  // desync: stop at what we have
    br.bits(1);                                    // reserved
    br.bits(1);                                    // blocking strategy
    const int bs_code = static_cast<int>(br.bits(4));
    const int sr_code = static_cast<int>(br.bits(4));
    const int ch_code = static_cast<int>(br.bits(4));
    const int ss_code = static_cast<int>(br.bits(3));
    br.bits(1);  // reserved
    read_coded_number(&br);
    uint32_t block_size;
    if (bs_code == 6) block_size = static_cast<uint32_t>(br.bits(8)) + 1;
    else if (bs_code == 7) block_size = static_cast<uint32_t>(br.bits(16)) + 1;
    else block_size = kBlockSizes[bs_code];
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    int frame_bps = bps;
    switch (ss_code) {  // frame may override STREAMINFO bps
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      case 7: frame_bps = 32; break;
      default: break;
    }
    br.bits(8);  // CRC8 (unverified)
    if (br.fail || block_size == 0) break;

    int n_ch;
    enum { kIndep, kLeftSide, kRightSide, kMidSide } assign = kIndep;
    if (ch_code < 8) {
      n_ch = ch_code + 1;
    } else if (ch_code == 8) {
      n_ch = 2; assign = kLeftSide;
    } else if (ch_code == 9) {
      n_ch = 2; assign = kRightSide;
    } else if (ch_code == 10) {
      n_ch = 2; assign = kMidSide;
    } else {
      break;
    }
    if (n_ch != channels) break;

    bool ok = true;
    for (int c = 0; c < n_ch && ok; ++c) {
      int sub_bps = frame_bps;
      // the side channel carries one extra bit
      if ((assign == kLeftSide && c == 1) || (assign == kRightSide && c == 0) ||
          (assign == kMidSide && c == 1))
        ++sub_bps;
      ok = read_subframe(&br, static_cast<int>(block_size), sub_bps, &ch[c]);
    }
    if (!ok || br.fail) break;
    br.align();
    br.bits(16);  // CRC16 (unverified)

    // undo inter-channel decorrelation, emit channel 0
    const float scale = 1.0f / static_cast<float>(1ll << (frame_bps - 1));
    const int64_t n = std::min<int64_t>(block_size, max_out - written);
    for (int64_t i = 0; i < n; ++i) {
      int64_t v;
      switch (assign) {
        case kLeftSide: v = ch[0][i]; break;                       // left stored
        case kRightSide: v = ch[1][i] + ch[0][i]; break;           // left = right + side
        case kMidSide: {
          const int64_t side = ch[1][i];
          const int64_t mid = (ch[0][i] << 1) | (side & 1);
          v = (mid + side) >> 1;
          break;
        }
        default: v = ch[0][i];
      }
      out[written + i] = static_cast<float>(v) * scale;
    }
    written += n;
  }
  return written > 0 ? written : -1;
}
