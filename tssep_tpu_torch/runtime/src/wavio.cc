// WAV (RIFF) codec: PCM16 / PCM24 / PCM32 / IEEE float32, N channels.
// Host-side audio I/O for the data loader — zero-dependency C++,
// exposed to Python via ctypes (tssep_tpu_torch/runtime/native.py).
//
// All functions return 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {

struct WavInfo {
  int32_t channels;
  int32_t sample_rate;
  int64_t num_frames;    // samples per channel
  int32_t bits;          // 16/24/32
  int32_t is_float;      // 1 if IEEE float
};

static int read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n ? 0 : -1;
}

// Parse header; on success fills info and leaves the file positioned at the
// start of sample data (internal use via wav_read).
static int wav_open(FILE* f, WavInfo* info, long* data_pos, int64_t* data_len) {
  char tag[4];
  uint32_t sz;
  if (read_exact(f, tag, 4) || memcmp(tag, "RIFF", 4)) return -2;
  if (read_exact(f, &sz, 4)) return -2;
  if (read_exact(f, tag, 4) || memcmp(tag, "WAVE", 4)) return -2;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool have_fmt = false;
  while (true) {
    if (read_exact(f, tag, 4) || read_exact(f, &sz, 4)) return -3;
    if (!memcmp(tag, "fmt ", 4)) {
      uint8_t buf[64];
      if (sz > sizeof(buf)) return -4;
      if (read_exact(f, buf, sz)) return -4;
      fmt = *(uint16_t*)(buf + 0);
      channels = *(uint16_t*)(buf + 2);
      sample_rate = *(uint32_t*)(buf + 4);
      bits = *(uint16_t*)(buf + 14);
      if (fmt == 0xFFFE && sz >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        fmt = *(uint16_t*)(buf + 24);
      }
      have_fmt = true;
    } else if (!memcmp(tag, "data", 4)) {
      if (!have_fmt) return -5;
      if (fmt != 1 && fmt != 3) return -6;  // PCM or IEEE float
      info->channels = channels;
      info->sample_rate = (int32_t)sample_rate;
      info->bits = bits;
      info->is_float = fmt == 3;
      info->num_frames = (int64_t)sz / (channels * (bits / 8));
      *data_pos = ftell(f);
      *data_len = sz;
      return 0;
    } else {
      if (fseek(f, (long)((sz + 1) & ~1u), SEEK_CUR)) return -7;
      continue;
    }
  }
}

int wav_info(const char* path, WavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long pos; int64_t len;
  int rc = wav_open(f, info, &pos, &len);
  fclose(f);
  return rc;
}

// Read samples [start, start+count) frames into out (float32, interleaved
// frame-major: out[frame * channels + ch]).  count<0 -> to the end.
int wav_read(const char* path, float* out, int64_t start, int64_t count) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  long pos; int64_t len;
  int rc = wav_open(f, &info, &pos, &len);
  if (rc) { fclose(f); return rc; }
  if (count < 0) count = info.num_frames - start;
  if (start < 0 || start + count > info.num_frames) { fclose(f); return -8; }
  const int bytes = info.bits / 8;
  const int64_t n_vals = count * info.channels;
  if (fseek(f, pos + (long)(start * info.channels * bytes), SEEK_SET)) {
    fclose(f); return -9;
  }
  std::vector<uint8_t> raw((size_t)(n_vals * bytes));
  if (read_exact(f, raw.data(), raw.size())) { fclose(f); return -10; }
  fclose(f);

  if (info.is_float && info.bits == 32) {
    memcpy(out, raw.data(), (size_t)n_vals * 4);
  } else if (info.bits == 16) {
    const int16_t* p = (const int16_t*)raw.data();
    for (int64_t i = 0; i < n_vals; i++) out[i] = p[i] / 32768.0f;
  } else if (info.bits == 32) {
    const int32_t* p = (const int32_t*)raw.data();
    for (int64_t i = 0; i < n_vals; i++) out[i] = (float)(p[i] / 2147483648.0);
  } else if (info.bits == 24) {
    const uint8_t* p = raw.data();
    for (int64_t i = 0; i < n_vals; i++) {
      int32_t v = (p[3 * i] << 8) | (p[3 * i + 1] << 16) | (p[3 * i + 2] << 24);
      out[i] = (float)(v / 2147483648.0);
    }
  } else {
    return -11;
  }
  return 0;
}

// Write float32 interleaved samples as PCM16 (clipping) or float32 WAV.
int wav_write(const char* path, const float* data, int64_t num_frames,
              int32_t channels, int32_t sample_rate, int32_t as_float) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const int bytes = as_float ? 4 : 2;
  const uint32_t data_sz = (uint32_t)(num_frames * channels * bytes);
  uint32_t riff_sz = 36 + data_sz;
  uint16_t fmt = as_float ? 3 : 1;
  uint16_t bits = as_float ? 32 : 16;
  uint32_t byte_rate = sample_rate * channels * bytes;
  uint16_t block_align = (uint16_t)(channels * bytes);

  fwrite("RIFF", 1, 4, f); fwrite(&riff_sz, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  uint32_t fmt_sz = 16; fwrite(&fmt_sz, 4, 1, f);
  fwrite(&fmt, 2, 1, f);
  uint16_t ch16 = (uint16_t)channels; fwrite(&ch16, 2, 1, f);
  uint32_t sr = (uint32_t)sample_rate; fwrite(&sr, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block_align, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f); fwrite(&data_sz, 4, 1, f);

  const int64_t n = num_frames * channels;
  if (as_float) {
    fwrite(data, 4, (size_t)n, f);
  } else {
    std::vector<int16_t> buf((size_t)n);
    for (int64_t i = 0; i < n; i++) {
      float v = data[i];
      if (v > 0.999969f) v = 0.999969f;
      if (v < -1.0f) v = -1.0f;
      buf[(size_t)i] = (int16_t)(v * 32768.0f);
    }
    fwrite(buf.data(), 2, (size_t)n, f);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
