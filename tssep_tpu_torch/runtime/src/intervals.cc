// Interval (RLE activity) kernels for hour-scale recordings:
// bool array <-> intervals, sample<->frame mapping, and the DER frame
// counters — the host-side hot loops of diarization scoring.

#include <cstdint>
#include <algorithm>

extern "C" {

// bool(u8) array -> intervals; returns count (pairs written to out if
// capacity suffices, else returns required count without writing past cap).
int64_t intervals_from_array(const uint8_t* arr, int64_t n,
                             int64_t* out, int64_t cap) {
  int64_t count = 0;
  int64_t i = 0;
  while (i < n) {
    while (i < n && !arr[i]) i++;
    if (i >= n) break;
    int64_t s = i;
    while (i < n && arr[i]) i++;
    if (count < cap) { out[2 * count] = s; out[2 * count + 1] = i; }
    count++;
  }
  return count;
}

void intervals_to_array(const int64_t* intervals, int64_t count,
                        uint8_t* arr, int64_t n) {
  for (int64_t i = 0; i < n; i++) arr[i] = 0;
  for (int64_t k = 0; k < count; k++) {
    int64_t s = std::max<int64_t>(0, intervals[2 * k]);
    int64_t e = std::min<int64_t>(n, intervals[2 * k + 1]);
    for (int64_t i = s; i < e; i++) arr[i] = 1;
  }
}

// Map sample intervals to frame intervals:
// frame = max(0, (s + pad) / shift - (wl/shift - 1) / 2)
void sample_to_frame_intervals(const int64_t* in, int64_t count,
                               int64_t window_length, int64_t shift,
                               int64_t pad, int64_t max_frames,
                               int64_t* out) {
  const int64_t off = (window_length / shift - 1) / 2;
  for (int64_t k = 0; k < count; k++) {
    int64_t fs = (in[2 * k] + pad) / shift - off;
    int64_t fe = (in[2 * k + 1] + pad) / shift - off;
    out[2 * k] = std::max<int64_t>(0, fs);
    out[2 * k + 1] = std::min<int64_t>(max_frames, std::max<int64_t>(0, fe));
  }
}

// DER frame counters with a fixed speaker mapping (hyp speaker k ->
// ref speaker mapping[k], -1 = unmapped).  Activities are (spk, frames)
// row-major u8.  Writes [total, miss, falarm, confusion] into counts.
void der_counts(const uint8_t* ref, int64_t n_ref,
                const uint8_t* hyp, int64_t n_hyp,
                const int64_t* mapping, int64_t frames,
                int64_t* counts) {
  int64_t total = 0, miss = 0, falarm = 0, confusion = 0;
  for (int64_t t = 0; t < frames; t++) {
    int64_t nr = 0, nh = 0, correct = 0;
    for (int64_t s = 0; s < n_ref; s++) nr += ref[s * frames + t];
    for (int64_t s = 0; s < n_hyp; s++) nh += hyp[s * frames + t];
    for (int64_t s = 0; s < n_hyp; s++) {
      int64_t m = mapping[s];
      if (m >= 0 && hyp[s * frames + t] && ref[m * frames + t]) correct++;
    }
    total += nr;
    miss += std::max<int64_t>(0, nr - nh);
    falarm += std::max<int64_t>(0, nh - nr);
    confusion += std::max<int64_t>(0, std::min(nr, nh) - correct);
  }
  counts[0] = total; counts[1] = miss;
  counts[2] = falarm; counts[3] = confusion;
}

// Overlap matrix (n_ref x n_hyp) of frame co-activity, for the optimal
// speaker mapping assignment.
void overlap_matrix(const uint8_t* ref, int64_t n_ref,
                    const uint8_t* hyp, int64_t n_hyp,
                    int64_t frames, int64_t* out) {
  for (int64_t r = 0; r < n_ref; r++) {
    for (int64_t h = 0; h < n_hyp; h++) {
      int64_t acc = 0;
      const uint8_t* pr = ref + r * frames;
      const uint8_t* ph = hyp + h * frames;
      for (int64_t t = 0; t < frames; t++) acc += pr[t] & ph[t];
      out[r * n_hyp + h] = acc;
    }
  }
}

}  // extern "C"
