// Native binary frame IO (host-side data-loader runtime component).
//
// The reference's real-data adapter declares a per-PRT on-disk framing
// (main_test_with_simulated_data.m:58-60: bytesFrameHead=64,
// bytesFrameRealtime=128, bytesFrameEnd=64) and a save_to_bin switch
// (main_test:35), but every function that actually reads or writes the
// .bin stream is missing from the repo (SURVEY.md section 2.4). This file
// defines a concrete little-endian record format around exactly those
// byte counts and implements a fast reader/writer; io/binio.py documents
// the same format and has an explicit numpy reader and writer.
//
// One PRT record =
//   64-byte head   : magic "RDPH", version, prt_index, n_samples,
//                    n_channels, freq_no, fs_hz(f64), prt_s(f64),
//                    servo_angle_deg(f64), iq_scale(f64), payload_bytes
//   payload        : n_samples x n_channels x (int16 I, int16 Q),
//                    channel fastest (row s contiguous), value = round(x /
//                    iq_scale) clipped to int16
//   128-byte block : 16 float64 realtime parameters (opaque to the reader)
//   64-byte end    : magic "RDPE", additive payload checksum (uint32 sum of
//                    payload bytes), record_bytes(u64)
//
// A file is a plain concatenation of PRT records; a "frame" of prtNum PRTs
// is prtNum consecutive records (the caller reshapes).
//
// Build: compiled with the host compiler at first use by
// radar_tpu_torch/_build.py::load_host("binio"); bound in
// radar_tpu_torch/native.py. A copy of radar_tpu/native/binio.cpp.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr uint32_t kHeadMagic = 0x48504452;  // "RDPH"
constexpr uint32_t kEndMagic = 0x45504452;   // "RDPE"
constexpr int64_t kHeadBytes = 64;
constexpr int64_t kRealtimeBytes = 128;
constexpr int64_t kEndBytes = 64;
constexpr int64_t kRealtimeDoubles = kRealtimeBytes / 8;

#pragma pack(push, 1)
struct RecordHead {
  uint32_t magic;
  uint32_t version;
  uint32_t prt_index;
  uint32_t n_samples;
  uint32_t n_channels;
  uint32_t freq_no;
  double fs_hz;
  double prt_s;
  double servo_angle_deg;
  double iq_scale;
  uint32_t payload_bytes;
  uint8_t reserved[4];
};
struct RecordEnd {
  uint32_t magic;
  uint32_t checksum;
  uint64_t record_bytes;
  uint8_t reserved[48];
};
#pragma pack(pop)

static_assert(sizeof(RecordHead) == kHeadBytes, "head must be 64 bytes");
static_assert(sizeof(RecordEnd) == kEndBytes, "end must be 64 bytes");

inline uint32_t payload_checksum(const uint8_t* p, int64_t n) {
  uint32_t s = 0;
  for (int64_t i = 0; i < n; ++i) s += p[i];
  return s;
}

inline int64_t record_bytes(int64_t n_samples, int64_t n_channels) {
  return kHeadBytes + n_samples * n_channels * 4 + kRealtimeBytes + kEndBytes;
}

}  // namespace

extern "C" {

// Reads the first record head and derives the record count from the file
// size. Returns 0, or <0 on error (-1 open, -2 magic/version, -5 size not a
// whole number of records).
int64_t binio_probe(const char* path, int64_t* n_prt, int64_t* n_samples,
                    int64_t* n_channels, int64_t* freq_no) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  RecordHead head;
  if (std::fread(&head, sizeof(head), 1, f) != 1) { std::fclose(f); return -5; }
  if (head.magic != kHeadMagic || head.version != 1) { std::fclose(f); return -2; }
  std::fseek(f, 0, SEEK_END);
  const int64_t size = std::ftell(f);
  std::fclose(f);
  const int64_t rec = record_bytes(head.n_samples, head.n_channels);
  if (rec <= 0 || size % rec != 0) return -5;
  *n_prt = size / rec;
  *n_samples = head.n_samples;
  *n_channels = head.n_channels;
  *freq_no = head.freq_no;
  return 0;
}

// Reads all records into caller buffers: out_iq is float32 interleaved I/Q
// [n_prt, n_samples, n_channels, 2] (already descaled by iq_scale),
// out_realtime float64 [n_prt, 16], out_servo float64 [n_prt]. Dims must
// match binio_probe. Returns 0, or <0 (-1 open, -2 magic, -3 dims, -4
// checksum, -5 short read).
int64_t binio_read(const char* path, float* out_iq, double* out_realtime,
                   double* out_servo, int64_t n_prt, int64_t n_samples,
                   int64_t n_channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const int64_t plane = n_samples * n_channels;
  std::vector<int16_t> buf(plane * 2);
  RecordHead head;
  RecordEnd end;
  for (int64_t m = 0; m < n_prt; ++m) {
    if (std::fread(&head, sizeof(head), 1, f) != 1) { std::fclose(f); return -5; }
    if (head.magic != kHeadMagic) { std::fclose(f); return -2; }
    if ((int64_t)head.n_samples != n_samples ||
        (int64_t)head.n_channels != n_channels ||
        (int64_t)head.payload_bytes != plane * 4) {
      std::fclose(f);
      return -3;
    }
    if (std::fread(buf.data(), 4, plane, f) != (size_t)plane) {
      std::fclose(f);
      return -5;
    }
    double* rt = out_realtime + m * kRealtimeDoubles;
    if (std::fread(rt, 8, kRealtimeDoubles, f) != (size_t)kRealtimeDoubles) {
      std::fclose(f);
      return -5;
    }
    if (std::fread(&end, sizeof(end), 1, f) != 1) { std::fclose(f); return -5; }
    if (end.magic != kEndMagic) { std::fclose(f); return -2; }
    if (end.checksum != payload_checksum(
            reinterpret_cast<const uint8_t*>(buf.data()), plane * 4)) {
      std::fclose(f);
      return -4;
    }
    out_servo[m] = head.servo_angle_deg;
    const float scale = (float)head.iq_scale;
    float* out = out_iq + m * plane * 2;
    for (int64_t i = 0; i < plane * 2; ++i) out[i] = buf[i] * scale;
  }
  std::fclose(f);
  return 0;
}

// Writes n_prt records. iq is float32 interleaved I/Q [n_prt, n_samples,
// n_channels, 2]; values are quantized as round(x / iq_scale) clipped to
// int16. realtime float64 [n_prt, 16] (may carry anything), servo float64
// [n_prt]. Returns 0 or -1 (open/write failure).
int64_t binio_write(const char* path, const float* iq, const double* realtime,
                    const double* servo, int64_t n_prt, int64_t n_samples,
                    int64_t n_channels, int64_t freq_no, double fs_hz,
                    double prt_s, double iq_scale) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const int64_t plane = n_samples * n_channels;
  std::vector<int16_t> buf(plane * 2);
  RecordHead head;
  RecordEnd end;
  std::memset(&head, 0, sizeof(head));
  std::memset(&end, 0, sizeof(end));
  head.magic = kHeadMagic;
  head.version = 1;
  head.n_samples = (uint32_t)n_samples;
  head.n_channels = (uint32_t)n_channels;
  head.freq_no = (uint32_t)freq_no;
  head.fs_hz = fs_hz;
  head.prt_s = prt_s;
  head.iq_scale = iq_scale;
  head.payload_bytes = (uint32_t)(plane * 4);
  end.magic = kEndMagic;
  end.record_bytes = (uint64_t)record_bytes(n_samples, n_channels);
  const double inv = 1.0 / iq_scale;
  for (int64_t m = 0; m < n_prt; ++m) {
    head.prt_index = (uint32_t)m;
    head.servo_angle_deg = servo[m];
    const float* in = iq + m * plane * 2;
    for (int64_t i = 0; i < plane * 2; ++i) {
      double q = std::nearbyint(in[i] * inv);
      if (q > 32767.0) q = 32767.0;
      if (q < -32768.0) q = -32768.0;
      buf[i] = (int16_t)q;
    }
    end.checksum = payload_checksum(
        reinterpret_cast<const uint8_t*>(buf.data()), plane * 4);
    if (std::fwrite(&head, sizeof(head), 1, f) != 1 ||
        std::fwrite(buf.data(), 4, plane, f) != (size_t)plane ||
        std::fwrite(realtime + m * kRealtimeDoubles, 8, kRealtimeDoubles, f)
            != (size_t)kRealtimeDoubles ||
        std::fwrite(&end, sizeof(end), 1, f) != 1) {
      std::fclose(f);
      return -1;
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
