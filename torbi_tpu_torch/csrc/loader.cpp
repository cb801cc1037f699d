// Native batch loader for observation files (host code, not a kernel).
//
// The port's own copy of the natural-layout loader of
// torbi_tpu/csrc/loader.cpp: it parses .npy observation files and fills a
// zero-padded (batch, max_frames, states) float32 buffer with a thread
// pool, outside the Python interpreter's lock, so that the file pipeline
// keeps the card fed. The buffer may be pinned host memory, which the
// caller then copies to the card without a staging copy.
//
// Plain C interface, bound with ctypes (data/native.py):
//   probe_npy(path, &frames, &states)                         -> 0 on success
//   load_batch(paths, n, out, frames, max_frames, states, threads) -> 0
//
// Only little-endian float32 C-order two-dimensional .npy files (format
// v1/v2) are read; anything else returns an error code, and the caller
// falls back to the Python loader.
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = 1;
constexpr int kErrMagic = 2;
constexpr int kErrHeader = 3;
constexpr int kErrDtype = 4;
constexpr int kErrShape = 5;
constexpr int kErrRead = 6;
constexpr int kErrStates = 7;

struct NpyInfo {
  int64_t frames = 0;
  int64_t states = 0;
};

// Parse the .npy header: magic, version, header length, then a Python dict
// literal {'descr': '<f4', 'fortran_order': False, 'shape': (T, S), }.
// Leaves the file at the start of the payload.
int parse_npy_header(FILE* file, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, file) != 8) return kErrMagic;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return kErrMagic;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char len_bytes[2];
    if (fread(len_bytes, 1, 2, file) != 2) return kErrHeader;
    header_len = len_bytes[0] | (len_bytes[1] << 8);
  } else {
    unsigned char len_bytes[4];
    if (fread(len_bytes, 1, 4, file) != 4) return kErrHeader;
    header_len = len_bytes[0] | (len_bytes[1] << 8) | (len_bytes[2] << 16) |
                 (static_cast<uint32_t>(len_bytes[3]) << 24);
  }
  std::string header(header_len, '\0');
  if (fread(header.data(), 1, header_len, file) != header_len)
    return kErrHeader;

  if (header.find("'<f4'") == std::string::npos &&
      header.find("\"<f4\"") == std::string::npos)
    return kErrDtype;
  if (header.find("'fortran_order': False") == std::string::npos)
    return kErrDtype;

  size_t shape_pos = header.find("'shape':");
  if (shape_pos == std::string::npos) return kErrShape;
  size_t open = header.find('(', shape_pos);
  size_t close = header.find(')', shape_pos);
  if (open == std::string::npos || close == std::string::npos)
    return kErrShape;
  std::string shape = header.substr(open + 1, close - open - 1);
  // Exactly two dimensions: reject N-D tuples instead of reading the first
  // two numbers (e.g. a (1, T, S) batch-leading save)
  long long frames = 0, states = 0;
  int consumed = 0;
  if (sscanf(shape.c_str(), " %lld , %lld %n", &frames, &states,
             &consumed) != 2)
    return kErrShape;
  for (size_t i = consumed; i < shape.size(); ++i) {
    char c = shape[i];
    if (c != ' ' && c != ',') return kErrShape;
  }
  info->frames = frames;
  info->states = states;
  return kOk;
}

// Read one file into its (max_frames, states) row of the batch and zero
// the frames past its length (padded frames are masked by batch_frames)
int load_one(const char* path, float* out_row, int32_t* frames_out,
             int64_t max_frames, int64_t states) {
  FILE* file = fopen(path, "rb");
  if (!file) return kErrOpen;
  NpyInfo info;
  int status = parse_npy_header(file, &info);
  if (status != kOk) {
    fclose(file);
    return status;
  }
  // The file may have changed since it was probed
  if (info.states != states || info.frames > max_frames) {
    fclose(file);
    return kErrStates;
  }
  size_t count = static_cast<size_t>(info.frames) * states;
  if (fread(out_row, sizeof(float), count, file) != count) {
    fclose(file);
    return kErrRead;
  }
  fclose(file);
  size_t total = static_cast<size_t>(max_frames) * states;
  memset(out_row + count, 0, (total - count) * sizeof(float));
  *frames_out = static_cast<int32_t>(info.frames);
  return kOk;
}

}  // namespace

extern "C" {

// Read just the shape of one .npy file
int probe_npy(const char* path, int64_t* frames, int64_t* states) {
  FILE* file = fopen(path, "rb");
  if (!file) return kErrOpen;
  NpyInfo info;
  int status = parse_npy_header(file, &info);
  fclose(file);
  if (status != kOk) return status;
  *frames = info.frames;
  *states = info.states;
  return kOk;
}

// Load n files into a zero-padded (n, max_frames, states) float32 buffer
// with a pool of threads; frames[i] receives file i's frame count.
// Returns 0 on success, else the first error code met.
int load_batch(const char** paths, int64_t n, float* out, int32_t* frames,
               int64_t max_frames, int64_t states, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int> error(kOk);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n || error.load() != kOk) return;
      float* row = out + i * max_frames * states;
      int status = load_one(paths[i], row, frames + i, max_frames, states);
      if (status != kOk) {
        int expected = kOk;
        error.compare_exchange_strong(expected, status);
        return;
      }
    }
  };
  std::vector<std::thread> threads;
  int spawn = static_cast<int>(
      n < static_cast<int64_t>(num_threads) ? n : num_threads);
  threads.reserve(spawn);
  for (int i = 0; i < spawn; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return error.load();
}

}  // extern "C"
