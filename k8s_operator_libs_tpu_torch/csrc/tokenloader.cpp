// Native token-data loader: mmap-backed token store + batch gather.
//
// The hot path of input pipelines is "gather B windows of T tokens from a
// multi-GB corpus into a contiguous host buffer" — work that in Python costs
// a per-sequence slice + copy under the GIL. Here it is one C++ loop over a
// memory-mapped file (page cache does the IO), called from Python via ctypes
// with zero per-batch allocations (the caller owns the output buffer).
//
// File format: 8-byte header — magic "TOKS" + uint32 elem_size (2 = uint16,
// 4 = int32) — followed by raw little-endian tokens. Headerless files are
// accepted with the caller-supplied elem_size (raw mode). Output is always
// int32 (what embedding lookups take).
//
// A copy of the JAX package's csrc/tokenloader.cpp for the PyTorch port:
// data/loader.py builds it with `g++ -O3 -shared -fPIC` at first use into
// build/torch_kernels/ (the file name carries a hash of this source) and
// loads it with ctypes.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Store {
  void* map = nullptr;
  size_t map_bytes = 0;
  const char* data = nullptr;  // payload start (past header if present)
  size_t bytes = 0;            // payload bytes
  int elem_size = 4;           // 2 or 4
  int fd = -1;
};

constexpr char kMagic[4] = {'T', 'O', 'K', 'S'};

}  // namespace

extern "C" {

// Open a token file; elem_size is 2 (uint16) or 4 (int32).
// Returns nullptr on failure.
void* tl_open(const char* path, int elem_size) {
  if (elem_size != 2 && elem_size != 4) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ::madvise(base, st.st_size, MADV_WILLNEED);
  Store* s = new Store();
  s->map = base;
  s->map_bytes = static_cast<size_t>(st.st_size);
  s->data = static_cast<const char*>(base);
  s->bytes = s->map_bytes;
  s->elem_size = elem_size;
  s->fd = fd;
  if (s->map_bytes >= 8 && std::memcmp(base, kMagic, 4) == 0) {
    uint32_t hdr_elem;
    std::memcpy(&hdr_elem, static_cast<const char*>(base) + 4, 4);
    if (hdr_elem == 2 || hdr_elem == 4) {
      s->elem_size = static_cast<int>(hdr_elem);
      s->data += 8;
      s->bytes -= 8;
    }
  }
  return s;
}

long tl_num_tokens(void* handle) {
  if (!handle) return -1;
  Store* s = static_cast<Store*>(handle);
  return static_cast<long>(s->bytes / s->elem_size);
}

// Gather batch sequences: out[b, :] = tokens[offsets[b] : offsets[b]+seqlen]
// (int32). Returns 0 on success, -1 on out-of-range offsets.
int tl_fill_batch(void* handle, const long* offsets, int batch, int seqlen,
                  int32_t* out) {
  if (!handle) return -1;
  Store* s = static_cast<Store*>(handle);
  const long n = static_cast<long>(s->bytes / s->elem_size);
  for (int b = 0; b < batch; ++b) {
    const long off = offsets[b];
    if (off < 0 || off + seqlen > n) return -1;
    int32_t* dst = out + static_cast<long>(b) * seqlen;
    if (s->elem_size == 4) {
      std::memcpy(dst, reinterpret_cast<const int32_t*>(s->data) + off,
                  static_cast<size_t>(seqlen) * 4);
    } else {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(s->data) + off;
      for (int t = 0; t < seqlen; ++t) dst[t] = static_cast<int32_t>(src[t]);
    }
  }
  return 0;
}

void tl_close(void* handle) {
  if (!handle) return;
  Store* s = static_cast<Store*>(handle);
  ::munmap(s->map, s->map_bytes);
  ::close(s->fd);
  delete s;
}

}  // extern "C"
