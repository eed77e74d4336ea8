// Fast nested-tar indexer for the ImageNet train tar.
//
// The port's copy of csrc/tar_index.cpp, the native path of
// bitdance_tpu_torch/data/imagenet.py::build_flat_index (the reference's
// imagenet_gen/src/dataset.py:41-77): scan the outer tar's
// 512-byte headers, and for each inner <class>.tar member scan its headers
// too, emitting (absolute_offset, size, class_index) per image. Python's
// tarfile walks the same bytes through interpreted code; this does it with
// raw header arithmetic and positioned reads — an order of magnitude faster
// on the ~150GB official tar.
//
// Built by g++ into build/ at first use (data/native.py) and bound with
// ctypes through a C ABI:
//   int64_t bd_build_tar_index(const char* tar_path, const char* out_path)
//     -> number of entries written, or -errno style negative on failure.
// Output format (little-endian): header "BDIX1\0\0\0", int64 n_entries,
// int64 n_classes, then n_entries * {int64 offset, int64 size, int64 cls},
// then n_classes * {int16 len, bytes name} class table (sorted).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr size_t kBlock = 512;

int64_t parse_octal(const char* p, size_t n) {
  // GNU tar also allows base-256 (high bit set)
  if (static_cast<unsigned char>(p[0]) & 0x80) {
    int64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (size_t i = 1; i < n; ++i)
      v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  int64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] == ' ') continue;
    if (p[i] < '0' || p[i] > '7') break;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

struct Entry {
  int64_t offset;
  int64_t size;
  std::string cls;
};

bool is_zero_block(const char* b) {
  for (size_t i = 0; i < kBlock; ++i)
    if (b[i]) return false;
  return true;
}

// Scan one tar stream (via pread at base..base+limit), appending entries.
// inner=true extracts the class prefix from "<cls>_suffix" file names.
bool scan_tar(FILE* f, int64_t base, int64_t limit, bool inner,
              const std::string& inner_cls, std::vector<Entry>* out) {
  char hdr[kBlock];
  int64_t pos = 0;
  int zero_run = 0;
  while (limit < 0 || pos + static_cast<int64_t>(kBlock) <= limit) {
    if (fseeko(f, base + pos, SEEK_SET) != 0) return false;
    if (fread(hdr, 1, kBlock, f) != kBlock) break;
    if (is_zero_block(hdr)) {
      if (++zero_run >= 2) break;
      pos += kBlock;
      continue;
    }
    zero_run = 0;
    char name[101];
    std::memcpy(name, hdr, 100);
    name[100] = '\0';
    int64_t size = parse_octal(hdr + 124, 12);
    char typeflag = hdr[156];
    int64_t data_off = pos + kBlock;
    int64_t padded = (size + kBlock - 1) / kBlock * kBlock;

    bool is_file = (typeflag == '0' || typeflag == '\0');
    std::string nm(name);
    if (is_file) {
      if (!inner && nm.size() > 4 &&
          nm.compare(nm.size() - 4, 4, ".tar") == 0) {
        // inner class tar: derive class from file name, recurse
        std::string cls = nm;
        size_t slash = cls.find_last_of('/');
        if (slash != std::string::npos) cls = cls.substr(slash + 1);
        cls = cls.substr(0, cls.size() - 4);
        if (!scan_tar(f, base + data_off, size, true, cls, out)) return false;
      } else if (inner && !nm.empty()) {
        std::string cls = inner_cls;
        if (cls.empty()) {
          size_t us = nm.find('_');
          cls = (us == std::string::npos) ? nm : nm.substr(0, us);
        }
        out->push_back({base + data_off, size, cls});
      }
    }
    pos = data_off + padded;
  }
  return true;
}

}  // namespace

extern "C" int64_t bd_build_tar_index(const char* tar_path,
                                      const char* out_path) {
  FILE* f = std::fopen(tar_path, "rb");
  if (!f) return -1;
  std::vector<Entry> entries;
  bool ok = scan_tar(f, 0, -1, false, "", &entries);
  std::fclose(f);
  if (!ok) return -2;

  std::map<std::string, int64_t> classes;
  for (const auto& e : entries) classes.emplace(e.cls, 0);
  int64_t idx = 0;
  for (auto& kv : classes) kv.second = idx++;  // std::map is sorted

  FILE* o = std::fopen(out_path, "wb");
  if (!o) return -3;
  const char magic[8] = {'B', 'D', 'I', 'X', '1', 0, 0, 0};
  int64_t n = static_cast<int64_t>(entries.size());
  int64_t nc = static_cast<int64_t>(classes.size());
  std::fwrite(magic, 1, 8, o);
  std::fwrite(&n, 8, 1, o);
  std::fwrite(&nc, 8, 1, o);
  for (const auto& e : entries) {
    int64_t cls = classes[e.cls];
    std::fwrite(&e.offset, 8, 1, o);
    std::fwrite(&e.size, 8, 1, o);
    std::fwrite(&cls, 8, 1, o);
  }
  for (const auto& kv : classes) {
    int16_t len = static_cast<int16_t>(kv.first.size());
    std::fwrite(&len, 2, 1, o);
    std::fwrite(kv.first.data(), 1, len, o);
  }
  std::fclose(o);
  return n;
}
