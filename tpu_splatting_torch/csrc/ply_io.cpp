// Native PLY point-cloud IO for 3D Gaussian-splatting checkpoints: the
// port's own copy of the repository's csrc/ply_io.cpp, the same code.
//
// Every 3DGS pipeline exchanges scenes as binary-little-endian PLY files
// with ~60 float properties per vertex; parsing multi-hundred-MB files in
// Python is the host-side bottleneck when feeding the card.  This is host
// code, not a kernel: header parse + bulk property de-interleave into
// contiguous per-property arrays, and the reverse for writing.  A vertex
// property that is not a float is an error (the numpy reader of
// tpu_splatting_torch/io/ply.py raises on it too).
//
// Built with g++ at first use and bound through a minimal C ABI with
// ctypes (tpu_splatting_torch/io/ply.py,
// tpu_splatting_torch/utils/cuda_build.py:load_host_library).

#include <cstdint>
#include <cstdio>
#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Header {
  size_t vertex_count = 0;
  size_t data_offset = 0;          // byte offset of the binary payload
  std::vector<std::string> names;  // float property names, in file order
  bool ok = false;
  std::string error;
};

Header parse_header(FILE* f) {
  Header h;
  char line[4096];
  bool in_vertex = false;
  size_t offset = 0;

  while (fgets(line, sizeof(line), f)) {
    offset += strlen(line);
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();

    if (s.rfind("format ", 0) == 0) {
      if (s.find("binary_little_endian") == std::string::npos) {
        h.error = "only binary_little_endian PLY is supported";
        return h;
      }
    } else if (s.rfind("element vertex ", 0) == 0) {
      h.vertex_count = strtoull(s.c_str() + 15, nullptr, 10);
      in_vertex = true;
    } else if (s.rfind("element ", 0) == 0) {
      in_vertex = false;  // later elements (faces etc.) are ignored
    } else if (s.rfind("property ", 0) == 0 && in_vertex) {
      // "property float <name>"
      size_t sp = s.rfind(' ');
      std::string type = s.substr(9, s.find(' ', 9) - 9);
      if (type != "float" && type != "float32") {
        h.error = "non-float vertex property: " + s;
        return h;
      }
      h.names.push_back(s.substr(sp + 1));
    } else if (s == "end_header") {
      h.data_offset = offset;
      h.ok = h.vertex_count > 0 && !h.names.empty();
      if (!h.ok) h.error = "no vertex element found";
      return h;
    }
  }
  h.error = "missing end_header";
  return h;
}

thread_local std::string g_error;

}  // namespace

extern "C" {

// Inspect: returns vertex count and property count; property names are
// written into `names_buf` separated by '\n' (up to names_buf_len bytes).
int64_t ply_inspect(const char* path, int64_t* n_props, char* names_buf,
                    int64_t names_buf_len) {
  FILE* f = fopen(path, "rb");
  if (!f) { g_error = "cannot open file"; return -1; }
  Header h = parse_header(f);
  fclose(f);
  if (!h.ok) { g_error = h.error; return -1; }

  *n_props = static_cast<int64_t>(h.names.size());
  std::string joined;
  for (size_t i = 0; i < h.names.size(); ++i) {
    if (i) joined += '\n';
    joined += h.names[i];
  }
  if (static_cast<int64_t>(joined.size()) + 1 > names_buf_len) {
    g_error = "names buffer too small";
    return -1;
  }
  memcpy(names_buf, joined.c_str(), joined.size() + 1);
  return static_cast<int64_t>(h.vertex_count);
}

// Read all float properties, de-interleaved: out is (n_props, n_vertices)
// row-major (each property contiguous — the layout JAX wants per field).
int64_t ply_read(const char* path, float* out, int64_t out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) { g_error = "cannot open file"; return -1; }
  Header h = parse_header(f);
  if (!h.ok) { fclose(f); g_error = h.error; return -1; }

  const size_t n = h.vertex_count;
  const size_t p = h.names.size();
  if (out_len < static_cast<int64_t>(n * p)) {
    fclose(f); g_error = "output buffer too small"; return -1;
  }

  fseek(f, static_cast<long>(h.data_offset), SEEK_SET);

  // stream in chunks and transpose (interleaved -> per-property)
  const size_t kChunk = 1 << 14;
  std::vector<float> buf(kChunk * p);
  size_t done = 0;
  while (done < n) {
    size_t take = n - done < kChunk ? n - done : kChunk;
    if (fread(buf.data(), sizeof(float) * p, take, f) != take) {
      fclose(f); g_error = "short read"; return -1;
    }
    for (size_t j = 0; j < p; ++j) {
      float* dst = out + j * n + done;
      const float* src = buf.data() + j;
      for (size_t i = 0; i < take; ++i) dst[i] = src[i * p];
    }
    done += take;
  }
  fclose(f);
  return static_cast<int64_t>(n);
}

// Write a binary PLY: props is (n_props, n_vertices) row-major;
// names: '\n'-separated property names.
int64_t ply_write(const char* path, const float* props, int64_t n_vertices,
                  int64_t n_props, const char* names) {
  FILE* f = fopen(path, "wb");
  if (!f) { g_error = "cannot open file for writing"; return -1; }

  fprintf(f, "ply\nformat binary_little_endian 1.0\n");
  fprintf(f, "element vertex %lld\n", static_cast<long long>(n_vertices));
  std::string nm(names);
  size_t start = 0;
  while (start <= nm.size()) {
    size_t end = nm.find('\n', start);
    if (end == std::string::npos) end = nm.size();
    fprintf(f, "property float %s\n", nm.substr(start, end - start).c_str());
    start = end + 1;
  }
  fprintf(f, "end_header\n");

  const size_t kChunk = 1 << 14;
  std::vector<float> buf(kChunk * n_props);
  int64_t done = 0;
  while (done < n_vertices) {
    int64_t take = std::min<int64_t>(kChunk, n_vertices - done);
    for (int64_t j = 0; j < n_props; ++j) {
      const float* src = props + j * n_vertices + done;
      float* dst = buf.data() + j;
      for (int64_t i = 0; i < take; ++i) dst[i * n_props] = src[i];
    }
    if (fwrite(buf.data(), sizeof(float) * n_props, take, f)
        != static_cast<size_t>(take)) {
      fclose(f); g_error = "short write"; return -1;
    }
    done += take;
  }
  fclose(f);
  return n_vertices;
}

const char* ply_last_error() { return g_error.c_str(); }

}  // extern "C"
