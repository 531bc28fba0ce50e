// Binary PLY vertex-table reader for Gaussian-splat scans (host code).
//
// A copy of the JAX package's native reader, kept in the port so that the
// port builds it from its own sources. The header is parsed once and the
// body is streamed straight into a caller-provided (n_verts, n_props)
// float32 matrix: one fread, or row chunks widened in place when a
// property is f64. Built at first use by utils/ply.py with
// ``g++ -O3 -fPIC -shared`` into the package's _build/ directory and
// loaded through ctypes.
//
// C ABI:
//   ply_probe(path, &n_verts, &n_props, names, names_cap) -> 0 on success
//   ply_read(path, out /* n_verts*n_props f32 */)          -> 0 on success
// Only binary_little_endian files with scalar float/double vertex
// properties are handled; ply_probe returns nonzero for anything else,
// and utils/ply.py reads such a file with its numpy reader.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Header {
    long n_verts = 0;
    std::vector<std::string> names;
    std::vector<int> sizes;          // bytes per property (4 or 8)
    long body_offset = 0;
    long skip_before = 0;            // bytes of earlier elements to skip
    bool ok = false;
};

Header parse_header(const char* path) {
    Header h;
    FILE* f = std::fopen(path, "rb");
    if (!f) return h;
    char line[512];
    if (!std::fgets(line, sizeof line, f) || std::strncmp(line, "ply", 3)) {
        std::fclose(f);
        return h;
    }
    bool little = false;
    bool in_vertex = false;
    bool seen_vertex = false;
    long cur_count = 0;
    long cur_row = 0;
    while (std::fgets(line, sizeof line, f)) {
        std::string s(line);
        if (s.rfind("format", 0) == 0) {
            little = s.find("binary_little_endian") != std::string::npos;
        } else if (s.rfind("element", 0) == 0) {
            if (in_vertex) in_vertex = false;  // vertex section ended
            char name[128];
            long count;
            if (std::sscanf(line, "element %127s %ld", name, &count) == 2) {
                if (std::strcmp(name, "vertex") == 0) {
                    in_vertex = true;
                    seen_vertex = true;
                    h.n_verts = count;
                } else if (!seen_vertex) {
                    cur_count = count;
                    cur_row = 0;  // accumulated below from properties
                }
            }
        } else if (s.rfind("property", 0) == 0) {
            char type[64], name[128];
            if (std::sscanf(line, "property %63s %127s", type, name) != 2)
                continue;
            if (std::strcmp(type, "list") == 0) {
                std::fclose(f);
                return h;  // unsupported
            }
            int size = 0;
            if (!std::strcmp(type, "float") || !std::strcmp(type, "float32") ||
                !std::strcmp(type, "int") || !std::strcmp(type, "int32") ||
                !std::strcmp(type, "uint") || !std::strcmp(type, "uint32"))
                size = 4;
            else if (!std::strcmp(type, "double") || !std::strcmp(type, "float64"))
                size = 8;
            else if (!std::strcmp(type, "short") || !std::strcmp(type, "ushort"))
                size = 2;
            else if (!std::strcmp(type, "char") || !std::strcmp(type, "uchar") ||
                     !std::strcmp(type, "int8") || !std::strcmp(type, "uint8"))
                size = 1;
            else {
                std::fclose(f);
                return h;
            }
            if (in_vertex) {
                // only float32/float64 handled in the fast path
                if (size != 4 && size != 8 &&
                    std::strncmp(type, "float", 5) && std::strncmp(type, "double", 6)) {
                    std::fclose(f);
                    return h;
                }
                h.names.emplace_back(name);
                h.sizes.push_back(size);
            } else if (!seen_vertex) {
                cur_row += size;
            }
        } else if (s.rfind("end_header", 0) == 0) {
            h.body_offset = std::ftell(f);
            h.skip_before = cur_count * cur_row;
            h.ok = little && seen_vertex && !h.names.empty();
            break;
        }
    }
    std::fclose(f);
    return h;
}

}  // namespace

extern "C" {

int ply_probe(const char* path, long* n_verts, int* n_props,
              char* names, long names_cap) {
    Header h = parse_header(path);
    if (!h.ok) return 1;
    *n_verts = h.n_verts;
    *n_props = static_cast<int>(h.names.size());
    std::string joined;
    for (size_t i = 0; i < h.names.size(); ++i) {
        if (i) joined += ',';
        joined += h.names[i];
    }
    if (static_cast<long>(joined.size()) + 1 > names_cap) return 2;
    std::memcpy(names, joined.c_str(), joined.size() + 1);
    return 0;
}

int ply_read(const char* path, float* out) {
    Header h = parse_header(path);
    if (!h.ok) return 1;
    const int p = static_cast<int>(h.names.size());
    long row_bytes = 0;
    bool all_f32 = true;
    for (int s : h.sizes) {
        row_bytes += s;
        if (s != 4) all_f32 = false;
    }

    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    if (std::fseek(f, h.body_offset + h.skip_before, SEEK_SET)) {
        std::fclose(f);
        return 1;
    }

    if (all_f32) {
        const size_t want = static_cast<size_t>(h.n_verts) * p;
        const size_t got = std::fread(out, sizeof(float), want, f);
        std::fclose(f);
        return got == want ? 0 : 1;
    }

    // mixed f32/f64 rows: stream row-chunks and widen
    const long CHUNK = 8192;
    std::vector<unsigned char> buf(static_cast<size_t>(CHUNK) * row_bytes);
    long done = 0;
    while (done < h.n_verts) {
        const long take = std::min(CHUNK, h.n_verts - done);
        const size_t got = std::fread(buf.data(), row_bytes, take, f);
        if (static_cast<long>(got) != take) {
            std::fclose(f);
            return 1;
        }
        for (long r = 0; r < take; ++r) {
            const unsigned char* src = buf.data() + r * row_bytes;
            float* dst = out + (done + r) * p;
            for (int c = 0; c < p; ++c) {
                if (h.sizes[c] == 4) {
                    float v;
                    std::memcpy(&v, src, 4);
                    dst[c] = v;
                    src += 4;
                } else {
                    double v;
                    std::memcpy(&v, src, 8);
                    dst[c] = static_cast<float>(v);
                    src += 8;
                }
            }
        }
        done += take;
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
