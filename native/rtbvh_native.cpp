// rtbvh native runtime: asset I/O (OBJ+MTL loader, BMP reader/writer).
//
// Counterpart of the reference's native asset layer
// (reference: ObjectFileLoader.cpp:212-468 Load_Geometry, :77-210
// Material_File; SaveBMP.cpp:3-62; Image.cpp:35-61 loadImage).  The
// reference parses OBJ/MTL and decodes images in C++ before uploading to
// the GPU; here the same work happens in C++ before jax.device_put.
// Exposed as a plain C ABI consumed from Python via ctypes
// (raytracebvh_tpu/native.py) — no pybind11 dependency.
//
// Semantics intentionally match raytracebvh_tpu/io/obj.py (the Python
// fallback) exactly:
//   * triangulated `f v/t/n` faces only
//   * vertex dedup by the full (position, normal, uv) triple — NOT the
//     reference's position-only map with its broken z-compare
//     (Helper.h:13,18, SURVEY.md Q8)
//   * texture v flipped to 1-v at parse time (DirectX top-left space)
//   * MTL fields Ka/Kd/Ks/Ns/Ni/d/Tr/map_Kd with Base_Mat defaults
//     (reference: ObjectFileLoader.cpp:66-75)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#if defined(_WIN32)
#define RTBVH_API extern "C" __declspec(dllexport)
#else
#define RTBVH_API extern "C" __attribute__((visibility("default")))
#endif

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct Material {
  std::string name;
  // Base_Mat defaults (reference: ObjectFileLoader.cpp:66-75)
  float ambient[4] = {0.2f, 0.2f, 0.2f, 1.0f};
  float diffuse[4] = {0.8f, 0.8f, 0.8f, 1.0f};
  float specular[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  float shininess = 0.0f;
  float optical_density = 0.0f;
  float alpha = 1.0f;
  std::string texture_path;
};

// Dedup key: position(3) + normal(3) + uv(2), hashed bytewise.
struct VKey {
  float f[8];
  bool operator==(const VKey& o) const {
    return std::memcmp(f, o.f, sizeof(f)) == 0;
  }
};

struct VKeyHash {
  size_t operator()(const VKey& k) const {
    // FNV-1a over the raw bytes
    const unsigned char* p = reinterpret_cast<const unsigned char*>(k.f);
    size_t h = 1469598103934665603ull;
    for (size_t i = 0; i < sizeof(k.f); ++i) {
      h ^= p[i];
      h *= 1099511628211ull;
    }
    return h;
  }
};

std::string dirname_of(const std::string& path) {
  size_t s = path.find_last_of("/\\");
  return s == std::string::npos ? std::string() : path.substr(0, s + 1);
}

// Split a line into whitespace tokens.
std::vector<std::string> tokens_of(const std::string& line) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < line.size()) {
    while (i < line.size() && std::isspace((unsigned char)line[i])) ++i;
    size_t j = i;
    while (j < line.size() && !std::isspace((unsigned char)line[j])) ++j;
    if (j > i) out.push_back(line.substr(i, j - i));
    i = j;
  }
  return out;
}

std::string rest_after(const std::string& line, size_t ntok) {
  // Join of tokens [ntok:] with single spaces — mirrors Python's
  // " ".join(tok[n:]) used for material names / file names.
  auto tok = tokens_of(line);
  std::string out;
  for (size_t i = ntok; i < tok.size(); ++i) {
    if (!out.empty()) out += ' ';
    out += tok[i];
  }
  return out;
}

}  // namespace

struct RtbvhObj {
  std::vector<float> positions;  // [nv*3] deduped
  std::vector<float> normals;    // [nv*3]
  std::vector<float> uv;         // [nv*2]
  std::vector<int32_t> indices;  // [ni]
  std::vector<int32_t> mat_index;  // [nf]
  std::vector<Material> materials;
  std::vector<float> mat_flat;   // [nm*15] ambient4|diffuse4|specular4|Ns|Ni|d
};

namespace {

void parse_mtl(const std::string& path, std::vector<Material>* mats) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    // reference prints and continues (ObjectFileLoader.cpp:208)
    std::fprintf(stderr, "warning: cannot find material file %s\n",
                 path.c_str());
    return;
  }
  std::string dir = dirname_of(path);
  char buf[4096];
  Material* cur = nullptr;
  while (std::fgets(buf, sizeof(buf), f)) {
    std::string line(buf);
    auto tok = tokens_of(line);
    if (tok.empty()) continue;
    const std::string& key = tok[0];
    if (key == "newmtl") {
      mats->emplace_back();
      cur = &mats->back();
      cur->name = rest_after(line, 1);
    } else if (!cur) {
      continue;
    } else if (key == "Ka" && tok.size() >= 4) {
      for (int i = 0; i < 3; ++i) cur->ambient[i] = (float)std::strtod(tok[1 + i].c_str(), nullptr);
    } else if (key == "Kd" && tok.size() >= 4) {
      for (int i = 0; i < 3; ++i) cur->diffuse[i] = (float)std::strtod(tok[1 + i].c_str(), nullptr);
    } else if (key == "Ks" && tok.size() >= 4) {
      for (int i = 0; i < 3; ++i) cur->specular[i] = (float)std::strtod(tok[1 + i].c_str(), nullptr);
    } else if (key == "Ns" && tok.size() >= 2) {
      cur->shininess = (float)std::strtod(tok[1].c_str(), nullptr);
    } else if (key == "Ni" && tok.size() >= 2) {
      cur->optical_density = (float)std::strtod(tok[1].c_str(), nullptr);
    } else if ((key == "d" || key == "Tr") && tok.size() >= 2) {
      cur->alpha = (float)std::strtod(tok[1].c_str(), nullptr);
    } else if (key == "map_Kd" && tok.size() >= 2) {
      cur->texture_path = dir + rest_after(line, 1);
    }
  }
  std::fclose(f);
}

// Parse "v/t/n" with optional t and n (1-based; 0 = absent).
bool parse_corner(const std::string& s, long* v, long* t, long* n) {
  const char* p = s.c_str();
  char* end = nullptr;
  *v = std::strtol(p, &end, 10);
  if (end == p) return false;
  *t = 0;
  *n = 0;
  if (*end == '/') {
    p = end + 1;
    if (*p != '/') {
      *t = std::strtol(p, &end, 10);
      if (end == p) return false;
    } else {
      end = const_cast<char*>(p);
    }
    if (*end == '/') {
      p = end + 1;
      *n = std::strtol(p, &end, 10);
      if (end == p) return false;
    }
  }
  return true;
}

}  // namespace

RTBVH_API const char* rtbvh_last_error() { return g_error.c_str(); }

RTBVH_API RtbvhObj* rtbvh_obj_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return nullptr;
  }
  std::string dir = dirname_of(path);

  std::vector<float> raw_pos, raw_nrm;  // file-order pools
  std::vector<double> raw_uv;  // double: the v-flip happens pre-f32-cast
                               // to match the Python loader bit-exactly
  auto obj = new RtbvhObj();
  std::unordered_map<VKey, int32_t, VKeyHash> dedup;
  int32_t cur_mat = 0;

  char buf[8192];
  long lineno = 0;
  while (std::fgets(buf, sizeof(buf), f)) {
    ++lineno;
    std::string line(buf);
    auto tok = tokens_of(line);
    if (tok.empty()) continue;
    const std::string& key = tok[0];
    if (key == "mtllib") {
      parse_mtl(dir + rest_after(line, 1), &obj->materials);
    } else if (key == "v" && tok.size() >= 4) {
      for (int i = 0; i < 3; ++i)
        raw_pos.push_back((float)std::strtod(tok[1 + i].c_str(), nullptr));
    } else if (key == "vn" && tok.size() >= 4) {
      for (int i = 0; i < 3; ++i)
        raw_nrm.push_back((float)std::strtod(tok[1 + i].c_str(), nullptr));
    } else if (key == "vt" && tok.size() >= 3) {
      raw_uv.push_back(std::strtod(tok[1].c_str(), nullptr));
      raw_uv.push_back(std::strtod(tok[2].c_str(), nullptr));
    } else if (key == "usemtl") {
      std::string name = rest_after(line, 1);
      for (size_t i = 0; i < obj->materials.size(); ++i) {
        if (obj->materials[i].name == name) {
          cur_mat = (int32_t)i;
          break;
        }
      }
    } else if (key == "f") {
      if (tok.size() != 4) {
        set_error(std::string(path) + ":" + std::to_string(lineno) +
                  ": non-triangle face with " +
                  std::to_string(tok.size() - 1) + " verts");
        std::fclose(f);
        delete obj;
        return nullptr;
      }
      for (int c = 1; c <= 3; ++c) {
        long vi, ti, ni;
        if (!parse_corner(tok[c], &vi, &ti, &ni) || vi < 1 ||
            (size_t)(vi * 3) > raw_pos.size() ||
            (ni > 0 && (size_t)(ni * 3) > raw_nrm.size()) ||
            (ti > 0 && (size_t)(ti * 2) > raw_uv.size())) {
          set_error(std::string(path) + ":" + std::to_string(lineno) +
                    ": bad face corner '" + tok[c] + "'");
          std::fclose(f);
          delete obj;
          return nullptr;
        }
        VKey k;
        std::memcpy(k.f, &raw_pos[(vi - 1) * 3], 3 * sizeof(float));
        if (ni > 0) {
          std::memcpy(k.f + 3, &raw_nrm[(ni - 1) * 3], 3 * sizeof(float));
        } else {
          k.f[3] = k.f[4] = k.f[5] = 0.0f;
        }
        if (ti > 0) {
          k.f[6] = (float)raw_uv[(ti - 1) * 2];
          k.f[7] = (float)(1.0 - raw_uv[(ti - 1) * 2 + 1]);  // DirectX v-flip
        } else {
          k.f[6] = k.f[7] = 0.0f;
        }
        auto it = dedup.find(k);
        int32_t idx;
        if (it == dedup.end()) {
          idx = (int32_t)(obj->positions.size() / 3);
          dedup.emplace(k, idx);
          obj->positions.insert(obj->positions.end(), k.f, k.f + 3);
          obj->normals.insert(obj->normals.end(), k.f + 3, k.f + 6);
          obj->uv.insert(obj->uv.end(), k.f + 6, k.f + 8);
        } else {
          idx = it->second;
        }
        obj->indices.push_back(idx);
      }
      obj->mat_index.push_back(cur_mat);
    }
  }
  std::fclose(f);

  if (obj->materials.empty()) {
    obj->materials.emplace_back();
    obj->materials.back().name = "Base_Mat";
  }
  obj->mat_flat.reserve(obj->materials.size() * 15);
  for (const auto& m : obj->materials) {
    obj->mat_flat.insert(obj->mat_flat.end(), m.ambient, m.ambient + 4);
    obj->mat_flat.insert(obj->mat_flat.end(), m.diffuse, m.diffuse + 4);
    obj->mat_flat.insert(obj->mat_flat.end(), m.specular, m.specular + 4);
    obj->mat_flat.push_back(m.shininess);
    obj->mat_flat.push_back(m.optical_density);
    obj->mat_flat.push_back(m.alpha);
  }
  return obj;
}

RTBVH_API void rtbvh_obj_free(RtbvhObj* o) { delete o; }

RTBVH_API int32_t rtbvh_obj_num_verts(const RtbvhObj* o) {
  return (int32_t)(o->positions.size() / 3);
}
RTBVH_API int32_t rtbvh_obj_num_indices(const RtbvhObj* o) {
  return (int32_t)o->indices.size();
}
RTBVH_API int32_t rtbvh_obj_num_faces(const RtbvhObj* o) {
  return (int32_t)o->mat_index.size();
}
RTBVH_API int32_t rtbvh_obj_num_materials(const RtbvhObj* o) {
  return (int32_t)o->materials.size();
}
RTBVH_API const float* rtbvh_obj_positions(const RtbvhObj* o) {
  return o->positions.data();
}
RTBVH_API const float* rtbvh_obj_normals(const RtbvhObj* o) {
  return o->normals.data();
}
RTBVH_API const float* rtbvh_obj_uv(const RtbvhObj* o) { return o->uv.data(); }
RTBVH_API const int32_t* rtbvh_obj_indices(const RtbvhObj* o) {
  return o->indices.data();
}
RTBVH_API const int32_t* rtbvh_obj_mat_index(const RtbvhObj* o) {
  return o->mat_index.data();
}
// Per material, 15 floats: ambient[4] diffuse[4] specular[4] Ns Ni alpha.
RTBVH_API const float* rtbvh_obj_materials(const RtbvhObj* o) {
  return o->mat_flat.data();
}
RTBVH_API const char* rtbvh_obj_material_name(const RtbvhObj* o, int32_t i) {
  if (i < 0 || (size_t)i >= o->materials.size()) return "";
  return o->materials[i].name.c_str();
}
RTBVH_API const char* rtbvh_obj_texture_path(const RtbvhObj* o, int32_t i) {
  if (i < 0 || (size_t)i >= o->materials.size()) return "";
  return o->materials[i].texture_path.c_str();
}

// ---------------------------------------------------------------------------
// BMP read/write (24-bit BI_RGB, bottom-up — the format the reference both
// writes (SaveBMP.cpp:13-36) and ships textures in (Obj/Balls.bmp)).

RTBVH_API int32_t rtbvh_write_bmp(const char* path, int32_t w, int32_t h,
                                  const uint8_t* rgb) {
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    set_error(std::string("cannot open for write: ") + path);
    return 0;
  }
  int32_t row = (w * 3 + 3) & ~3;  // 4-byte padded rows
  uint32_t data_size = (uint32_t)(row * h);
  uint32_t off = 14 + 40;
  uint32_t file_size = off + data_size;
  uint8_t hdr[54] = {0};
  hdr[0] = 'B';
  hdr[1] = 'M';
  std::memcpy(hdr + 2, &file_size, 4);
  std::memcpy(hdr + 10, &off, 4);
  uint32_t ihsz = 40;
  std::memcpy(hdr + 14, &ihsz, 4);
  std::memcpy(hdr + 18, &w, 4);
  std::memcpy(hdr + 22, &h, 4);
  uint16_t planes = 1, bpp = 24;
  std::memcpy(hdr + 26, &planes, 2);
  std::memcpy(hdr + 28, &bpp, 2);
  std::memcpy(hdr + 34, &data_size, 4);
  uint32_t ppm = 2835;  // 72 dpi, matches io/bmp.py byte-for-byte
  std::memcpy(hdr + 38, &ppm, 4);
  std::memcpy(hdr + 42, &ppm, 4);
  std::fwrite(hdr, 1, 54, f);
  std::vector<uint8_t> line(row, 0);
  for (int32_t y = h - 1; y >= 0; --y) {  // bottom-up
    const uint8_t* src = rgb + (size_t)y * w * 3;
    for (int32_t x = 0; x < w; ++x) {  // RGB -> BGR
      line[x * 3 + 0] = src[x * 3 + 2];
      line[x * 3 + 1] = src[x * 3 + 1];
      line[x * 3 + 2] = src[x * 3 + 0];
    }
    std::fwrite(line.data(), 1, row, f);
  }
  std::fclose(f);
  return 1;
}

RTBVH_API uint8_t* rtbvh_read_bmp(const char* path, int32_t* out_w,
                                  int32_t* out_h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return nullptr;
  }
  uint8_t hdr[54];
  if (std::fread(hdr, 1, 54, f) != 54 || hdr[0] != 'B' || hdr[1] != 'M') {
    set_error("not a BMP file");
    std::fclose(f);
    return nullptr;
  }
  uint32_t off;
  int32_t w, h;
  uint16_t bpp;
  std::memcpy(&off, hdr + 10, 4);
  std::memcpy(&w, hdr + 18, 4);
  std::memcpy(&h, hdr + 22, 4);
  std::memcpy(&bpp, hdr + 28, 2);
  uint32_t comp;
  std::memcpy(&comp, hdr + 30, 4);
  bool flip = h >= 0;  // positive height = bottom-up rows
  if (h < 0) h = -h;
  if ((bpp != 24 && bpp != 32) || comp != 0 || w <= 0 || h <= 0) {
    set_error("unsupported BMP (need 24/32-bit uncompressed)");
    std::fclose(f);
    return nullptr;
  }
  int32_t stride = bpp == 24 ? ((w * 3 + 3) & ~3) : w * 4;
  std::vector<uint8_t> line(stride);
  uint8_t* out = (uint8_t*)std::malloc((size_t)w * h * 3);
  if (!out) {
    set_error("out of memory");
    std::fclose(f);
    return nullptr;
  }
  std::fseek(f, (long)off, SEEK_SET);
  for (int32_t r = 0; r < h; ++r) {
    if (std::fread(line.data(), 1, stride, f) != (size_t)stride) {
      set_error("truncated BMP");
      std::free(out);
      std::fclose(f);
      return nullptr;
    }
    int32_t y = flip ? h - 1 - r : r;
    uint8_t* dst = out + (size_t)y * w * 3;
    int32_t ps = bpp / 8;
    for (int32_t x = 0; x < w; ++x) {  // BGR(A) -> RGB
      dst[x * 3 + 0] = line[x * ps + 2];
      dst[x * 3 + 1] = line[x * ps + 1];
      dst[x * 3 + 2] = line[x * ps + 0];
    }
  }
  std::fclose(f);
  *out_w = w;
  *out_h = h;
  return out;
}

RTBVH_API void rtbvh_free(void* p) { std::free(p); }
