// Fast OBJ mesh loader — the native asset-IO component.
//
// The PyTorch port's copy of stable_renderer_tpu/native/objloader.cpp.
// Replaces the reference's assimp C++ binding for its primary format
// (reference: engine/static/mesh/mesh.py:155-318 loads via assimp_py with
// Triangulate | JoinIdenticalVertices | CalcTangentSpace). The host
// loop must not stall on asset IO while frames stream, so parsing is native:
// single pass, no per-token Python objects, (v, vt, vn) triple dedup via open
// hash, polygon fan triangulation, usemtl tracking.
//
// ABI (ctypes, see native/__init__.py):
//   handle = obj_parse(path)                 -> opaque* (NULL on failure)
//   obj_counts(handle, int64 out[3])         -> vertices, triangles, materials
//   obj_fill(handle, pos, uv, nrm, tris, tri_mat)  (caller-allocated)
//   obj_material_name(handle, i)             -> const char*
//   obj_free(handle)
//
// Build: native/__init__.py runs g++ -O3 -shared -fPIC -std=c++17 on it at first
// use, into build/native/ at the repository root.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  int32_t p, t, n;
  bool operator==(const Key& o) const { return p == o.p && t == o.t && n == o.n; }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = (uint64_t)(uint32_t)k.p;
    h = h * 1000003u ^ (uint64_t)(uint32_t)k.t;
    h = h * 1000003u ^ (uint64_t)(uint32_t)k.n;
    return (size_t)h;
  }
};

struct ObjMesh {
  std::vector<float> positions;  // 3 per vertex
  std::vector<float> uvs;       // 2 per vertex
  std::vector<float> normals;   // 3 per vertex
  std::vector<int32_t> tris;    // 3 per triangle
  std::vector<int32_t> tri_mat; // 1 per triangle
  std::vector<std::string> materials;
};

// parse up to `maxn` whitespace-separated floats starting at s; returns count
int parse_floats(const char* s, float* out, int maxn) {
  int n = 0;
  char* end = nullptr;
  while (n < maxn) {
    while (*s == ' ' || *s == '\t') s++;
    if (*s == '\0' || *s == '\n' || *s == '\r') break;
    float v = strtof(s, &end);
    if (end == s) break;
    out[n++] = v;
    s = end;
  }
  return n;
}

// parse one face vertex token "p", "p/t", "p//n", "p/t/n" (1-based, negatives ok)
void parse_face_token(const char* tok, int32_t* p, int32_t* t, int32_t* n) {
  *p = *t = *n = 0;
  char* end;
  *p = (int32_t)strtol(tok, &end, 10);
  if (*end == '/') {
    tok = end + 1;
    if (*tok != '/') {
      *t = (int32_t)strtol(tok, &end, 10);
    } else {
      end = (char*)tok;
    }
    if (*end == '/') {
      tok = end + 1;
      *n = (int32_t)strtol(tok, &end, 10);
    }
  }
}

inline int32_t resolve(int32_t idx, size_t count) {
  if (idx > 0) return idx - 1;
  if (idx < 0) return (int32_t)count + idx;
  return -1;
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;

  std::vector<float> pos_in, uv_in, nrm_in;
  auto* mesh = new ObjMesh();
  std::unordered_map<Key, int32_t, KeyHash> dedup;
  int32_t cur_mat = -1;

  char line[4096];
  float vals[4];
  std::vector<int32_t> face;  // resolved vertex indices of current polygon
  while (fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      if (parse_floats(line + 2, vals, 3) == 3)
        pos_in.insert(pos_in.end(), vals, vals + 3);
    } else if (line[0] == 'v' && line[1] == 't') {
      int n = parse_floats(line + 3, vals, 2);
      uv_in.push_back(n > 0 ? vals[0] : 0.f);
      uv_in.push_back(n > 1 ? vals[1] : 0.f);
    } else if (line[0] == 'v' && line[1] == 'n') {
      if (parse_floats(line + 3, vals, 3) == 3)
        nrm_in.insert(nrm_in.end(), vals, vals + 3);
    } else if (strncmp(line, "usemtl", 6) == 0) {
      const char* s = line + 6;
      while (*s == ' ' || *s == '\t') s++;
      std::string name(s);
      while (!name.empty() && (name.back() == '\n' || name.back() == '\r' || name.back() == ' '))
        name.pop_back();
      int32_t found = -1;
      for (size_t i = 0; i < mesh->materials.size(); i++)
        if (mesh->materials[i] == name) { found = (int32_t)i; break; }
      if (found < 0) {
        mesh->materials.push_back(name);
        found = (int32_t)mesh->materials.size() - 1;
      }
      cur_mat = found;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      face.clear();
      const char* s = line + 2;
      while (true) {
        while (*s == ' ' || *s == '\t') s++;
        if (*s == '\0' || *s == '\n' || *s == '\r') break;
        int32_t pi, ti, ni;
        parse_face_token(s, &pi, &ti, &ni);
        while (*s && *s != ' ' && *s != '\t' && *s != '\n' && *s != '\r') s++;
        Key key{resolve(pi, pos_in.size() / 3),
                resolve(ti, uv_in.size() / 2),
                resolve(ni, nrm_in.size() / 3)};
        if (key.p < 0) continue;
        auto it = dedup.find(key);
        int32_t vid;
        if (it != dedup.end()) {
          vid = it->second;
        } else {
          vid = (int32_t)(mesh->positions.size() / 3);
          dedup.emplace(key, vid);
          mesh->positions.insert(mesh->positions.end(),
                                 &pos_in[3 * key.p], &pos_in[3 * key.p] + 3);
          if (key.t >= 0 && !uv_in.empty()) {
            mesh->uvs.push_back(uv_in[2 * key.t]);
            mesh->uvs.push_back(uv_in[2 * key.t + 1]);
          } else {
            mesh->uvs.push_back(0.f);
            mesh->uvs.push_back(0.f);
          }
          if (key.n >= 0 && !nrm_in.empty()) {
            mesh->normals.insert(mesh->normals.end(),
                                 &nrm_in[3 * key.n], &nrm_in[3 * key.n] + 3);
          } else {
            mesh->normals.insert(mesh->normals.end(), {0.f, 0.f, 0.f});
          }
        }
        face.push_back(vid);
      }
      for (size_t k = 1; k + 1 < face.size(); k++) {
        mesh->tris.push_back(face[0]);
        mesh->tris.push_back(face[k]);
        mesh->tris.push_back(face[k + 1]);
        mesh->tri_mat.push_back(cur_mat);
      }
    }
  }
  fclose(f);
  return mesh;
}

void obj_counts(void* handle, int64_t out[3]) {
  auto* m = (ObjMesh*)handle;
  out[0] = (int64_t)(m->positions.size() / 3);
  out[1] = (int64_t)(m->tris.size() / 3);
  out[2] = (int64_t)m->materials.size();
}

void obj_fill(void* handle, float* pos, float* uv, float* nrm,
              int32_t* tris, int32_t* tri_mat) {
  auto* m = (ObjMesh*)handle;
  memcpy(pos, m->positions.data(), m->positions.size() * sizeof(float));
  memcpy(uv, m->uvs.data(), m->uvs.size() * sizeof(float));
  memcpy(nrm, m->normals.data(), m->normals.size() * sizeof(float));
  memcpy(tris, m->tris.data(), m->tris.size() * sizeof(int32_t));
  memcpy(tri_mat, m->tri_mat.data(), m->tri_mat.size() * sizeof(int32_t));
}

const char* obj_material_name(void* handle, int64_t i) {
  auto* m = (ObjMesh*)handle;
  if (i < 0 || (size_t)i >= m->materials.size()) return "";
  return m->materials[(size_t)i].c_str();
}

void obj_free(void* handle) { delete (ObjMesh*)handle; }

}  // extern "C"
