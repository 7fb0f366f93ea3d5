// Marching-tetrahedra isosurface extraction (native core).
//
// Replaces the reference's mesh-extraction dependency (nr3d_lib uses
// skimage/CUDA marching cubes via trianglemesh.py:134 extract_mesh). Each
// grid cube is split into 6 tetrahedra; every tet contributes 0-2 triangles
// with vertices interpolated on sign-crossing edges. Vertices are
// deduplicated by their (global) edge key so the mesh is watertight across
// cells. Tet decomposition also matches the Python DMTet implementation
// (models/tetrahedral.py) so both paths triangulate identically.
//
// C API (ctypes-friendly):
//   mt_extract(grid, nx, ny, nz, level) -> handle (>=0) or -1
//   mt_counts(handle, &n_verts, &n_faces)
//   mt_copy(handle, verts_out, faces_out)   // float[n_verts*3], int[n_faces*3]
//   mt_free(handle)

#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Mesh {
  std::vector<float> verts;
  std::vector<int32_t> faces;
};

std::mutex g_mutex;
std::unordered_map<int, Mesh*> g_meshes;
int g_next_handle = 0;

// Standard 6-tet decomposition of a cube around the main diagonal 0-7;
// corner ids are the cube's (dx,dy,dz) bits packed as dx*4+dy*2+dz. Every
// tet contains edge 0-7, so shared cube faces split along consistent
// diagonals between neighboring cells (crack-free).
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

inline void corner_coord(int cid, int x, int y, int z, int out[3]) {
  out[0] = x + ((cid >> 2) & 1);
  out[1] = y + ((cid >> 1) & 1);
  out[2] = z + (cid & 1);
}

}  // namespace

extern "C" {

int mt_extract(const float* grid, int nx, int ny, int nz, float level) {
  if (nx < 2 || ny < 2 || nz < 2) return -1;
  Mesh* mesh = new Mesh();
  // dedup: edge key = (min_vertex_flat, max_vertex_flat)
  std::unordered_map<uint64_t, int32_t> edge_to_vert;
  edge_to_vert.reserve(1 << 16);

  auto value = [&](const int c[3]) -> float {
    return grid[(c[0] * (int64_t)ny + c[1]) * nz + c[2]] - level;
  };
  auto flat = [&](const int c[3]) -> uint64_t {
    return (c[0] * (uint64_t)ny + c[1]) * (uint64_t)nz + c[2];
  };

  // orient (a,b,c) so its normal points from inside (field<0) toward
  // outside: away from `in_pt` (an inside corner of the generating tet)
  auto emit_tri = [&](int32_t ia, int32_t ib, int32_t ic, const int in_pt[3]) {
    const float* pa = &mesh->verts[ia * 3];
    const float* pb = &mesh->verts[ib * 3];
    const float* pc = &mesh->verts[ic * 3];
    float u[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    float w[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    float n[3] = {u[1] * w[2] - u[2] * w[1], u[2] * w[0] - u[0] * w[2],
                  u[0] * w[1] - u[1] * w[0]};
    float cx = (pa[0] + pb[0] + pc[0]) / 3.f - in_pt[0];
    float cy = (pa[1] + pb[1] + pc[1]) / 3.f - in_pt[1];
    float cz = (pa[2] + pb[2] + pc[2]) / 3.f - in_pt[2];
    if (n[0] * cx + n[1] * cy + n[2] * cz < 0.f) {
      int32_t tmp = ib;
      ib = ic;
      ic = tmp;
    }
    mesh->faces.push_back(ia);
    mesh->faces.push_back(ib);
    mesh->faces.push_back(ic);
  };

  auto edge_vertex = [&](const int a[3], const int b[3], float va,
                         float vb) -> int32_t {
    uint64_t fa = flat(a), fb = flat(b);
    uint64_t key = fa < fb ? (fa << 32 | fb) : (fb << 32 | fa);
    auto it = edge_to_vert.find(key);
    if (it != edge_to_vert.end()) return it->second;
    float t = va / (va - vb);  // va, vb have opposite signs
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    int32_t idx = (int32_t)(mesh->verts.size() / 3);
    mesh->verts.push_back(a[0] + t * (b[0] - a[0]));
    mesh->verts.push_back(a[1] + t * (b[1] - a[1]));
    mesh->verts.push_back(a[2] + t * (b[2] - a[2]));
    edge_to_vert.emplace(key, idx);
    return idx;
  };

  for (int x = 0; x < nx - 1; ++x) {
    for (int y = 0; y < ny - 1; ++y) {
      for (int z = 0; z < nz - 1; ++z) {
        for (int t = 0; t < 6; ++t) {
          int c[4][3];
          float v[4];
          int inside_mask = 0;
          for (int k = 0; k < 4; ++k) {
            corner_coord(kTets[t][k], x, y, z, c[k]);
            v[k] = value(c[k]);
            if (v[k] < 0.f) inside_mask |= 1 << k;
          }
          if (inside_mask == 0 || inside_mask == 15) continue;
          int nin = __builtin_popcount(inside_mask);
          if (nin == 1 || nin == 3) {
            int ref = 0;
            bool ref_inside = (nin == 1);
            for (int k = 0; k < 4; ++k) {
              bool in = (inside_mask >> k) & 1;
              if (in == ref_inside) ref = k;
            }
            int others[3], no = 0;
            for (int k = 0; k < 4; ++k)
              if (k != ref) others[no++] = k;
            int ev[3];
            for (int k = 0; k < 3; ++k)
              ev[k] = edge_vertex(c[ref], c[others[k]], v[ref], v[others[k]]);
            // an inside corner for orientation
            int in_corner = ref_inside ? ref : ((inside_mask & 1) ? 0 : -1);
            if (!ref_inside) {
              for (int k = 0; k < 4; ++k)
                if ((inside_mask >> k) & 1) { in_corner = k; break; }
            }
            emit_tri(ev[0], ev[1], ev[2], c[in_corner]);
          } else {  // nin == 2 → quad between the two in/out pairs
            int ins[2], outs[2], ni = 0, no = 0;
            for (int k = 0; k < 4; ++k) {
              if ((inside_mask >> k) & 1) ins[ni++] = k;
              else outs[no++] = k;
            }
            int q0 = edge_vertex(c[ins[0]], c[outs[0]], v[ins[0]], v[outs[0]]);
            int q1 = edge_vertex(c[ins[0]], c[outs[1]], v[ins[0]], v[outs[1]]);
            int q2 = edge_vertex(c[ins[1]], c[outs[1]], v[ins[1]], v[outs[1]]);
            int q3 = edge_vertex(c[ins[1]], c[outs[0]], v[ins[1]], v[outs[0]]);
            emit_tri(q0, q1, q2, c[ins[0]]);
            emit_tri(q0, q2, q3, c[ins[0]]);
          }
        }
      }
    }
  }

  std::lock_guard<std::mutex> lock(g_mutex);
  int h = g_next_handle++;
  g_meshes[h] = mesh;
  return h;
}

void mt_counts(int handle, int64_t* n_verts, int64_t* n_faces) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_meshes.find(handle);
  if (it == g_meshes.end()) {
    *n_verts = *n_faces = 0;
    return;
  }
  *n_verts = (int64_t)(it->second->verts.size() / 3);
  *n_faces = (int64_t)(it->second->faces.size() / 3);
}

void mt_copy(int handle, float* verts_out, int32_t* faces_out) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_meshes.find(handle);
  if (it == g_meshes.end()) return;
  std::memcpy(verts_out, it->second->verts.data(),
              it->second->verts.size() * sizeof(float));
  std::memcpy(faces_out, it->second->faces.data(),
              it->second->faces.size() * sizeof(int32_t));
}

void mt_free(int handle) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_meshes.find(handle);
  if (it != g_meshes.end()) {
    delete it->second;
    g_meshes.erase(it);
  }
}

}  // extern "C"
