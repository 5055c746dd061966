// Host-side native runtime: fast OBJ parsing + per-face UV atlas packing.
// The port's own copy of contexture_nerf_tpu/native/objio.cpp, built with
// the same g++ flags by contexture_nerf_tpu_torch/native/objio.py.
//
// Plays the role of the reference's native IO/preprocessing dependencies
// (kaolin's C++ OBJ importer, xatlas C++ unwrap — SURVEY.md §2.2). These run
// once at experiment init on the host; the TPU never sees this code. The
// Python fallbacks in models/mesh.py and models/textured_mesh.py produce
// identical output; this library is the fast path for large meshes.
//
// C ABI (ctypes): all buffers are caller-owned after the call via
// objio_free(). Triangulation is fan-based (matches kaolin's naive
// homogenizer).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#include <unordered_map>

extern "C" {

struct ObjMesh {
  float* vertices;     // [n_vertices * 3]
  int64_t n_vertices;
  int64_t* faces;      // [n_faces * 3]
  int64_t n_faces;
  float* uvs;          // [n_uvs * 2] (may be null)
  int64_t n_uvs;
  int64_t* face_uvs;   // [n_faces * 3] (may be null)
};

static const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t') p++;
  return p;
}

int objio_load(const char* path, ObjMesh* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return -2;
  }
  fclose(f);
  buf[size] = '\0';

  std::vector<float> verts, uvs;
  std::vector<int64_t> face_v, face_vt;
  std::vector<int64_t> poly_v, poly_vt;

  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    const char* line_end = strchr(p, '\n');
    if (!line_end) line_end = end;
    p = skip_ws(p);
    if (p[0] == 'v' && p[1] == ' ') {
      char* q;
      float x = strtof(p + 2, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      verts.push_back(x);
      verts.push_back(y);
      verts.push_back(z);
    } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
      char* q;
      float u = strtof(p + 3, &q);
      float v = strtof(q, &q);
      uvs.push_back(u);
      uvs.push_back(v);
    } else if (p[0] == 'f' && p[1] == ' ') {
      poly_v.clear();
      poly_vt.clear();
      const char* q = p + 2;
      while (q < line_end) {
        q = skip_ws(q);
        if (q >= line_end || *q == '\r' || *q == '\n') break;
        char* next;
        long vi = strtol(q, &next, 10);
        if (next == q) break;
        int64_t v_idx = vi > 0 ? vi - 1 : (int64_t)(verts.size() / 3) + vi;
        int64_t t_idx = -1;
        q = next;
        if (*q == '/') {
          q++;
          if (*q != '/' && isdigit((unsigned char)*q)) {
            long ti = strtol(q, &next, 10);
            t_idx = ti > 0 ? ti - 1 : (int64_t)(uvs.size() / 2) + ti;
            q = next;
          }
          if (*q == '/') {  // skip normal index
            q++;
            strtol(q, &next, 10);
            q = next;
          }
        }
        poly_v.push_back(v_idx);
        poly_vt.push_back(t_idx);
      }
      // fan triangulation
      for (size_t k = 1; k + 1 < poly_v.size(); k++) {
        face_v.push_back(poly_v[0]);
        face_v.push_back(poly_v[k]);
        face_v.push_back(poly_v[k + 1]);
        face_vt.push_back(poly_vt[0]);
        face_vt.push_back(poly_vt[k]);
        face_vt.push_back(poly_vt[k + 1]);
      }
    }
    p = line_end + 1;
  }

  out->n_vertices = verts.size() / 3;
  out->vertices = (float*)malloc(verts.size() * sizeof(float));
  memcpy(out->vertices, verts.data(), verts.size() * sizeof(float));
  out->n_faces = face_v.size() / 3;
  out->faces = (int64_t*)malloc(face_v.size() * sizeof(int64_t));
  memcpy(out->faces, face_v.data(), face_v.size() * sizeof(int64_t));
  out->n_uvs = uvs.size() / 2;
  if (out->n_uvs > 0) {
    out->uvs = (float*)malloc(uvs.size() * sizeof(float));
    memcpy(out->uvs, uvs.data(), uvs.size() * sizeof(float));
    out->face_uvs = (int64_t*)malloc(face_vt.size() * sizeof(int64_t));
    memcpy(out->face_uvs, face_vt.data(), face_vt.size() * sizeof(int64_t));
  } else {
    out->uvs = nullptr;
    out->face_uvs = nullptr;
  }
  return 0;
}

void objio_free(ObjMesh* m) {
  free(m->vertices);
  free(m->faces);
  free(m->uvs);
  free(m->face_uvs);
  memset(m, 0, sizeof(ObjMesh));
}

// Connected-chart UV unwrap (xatlas-role; mirrors the numpy implementation
// in models/textured_mesh.py::atlas_unwrap so both produce the same charts):
// BFS chart growth over face adjacency bounded by a normal-angle threshold
// against the chart's seed normal, per-chart planar projection with welded
// vertices, shelf packing at uniform density.
//
// vt_out must hold [3*n_faces*2] floats (worst case: every face its own
// chart); *n_vt_out receives the welded vertex count actually written.
int objio_chart_unwrap(int64_t n_vertices, const float* verts /*[n*3]*/,
                       int64_t n_faces, const int64_t* faces /*[f*3]*/,
                       float angle_thr_deg, float gutter,
                       float* vt_out, int64_t* ft_out, int64_t* n_vt_out) {
  if (n_faces <= 0) return 1;
  // face unit normals
  std::vector<double> normal(n_faces * 3);
  for (int64_t f = 0; f < n_faces; f++) {
    const float* a = verts + faces[f * 3 + 0] * 3;
    const float* b = verts + faces[f * 3 + 1] * 3;
    const float* c = verts + faces[f * 3 + 2] * 3;
    double e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    double e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    double n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                   e1[2] * e2[0] - e1[0] * e2[2],
                   e1[0] * e2[1] - e1[1] * e2[0]};
    double len = sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len < 1e-12) len = 1e-12;
    for (int k = 0; k < 3; k++) normal[f * 3 + k] = n[k] / len;
  }
  // edge -> faces adjacency
  std::unordered_map<uint64_t, std::vector<int64_t>> edge_faces;
  edge_faces.reserve(n_faces * 3);
  for (int64_t f = 0; f < n_faces; f++) {
    for (int e = 0; e < 3; e++) {
      int64_t a = faces[f * 3 + e], b = faces[f * 3 + (e + 1) % 3];
      uint64_t key = (uint64_t)std::min(a, b) * (uint64_t)n_vertices +
                     (uint64_t)std::max(a, b);
      edge_faces[key].push_back(f);
    }
  }
  std::vector<std::vector<int64_t>> neighbors(n_faces);
  for (auto& kv : edge_faces)
    for (int64_t i : kv.second)
      for (int64_t j : kv.second)
        if (i != j) neighbors[i].push_back(j);

  // BFS chart growth (membership is order-independent: a chart is the
  // connected component of seed-angle-eligible unassigned faces)
  double cos_thr = cos(angle_thr_deg * M_PI / 180.0);
  std::vector<int64_t> chart(n_faces, -1);
  int64_t n_charts = 0;
  std::vector<int64_t> queue;
  for (int64_t seed = 0; seed < n_faces; seed++) {
    if (chart[seed] >= 0) continue;
    int64_t cid = n_charts++;
    chart[seed] = cid;
    const double* sn = &normal[seed * 3];
    queue.clear();
    queue.push_back(seed);
    for (size_t qi = 0; qi < queue.size(); qi++) {
      int64_t f = queue[qi];
      for (int64_t g : neighbors[f]) {
        if (chart[g] >= 0) continue;
        const double* gn = &normal[g * 3];
        if (gn[0] * sn[0] + gn[1] * sn[1] + gn[2] * sn[2] >= cos_thr) {
          chart[g] = cid;
          queue.push_back(g);
        }
      }
    }
  }

  // group faces per chart (face order preserved)
  std::vector<std::vector<int64_t>> chart_faces(n_charts);
  for (int64_t f = 0; f < n_faces; f++) chart_faces[chart[f]].push_back(f);

  // per-chart planar parameterization with welded vertices
  std::vector<std::vector<double>> chart_uv(n_charts);   // local (k,2)
  std::vector<std::vector<int64_t>> chart_ft(n_charts);  // local (m,3)
  std::vector<double> size_w(n_charts), size_h(n_charts);
  std::vector<int64_t> global_to_local(n_vertices, -1);
  for (int64_t c = 0; c < n_charts; c++) {
    auto& fids = chart_faces[c];
    const double* sn = &normal[fids[0] * 3];
    double up[3] = {0.0, 1.0, 0.0};
    if (fabs(sn[1]) > 0.9) { up[0] = 1.0; up[1] = 0.0; }
    double u[3] = {up[1] * sn[2] - up[2] * sn[1],
                   up[2] * sn[0] - up[0] * sn[2],
                   up[0] * sn[1] - up[1] * sn[0]};
    double ul = sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
    if (ul < 1e-12) ul = 1e-12;
    for (int k = 0; k < 3; k++) u[k] /= ul;
    double v[3] = {sn[1] * u[2] - sn[2] * u[1],
                   sn[2] * u[0] - sn[0] * u[2],
                   sn[0] * u[1] - sn[1] * u[0]};
    // welded local ids in sorted-global-id order (matches np.unique)
    std::vector<int64_t> verts_used;
    for (int64_t f : fids)
      for (int e = 0; e < 3; e++) verts_used.push_back(faces[f * 3 + e]);
    std::sort(verts_used.begin(), verts_used.end());
    verts_used.erase(std::unique(verts_used.begin(), verts_used.end()),
                     verts_used.end());
    for (size_t i = 0; i < verts_used.size(); i++)
      global_to_local[verts_used[i]] = (int64_t)i;
    double min_u = 1e30, min_v = 1e30, max_u = -1e30, max_v = -1e30;
    chart_uv[c].resize(verts_used.size() * 2);
    for (size_t i = 0; i < verts_used.size(); i++) {
      const float* p = verts + verts_used[i] * 3;
      double pu = p[0] * u[0] + p[1] * u[1] + p[2] * u[2];
      double pv = p[0] * v[0] + p[1] * v[1] + p[2] * v[2];
      chart_uv[c][i * 2 + 0] = pu;
      chart_uv[c][i * 2 + 1] = pv;
      min_u = std::min(min_u, pu); max_u = std::max(max_u, pu);
      min_v = std::min(min_v, pv); max_v = std::max(max_v, pv);
    }
    for (size_t i = 0; i < verts_used.size(); i++) {
      chart_uv[c][i * 2 + 0] -= min_u;
      chart_uv[c][i * 2 + 1] -= min_v;
    }
    size_w[c] = max_u - min_u;
    size_h[c] = max_v - min_v;
    chart_ft[c].resize(fids.size() * 3);
    for (size_t i = 0; i < fids.size(); i++)
      for (int e = 0; e < 3; e++)
        chart_ft[c][i * 3 + e] = global_to_local[faces[fids[i] * 3 + e]];
  }

  // shelf packing: tallest first, binary-ish search on the global scale
  std::vector<int64_t> order(n_charts);
  for (int64_t c = 0; c < n_charts; c++) order[c] = c;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return size_h[a] > size_h[b];
  });
  double total_area = 0.0;
  for (int64_t c = 0; c < n_charts; c++)
    total_area += (size_w[c] + 1e-9) * (size_h[c] + 1e-9);
  double scale = sqrt(0.5 / std::max(total_area, 1e-12));
  std::vector<double> off_x(n_charts), off_y(n_charts);
  bool packed = false;
  for (int attempt = 0; attempt < 40 && !packed; attempt++) {
    double x = 0.0, y = 0.0, shelf_h = 0.0;
    packed = true;
    for (int64_t ci : order) {
      double w = size_w[ci] * scale, h = size_h[ci] * scale;
      if (w > 1.0 - 2 * gutter || h > 1.0 - 2 * gutter) { packed = false; break; }
      if (x + w + 2 * gutter > 1.0) { y += shelf_h; x = 0.0; shelf_h = 0.0; }
      if (y + h + 2 * gutter > 1.0) { packed = false; break; }
      off_x[ci] = x + gutter;
      off_y[ci] = y + gutter;
      x += w + 2 * gutter;
      shelf_h = std::max(shelf_h, h + 2 * gutter);
    }
    if (!packed) scale *= 0.85;
  }
  if (!packed) return 2;

  int64_t base = 0;
  for (int64_t c = 0; c < n_charts; c++) {
    int64_t k = (int64_t)(chart_uv[c].size() / 2);
    for (int64_t i = 0; i < k; i++) {
      double uu = chart_uv[c][i * 2 + 0] * scale + off_x[c];
      double vv = chart_uv[c][i * 2 + 1] * scale + off_y[c];
      vt_out[(base + i) * 2 + 0] = (float)std::min(std::max(uu, 0.0), 1.0);
      vt_out[(base + i) * 2 + 1] = (float)std::min(std::max(vv, 0.0), 1.0);
    }
    auto& fids = chart_faces[c];
    for (size_t i = 0; i < fids.size(); i++)
      for (int e = 0; e < 3; e++)
        ft_out[fids[i] * 3 + e] = chart_ft[c][i * 3 + e] + base;
    base += k;
  }
  *n_vt_out = base;
  return 0;
}

}  // extern "C"
