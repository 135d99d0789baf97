// qmesh: native mesh front-end for hnumo_tpu_torch.
//
// The package's own copy of the JAX package's C++ mesh front end (the same
// functions, the same C ABI), built by hnumo_tpu_torch/mesh/_native.py into
// hnumo_tpu_torch/_build/ at first use.
//
// The counterpart of the reference's p4est C glue
// (src/p4est.c:1030-2043): builds quad-grid connectivity from an external
// mesh, infers the logically-structured (nely, nelx) element layout with
// consistent per-element orientation, extracts the corner-vertex table, and
// computes block partitions for the device mesh. Parsing + BFS are O(nelem)
// with hashed edge lookup — the path for meshes where the pure-Python one
// (hnumo_tpu_torch/mesh/gmsh.py, the parity oracle) is too slow.
//
// C ABI (ctypes): every function returns 0 on success, nonzero on error with
// a message in err/errlen.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

inline uint64_t edge_key(int64_t a, int64_t b) {
  uint64_t lo = static_cast<uint64_t>(a < b ? a : b);
  uint64_t hi = static_cast<uint64_t>(a < b ? b : a);
  return (hi << 32) | lo;
}

// canonical local edges of a quad (S, E, N, W) for node order (SW,SE,NE,NW)
const int EDGE_A[4] = {0, 1, 2, 3};
const int EDGE_B[4] = {1, 2, 3, 0};
// crossing canonical edge le moves (dy, dx)
const int MOVE_DY[4] = {-1, 0, 1, 0};
const int MOVE_DX[4] = {0, 1, 0, -1};

struct EdgeUse {
  int64_t elem[2];
  int le[2];
  int n = 0;
};

}  // namespace

extern "C" {

// Infer the structured layout of a quad grid.
//   quads: nelem*4 node indices (0-based, consistently CCW)
//   dims[0]=nely, dims[1]=nelx; elem_of: nely*nelx element ids (row-major);
//   rot: per-element left-rotation that canonicalizes its node order.
int qmesh_infer_layout(int64_t nelem, const int64_t* quads, int64_t* dims,
                       int64_t* elem_of, int64_t* rot, char* err, int errlen) {
  if (nelem <= 0) {
    set_err(err, errlen, "empty mesh");
    return 1;
  }
  std::unordered_map<uint64_t, EdgeUse> edges;
  edges.reserve(static_cast<size_t>(nelem) * 4);
  for (int64_t e = 0; e < nelem; ++e) {
    for (int le = 0; le < 4; ++le) {
      uint64_t k =
          edge_key(quads[e * 4 + EDGE_A[le]], quads[e * 4 + EDGE_B[le]]);
      EdgeUse& u = edges[k];
      if (u.n >= 2) {
        set_err(err, errlen, "non-manifold edge (shared by >2 quads)");
        return 2;
      }
      u.elem[u.n] = e;
      u.le[u.n] = le;
      u.n++;
    }
  }

  std::vector<int64_t> py(nelem), px(nelem);
  std::vector<int8_t> rot8(nelem, -1);
  std::vector<int64_t> stack;
  stack.reserve(nelem);
  rot8[0] = 0;
  py[0] = px[0] = 0;
  stack.push_back(0);
  int64_t seen = 1;
  while (!stack.empty()) {
    int64_t e = stack.back();
    stack.pop_back();
    for (int canon = 0; canon < 4; ++canon) {
      int le = (canon + rot8[e]) & 3;  // stored edge index
      uint64_t k =
          edge_key(quads[e * 4 + EDGE_A[le]], quads[e * 4 + EDGE_B[le]]);
      const EdgeUse& u = edges[k];
      if (u.n < 2) continue;  // boundary edge
      int64_t e2 = (u.elem[0] == e && u.le[0] == le) ? u.elem[1] : u.elem[0];
      int le2 = (u.elem[0] == e && u.le[0] == le) ? u.le[1] : u.le[0];
      int opp = (canon + 2) & 3;
      int r2 = ((le2 - opp) % 4 + 4) & 3;
      int64_t y2 = py[e] + MOVE_DY[canon];
      int64_t x2 = px[e] + MOVE_DX[canon];
      if (rot8[e2] >= 0) {
        if (rot8[e2] != r2 || py[e2] != y2 || px[e2] != x2) {
          set_err(err, errlen,
                  "mesh is not logically structured (inconsistent layout)");
          return 3;
        }
        continue;
      }
      rot8[e2] = static_cast<int8_t>(r2);
      py[e2] = y2;
      px[e2] = x2;
      stack.push_back(e2);
      ++seen;
    }
  }
  if (seen != nelem) {
    set_err(err, errlen, "mesh has disconnected components");
    return 4;
  }

  int64_t ymin = py[0], xmin = px[0], ymax = py[0], xmax = px[0];
  for (int64_t e = 1; e < nelem; ++e) {
    if (py[e] < ymin) ymin = py[e];
    if (py[e] > ymax) ymax = py[e];
    if (px[e] < xmin) xmin = px[e];
    if (px[e] > xmax) xmax = px[e];
  }
  int64_t nely = ymax - ymin + 1, nelx = xmax - xmin + 1;
  if (nely * nelx != nelem) {
    set_err(err, errlen, "mesh is not a full quad grid (holes or irregular)");
    return 5;
  }
  dims[0] = nely;
  dims[1] = nelx;
  for (int64_t i = 0; i < nelem; ++i) elem_of[i] = -1;
  for (int64_t e = 0; e < nelem; ++e) {
    int64_t slot = (py[e] - ymin) * nelx + (px[e] - xmin);
    if (elem_of[slot] != -1) {
      set_err(err, errlen, "duplicate layout slot (irregular topology)");
      return 6;
    }
    elem_of[slot] = e;
    rot[e] = rot8[e];
  }
  return 0;
}

// Extract the (nely+1)*(nelx+1) corner-node table from a canonicalized
// layout (row-major; canonical node order SW,SE,NE,NW).
int qmesh_corner_table(int64_t nely, int64_t nelx, const int64_t* quads,
                       const int64_t* elem_of, const int64_t* rot,
                       int64_t* corners, char* err, int errlen) {
  (void)err;
  (void)errlen;
  int64_t ncx = nelx + 1;
  for (int64_t ey = 0; ey < nely; ++ey) {
    for (int64_t ex = 0; ex < nelx; ++ex) {
      int64_t e = elem_of[ey * nelx + ex];
      int r = static_cast<int>(rot[e]);
      const int64_t* q = quads + e * 4;
      corners[ey * ncx + ex] = q[r & 3];
      corners[ey * ncx + ex + 1] = q[(r + 1) & 3];
      corners[(ey + 1) * ncx + ex + 1] = q[(r + 2) & 3];
      corners[(ey + 1) * ncx + ex] = q[(r + 3) & 3];
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// MSH 2.x ASCII parsing (reference read_gmsh format, src/read_gmsh.F90)
// ---------------------------------------------------------------------------

namespace {

struct MshData {
  std::vector<double> nodes;      // 2*nnodes
  std::vector<int64_t> node_ids;  // original ids
  std::vector<int64_t> quads;     // 4*nquads (0-based)
  std::vector<int64_t> bedges;    // 3*nbedges (n0, n1, phys)
  std::vector<int64_t> bc_pairs;  // 2*nbc (phys, code)
};

bool parse_msh(const char* path, MshData& m, std::string& msg) {
  FILE* f = std::fopen(path, "r");
  if (!f) {
    msg = "cannot open mesh file";
    return false;
  }
  char line[512];
  std::unordered_map<int64_t, int64_t> id_to_idx;
  while (std::fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "$Nodes", 6) == 0) {
      long long n = 0;
      if (!std::fgets(line, sizeof line, f) ||
          std::sscanf(line, "%lld", &n) != 1) {
        msg = "bad $Nodes count";
        std::fclose(f);
        return false;
      }
      m.nodes.resize(2 * n);
      m.node_ids.resize(n);
      id_to_idx.reserve(static_cast<size_t>(n));
      for (long long i = 0; i < n; ++i) {
        long long ip;
        double x, y, z;
        if (!std::fgets(line, sizeof line, f) ||
            std::sscanf(line, "%lld %lf %lf %lf", &ip, &x, &y, &z) < 3) {
          msg = "bad node line";
          std::fclose(f);
          return false;
        }
        m.node_ids[i] = ip;
        id_to_idx[ip] = i;
        m.nodes[2 * i] = x;
        m.nodes[2 * i + 1] = y;
      }
    } else if (std::strncmp(line, "$Elements", 9) == 0) {
      long long n = 0;
      if (!std::fgets(line, sizeof line, f) ||
          std::sscanf(line, "%lld", &n) != 1) {
        msg = "bad $Elements count";
        std::fclose(f);
        return false;
      }
      for (long long i = 0; i < n; ++i) {
        if (!std::fgets(line, sizeof line, f)) {
          msg = "truncated $Elements";
          std::fclose(f);
          return false;
        }
        long long vals[32];
        int nv = 0;
        for (char* p = line; *p && nv < 32;) {
          char* end;
          long long v = std::strtoll(p, &end, 10);
          if (end == p) break;
          vals[nv++] = v;
          p = end;
        }
        if (nv < 3) continue;
        long long etype = vals[1], ntags = vals[2];
        long long phys = ntags > 0 && nv > 3 ? vals[3] : 0;
        const long long* conn = vals + 3 + ntags;
        int nconn = nv - 3 - static_cast<int>(ntags);
        if (etype == 3 && nconn >= 4) {  // 4-node quad
          for (int c = 0; c < 4; ++c) {
            auto it = id_to_idx.find(conn[c]);
            if (it == id_to_idx.end()) {
              msg = "quad references unknown node";
              std::fclose(f);
              return false;
            }
            m.quads.push_back(it->second);
          }
        } else if (etype == 1 && nconn >= 2) {  // boundary line
          m.bedges.push_back(id_to_idx.at(conn[0]));
          m.bedges.push_back(id_to_idx.at(conn[1]));
          m.bedges.push_back(phys);
        }
      }
    } else if (std::strncmp(line, "$BC", 3) == 0 &&
               std::strncmp(line, "$BCEnd", 6) != 0) {
      long long n = 0;
      if (std::fgets(line, sizeof line, f) &&
          std::sscanf(line, "%lld", &n) == 1) {
        for (long long i = 0; i < n; ++i) {
          long long t, c;
          if (std::fgets(line, sizeof line, f) &&
              std::sscanf(line, "%lld %lld", &t, &c) == 2) {
            m.bc_pairs.push_back(t);
            m.bc_pairs.push_back(c);
          }
        }
      }
    }
  }
  std::fclose(f);
  if (m.quads.empty()) {
    msg = "no quad elements found";
    return false;
  }
  // enforce CCW orientation (reference src/read_gmsh.F90:735-760)
  int64_t nq = static_cast<int64_t>(m.quads.size()) / 4;
  for (int64_t e = 0; e < nq; ++e) {
    int64_t* q = m.quads.data() + e * 4;
    double a2 = 0;
    for (int c = 0; c < 4; ++c) {
      int d = (c + 1) & 3;
      a2 += m.nodes[2 * q[c]] * m.nodes[2 * q[d] + 1] -
            m.nodes[2 * q[d]] * m.nodes[2 * q[c] + 1];
    }
    if (a2 < 0) {
      std::swap(q[0], q[3]);
      std::swap(q[1], q[2]);
    }
  }
  return true;
}

thread_local MshData g_msh;

}  // namespace

// Two-phase read: sizes first (caller allocates), then data.
int qmesh_msh_sizes(const char* path, int64_t* sizes, char* err, int errlen) {
  std::string msg;
  g_msh = MshData();
  if (!parse_msh(path, g_msh, msg)) {
    set_err(err, errlen, msg);
    return 1;
  }
  sizes[0] = static_cast<int64_t>(g_msh.nodes.size()) / 2;
  sizes[1] = static_cast<int64_t>(g_msh.quads.size()) / 4;
  sizes[2] = static_cast<int64_t>(g_msh.bedges.size()) / 3;
  sizes[3] = static_cast<int64_t>(g_msh.bc_pairs.size()) / 2;
  return 0;
}

int qmesh_msh_data(double* nodes, int64_t* node_ids, int64_t* quads,
                   int64_t* bedges, int64_t* bc_pairs, char* err, int errlen) {
  if (g_msh.quads.empty()) {
    set_err(err, errlen, "qmesh_msh_sizes must be called first");
    return 1;
  }
  std::memcpy(nodes, g_msh.nodes.data(), g_msh.nodes.size() * sizeof(double));
  std::memcpy(node_ids, g_msh.node_ids.data(),
              g_msh.node_ids.size() * sizeof(int64_t));
  std::memcpy(quads, g_msh.quads.data(), g_msh.quads.size() * sizeof(int64_t));
  if (!g_msh.bedges.empty())
    std::memcpy(bedges, g_msh.bedges.data(),
                g_msh.bedges.size() * sizeof(int64_t));
  if (!g_msh.bc_pairs.empty())
    std::memcpy(bc_pairs, g_msh.bc_pairs.data(),
                g_msh.bc_pairs.size() * sizeof(int64_t));
  g_msh = MshData();
  return 0;
}

// Balanced block partition of an n-long axis over p shards:
// bounds[i] = start of shard i (bounds[p] = n). The device-mesh analog of
// p4est_partition (src/p4est.c:1174-1179); with divisible axes it matches
// the shard_map block decomposition exactly.
int qmesh_partition(int64_t n, int64_t p, int64_t* bounds, char* err,
                    int errlen) {
  if (p <= 0 || n < p) {
    set_err(err, errlen, "need 0 < nshards <= n");
    return 1;
  }
  int64_t base = n / p, rem = n % p, acc = 0;
  for (int64_t i = 0; i < p; ++i) {
    bounds[i] = acc;
    acc += base + (i < rem ? 1 : 0);
  }
  bounds[p] = n;
  return 0;
}

}  // extern "C"
