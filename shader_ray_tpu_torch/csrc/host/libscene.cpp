// libscene — native scene compiler for shader_ray_tpu.
//
// C++ implementation of the host-side hot path: binned-SAH BVH build,
// DFS in-order index assignment, and 8-octant stackless hit/miss link
// precomputation.  Functionally equivalent to the reference's
// bvh.cpp:288-358 + world.cpp:145-288 pipeline and bit-compatible with
// the pure-numpy builder in shader_ray_tpu/models/{bvh,flatten}.py
// (same float32 arithmetic order, same stable partition), so the two
// paths are interchangeable and cross-checked by tests.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxBinCount = 40;   // bvh.cpp:200
constexpr int kHitmissDirs = 8;
constexpr int32_t kSentinel = -1;  // numpy flatten.py stop sentinel

struct Node {
  float bmin[3];
  float bmax[3];
  int32_t axis = -1;      // split axis, -1 = leaf
  int32_t neg = -1;       // child node ids (creation order), -1 = leaf
  int32_t pos = -1;
  int32_t start = 0;      // leaf triangle range
  int32_t count = 0;
  bool is_leaf() const { return neg < 0; }
};

struct Builder {
  // mutable copies, permuted in place during partitioning (T x 3 each)
  std::vector<float> bmin, bmax, bary;
  std::vector<int32_t> order;
  int32_t T = 0;
  int32_t leaf_max = 10;
  int32_t max_depth = 30;
  float ctrav = 1.0f;
  float cisec = 4.0f;

  std::vector<Node> nodes;
  int32_t root = -1;
  int32_t leaf_count = 0;
  int32_t large_leaf_no_split = 0;
  int32_t large_leaf_one_side = 0;
  int error = 0;  // nonzero: hitmiss stack overflow etc.

  // DFS in-order numbering (filled by assign_indices)
  std::vector<int32_t> perm;  // creation id -> DFS index

  static float surface_area(const float d[3]) {
    return 2.0f * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]);
  }

  int32_t make_leaf(int32_t start, int32_t count) {
    Node n;
    for (int d = 0; d < 3; ++d) {
      n.bmin[d] = FLT_MAX;
      n.bmax[d] = -FLT_MAX;
    }
    for (int32_t i = start; i < start + count; ++i) {
      for (int d = 0; d < 3; ++d) {
        n.bmin[d] = std::min(n.bmin[d], bmin[i * 3 + d]);
        n.bmax[d] = std::max(n.bmax[d], bmax[i * 3 + d]);
      }
    }
    n.start = start;
    n.count = count;
    nodes.push_back(n);
    ++leaf_count;
    return (int32_t)nodes.size() - 1;
  }

  int32_t build(int32_t start, int32_t count, int level) {
    if (level >= max_depth || count <= leaf_max) return make_leaf(start, count);

    float vmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float vmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    float bmn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float bmx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int32_t i = start; i < start + count; ++i) {
      for (int d = 0; d < 3; ++d) {
        vmin[d] = std::min(vmin[d], bmin[i * 3 + d]);
        vmax[d] = std::max(vmax[d], bmax[i * 3 + d]);
        bmn[d] = std::min(bmn[d], bary[i * 3 + d]);
        bmx[d] = std::max(bmx[d], bary[i * 3 + d]);
      }
    }
    float bd[3];
    for (int d = 0; d < 3; ++d) bd[d] = std::max(0.0f, bmx[d] - bmn[d]);
    // widest barycenter extent, same comparison order as bvh.cpp:318-327
    int axis;
    if (bd[0] > bd[1] && bd[0] > bd[2]) axis = 0;
    else if (bd[1] > bd[2]) axis = 1;
    else axis = 2;

    const float leaf_cost = ctrav + cisec * (float)count;
    const int bin_count = std::min(kMaxBinCount, (int)count * 2);
    const double lo = (double)vmin[axis];
    const double hi = (double)vmax[axis];

    bool have_split = false;
    float split_x = 0.0f;
    if (hi > lo) {
      std::vector<int32_t> bin_cnt(bin_count, 0);
      std::vector<float> bin_min(bin_count * 3, FLT_MAX);
      std::vector<float> bin_max(bin_count * 3, -FLT_MAX);
      const float lof = (float)lo;
      const float denom = (float)(hi - lo);
      for (int32_t i = start; i < start + count; ++i) {
        float x = bary[i * 3 + axis];
        int b = (int)std::floor((x - lof) * (float)bin_count / denom);
        b = std::min(std::max(b, 0), bin_count - 1);
        ++bin_cnt[b];
        for (int d = 0; d < 3; ++d) {
          bin_min[b * 3 + d] = std::min(bin_min[b * 3 + d], bmin[i * 3 + d]);
          bin_max[b * 3 + d] = std::max(bin_max[b * 3 + d], bmax[i * 3 + d]);
        }
      }
      // suffix scan: right boxes/counts (bvh.cpp:213-222)
      std::vector<float> right_min(bin_count * 3), right_max(bin_count * 3);
      std::vector<int32_t> right_cnt(bin_count);
      for (int b = bin_count - 1; b >= 0; --b) {
        for (int d = 0; d < 3; ++d) {
          float rm = bin_min[b * 3 + d], rM = bin_max[b * 3 + d];
          if (b + 1 < bin_count) {
            rm = std::min(rm, right_min[(b + 1) * 3 + d]);
            rM = std::max(rM, right_max[(b + 1) * 3 + d]);
          }
          right_min[b * 3 + d] = rm;
          right_max[b * 3 + d] = rM;
        }
        right_cnt[b] = bin_cnt[b] + (b + 1 < bin_count ? right_cnt[b + 1] : 0);
      }
      // prefix scan: left boxes, picking min cost (bvh.cpp:226-246)
      float dim[3];
      for (int d = 0; d < 3; ++d) dim[d] = std::max(0.0f, vmax[d] - vmin[d]);
      const float area = surface_area(dim);
      float best = leaf_cost;
      float left_min[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
      float left_max[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      for (int i = 1; i < bin_count; ++i) {
        for (int d = 0; d < 3; ++d) {
          left_min[d] = std::min(left_min[d], bin_min[(i - 1) * 3 + d]);
          left_max[d] = std::max(left_max[d], bin_max[(i - 1) * 3 + d]);
        }
        const int32_t rtri = right_cnt[i];
        const int32_t ltri = count - rtri;
        if (rtri == 0 || ltri == 0) continue;
        float ldim[3], rdim[3];
        for (int d = 0; d < 3; ++d) {
          ldim[d] = std::max(0.0f, left_max[d] - left_min[d]);
          rdim[d] = std::max(0.0f, right_max[i * 3 + d] - right_min[i * 3 + d]);
        }
        const float cost =
            ctrav + cisec * (surface_area(ldim) / area * (float)ltri +
                             surface_area(rdim) / area * (float)rtri);
        if (cost < best) {
          best = cost;
          // split plane position computed in double like the numpy
          // builder (bvh.cpp:187 analog), compared in float below
          split_x = (float)(lo + (double)i * (hi - lo) / (double)bin_count);
          have_split = true;
        }
      }
    }

    if (!have_split) {
      ++large_leaf_no_split;
      return make_leaf(start, count);
    }

    // stable partition by barycenter vs. split plane (bvh.cpp:249-286;
    // numpy uses a stable index-gather — replicated here)
    std::vector<int32_t> idx(count);
    int32_t countA = 0;
    for (int32_t i = 0; i < count; ++i)
      if (bary[(start + i) * 3 + axis] < split_x) idx[countA++] = i;
    int32_t k = countA;
    for (int32_t i = 0; i < count; ++i)
      if (!(bary[(start + i) * 3 + axis] < split_x)) idx[k++] = i;
    const int32_t countB = count - countA;
    if (countA == 0 || countB == 0) {
      ++large_leaf_one_side;
      return make_leaf(start, count);
    }
    apply_permutation(start, count, idx);

    const int32_t neg = build(start, countA, level + 1);
    const int32_t pos = build(start + countA, countB, level + 1);
    Node n;
    std::memcpy(n.bmin, vmin, sizeof(vmin));
    std::memcpy(n.bmax, vmax, sizeof(vmax));
    n.axis = axis;
    n.neg = neg;
    n.pos = pos;
    nodes.push_back(n);
    return (int32_t)nodes.size() - 1;
  }

  void apply_permutation(int32_t start, int32_t count,
                         const std::vector<int32_t>& idx) {
    std::vector<float> tmp3(count * 3);
    std::vector<int32_t> tmpi(count);
    auto permute3 = [&](std::vector<float>& a) {
      for (int32_t i = 0; i < count; ++i)
        for (int d = 0; d < 3; ++d)
          tmp3[i * 3 + d] = a[(start + idx[i]) * 3 + d];
      std::memcpy(&a[start * 3], tmp3.data(), sizeof(float) * count * 3);
    };
    permute3(bmin);
    permute3(bmax);
    permute3(bary);
    for (int32_t i = 0; i < count; ++i) tmpi[i] = order[start + idx[i]];
    std::memcpy(&order[start], tmpi.data(), sizeof(int32_t) * count);
  }

  // DFS in-order numbering: negative subtree, self, positive subtree
  // (world.cpp:145-177)
  void assign_indices() {
    perm.assign(nodes.size(), -1);
    int32_t counter = 0;
    struct Frame { int32_t id; bool expanded; };
    std::vector<Frame> stack;
    stack.push_back({root, false});
    while (!stack.empty()) {
      Frame f = stack.back();
      stack.pop_back();
      const Node& n = nodes[f.id];
      if (n.is_leaf() || f.expanded) {
        perm[f.id] = counter++;
        continue;
      }
      stack.push_back({n.pos, false});
      stack.push_back({f.id, true});
      stack.push_back({n.neg, false});
    }
    if (counter != (int32_t)nodes.size()) error = 2;
  }

  // One octant's (hit_next, miss_next) bank in DFS numbering
  // (world.cpp:215-278); near child by sign of dot(octant, axis)
  void hitmiss_octant(int dircode, int32_t* out /* N*2 */) const {
    const int32_t n = (int32_t)nodes.size();
    for (int32_t i = 0; i < 2 * n; ++i) out[i] = kSentinel;
    const float sign[3] = {
        (dircode & 1) ? 1.0f : -1.0f,
        (dircode & 2) ? 1.0f : -1.0f,
        (dircode & 4) ? 1.0f : -1.0f,
    };
    std::vector<int32_t> stack;
    int32_t g = root;
    while (g != -1) {
      const int32_t miss = stack.empty() ? -1 : stack.back();
      const Node& node = nodes[g];
      const int32_t gi = perm[g];
      if (node.is_leaf()) {
        out[gi * 2 + 0] = (miss != -1) ? perm[miss] : kSentinel;
        out[gi * 2 + 1] = out[gi * 2 + 0];
        if (stack.empty()) {
          g = -1;
        } else {
          g = stack.back();
          stack.pop_back();
        }
      } else {
        int32_t near, far;
        if (sign[node.axis] < 0) {
          near = node.pos;
          far = node.neg;
        } else {
          near = node.neg;
          far = node.pos;
        }
        out[gi * 2 + 0] = perm[near];
        out[gi * 2 + 1] = (miss != -1) ? perm[miss] : kSentinel;
        stack.push_back(far);
        g = near;
      }
    }
  }
};

}  // namespace

extern "C" {

// Build the BVH. Returns an opaque handle (srt_bvh_free to release).
// order must hold tri_count int32 (receives the BVH triangle
// permutation: order[k] = original index of BVH-slot k).
void* srt_bvh_build(const float* tri_boxmin, const float* tri_boxmax,
                    const float* barycenters, int32_t tri_count,
                    int32_t leaf_max, int32_t max_depth, float ctrav,
                    float cisec, int32_t* out_node_count, int32_t* out_root,
                    int32_t* order) {
  Builder* b = new Builder();
  b->T = tri_count;
  b->leaf_max = leaf_max;
  b->max_depth = max_depth;
  b->ctrav = ctrav;
  b->cisec = cisec;
  b->bmin.assign(tri_boxmin, tri_boxmin + (size_t)tri_count * 3);
  b->bmax.assign(tri_boxmax, tri_boxmax + (size_t)tri_count * 3);
  b->bary.assign(barycenters, barycenters + (size_t)tri_count * 3);
  b->order.resize(tri_count);
  for (int32_t i = 0; i < tri_count; ++i) b->order[i] = i;

  b->nodes.reserve(tri_count / 4 + 8);
  b->root = (tri_count == 0) ? b->make_leaf(0, 0) : b->build(0, tri_count, 0);
  b->assign_indices();

  *out_node_count = (int32_t)b->nodes.size();
  *out_root = (b->error == 0) ? b->perm[b->root] : -1;
  std::memcpy(order, b->order.data(), sizeof(int32_t) * tri_count);
  return b;
}

// Fill flattened arrays in DFS numbering.  boxmin/boxmax are N*3,
// start/count/axis N, children N*2, hitmiss 8*N*2.  Returns 0 on
// success.
int32_t srt_bvh_fill(void* handle, float* boxmin, float* boxmax,
                     int32_t* start, int32_t* count, int32_t* children,
                     int32_t* axis, int32_t* hitmiss) {
  Builder* b = static_cast<Builder*>(handle);
  if (b->error) return b->error;
  const int32_t n = (int32_t)b->nodes.size();
  for (int32_t old_id = 0; old_id < n; ++old_id) {
    const Node& node = b->nodes[old_id];
    const int32_t i = b->perm[old_id];
    std::memcpy(&boxmin[i * 3], node.bmin, sizeof(node.bmin));
    std::memcpy(&boxmax[i * 3], node.bmax, sizeof(node.bmax));
    if (node.is_leaf()) {
      start[i] = node.start;
      count[i] = node.count;
      children[i * 2 + 0] = kSentinel;
      children[i * 2 + 1] = kSentinel;
      axis[i] = -1;
    } else {
      start[i] = 0;
      count[i] = 0;
      children[i * 2 + 0] = b->perm[node.neg];
      children[i * 2 + 1] = b->perm[node.pos];
      axis[i] = node.axis;
    }
  }
  for (int d = 0; d < kHitmissDirs; ++d)
    b->hitmiss_octant(d, hitmiss + (size_t)d * n * 2);
  return 0;
}

int32_t srt_bvh_leaf_count(void* handle) {
  return static_cast<Builder*>(handle)->leaf_count;
}

void srt_bvh_free(void* handle) { delete static_cast<Builder*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Native scene-file loaders (reference trisrc-support.cpp:43-104 and
// obj-support.cpp:226-350 equivalents; same grammar and numeric
// behavior as the Python parsers in shader_ray_tpu/models/, which stay
// as the portable fallback).  Two-pass API: *_count sizes the arrays,
// *_parse fills caller-allocated buffers.
// ---------------------------------------------------------------------------

#include <cstdio>
#include <string>

namespace {

bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize((size_t)n);
  size_t got = n ? std::fread(&(*out)[0], 1, (size_t)n, f) : 0;
  std::fclose(f);
  return got == (size_t)n;
}

// trisrc tokenizer: quoted strings are single tokens (may contain
// whitespace), everything else splits on whitespace.
struct TrisrcTok {
  const std::string& s;
  size_t pos = 0;
  explicit TrisrcTok(const std::string& text) : s(text) {}
  // returns token kind: 0 = end, 1 = quoted, 2 = plain, -1 = error
  int next(std::string* tok) {
    while (pos < s.size() && std::isspace((unsigned char)s[pos])) ++pos;
    if (pos >= s.size()) return 0;
    if (s[pos] == '"') {
      size_t end = s.find('"', pos + 1);
      if (end == std::string::npos) return -1;
      *tok = s.substr(pos, end - pos + 1);
      pos = end + 1;
      return 1;
    }
    size_t end = pos;
    while (end < s.size() && !std::isspace((unsigned char)s[end])) ++end;
    *tok = s.substr(pos, end - pos);
    pos = end;
    return 2;
  }
};

int64_t trisrc_scan(const std::string& text, double scale, double gamma,
                    int linear, float* pos, float* nrm, float* col) {
  TrisrcTok tk(text);
  std::string tok;
  int64_t T = 0;
  for (;;) {
    int kind = tk.next(&tok);
    if (kind == 0) break;
    if (kind != 1) return -2;  // expected quoted texture name
    if (tk.next(&tok) <= 0) return -2;  // tag
    double spec[5];
    for (int i = 0; i < 5; ++i) {
      if (tk.next(&tok) <= 0) return -2;
      spec[i] = std::strtod(tok.c_str(), nullptr);
    }
    (void)spec;  // materials parsed but discarded (trisrc-support.cpp:88)
    double vals[36];
    for (int i = 0; i < 36; ++i) {
      if (tk.next(&tok) <= 0) return -2;
      vals[i] = std::strtod(tok.c_str(), nullptr);
    }
    if (pos) {
      for (int v = 0; v < 3; ++v) {
        const double* rec = vals + v * 12;
        for (int c = 0; c < 3; ++c)
          pos[T * 9 + v * 3 + c] = (float)(rec[c] * scale);
        double nx = rec[3], ny = rec[4], nz = rec[5];
        double len = std::sqrt(nx * nx + ny * ny + nz * nz);
        if (len == 0.0) len = 1.0;
        nrm[T * 9 + v * 3 + 0] = (float)(nx / len);
        nrm[T * 9 + v * 3 + 1] = (float)(ny / len);
        nrm[T * 9 + v * 3 + 2] = (float)(nz / len);
        for (int c = 0; c < 3; ++c) {
          double cc = rec[6 + c];
          if (!linear)
            cc = std::pow(std::fabs(cc), gamma) * (cc < 0 ? -1.0 : 1.0);
          col[T * 9 + v * 3 + c] = (float)cc;
        }
      }
    }
    ++T;
  }
  return T;
}

// Minimal OBJ model shared by count/parse passes.
struct ObjData {
  std::vector<float> pos;                 // V*3 (float32, like the numpy path)
  std::vector<float> nrm;                 // N*3
  std::vector<std::vector<int32_t>> faces;  // per face: (v, vn) pairs
  std::vector<uint8_t> face_has_n;
  bool file_has_normals = false;
};

bool obj_read(const std::string& text, ObjData* o) {
  size_t p = 0, n = text.size();
  while (p < n) {
    size_t eol = text.find('\n', p);
    if (eol == std::string::npos) eol = n;
    std::string line = text.substr(p, eol - p);
    p = eol + 1;
    size_t b = line.find_first_not_of(" \t\r");
    if (b == std::string::npos || line[b] == '#') continue;
    std::vector<std::string> parts;
    size_t q = b;
    while (q < line.size()) {
      while (q < line.size() && std::isspace((unsigned char)line[q])) ++q;
      if (q >= line.size()) break;
      size_t e = q;
      while (e < line.size() && !std::isspace((unsigned char)line[e])) ++e;
      parts.push_back(line.substr(q, e - q));
      q = e;
    }
    if (parts.empty()) continue;
    const std::string& kind = parts[0];
    if (kind == "v") {
      for (int c = 0; c < 3; ++c)
        o->pos.push_back(
            parts.size() > (size_t)c + 1
                ? (float)std::strtod(parts[c + 1].c_str(), nullptr)
                : 0.0f);
    } else if (kind == "vn") {
      o->file_has_normals = true;
      for (int c = 0; c < 3; ++c)
        o->nrm.push_back(
            parts.size() > (size_t)c + 1
                ? (float)std::strtod(parts[c + 1].c_str(), nullptr)
                : 0.0f);
    } else if (kind == "f") {
      std::vector<int32_t> idx;
      bool has_n = false;
      const int32_t nv = (int32_t)(o->pos.size() / 3);
      const int32_t nn = (int32_t)(o->nrm.size() / 3);
      for (size_t i = 1; i < parts.size(); ++i) {
        const std::string& tup = parts[i];
        // v[/vt[/vn]] -- 1-based -> 0-based; negative indices are
        // relative to the elements defined so far (OBJ spec)
        int32_t v = (int32_t)std::strtol(tup.c_str(), nullptr, 10);
        v = (v < 0) ? nv + v : v - 1;
        int32_t vn = -1;
        size_t s1 = tup.find('/');
        if (s1 != std::string::npos) {
          size_t s2 = tup.find('/', s1 + 1);
          if (s2 != std::string::npos && s2 + 1 < tup.size()) {
            vn = (int32_t)std::strtol(tup.c_str() + s2 + 1, nullptr, 10);
            vn = (vn < 0) ? nn + vn : vn - 1;
          }
        }
        if (vn >= 0) has_n = true;
        idx.push_back(v);
        idx.push_back(vn);
      }
      o->faces.push_back(std::move(idx));
      o->face_has_n.push_back(has_n ? 1 : 0);
    }
    // 'o'/'vt'/others: ignored
  }
  return true;
}

}  // namespace

extern "C" {

// Count trisrc triangles. Returns T, -1 on I/O error, -2 on parse error.
int64_t srt_trisrc_count(const char* path) {
  std::string text;
  if (!read_file(path, &text)) return -1;
  return trisrc_scan(text, 1.0, 2.63, 1, nullptr, nullptr, nullptr);
}

// Fill pos/nrm/col (each T*9 float32). Returns T or negative error.
int64_t srt_trisrc_parse(const char* path, double scale, double gamma,
                         int32_t linear, float* pos, float* nrm, float* col) {
  std::string text;
  if (!read_file(path, &text)) return -1;
  return trisrc_scan(text, scale, gamma, linear, pos, nrm, col);
}

// Count OBJ triangles after fan triangulation. -1 on I/O error.
int64_t srt_obj_count(const char* path) {
  std::string text;
  if (!read_file(path, &text)) return -1;
  ObjData o;
  obj_read(text, &o);
  int64_t T = 0;
  for (const auto& f : o.faces) {
    int64_t verts = (int64_t)f.size() / 2;
    if (verts >= 3) T += verts - 2;
  }
  return T;
}

// Fill pos/nrm (each T*9 float32; colors are always white,
// obj-support.cpp:344). Returns T or negative error.
int64_t srt_obj_parse(const char* path, float* pos, float* nrm) {
  std::string text;
  if (!read_file(path, &text)) return -1;
  ObjData o;
  obj_read(text, &o);
  const int64_t V = (int64_t)o.pos.size() / 3;

  // area-weighted vertex normals when the file has none
  // (obj-support.cpp:104-146), float32 accumulation like the numpy path
  std::vector<float> acc;
  if (!o.file_has_normals) {
    acc.assign(o.pos.size(), 0.0f);
    for (const auto& f : o.faces) {
      int64_t verts = (int64_t)f.size() / 2;
      if (verts < 3) continue;
      int32_t v0 = f[0];
      for (int64_t t = 0; t < verts - 2; ++t) {
        int32_t v1 = f[(t + 1) * 2], v2 = f[(t + 2) * 2];
        if (v0 < 0 || v0 >= V || v1 < 0 || v1 >= V || v2 < 0 || v2 >= V)
          return -2;
        float e1[3], e2[3], fn[3];
        for (int c = 0; c < 3; ++c) {
          e1[c] = o.pos[v1 * 3 + c] - o.pos[v0 * 3 + c];
          e2[c] = o.pos[v2 * 3 + c] - o.pos[v0 * 3 + c];
        }
        fn[0] = e1[1] * e2[2] - e1[2] * e2[1];
        fn[1] = e1[2] * e2[0] - e1[0] * e2[2];
        fn[2] = e1[0] * e2[1] - e1[1] * e2[0];
        for (int c = 0; c < 3; ++c) {
          acc[v0 * 3 + c] += fn[c];
          acc[v1 * 3 + c] += fn[c];
          acc[v2 * 3 + c] += fn[c];
        }
      }
    }
    for (int64_t v = 0; v < V; ++v) {
      float len = std::sqrt(acc[v * 3] * acc[v * 3] +
                            acc[v * 3 + 1] * acc[v * 3 + 1] +
                            acc[v * 3 + 2] * acc[v * 3 + 2]);
      if (len == 0.0f) len = 1.0f;
      for (int c = 0; c < 3; ++c) acc[v * 3 + c] /= len;
    }
  }

  const int64_t NN = (int64_t)o.nrm.size() / 3;
  int64_t T = 0;
  for (size_t fi = 0; fi < o.faces.size(); ++fi) {
    const auto& f = o.faces[fi];
    int64_t verts = (int64_t)f.size() / 2;
    if (verts < 3) continue;
    int32_t v0 = f[0], n0 = f[1];
    for (int64_t t = 0; t < verts - 2; ++t) {
      int32_t v1 = f[(t + 1) * 2], n1 = f[(t + 1) * 2 + 1];
      int32_t v2 = f[(t + 2) * 2], n2 = f[(t + 2) * 2 + 1];
      const int32_t vs[3] = {v0, v1, v2};
      const int32_t ns[3] = {n0, n1, n2};
      for (int j = 0; j < 3; ++j) {
        if (vs[j] < 0 || vs[j] >= V) return -2;
        for (int c = 0; c < 3; ++c)
          pos[T * 9 + j * 3 + c] = o.pos[vs[j] * 3 + c];
        if (o.file_has_normals && o.face_has_n[fi]) {
          if (ns[j] < 0 || ns[j] >= NN) return -2;
          for (int c = 0; c < 3; ++c)
            nrm[T * 9 + j * 3 + c] = o.nrm[ns[j] * 3 + c];
        } else if (!o.file_has_normals) {
          for (int c = 0; c < 3; ++c)
            nrm[T * 9 + j * 3 + c] = acc[vs[j] * 3 + c];
        } else {
          // file has normals but this face lacks them: zero normal
          for (int c = 0; c < 3; ++c) nrm[T * 9 + j * 3 + c] = 0.0f;
        }
      }
      ++T;
    }
  }
  return T;
}

}  // extern "C"

extern "C" {

// Radiance RGBE (.hdr) reader (reference used FreeImagePlus FIT_RGBF,
// ray.cpp:1048-1054).  Supports -Y H +X W orientation with adaptive
// RLE and flat scanlines, matching the Python fallback bit-for-bit
// (value = mantissa * 2^(e-136); e == 0 -> 0).
// srt_hdr_size: 0 ok (writes H, W); -1 I/O, -2 not HDR, -3 orientation.
int32_t srt_hdr_size(const char* path, int32_t* H, int32_t* W) {
  std::string data;
  if (!read_file(path, &data)) return -1;
  if (data.rfind("#?RADIANCE", 0) != 0 && data.rfind("#?RGBE", 0) != 0)
    return -2;
  size_t pos = 0;
  for (;;) {  // header lines until blank
    size_t nl = data.find('\n', pos);
    if (nl == std::string::npos) return -2;
    if (nl == pos) { pos = nl + 1; break; }
    pos = nl + 1;
  }
  size_t nl = data.find('\n', pos);
  if (nl == std::string::npos) return -2;
  int h = 0, w = 0;
  if (std::sscanf(data.substr(pos, nl - pos).c_str(), "-Y %d +X %d", &h, &w) != 2)
    return -3;
  *H = h;
  *W = w;
  return 0;
}

// srt_hdr_read: fills out (H*W*3 float32). Returns 0, or negative error
// (-4: truncated/corrupt pixel data).
int32_t srt_hdr_read(const char* path, float* out) {
  std::string data;
  if (!read_file(path, &data)) return -1;
  size_t pos = 0;
  for (;;) {
    size_t nl = data.find('\n', pos);
    if (nl == std::string::npos) return -2;
    if (nl == pos) { pos = nl + 1; break; }
    pos = nl + 1;
  }
  size_t nl = data.find('\n', pos);
  int H = 0, W = 0;
  if (std::sscanf(data.substr(pos, nl - pos).c_str(), "-Y %d +X %d", &H, &W) != 2)
    return -3;
  pos = nl + 1;

  const uint8_t* buf = (const uint8_t*)data.data();
  size_t n = data.size(), p = pos;
  std::vector<uint8_t> line((size_t)W * 4);
  for (int y = 0; y < H; ++y) {
    if (W >= 8 && W < 32768 && p + 4 <= n && buf[p] == 2 && buf[p + 1] == 2 &&
        (((int)buf[p + 2] << 8) | (int)buf[p + 3]) == W) {
      p += 4;  // adaptive RLE: 4 component planes
      for (int c = 0; c < 4; ++c) {
        int x = 0;
        while (x < W) {
          if (p >= n) return -4;
          int code = buf[p++];
          if (code > 128) {
            int run = code - 128;
            if (p >= n || x + run > W) return -4;
            for (int k = 0; k < run; ++k) line[(size_t)(x + k) * 4 + c] = buf[p];
            ++p;
            x += run;
          } else {
            if (p + (size_t)code > n || x + code > W) return -4;
            for (int k = 0; k < code; ++k)
              line[(size_t)(x + k) * 4 + c] = buf[p + k];
            p += code;
            x += code;
          }
        }
      }
    } else {  // flat scanline
      if (p + (size_t)W * 4 > n) return -4;
      std::memcpy(line.data(), buf + p, (size_t)W * 4);
      p += (size_t)W * 4;
    }
    for (int x = 0; x < W; ++x) {
      const uint8_t* px = &line[(size_t)x * 4];
      float* o = out + ((size_t)y * W + x) * 3;
      if (px[3] == 0) {
        o[0] = o[1] = o[2] = 0.0f;
      } else {
        float scale = std::ldexp(1.0f, (int)px[3] - 136);
        o[0] = px[0] * scale;
        o[1] = px[1] * scale;
        o[2] = px[2] * scale;
      }
    }
  }
  return 0;
}

}  // extern "C"
