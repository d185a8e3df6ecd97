// libscene — native scene compiler for shader_ray_tpu.
//
// C++ implementation of the host-side hot path: binned-SAH BVH build,
// the SBVH build of shader_ray_tpu_torch/models/sbvh.py (below), DFS
// in-order index assignment, and 8-octant stackless hit/miss link
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

// The node list of a built tree, its DFS numbering and its hit/miss links:
// what the flatten reads, whichever build made the nodes.
struct Tree {
  std::vector<Node> nodes;
  int32_t root = -1;
  int32_t leaf_count = 0;
  int error = 0;  // nonzero: hitmiss stack overflow etc.

  // DFS in-order numbering (filled by assign_indices)
  std::vector<int32_t> perm;  // creation id -> DFS index

  virtual ~Tree() = default;

  static float surface_area(const float d[3]) {
    return 2.0f * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]);
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

struct Builder : Tree {
  // mutable copies, permuted in place during partitioning (T x 3 each)
  std::vector<float> bmin, bmax, bary;
  std::vector<int32_t> order;
  int32_t T = 0;
  int32_t leaf_max = 10;
  int32_t max_depth = 30;
  float ctrav = 1.0f;
  float cisec = 4.0f;
  int32_t leaf_cap = INT32_MAX;  // the kernels' max_leaf_tests (cap_order)

  int32_t large_leaf_no_split = 0;
  int32_t large_leaf_one_side = 0;

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

    // stable partition by barycenter vs. split plane (bvh.cpp:249-286;
    // numpy uses a stable index-gather — replicated here)
    std::vector<int32_t> idx(count);
    int32_t countA = 0;
    if (have_split) {
      for (int32_t i = 0; i < count; ++i)
        if (bary[(start + i) * 3 + axis] < split_x) idx[countA++] = i;
      int32_t k = countA;
      for (int32_t i = 0; i < count; ++i)
        if (!(bary[(start + i) * 3 + axis] < split_x)) idx[k++] = i;
    }
    if (countA == 0 || countA == count) {
      if (count > leaf_cap) {
        countA = cap_order(start, count, axis, idx);
      } else if (!have_split) {
        ++large_leaf_no_split;
        return make_leaf(start, count);
      } else {
        ++large_leaf_one_side;
        return make_leaf(start, count);
      }
    }
    const int32_t countB = count - countA;
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

  // The leaf cap's split (models/bvh.py _cap_split): a node no split
  // divides that holds more than leaf_cap triangles, which the kernels
  // would test only in part, is split in the stable order of its
  // barycenters on the axis, halved.  Returns the left count.
  int32_t cap_order(int32_t start, int32_t count, int axis, std::vector<int32_t>& idx) const {
    for (int32_t i = 0; i < count; ++i) idx[i] = i;
    std::stable_sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
      return bary[(start + a) * 3 + axis] < bary[(start + b) * 3 + axis];
    });
    return count / 2;
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
};

// --- SBVH: spatial splits (Stich et al. 2009) --------------------------------
//
// The numpy build models/sbvh.py (make_sbvh) in C++, split for split: the
// same binned object candidates over the three centroid axes, the same
// chopped spatial bins over the node box, the same clipping, padding and
// budget, the same leaf cap split where no split divides a node past the
// kernels' max_leaf_tests, evaluated in the numpy build's precisions (float32 boxes,
// bins and clips; float64 costs and planes, a plane compared as float32),
// so that the tree, its reference order and the flattened arrays are the
// numpy build's bit for bit.

constexpr int kSpatialBins = 32;  // models/sbvh.py SPATIAL_BINS

// numpy's float32 -> int64 cast on x86: NaN and out of range give INT64_MIN
int64_t trunc_i64(float v) {
  if (!(v > -9.2233720e18f && v < 9.2233720e18f)) return INT64_MIN;
  return (int64_t)v;
}

int clip_bin(float v, int bins) {
  return (int)std::min<int64_t>(std::max<int64_t>(trunc_i64(v), 0), bins - 1);
}

struct Ref {
  int32_t tri;
  float mn[3];
  float mx[3];
};

struct Split {
  bool ok = false;
  double cost = 0.0;
  int axis = -1;
  double x = 0.0;
  double overlap = 0.0;  // object splits: surface area of the children's overlap
};

// Prefix and suffix boxes of per-bin boxes: left[i] covers bins [0, i],
// right[i] covers bins [i, bins).
struct Scan {
  std::vector<float> bmin, bmax, lmin, lmax, rmin, rmax;
  explicit Scan(int bins)
      : bmin(bins * 3), bmax(bins * 3), lmin(bins * 3), lmax(bins * 3),
        rmin(bins * 3), rmax(bins * 3) {}
  void clear() {
    std::fill(bmin.begin(), bmin.end(), FLT_MAX);
    std::fill(bmax.begin(), bmax.end(), -FLT_MAX);
  }
  void add(int b, const float mn[3], const float mx[3]) {
    for (int d = 0; d < 3; ++d) {
      bmin[b * 3 + d] = std::min(bmin[b * 3 + d], mn[d]);
      bmax[b * 3 + d] = std::max(bmax[b * 3 + d], mx[d]);
    }
  }
  void scan(int bins) {
    for (int d = 0; d < 3; ++d) {
      lmin[d] = bmin[d];
      lmax[d] = bmax[d];
      rmin[(bins - 1) * 3 + d] = bmin[(bins - 1) * 3 + d];
      rmax[(bins - 1) * 3 + d] = bmax[(bins - 1) * 3 + d];
    }
    for (int b = 1; b < bins; ++b)
      for (int d = 0; d < 3; ++d) {
        lmin[b * 3 + d] = std::min(lmin[(b - 1) * 3 + d], bmin[b * 3 + d]);
        lmax[b * 3 + d] = std::max(lmax[(b - 1) * 3 + d], bmax[b * 3 + d]);
      }
    for (int b = bins - 2; b >= 0; --b)
      for (int d = 0; d < 3; ++d) {
        rmin[b * 3 + d] = std::min(rmin[(b + 1) * 3 + d], bmin[b * 3 + d]);
        rmax[b * 3 + d] = std::max(rmax[(b + 1) * 3 + d], bmax[b * 3 + d]);
      }
  }
};

struct SpatialBuilder : Tree {
  const float* verts = nullptr;  // T x 3 x 3
  int32_t T = 0;
  int32_t leaf_max = 10;
  int32_t max_depth = 30;
  int32_t leaf_cap = INT32_MAX;  // the kernels' max_leaf_tests (cap_split)
  double ctrav = 1.0;
  double cisec = 4.0;
  double alpha = 1e-5;
  float bumpout = 1e-5f;
  int64_t max_refs = 0;
  int64_t total_refs = 0;
  int32_t spatial_splits = 0;
  double sa_root = 1e-30;
  std::vector<int32_t> order;  // the leaves' references, leaf after leaf

  // models/sbvh.py _sa: the float32 surface area of max(0, mx - mn)
  static double sa(const float mn[3], const float mx[3]) {
    float d[3];
    for (int k = 0; k < 3; ++k) d[k] = std::max(0.0f, mx[k] - mn[k]);
    return (double)surface_area(d);
  }

  double cost(double sa_l, double sa_r, double area, int64_t nl, int64_t nr) const {
    return ctrav + cisec * (sa_l / area * (double)nl + sa_r / area * (double)nr);
  }

  int32_t make_leaf(const std::vector<Ref>& refs) {
    Node n;
    for (int d = 0; d < 3; ++d) {
      n.bmin[d] = FLT_MAX;
      n.bmax[d] = -FLT_MAX;
    }
    for (const Ref& r : refs)
      for (int d = 0; d < 3; ++d) {
        n.bmin[d] = std::min(n.bmin[d], r.mn[d]);
        n.bmax[d] = std::max(n.bmax[d], r.mx[d]);
      }
    n.start = (int32_t)order.size();
    n.count = (int32_t)refs.size();
    for (const Ref& r : refs) order.push_back(r.tri);
    nodes.push_back(n);
    ++leaf_count;
    return (int32_t)nodes.size() - 1;
  }

  // _object_candidates: binned SAH over each centroid axis
  Split object_split(const std::vector<Ref>& refs, double area) const {
    const int count = (int)refs.size();
    std::vector<float> cent((size_t)count * 3);
    float clo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float chi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = 0; i < count; ++i)
      for (int d = 0; d < 3; ++d) {
        const float c = 0.5f * (refs[i].mn[d] + refs[i].mx[d]);
        cent[i * 3 + d] = c;
        clo[d] = std::min(clo[d], c);
        chi[d] = std::max(chi[d], c);
      }
    const int nb = std::min(kSpatialBins, 2 * count);
    Scan bins(nb);
    std::vector<int64_t> cnt(nb), rcnt(nb);
    Split best;
    for (int a = 0; a < 3; ++a) {
      const double lo = clo[a], hi = chi[a];
      if (hi <= lo) continue;
      const float flo = (float)lo, fnb = (float)nb, fden = (float)(hi - lo);
      bins.clear();
      std::fill(cnt.begin(), cnt.end(), 0);
      for (int i = 0; i < count; ++i) {
        const int b = clip_bin((cent[i * 3 + a] - flo) * fnb / fden, nb);
        ++cnt[b];
        bins.add(b, refs[i].mn, refs[i].mx);
      }
      bins.scan(nb);
      rcnt[nb - 1] = cnt[nb - 1];
      for (int b = nb - 2; b >= 0; --b) rcnt[b] = cnt[b] + rcnt[b + 1];
      for (int i = 1; i < nb; ++i) {
        const int64_t nr = rcnt[i], nl = count - nr;
        if (nl == 0 || nr == 0) continue;
        const float* lmn = &bins.lmin[(i - 1) * 3];
        const float* lmx = &bins.lmax[(i - 1) * 3];
        const float* rmn = &bins.rmin[i * 3];
        const float* rmx = &bins.rmax[i * 3];
        const double c = cost(sa(lmn, lmx), sa(rmn, rmx), area, nl, nr);
        if (best.ok && !(c < best.cost)) continue;
        float omin[3], omax[3];
        bool overlaps = true;
        for (int d = 0; d < 3; ++d) {
          omin[d] = std::max(lmn[d], rmn[d]);
          omax[d] = std::min(lmx[d], rmx[d]);
          overlaps = overlaps && omin[d] <= omax[d];
        }
        best = {true, c, a, lo + (double)i * (hi - lo) / (double)nb,
                overlaps ? sa(omin, omax) : 0.0};
      }
    }
    return best;
  }

  // _spatial_candidates: chopped binning over each axis of the node box
  Split spatial_split(const std::vector<Ref>& refs, double area, const float nmin[3],
                      const float nmax[3]) const {
    const int count = (int)refs.size();
    Scan bins(kSpatialBins);
    std::vector<int64_t> entry(kSpatialBins), exit_(kSpatialBins);
    Split best;
    for (int a = 0; a < 3; ++a) {
      const double lo = nmin[a], hi = nmax[a];
      if (hi <= lo) continue;
      const double w = (hi - lo) / kSpatialBins;
      const float flo = (float)lo, fw = (float)w;
      bins.clear();
      std::fill(entry.begin(), entry.end(), 0);
      std::fill(exit_.begin(), exit_.end(), 0);
      for (int i = 0; i < count; ++i) {
        const Ref& r = refs[i];
        const int b_in = clip_bin((r.mn[a] - flo) / fw, kSpatialBins);
        const int b_out = clip_bin((r.mx[a] - flo) / fw, kSpatialBins);
        ++entry[b_in];
        ++exit_[b_out];
        for (int j = b_in; j <= b_out; ++j) {
          // the reference's extent chopped to the bin on the split axis
          float mn[3], mx[3];
          std::memcpy(mn, r.mn, sizeof(mn));
          std::memcpy(mx, r.mx, sizeof(mx));
          const float blo = (float)(lo + (double)j * w);
          mn[a] = std::max(mn[a], blo);
          mx[a] = std::min(mx[a], blo + fw);
          bins.add(j, mn, mx);
        }
      }
      bins.scan(kSpatialBins);
      int64_t nl = 0;
      int64_t nr = count;  // references exiting at or after plane i
      for (int i = 1; i < kSpatialBins; ++i) {
        nl += entry[i - 1];
        nr -= exit_[i - 1];
        if (nl == 0 || nr == 0) continue;
        const double c = cost(sa(&bins.lmin[(i - 1) * 3], &bins.lmax[(i - 1) * 3]),
                              sa(&bins.rmin[i * 3], &bins.rmax[i * 3]), area, nl, nr);
        if (!best.ok || c < best.cost) best = {true, c, a, lo + (double)i * w, 0.0};
      }
    }
    return best;
  }

  // _clip_tri_plane for one triangle: the boxes of its parts on each side
  // of p[axis] == x (a vertex on the plane belongs to both)
  void clip(int32_t tri, int axis, float x, float lmn[3], float lmx[3], float rmn[3],
            float rmx[3]) const {
    const float* V = verts + (size_t)tri * 9;
    for (int k = 0; k < 3; ++k) {
      lmn[k] = rmn[k] = FLT_MAX;
      lmx[k] = rmx[k] = -FLT_MAX;
    }
    auto accum = [](const float* p, float* mn, float* mx) {
      for (int k = 0; k < 3; ++k) {
        mn[k] = std::min(mn[k], p[k]);
        mx[k] = std::max(mx[k], p[k]);
      }
    };
    float d[3];
    for (int i = 0; i < 3; ++i) d[i] = V[i * 3 + axis] - x;
    for (int i = 0; i < 3; ++i) {
      if (d[i] <= 0.0f) accum(V + i * 3, lmn, lmx);
      if (d[i] >= 0.0f) accum(V + i * 3, rmn, rmx);
    }
    for (int i = 0; i < 3; ++i) {
      const int j = (i + 1) % 3;
      if (!(d[i] * d[j] < 0.0f)) continue;  // a strict sign change
      const float denom = d[i] - d[j];
      const float t = d[i] / (denom == 0.0f ? 1.0f : denom);
      float P[3];
      for (int k = 0; k < 3; ++k) P[k] = V[i * 3 + k] + t * (V[j * 3 + k] - V[i * 3 + k]);
      P[axis] = x;
      accum(P, lmn, lmx);
      accum(P, rmn, rmx);
    }
    lmx[axis] = std::min(lmx[axis], x);
    rmn[axis] = std::max(rmn[axis], x);
  }

  int32_t build(std::vector<Ref>& refs, int level) {
    const int64_t count = (int64_t)refs.size();
    if (level >= max_depth || count <= leaf_max) return make_leaf(refs);
    float nmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float nmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (const Ref& r : refs)
      for (int d = 0; d < 3; ++d) {
        nmin[d] = std::min(nmin[d], r.mn[d]);
        nmax[d] = std::max(nmax[d], r.mx[d]);
      }
    const double area = std::max(sa(nmin, nmax), 1e-30);
    const double leaf_cost = ctrav + cisec * (double)count;

    const Split obj = object_split(refs, area);
    Split plan;
    bool spatial = false;
    if (obj.ok && obj.cost < leaf_cost) plan = obj;
    const double overlap_frac = obj.ok ? obj.overlap / sa_root : 1.0;
    if (overlap_frac > alpha && total_refs <= max_refs) {
      const Split sp = spatial_split(refs, area, nmin, nmax);
      if (sp.ok && sp.cost < leaf_cost && (!plan.ok || sp.cost < plan.cost)) {
        plan = sp;
        spatial = true;
      }
    }
    if (!plan.ok) return count > leaf_cap ? cap_split(refs, nmin, nmax, level) : make_leaf(refs);

    const int a = plan.axis;
    const float x = (float)plan.x;  // numpy compares a float32 array with the plane in float32
    std::vector<Ref> left, right;
    int64_t dup = 0;
    if (spatial) {
      std::vector<Ref> lclip, rclip;
      for (const Ref& r : refs) {
        const bool left_only = r.mx[a] <= x;
        if (left_only) {
          left.push_back(r);
        } else if (r.mn[a] >= x) {
          right.push_back(r);
        } else {
          Ref l = r, q = r;
          clip(r.tri, a, x, l.mn, l.mx, q.mn, q.mx);
          bool lvalid = true, rvalid = true;
          for (int d = 0; d < 3; ++d) {
            // pad as TriangleSet pads whole triangles, within the ancestors' clips
            l.mn[d] = std::max(l.mn[d] - bumpout, r.mn[d]);
            l.mx[d] = std::min(l.mx[d] + bumpout, r.mx[d]);
            q.mn[d] = std::max(q.mn[d] - bumpout, r.mn[d]);
            q.mx[d] = std::min(q.mx[d] + bumpout, r.mx[d]);
          }
          for (int d = 0; d < 3; ++d) {
            lvalid = lvalid && l.mn[d] <= l.mx[d];
            rvalid = rvalid && q.mn[d] <= q.mx[d];
          }
          if (!lvalid && !rvalid) {  // a straddler lands somewhere: whole
            lvalid = true;
            l = r;
          }
          dup += lvalid && rvalid;
          if (lvalid) lclip.push_back(l);
          if (rvalid) rclip.push_back(q);
        }
      }
      left.insert(left.end(), lclip.begin(), lclip.end());
      right.insert(right.end(), rclip.begin(), rclip.end());
      const int64_t nl = (int64_t)left.size(), nr = (int64_t)right.size();
      if (nl == 0 || nr == 0 || nl == count || nr == count)
        return count > leaf_cap ? cap_split(refs, nmin, nmax, level) : make_leaf(refs);
      total_refs += dup;
      ++spatial_splits;
    } else {
      for (const Ref& r : refs) (0.5f * (r.mn[a] + r.mx[a]) < x ? left : right).push_back(r);
      if (left.empty() || right.empty())
        return count > leaf_cap ? cap_split(refs, nmin, nmax, level) : make_leaf(refs);
    }
    std::vector<Ref>().swap(refs);
    const int32_t neg = build(left, level + 1);
    return inner(a, nmin, nmax, neg, build(right, level + 1));
  }

  int32_t inner(int a, const float nmin[3], const float nmax[3], int32_t neg, int32_t pos) {
    Node n;
    std::memcpy(n.bmin, nmin, sizeof(n.bmin));
    std::memcpy(n.bmax, nmax, sizeof(n.bmax));
    n.axis = a;
    n.neg = neg;
    n.pos = pos;
    nodes.push_back(n);
    return (int32_t)nodes.size() - 1;
  }

  // models/sbvh.py cap_split: the references in the stable order of their
  // centroids on the widest centroid axis, halved
  int32_t cap_split(std::vector<Ref>& refs, const float nmin[3], const float nmax[3], int level) {
    const int32_t count = (int32_t)refs.size();
    std::vector<float> cent((size_t)count * 3);
    float clo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float chi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int32_t i = 0; i < count; ++i)
      for (int d = 0; d < 3; ++d) {
        const float c = 0.5f * (refs[i].mn[d] + refs[i].mx[d]);
        cent[i * 3 + d] = c;
        clo[d] = std::min(clo[d], c);
        chi[d] = std::max(chi[d], c);
      }
    int a = 0;
    for (int d = 1; d < 3; ++d)
      if (chi[d] - clo[d] > chi[a] - clo[a]) a = d;
    std::vector<int32_t> idx(count);
    for (int32_t i = 0; i < count; ++i) idx[i] = i;
    std::stable_sort(idx.begin(), idx.end(),
                     [&](int32_t p, int32_t q) { return cent[p * 3 + a] < cent[q * 3 + a]; });
    std::vector<Ref> left, right;
    for (int32_t k = 0; k < count; ++k) (k < count / 2 ? left : right).push_back(refs[idx[k]]);
    std::vector<Ref>().swap(refs);
    const int32_t neg = build(left, level + 1);
    return inner(a, nmin, nmax, neg, build(right, level + 1));
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
                    float cisec, int32_t leaf_cap, int32_t* out_node_count,
                    int32_t* out_root, int32_t* order) {
  Builder* b = new Builder();
  b->T = tri_count;
  b->leaf_max = leaf_max;
  b->leaf_cap = leaf_cap;
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
  return static_cast<Tree*>(b);
}

// Build the SBVH over tri_count triangles' vertices (T x 3 x 3) with the
// numpy build's knobs (models/sbvh.py make_sbvh). Returns an opaque handle
// for srt_bvh_fill, srt_bvh_leaf_count and srt_bvh_free, and the node
// count, the root's DFS index (-1 on failure), the reference count R and
// the spatial splits taken; srt_sbvh_order copies the R references.
void* srt_sbvh_build(const float* verts, int32_t tri_count, int32_t leaf_max,
                     int32_t max_depth, int32_t leaf_cap, double ctrav, double cisec,
                     double alpha, double ref_budget, float bumpout,
                     int32_t* out_node_count, int32_t* out_root,
                     int32_t* out_ref_count, int32_t* out_spatial_splits) {
  SpatialBuilder* b = new SpatialBuilder();
  b->verts = verts;
  b->T = tri_count;
  b->leaf_max = leaf_max;
  b->max_depth = max_depth;
  b->leaf_cap = leaf_cap;
  b->ctrav = ctrav;
  b->cisec = cisec;
  b->alpha = alpha;
  b->bumpout = bumpout;
  b->total_refs = tri_count;
  b->max_refs = (int64_t)((double)tri_count * ref_budget) + leaf_max + 1;
  std::vector<Ref> refs(tri_count);
  float root_min[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float root_max[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int32_t t = 0; t < tri_count; ++t) {
    Ref& r = refs[t];
    r.tri = t;
    for (int d = 0; d < 3; ++d) {
      float lo = FLT_MAX, hi = -FLT_MAX;
      for (int v = 0; v < 3; ++v) {
        lo = std::min(lo, verts[(size_t)t * 9 + v * 3 + d]);
        hi = std::max(hi, verts[(size_t)t * 9 + v * 3 + d]);
      }
      root_min[d] = std::min(root_min[d], lo);
      root_max[d] = std::max(root_max[d], hi);
      r.mn[d] = lo - bumpout;  // TriangleSet's padding of whole triangles
      r.mx[d] = hi + bumpout;
    }
  }
  b->sa_root = std::max(SpatialBuilder::sa(root_min, root_max), 1e-30);
  b->nodes.reserve(tri_count / 4 + 8);
  b->root = (tri_count == 0) ? b->make_leaf(refs) : b->build(refs, 0);
  b->verts = nullptr;
  b->assign_indices();
  *out_node_count = (int32_t)b->nodes.size();
  *out_root = (b->error == 0) ? b->perm[b->root] : -1;
  *out_ref_count = (int32_t)b->order.size();
  *out_spatial_splits = b->spatial_splits;
  return static_cast<Tree*>(b);
}

// Copy an SBVH's reference order (R int32: the triangle at each slot).
void srt_sbvh_order(void* handle, int32_t* order) {
  const SpatialBuilder* b =
      static_cast<const SpatialBuilder*>(static_cast<Tree*>(handle));
  std::memcpy(order, b->order.data(), sizeof(int32_t) * b->order.size());
}

// Fill flattened arrays in DFS numbering.  boxmin/boxmax are N*3,
// start/count/axis N, children N*2, hitmiss 8*N*2.  Returns 0 on
// success.
int32_t srt_bvh_fill(void* handle, float* boxmin, float* boxmax,
                     int32_t* start, int32_t* count, int32_t* children,
                     int32_t* axis, int32_t* hitmiss) {
  Tree* b = static_cast<Tree*>(handle);
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
  return static_cast<Tree*>(handle)->leaf_count;
}

void srt_bvh_free(void* handle) { delete static_cast<Tree*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// The 8-wide SAH collapse of ops/pack_wide.py _collapse_sah, step for step:
// the same float64 areas and costs, the same strict comparisons and tie
// order, the same forest order and BFS numbering, so the pack gives the
// same wide tree on either route.  Explicit stacks, no recursion.
// ---------------------------------------------------------------------------

namespace {

constexpr int kWide = 8;
constexpr int32_t kTinyLeafMax = 4;   // pack_wide.TINY_LEAF_MAX
constexpr int32_t kSmallLeafMax = 7;  // pack_wide.SMALL_LEAF_MAX
// _collapse_sah's costs: a cut internal node, a leaf child's fixed part
// and its part a slot of its unrolled test count
constexpr double kCNode = 1.0, kCLeafFixed = 0.8, kCSlot = 0.45;

struct Collapse {
  const int32_t* children;  // (n, 2)
  const int32_t* count;     // (n,) raw leaf counts
  std::vector<double> C;    // (n, kWide): C[b, i-1] best cost of subtree(b) as <= i roots
  std::vector<int8_t> K;    // (n, kWide): 0 keep b whole, k > 0 split k left, i-k right

  bool is_leaf(int32_t b) const { return count[b] > 0; }
  bool terminal(int32_t b) const { return is_leaf(b) || children[2 * b] < 0; }

  // forest(b, i): the roots that stand for subtree(b) in <= i slots, left
  // before right
  void forest(int32_t b, int i, std::vector<int32_t>* out) const {
    std::vector<std::pair<int32_t, int>> stack{{b, i}};
    while (!stack.empty()) {
      auto [x, slots] = stack.back();
      stack.pop_back();
      const int k = terminal(x) ? 0 : K[(size_t)x * kWide + slots - 1];
      if (k == 0) {
        out->push_back(x);
        continue;
      }
      stack.push_back({children[2 * x + 1], slots - k});
      stack.push_back({children[2 * x], k});
    }
  }

  // node_children_of(b): a wide node's child slots
  void node_children(int32_t b, std::vector<int32_t>* out) const {
    out->clear();
    if (is_leaf(b)) {
      out->push_back(b);
      return;
    }
    if (children[2 * b] < 0) return;
    const int32_t l = children[2 * b], r = children[2 * b + 1];
    double best = INFINITY;
    int bestk = 1;
    for (int k = 1; k < kWide; ++k) {
      const double c = C[(size_t)l * kWide + k - 1] + C[(size_t)r * kWide + kWide - k - 1];
      if (c < best) {
        best = c;
        bestk = k;
      }
    }
    forest(l, bestk, out);
    forest(r, kWide - bestk, out);
  }
};

}  // namespace

extern "C" {

// Collapse the flat binary tree (boxes n x 6 f32 lo.xyz hi.xyz, children
// n x 2, raw leaf counts n) into 8-wide nodes.  slots (n x 8) receives each
// wide node's child slots as binary node ids padded with -1, depth (n) each
// wide node's depth, wid (n) each binary node's wide id or -1.  Returns the
// wide node count (<= n), or -1 when the root is not a node or the
// nodes do not form a tree.
int32_t srt_collapse_sah(const float* boxes, const int32_t* children,
                         const int32_t* count, int32_t n, int32_t root,
                         int32_t* slots, int32_t* depth, int32_t* wid) {
  if (root < 0 || root >= n) return -1;
  std::vector<double> area(n);
  int32_t count_max = count[0];
  for (int32_t b = 0; b < n; ++b) {
    double e[3];
    for (int d = 0; d < 3; ++d) {
      const double x = (double)boxes[(size_t)b * 6 + 3 + d] - (double)boxes[(size_t)b * 6 + d];
      e[d] = x < 0.0 ? 0.0 : x;  // np.maximum(x, 0.0), NaN kept
    }
    area[b] = e[0] * e[1] + e[1] * e[2] + e[2] * e[0];
    count_max = std::max(count_max, count[b]);
  }
  const double area_root = area[root];
  if (area_root > 0)
    for (double& a : area) a = a / area_root;

  Collapse t{children, count, std::vector<double>((size_t)n * kWide, INFINITY),
             std::vector<int8_t>((size_t)n * kWide, 0)};
  auto unroll = [&](int32_t c) -> int32_t {
    if (c <= kTinyLeafMax) return kTinyLeafMax;
    if (c <= kSmallLeafMax) return kSmallLeafMax;
    return std::max(count_max, kSmallLeafMax + 1);
  };

  // pre-order from the root, then children before parents
  std::vector<int32_t> order, stack{root};
  std::vector<char> seen(n, 0);
  while (!stack.empty()) {
    const int32_t b = stack.back();
    stack.pop_back();
    if (seen[b]) continue;
    seen[b] = 1;
    order.push_back(b);
    if (!t.is_leaf(b) && children[2 * b] >= 0) {
      stack.push_back(children[2 * b]);
      stack.push_back(children[2 * b + 1]);
    }
  }
  for (auto it = order.rbegin(); it != order.rend(); ++it) {
    const int32_t b = *it;
    double* Cb = &t.C[(size_t)b * kWide];
    int8_t* Kb = &t.K[(size_t)b * kWide];
    if (t.terminal(b)) {
      const double c = area[b] * (kCLeafFixed + kCSlot * (double)unroll(count[b]));
      for (int i = 0; i < kWide; ++i) Cb[i] = c;
      continue;
    }
    const double* Cl = &t.C[(size_t)children[2 * b] * kWide];
    const double* Cr = &t.C[(size_t)children[2 * b + 1] * kWide];
    double dist[kWide + 1];
    int8_t dargk[kWide + 1];
    for (int i = 0; i <= kWide; ++i) {
      dist[i] = INFINITY;
      dargk[i] = 0;
    }
    for (int i = 2; i <= kWide; ++i)
      for (int k = 1; k < i; ++k) {
        const double c = Cl[k - 1] + Cr[i - k - 1];
        if (c < dist[i]) {
          dist[i] = c;
          dargk[i] = (int8_t)k;
        }
      }
    const double c_cut = area[b] * kCNode + dist[kWide];
    Cb[0] = c_cut;
    Kb[0] = 0;
    for (int i = 2; i <= kWide; ++i) {
      const bool split = dist[i] < c_cut;
      Cb[i - 1] = split ? dist[i] : c_cut;
      Kb[i - 1] = split ? dargk[i] : 0;
    }
  }

  // BFS with FIFO ids: parents precede children, root = 0
  std::fill(wid, wid + n, -1);
  std::vector<std::pair<int32_t, int32_t>> queue{{root, 0}};
  std::vector<int32_t> fr;
  wid[root] = 0;
  int32_t next_id = 1;
  for (size_t head = 0; head < queue.size(); ++head) {
    const auto [b, d] = queue[head];
    t.node_children(b, &fr);
    int32_t* row = slots + head * kWide;
    std::fill(row, row + kWide, -1);
    std::copy(fr.begin(), fr.end(), row);
    depth[head] = d;
    for (const int32_t f : fr)
      if (!t.is_leaf(f)) {
        if (next_id >= n) return -1;  // not a tree: more wide nodes than nodes
        wid[f] = next_id++;
        queue.push_back({f, d + 1});
      }
  }
  return (int32_t)queue.size();
}

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
