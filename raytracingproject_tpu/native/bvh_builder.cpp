// Native binned-SAH BVH2 builder (ref: bvh/bvh_build.cpp BVHBuild,
// bvh/bvh_binning.cpp — re-implemented for the SoA node layout used by
// the traversal kernels, see bvh/build.py for the layout contract).
//
// C ABI consumed via ctypes (no pybind11 in this image). The output
// arrays follow exactly the Python builder's contract:
//   bounds   (M, 12) float32 : child0 lo/hi, child1 lo/hi
//   children (M, 2)  int32   : >=0 inner child; <0 leaf enc
//                              -(1 + (start << 4) + count)
//   prim_order (P,) int32    : new position -> original primitive
//
// Multithreaded: the top levels of the tree spawn tasks; below a
// threshold each subtree is built serially (the same shape as the
// reference's TBB task recursion, bvh_build.cpp:415-524).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int NUM_BINS = 16;
constexpr float INF = std::numeric_limits<float>::infinity();

struct V3 {
  float x, y, z;
  V3() : x(INF), y(INF), z(INF) {}
  V3(float a, float b, float c) : x(a), y(b), z(c) {}
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return V3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return V3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct BBox {
  V3 lo{INF, INF, INF};
  V3 hi{-INF, -INF, -INF};
  void grow(const V3 &l, const V3 &h) {
    lo = vmin(lo, l);
    hi = vmax(hi, h);
  }
  void grow(const BBox &b) { grow(b.lo, b.hi); }
  float half_area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Node {
  float bounds[12];
  int32_t child[2];
};

struct Builder {
  const float *lo, *hi;
  std::vector<V3> cent;
  int max_leaf;
  std::vector<Node> nodes;
  // the build partitions this array in place; when it ends, it is the
  // prim order and every subtree covers one contiguous range of it
  int32_t *idx_base = nullptr;
  std::mutex mu;  // guards nodes growth

  int new_node() {
    std::lock_guard<std::mutex> g(mu);
    nodes.emplace_back();
    return (int)nodes.size() - 1;
  }

  // a leaf's prims are its slice of idx_base, so leaves built by
  // different threads never interleave
  int32_t leaf_child(const int32_t *idx, int n) const {
    int start = (int)(idx - idx_base);
    return -(1 + (start << 4) + n);
  }

  BBox range_bounds(const int32_t *idx, int n) const {
    BBox b;
    for (int i = 0; i < n; i++) {
      int p = idx[i];
      b.grow(V3(lo[3 * p], lo[3 * p + 1], lo[3 * p + 2]),
             V3(hi[3 * p], hi[3 * p + 1], hi[3 * p + 2]));
    }
    return b;
  }

  // returns split position in idx (elements swapped in place), or -1
  // for "make a leaf"
  int split(int32_t *idx, int n) {
    if (n <= max_leaf) return -1;
    // centroid bounds
    BBox cb;
    for (int i = 0; i < n; i++) {
      const V3 &c = cent[idx[i]];
      cb.grow(c, c);
    }
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    float clo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
    if (ext[axis] <= 1e-12f) {
      // degenerate: median split
      int half = n / 2;
      std::nth_element(idx, idx + half, idx + n, [&](int a, int b) {
        auto key = [&](int p) {
          return axis == 0 ? cent[p].x : (axis == 1 ? cent[p].y : cent[p].z);
        };
        return key(a) < key(b);
      });
      return half;
    }
    float scale = NUM_BINS * (1.0f - 1e-6f) / ext[axis];
    int counts[NUM_BINS] = {0};
    BBox bins[NUM_BINS];
    std::vector<uint8_t> bin_of(n);
    for (int i = 0; i < n; i++) {
      int p = idx[i];
      float c = axis == 0 ? cent[p].x : (axis == 1 ? cent[p].y : cent[p].z);
      int b = (int)((c - clo) * scale);
      if (b < 0) b = 0;
      if (b >= NUM_BINS) b = NUM_BINS - 1;
      bin_of[i] = (uint8_t)b;
      counts[b]++;
      bins[b].grow(V3(lo[3 * p], lo[3 * p + 1], lo[3 * p + 2]),
                   V3(hi[3 * p], hi[3 * p + 1], hi[3 * p + 2]));
    }
    // sweep SAH
    float larea[NUM_BINS], rarea[NUM_BINS];
    int lcount[NUM_BINS];
    BBox acc;
    int cacc = 0;
    for (int i = 0; i < NUM_BINS; i++) {
      acc.grow(bins[i]);
      cacc += counts[i];
      larea[i] = acc.half_area();
      lcount[i] = cacc;
    }
    BBox racc;
    for (int i = NUM_BINS - 1; i >= 0; i--) {
      racc.grow(bins[i]);
      rarea[i] = racc.half_area();
    }
    float best_sah = INF;
    int best = -1;
    for (int i = 0; i < NUM_BINS - 1; i++) {
      int lc = lcount[i], rc = n - lc;
      if (lc == 0 || rc == 0) continue;
      float sah = larea[i] * lc + rarea[i + 1] * rc;
      if (sah < best_sah) {
        best_sah = sah;
        best = i;
      }
    }
    if (best < 0) {
      int half = n / 2;
      std::nth_element(idx, idx + half, idx + n, [&](int a, int b) {
        auto key = [&](int p) {
          return axis == 0 ? cent[p].x : (axis == 1 ? cent[p].y : cent[p].z);
        };
        return key(a) < key(b);
      });
      return half;
    }
    // SAH leaf test (ref: bvh_build.cpp:572-600), leaf max 8 = LEAF_UNROLL
    if (max_leaf > 1 && n <= 8) {
      BBox whole = range_bounds(idx, n);
      float wa = std::max(whole.half_area(), 1e-20f);
      float split_cost = 0.125f + best_sah / wa;
      if (split_cost >= (float)n) return -1;
    }
    // partition by bin
    int i = 0, j = n - 1;
    while (i <= j) {
      if (bin_of[i] <= best) {
        i++;
      } else {
        std::swap(idx[i], idx[j]);
        std::swap(bin_of[i], bin_of[j]);
        j--;
      }
    }
    if (i == 0 || i == n) return n / 2;  // safety
    return i;
  }

  void build_range(int node_id, int32_t *idx, int n, int depth) {
    int pos = split(idx, n);
    Node local;
    if (pos < 0) {
      BBox b = range_bounds(idx, n);
      local.bounds[0] = b.lo.x; local.bounds[1] = b.lo.y; local.bounds[2] = b.lo.z;
      local.bounds[3] = b.hi.x; local.bounds[4] = b.hi.y; local.bounds[5] = b.hi.z;
      local.bounds[6] = INF; local.bounds[7] = INF; local.bounds[8] = INF;
      local.bounds[9] = -INF; local.bounds[10] = -INF; local.bounds[11] = -INF;
      local.child[0] = leaf_child(idx, n);
      local.child[1] = -1;  // empty leaf enc(0,0)
      {
        std::lock_guard<std::mutex> g(mu);
        nodes[node_id] = local;
      }
      return;
    }
    int32_t *left = idx, *right = idx + pos;
    int ln = pos, rn = n - pos;
    BBox lb = range_bounds(left, ln), rb = range_bounds(right, rn);
    local.bounds[0] = lb.lo.x; local.bounds[1] = lb.lo.y; local.bounds[2] = lb.lo.z;
    local.bounds[3] = lb.hi.x; local.bounds[4] = lb.hi.y; local.bounds[5] = lb.hi.z;
    local.bounds[6] = rb.lo.x; local.bounds[7] = rb.lo.y; local.bounds[8] = rb.lo.z;
    local.bounds[9] = rb.hi.x; local.bounds[10] = rb.hi.y; local.bounds[11] = rb.hi.z;

    int lchild = -1, rchild = -1;
    bool lleaf = ln <= max_leaf, rleaf = rn <= max_leaf;
    if (lleaf) local.child[0] = leaf_child(left, ln);
    else { lchild = new_node(); local.child[0] = lchild; }
    if (rleaf) local.child[1] = leaf_child(right, rn);
    else { rchild = new_node(); local.child[1] = rchild; }
    {
      std::lock_guard<std::mutex> g(mu);
      nodes[node_id] = local;
    }
    // parallel recursion near the top (ref: TBB task split)
    bool parallel = depth < 4 && ln > 4096 && rn > 4096;
    if (parallel) {
      std::thread t([this, lchild, left, ln, depth]() {
        build_range(lchild, left, ln, depth + 1);
      });
      if (!rleaf) build_range(rchild, right, rn, depth + 1);
      t.join();
      return;
    }
    if (!lleaf) build_range(lchild, left, ln, depth + 1);
    if (!rleaf) build_range(rchild, right, rn, depth + 1);
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees with rtp_free.
int rtp_build_bvh(const float *lo, const float *hi, int nprims,
                  int max_leaf_size, float **out_bounds,
                  int32_t **out_children, int32_t *out_nnodes,
                  int32_t **out_prim_order) {
  Builder b;
  b.lo = lo;
  b.hi = hi;
  b.max_leaf = max_leaf_size;
  b.cent.resize(nprims);
  for (int i = 0; i < nprims; i++) {
    b.cent[i] = V3(0.5f * (lo[3 * i] + hi[3 * i]),
                   0.5f * (lo[3 * i + 1] + hi[3 * i + 1]),
                   0.5f * (lo[3 * i + 2] + hi[3 * i + 2]));
  }
  b.nodes.reserve(std::max(2 * nprims / std::max(max_leaf_size, 1), 16));

  std::vector<int32_t> idx(nprims);
  for (int i = 0; i < nprims; i++) idx[i] = i;
  b.idx_base = idx.data();

  if (nprims == 0) {
    b.nodes.emplace_back();
    Node &n0 = b.nodes[0];
    std::memset(n0.bounds, 0, sizeof(n0.bounds));
    n0.child[0] = -1;
    n0.child[1] = -1;
  } else {
    int root = b.new_node();
    b.build_range(root, idx.data(), nprims, 0);
  }

  int nn = (int)b.nodes.size();
  *out_bounds = (float *)std::malloc(sizeof(float) * 12 * nn);
  *out_children = (int32_t *)std::malloc(sizeof(int32_t) * 2 * nn);
  for (int i = 0; i < nn; i++) {
    std::memcpy(*out_bounds + 12 * i, b.nodes[i].bounds, 12 * sizeof(float));
    (*out_children)[2 * i] = b.nodes[i].child[0];
    (*out_children)[2 * i + 1] = b.nodes[i].child[1];
  }
  *out_nnodes = nn;
  *out_prim_order =
      (int32_t *)std::malloc(sizeof(int32_t) * std::max(nprims, 1));
  std::memcpy(*out_prim_order, idx.data(), sizeof(int32_t) * nprims);
  return 0;
}

void rtp_free(void *p) { std::free(p); }

}  // extern "C"
