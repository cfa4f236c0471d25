// Compact 3-D kd-tree: build + 1-NN / k-NN queries.
//
// Native counterpart of the reference's vendored nanoflann
// (4DRadarSLAM/include/scan_context/nanoflann.hpp, 2040 LoC) and of
// pcl::search::KdTree as used for correspondences — kept for host-side
// validation of the brute-force NN search and for CPU-only deployments.
// Iterative build (median split on the widest axis), heap-based kNN.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace gorio {

struct KDNode {
  int32_t left = -1;
  int32_t right = -1;
  int32_t begin = 0;  // leaf: range into indices
  int32_t end = 0;
  int8_t axis = -1;   // -1 => leaf
  float split = 0.f;
};

class KDTree {
 public:
  void build(const float* pts, int n, int leaf_size = 16) {
    pts_.assign(pts, pts + 3 * n);
    idx_.resize(n);
    for (int i = 0; i < n; ++i) idx_[i] = i;
    nodes_.clear();
    nodes_.reserve(2 * n / leaf_size + 8);
    leaf_size_ = leaf_size;
    if (n > 0) build_range(0, n);
  }

  void knn(const float* q, int k, int32_t* out_idx, float* out_d2) const {
    // max-heap of (d2, idx)
    std::priority_queue<std::pair<float, int32_t>> heap;
    search(0, q, k, heap);
    int m = static_cast<int>(heap.size());
    for (int i = m - 1; i >= 0; --i) {
      out_d2[i] = heap.top().first;
      out_idx[i] = heap.top().second;
      heap.pop();
    }
    for (int i = m; i < k; ++i) {
      out_idx[i] = -1;
      out_d2[i] = INFINITY;
    }
  }

 private:
  int32_t build_range(int begin, int end) {
    int32_t id = static_cast<int32_t>(nodes_.size());
    nodes_.emplace_back();
    if (end - begin <= leaf_size_) {
      nodes_[id].begin = begin;
      nodes_[id].end = end;
      return id;
    }
    // widest axis
    float mn[3] = {INFINITY, INFINITY, INFINITY};
    float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int i = begin; i < end; ++i) {
      const float* p = &pts_[3 * idx_[i]];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], p[a]);
        mx[a] = std::max(mx[a], p[a]);
      }
    }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (mx[a] - mn[a] > mx[axis] - mn[axis]) axis = a;
    int mid = (begin + end) / 2;
    std::nth_element(idx_.begin() + begin, idx_.begin() + mid, idx_.begin() + end,
                     [&](int32_t a, int32_t b) {
                       return pts_[3 * a + axis] < pts_[3 * b + axis];
                     });
    float split = pts_[3 * idx_[mid] + axis];
    nodes_[id].axis = static_cast<int8_t>(axis);
    nodes_[id].split = split;
    int32_t l = build_range(begin, mid);
    int32_t r = build_range(mid, end);
    nodes_[id].left = l;
    nodes_[id].right = r;
    return id;
  }

  void search(int32_t node, const float* q, int k,
              std::priority_queue<std::pair<float, int32_t>>& heap) const {
    const KDNode& nd = nodes_[node];
    if (nd.axis < 0) {
      for (int i = nd.begin; i < nd.end; ++i) {
        const float* p = &pts_[3 * idx_[i]];
        float d2 = 0.f;
        for (int a = 0; a < 3; ++a) {
          float d = p[a] - q[a];
          d2 += d * d;
        }
        if (static_cast<int>(heap.size()) < k)
          heap.emplace(d2, idx_[i]);
        else if (d2 < heap.top().first) {
          heap.pop();
          heap.emplace(d2, idx_[i]);
        }
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int32_t near = diff <= 0 ? nd.left : nd.right;
    int32_t far = diff <= 0 ? nd.right : nd.left;
    search(near, q, k, heap);
    if (static_cast<int>(heap.size()) < k || diff * diff < heap.top().first)
      search(far, q, k, heap);
  }

  std::vector<float> pts_;
  std::vector<int32_t> idx_;
  std::vector<KDNode> nodes_;
  int leaf_size_ = 16;
};

}  // namespace gorio

extern "C" {

void* gorio_kdtree_create(const float* pts, int n, int leaf_size) {
  auto* t = new gorio::KDTree();
  t->build(pts, n, leaf_size > 0 ? leaf_size : 16);
  return t;
}

void gorio_kdtree_destroy(void* tree) { delete static_cast<gorio::KDTree*>(tree); }

void gorio_kdtree_knn(void* tree, const float* queries, int nq, int k,
                      int32_t* out_idx, float* out_d2) {
  auto* t = static_cast<gorio::KDTree*>(tree);
  for (int i = 0; i < nq; ++i) {
    t->knn(queries + 3 * i, k, out_idx + (size_t)k * i, out_d2 + (size_t)k * i);
  }
}

}  // extern "C"
