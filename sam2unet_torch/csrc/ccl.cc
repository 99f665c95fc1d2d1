// Host-side connected-component labeling (8-connectivity) with per-component
// area counting. The framework's C++ replacement for the reference's
// CUDA union-find kernel (sam2/csrc/connected_components.cu:20-289); same
// output contract: labels (0 = background, component-id otherwise) and
// counts (component area broadcast to every member pixel). The PyTorch
// port's copy of csrc/ccl.cc.
//
// Algorithm: classic two-pass union-find with path compression over the
// raster scan (checks W, NW, N, NE neighbors), then a relabeling pass that
// assigns ids in first-root-seen order and a final pass writing areas.
//
// Built with g++ at first use by sam2unet_torch/ops/connected_components.py
// (into build/native/<hash>/libccl.so at the repository root).

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  void unite(int32_t a, int32_t b) {
    int32_t ra = find(a), rb = find(b);
    if (ra != rb) parent[ra < rb ? rb : ra] = ra < rb ? ra : rb;
  }
};

}  // namespace

extern "C" {

// mask: (h, w) uint8; labels/counts: (h, w) int32, fully overwritten.
// Returns the number of components, or -1 for unsupported sizes.
int32_t ccl_label_u8(const uint8_t* mask, int32_t* labels, int32_t* counts,
                     int32_t h, int32_t w) {
  const size_t n = static_cast<size_t>(h) * w;
  // pixel indices are carried as int32: refuse sizes that would wrap
  // (callers fall back to the scipy path on a negative return)
  if (h < 0 || w < 0 || n > static_cast<size_t>(INT32_MAX)) return -1;
  UnionFind uf(n);

  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const size_t i = static_cast<size_t>(y) * w + x;
      if (!mask[i]) continue;
      if (x > 0 && mask[i - 1]) uf.unite(static_cast<int32_t>(i), static_cast<int32_t>(i - 1));
      if (y > 0) {
        const size_t up = i - w;
        if (mask[up]) uf.unite(static_cast<int32_t>(i), static_cast<int32_t>(up));
        if (x > 0 && mask[up - 1]) uf.unite(static_cast<int32_t>(i), static_cast<int32_t>(up - 1));
        if (x + 1 < w && mask[up + 1]) uf.unite(static_cast<int32_t>(i), static_cast<int32_t>(up + 1));
      }
    }
  }

  // second pass: compress roots to dense first-seen ids and count areas
  std::vector<int32_t> root_to_id(n, 0);
  std::vector<int32_t> areas;
  areas.push_back(0);  // background slot
  int32_t next_id = 0;
  for (size_t i = 0; i < n; ++i) {
    if (!mask[i]) {
      labels[i] = 0;
      continue;
    }
    const int32_t root = uf.find(static_cast<int32_t>(i));
    int32_t id = root_to_id[root];
    if (id == 0) {
      id = ++next_id;
      root_to_id[root] = id;
      areas.push_back(0);
    }
    labels[i] = id;
    ++areas[id];
  }
  for (size_t i = 0; i < n; ++i) {
    counts[i] = labels[i] ? areas[labels[i]] : 0;
  }
  return next_id;
}

}  // extern "C"
