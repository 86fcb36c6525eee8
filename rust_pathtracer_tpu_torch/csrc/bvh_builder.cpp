// Native threaded-BVH builder.
//
// A copy of rust_pathtracer_tpu/csrc/bvh_builder.cpp (the port imports
// nothing of the JAX package), so that the port's default primitive
// order is the JAX package's default order.  Host-side counterpart of
// the reference's BvhNode::new (bvh.rs:65-103), for the flattened
// skip-link layout (see ../bvh.py for the algorithm contract; the numpy
// builder there is the oracle for this one):
//   * deterministic widest-extent centroid axis (reference used a random
//     axis, bvh.rs:67 — documented deviation),
//   * median (count) split via nth_element: O(n log n) total.  It leaves
//     each half in the standard library's (libstdc++) order, not numpy's
//     argpartition order, so this order and build_bvh_numpy's differ,
//   * DFS layout, first child at i+1, miss[] skip links, leaves hold up
//     to leaf_size primitives contiguous in prim_order.
//
// C ABI for ctypes (../native.py). Caller allocates 2n-node buffers.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Range {
  int64_t lo, hi;       // prim index range into the permutation
  int64_t out_offset;   // first reordered-prim slot for this subtree
  int32_t miss;         // miss link (or kPending)
};

constexpr int32_t kPending = -2;

}  // namespace

extern "C" int pt_build_bvh(
    const float* bbox_min,   // [n,3]
    const float* bbox_max,   // [n,3]
    int n,
    int leaf_size,
    float* node_min,         // [2n,3] out
    float* node_max,         // [2n,3] out
    int32_t* miss,           // [2n] out
    int32_t* leaf_first,     // [2n] out
    int32_t* leaf_count,     // [2n] out
    int32_t* prim_order      // [n] out
) {
  if (n <= 0 || leaf_size <= 0) return -1;

  std::vector<int64_t> perm(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = i;

  std::vector<float> cx(n), cy(n), cz(n);
  for (int64_t i = 0; i < n; ++i) {
    cx[i] = 0.5f * (bbox_min[3 * i + 0] + bbox_max[3 * i + 0]);
    cy[i] = 0.5f * (bbox_min[3 * i + 1] + bbox_max[3 * i + 1]);
    cz[i] = 0.5f * (bbox_min[3 * i + 2] + bbox_max[3 * i + 2]);
  }
  const float* cents[3] = {cx.data(), cy.data(), cz.data()};

  int32_t next_node = 0;
  std::vector<Range> stack;
  stack.push_back({0, n, 0, -1});

  while (!stack.empty()) {
    Range r = stack.back();
    stack.pop_back();
    const int32_t me = next_node++;

    float lo[3] = {3e38f, 3e38f, 3e38f};
    float hi[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = r.lo; i < r.hi; ++i) {
      const int64_t p = perm[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], bbox_min[3 * p + a]);
        hi[a] = std::max(hi[a], bbox_max[3 * p + a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      node_min[3 * me + a] = lo[a];
      node_max[3 * me + a] = hi[a];
    }
    miss[me] = r.miss;

    const int64_t count = r.hi - r.lo;
    if (count <= leaf_size) {
      leaf_first[me] = static_cast<int32_t>(r.out_offset);
      leaf_count[me] = static_cast<int32_t>(count);
      for (int64_t i = 0; i < count; ++i)
        prim_order[r.out_offset + i] = static_cast<int32_t>(perm[r.lo + i]);
      continue;
    }
    leaf_first[me] = 0;
    leaf_count[me] = 0;

    // widest centroid extent picks the split axis
    float cmin[3] = {3e38f, 3e38f, 3e38f};
    float cmax[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = r.lo; i < r.hi; ++i) {
      const int64_t p = perm[i];
      for (int a = 0; a < 3; ++a) {
        const float c = cents[a][p];
        cmin[a] = std::min(cmin[a], c);
        cmax[a] = std::max(cmax[a], c);
      }
    }
    int axis = 0;
    float best = cmax[0] - cmin[0];
    for (int a = 1; a < 3; ++a) {
      const float e = cmax[a] - cmin[a];
      if (e > best) { best = e; axis = a; }
    }

    const int64_t half = count / 2;
    const float* cen = cents[axis];
    std::nth_element(
        perm.begin() + r.lo, perm.begin() + r.lo + half, perm.begin() + r.hi,
        [cen](int64_t a, int64_t b) { return cen[a] < cen[b]; });

    // DFS order: right pushed first (popped later), left is node me+1.
    stack.push_back({r.lo + half, r.hi, r.out_offset + half, r.miss});
    stack.push_back({r.lo, r.lo + half, r.out_offset, kPending});
  }

  // resolve pending miss links: a left child's miss is its right
  // sibling = the node right after its own DFS subtree
  for (int32_t i = 0; i < next_node; ++i) {
    if (miss[i] != kPending) continue;
    int32_t depth = 0;
    int32_t j = i;
    while (j < next_node) {
      if (leaf_count[j] > 0) {
        if (depth == 0) { miss[i] = j + 1; break; }
        --depth;
      } else {
        ++depth;
      }
      ++j;
    }
  }
  return next_node;
}
