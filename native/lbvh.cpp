// Native LBVH builder — the performance path behind ops/bvh.py.
//
// Same algorithm and output contract as the NumPy builder
// (vulkan_pathtracer_tpu/ops/bvh.py): 30-bit Morton codes over
// triangle centroids, radix-friendly sort, highest-differing-bit
// range splits with median fallback, preorder emission with skip
// (escape) pointers and contiguous leaf triangle ranges.
//
// This is the equivalent of the work the Vulkan driver does
// inside vkCmdBuildAccelerationStructuresKHR for the reference
// (RaytracingPass.zig:451-465); the reference's host-side native
// ingestion discipline (Zig + C libs) maps to this C++ extension,
// loaded via ctypes with a pure-NumPy fallback.
//
// C ABI:
//   int lbvh_build(const float* v0, const float* e1, const float* e2,
//                  int64 n_tris, int max_leaf_size,
//                  float* bmin, float* bmax,          // cap 2n x 3
//                  int32* skip, int32* leaf_first,    // cap 2n
//                  int32* leaf_count, int32* left, int32* right,
//                  int64* tri_order)                  // n
//   returns node_count (>= 1), or -1 on error.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
};

inline uint32_t expand_bits(uint32_t v) {
    v &= 0x3FFu;
    v = (v | (v << 16)) & 0x030000FFu;
    v = (v | (v << 8)) & 0x0300F00Fu;
    v = (v | (v << 4)) & 0x030C30C3u;
    v = (v | (v << 2)) & 0x09249249u;
    return v;
}

inline uint32_t morton3d(uint32_t x, uint32_t y, uint32_t z) {
    return expand_bits(x) | (expand_bits(y) << 1) | (expand_bits(z) << 2);
}

struct Builder {
    int64_t n;
    int max_leaf;
    // sorted per-triangle data
    std::vector<uint32_t> codes;
    std::vector<double> tmin;  // n x 3
    std::vector<double> tmax;  // n x 3
    // outputs
    float* bmin;
    float* bmax;
    int32_t* skip;
    int32_t* leaf_first;
    int32_t* leaf_count;
    int32_t* left;
    int32_t* right;
    int64_t node_count = 0;
    int64_t cap;

    int64_t find_split(int64_t start, int64_t end) const {
        int64_t split;
        uint32_t first = codes[start];
        uint32_t last = codes[end - 1];
        if (first == last) {
            split = (start + end) / 2;
        } else {
            uint32_t common = first ^ last;
            int split_bit = 31 - __builtin_clz(common);
            uint32_t mask = 1u << split_bit;
            // binary search for the first index with the bit set
            int64_t lo = start, hi = end;  // codes[start]&mask==0
            while (lo + 1 < hi) {
                int64_t mid = (lo + hi) / 2;
                if (codes[mid] & mask)
                    hi = mid;
                else
                    lo = mid;
            }
            split = hi;
            if (split <= start || split >= end) split = (start + end) / 2;
        }
        // Snap to a leaf-block multiple (ranges start block-aligned
        // from the root, so every leaf fills a whole block — halves
        // node count and memory footprint vs ragged leaves).
        int64_t b = max_leaf;
        int64_t rel = split - start;
        int64_t snapped = ((rel + b / 2) / b) * b;
        if (snapped <= 0) snapped = b;
        if (start + snapped >= end) snapped = ((end - start - 1) / b) * b;
        if (snapped <= 0) snapped = b;
        split = start + snapped;
        if (split >= end) split = (start + end) / 2;  // tiny ranges
        return split;
    }

    // Iterative preorder emission with an explicit stack.
    // Each frame: [start, end), plus a slot to patch skip afterwards.
    void build() {
        struct Frame {
            int64_t start, end;
            int64_t node;   // -1 until emitted
            int state;      // 0 = emit, 1 = after subtree (patch skip)
        };
        std::vector<Frame> stack;
        stack.push_back({0, n, -1, 0});
        std::vector<int64_t> patch_stack;  // nodes awaiting skip patch

        while (!stack.empty()) {
            Frame f = stack.back();
            stack.pop_back();
            if (f.state == 1) {
                // subtree finished: skip = next node index
                skip[f.node] = static_cast<int32_t>(node_count);
                continue;
            }
            int64_t node = node_count++;
            // AABBs are filled bottom-up after topology (O(n) total
            // instead of O(n*depth) per-range recomputes).
            leaf_first[node] = -1;  // provisional; set below for leaves

            // schedule the skip patch to run after this subtree
            stack.push_back({f.start, f.end, node, 1});

            if (f.end - f.start <= max_leaf) {
                leaf_first[node] = static_cast<int32_t>(f.start);
                leaf_count[node] = static_cast<int32_t>(f.end - f.start);
                left[node] = -1;
                right[node] = -1;
            } else {
                leaf_first[node] = -1;
                leaf_count[node] = 0;
                int64_t split = find_split(f.start, f.end);
                // preorder: left subtree first -> push right THEN left
                stack.push_back({split, f.end, -1, 0});
                stack.push_back({f.start, split, -1, 0});
                // children indices: left = node+1; right discovered at
                // patch time is awkward — record via a second pass below.
                left[node] = static_cast<int32_t>(node + 1);
                right[node] = -2;  // fixed up after build via skip of left
            }
        }
        // Fix up right children: right(child) = skip(left child).
        for (int64_t i = 0; i < node_count; ++i) {
            if (right[i] == -2) right[i] = skip[left[i]];
        }
        // Bottom-up AABBs: children always have larger preorder
        // indices than their parent, so a reverse sweep sees children
        // before parents.
        for (int64_t node = node_count - 1; node >= 0; --node) {
            double bx = 1e300, by = 1e300, bz = 1e300;
            double ux = -1e300, uy = -1e300, uz = -1e300;
            if (leaf_first[node] >= 0) {
                int64_t s = leaf_first[node];
                int64_t e = s + leaf_count[node];
                for (int64_t i = s; i < e; ++i) {
                    bx = std::min(bx, tmin[i * 3 + 0]);
                    by = std::min(by, tmin[i * 3 + 1]);
                    bz = std::min(bz, tmin[i * 3 + 2]);
                    ux = std::max(ux, tmax[i * 3 + 0]);
                    uy = std::max(uy, tmax[i * 3 + 1]);
                    uz = std::max(uz, tmax[i * 3 + 2]);
                }
            } else {
                for (int32_t c : {left[node], right[node]}) {
                    bx = std::min(bx, (double)bmin[c * 3 + 0]);
                    by = std::min(by, (double)bmin[c * 3 + 1]);
                    bz = std::min(bz, (double)bmin[c * 3 + 2]);
                    ux = std::max(ux, (double)bmax[c * 3 + 0]);
                    uy = std::max(uy, (double)bmax[c * 3 + 1]);
                    uz = std::max(uz, (double)bmax[c * 3 + 2]);
                }
            }
            bmin[node * 3 + 0] = static_cast<float>(bx);
            bmin[node * 3 + 1] = static_cast<float>(by);
            bmin[node * 3 + 2] = static_cast<float>(bz);
            bmax[node * 3 + 0] = static_cast<float>(ux);
            bmax[node * 3 + 1] = static_cast<float>(uy);
            bmax[node * 3 + 2] = static_cast<float>(uz);
        }
    }
};

}  // namespace

extern "C" int64_t lbvh_build(
    const float* v0, const float* e1, const float* e2, int64_t n_tris,
    int max_leaf_size, float* bmin, float* bmax, int32_t* skip,
    int32_t* leaf_first, int32_t* leaf_count, int32_t* left,
    int32_t* right, int64_t* tri_order) {
    if (n_tris <= 0) return -1;

    // Triangle AABBs + centroids.
    std::vector<double> tmin(n_tris * 3), tmax(n_tris * 3),
        centroid(n_tris * 3);
    double smin[3] = {1e300, 1e300, 1e300};
    double smax[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = 0; i < n_tris; ++i) {
        for (int k = 0; k < 3; ++k) {
            double a = v0[i * 3 + k];
            double b = a + e1[i * 3 + k];
            double c = a + e2[i * 3 + k];
            double lo = std::min(a, std::min(b, c));
            double hi = std::max(a, std::max(b, c));
            tmin[i * 3 + k] = lo;
            tmax[i * 3 + k] = hi;
            double mid = (lo + hi) * 0.5;
            centroid[i * 3 + k] = mid;
            smin[k] = std::min(smin[k], mid);
            smax[k] = std::max(smax[k], mid);
        }
    }

    // Morton codes (match ops/bvh.py: normalize to centroid bounds).
    std::vector<uint32_t> codes(n_tris);
    double ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = std::max(smax[k] - smin[k], 1e-12);
    for (int64_t i = 0; i < n_tris; ++i) {
        uint32_t q[3];
        for (int k = 0; k < 3; ++k) {
            double v = (centroid[i * 3 + k] - smin[k]) / ext[k] * 1023.0;
            v = std::min(std::max(v, 0.0), 1023.0);
            q[k] = static_cast<uint32_t>(v);
        }
        codes[i] = morton3d(q[0], q[1], q[2]);
    }

    // Stable sort by code.
    std::vector<int64_t> order(n_tris);
    for (int64_t i = 0; i < n_tris; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return codes[a] < codes[b]; });

    Builder bld;
    bld.n = n_tris;
    bld.max_leaf = max_leaf_size;
    bld.cap = 2 * n_tris;
    bld.codes.resize(n_tris);
    bld.tmin.resize(n_tris * 3);
    bld.tmax.resize(n_tris * 3);
    for (int64_t i = 0; i < n_tris; ++i) {
        int64_t src = order[i];
        bld.codes[i] = codes[src];
        for (int k = 0; k < 3; ++k) {
            bld.tmin[i * 3 + k] = tmin[src * 3 + k];
            bld.tmax[i * 3 + k] = tmax[src * 3 + k];
        }
        tri_order[i] = src;
    }
    bld.bmin = bmin;
    bld.bmax = bmax;
    bld.skip = skip;
    bld.leaf_first = leaf_first;
    bld.leaf_count = leaf_count;
    bld.left = left;
    bld.right = right;
    bld.build();
    return bld.node_count;
}

// ---------------------------------------------------------------------------
// Octant-ordered linearizations.
//
// Skip-pointer traversal visits children in a FIXED order, so rays
// moving "backwards" through the scene find far hits first and keep
// traversing with a large t_best. Emitting 8 DFS orders — one per ray
// direction octant, visiting at every internal node the child nearer
// along the dominant child-separation axis first — restores
// near-to-far ordering with zero extra per-ray state: the ray just
// adds octant * node_count to its cursor.
//
// Outputs, per octant o (concatenated, stride node_count):
//   skip8 / leaf_first8 / leaf_count8: node records in octant-o preorder
//     (skip values are LOCAL 0..node_count; caller adds the offset)
//   perm8: octant-order index -> build-order node index (for AABB
//     gathers and refit updates)
extern "C" int lbvh_octant_orders(
    int64_t node_count, const float* bmin, const float* bmax,
    const int32_t* left, const int32_t* right, const int32_t* leaf_first,
    const int32_t* leaf_count, int32_t* skip8, int32_t* leaf_first8,
    int32_t* leaf_count8, int32_t* perm8) {
    if (node_count <= 0) return -1;

    // Per internal node: dominant separation axis + which child is
    // "lower" along it.
    std::vector<uint8_t> axis(node_count, 0);
    std::vector<uint8_t> left_is_lower(node_count, 1);
    for (int64_t i = 0; i < node_count; ++i) {
        int32_t l = left[i], r = right[i];
        if (l < 0) continue;
        double best = -1.0;
        for (int k = 0; k < 3; ++k) {
            double cl = 0.5 * (double(bmin[l * 3 + k]) + double(bmax[l * 3 + k]));
            double cr = 0.5 * (double(bmin[r * 3 + k]) + double(bmax[r * 3 + k]));
            double d = std::abs(cr - cl);
            if (d > best) {
                best = d;
                axis[i] = static_cast<uint8_t>(k);
                left_is_lower[i] = cl <= cr ? 1 : 0;
            }
        }
    }

    struct Frame {
        int32_t node;   // build-order node id
        int64_t out;    // -1 until emitted; used for skip patch
        int state;
    };

    for (int o = 0; o < 8; ++o) {
        int64_t base = static_cast<int64_t>(o) * node_count;
        int64_t count = 0;
        std::vector<Frame> stack;
        stack.push_back({0, -1, 0});
        while (!stack.empty()) {
            Frame f = stack.back();
            stack.pop_back();
            if (f.state == 1) {
                skip8[base + f.out] = static_cast<int32_t>(count);
                continue;
            }
            int64_t out = count++;
            perm8[base + out] = f.node;
            leaf_first8[base + out] = leaf_first[f.node];
            leaf_count8[base + out] = leaf_count[f.node];
            stack.push_back({f.node, out, 1});
            int32_t l = left[f.node];
            if (l >= 0) {
                int32_t r = right[f.node];
                // Octant bit set => ray direction negative along that
                // axis => visit the HIGHER child first.
                bool neg = (o >> axis[f.node]) & 1;
                int32_t first_child =
                    (left_is_lower[f.node] ? !neg : neg) ? l : r;
                int32_t second_child = first_child == l ? r : l;
                // preorder: push second THEN first.
                stack.push_back({second_child, -1, 0});
                stack.push_back({first_child, -1, 0});
            }
        }
    }
    return 0;
}
