// Binned-SAH BVH builder (native, host side).
//
// The port's own copy of native/sah_builder.cpp, unchanged in its
// algorithm, so the port builds the same SAH leaves as the JAX package
// without importing it. It produces a surface-area-heuristic triangle
// ordering plus fat-leaf boundaries that ops/packet.py packs into FatBVH
// tensors: tighter leaves mean fewer candidate visits per ray block.
// Built by g++ on first use (stratum_tpu_torch/utils/native.py).
//
// Exposed via a C ABI for ctypes:
//   int sah_build(const float* positions, int num_vertices,
//                 const int* indices, int num_tris,
//                 int leaf_size,
//                 int* out_order,        // [num_tris] triangle order
//                 int* out_leaf_offsets, // [num_tris+1] capacity
//                 int* out_num_leaves);
//
// Algorithm: top-down recursion; at each node try 16-bin SAH splits on the
// widest centroid axes, fall back to median splits when SAH finds no gain;
// stop at leaf_size triangles. Work is partitioned with std::thread on the
// first levels.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct AABB {
    float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    void grow(const float* p) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], p[a]);
            hi[a] = std::max(hi[a], p[a]);
        }
    }
    void grow(const AABB& b) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], b.lo[a]);
            hi[a] = std::max(hi[a], b.hi[a]);
        }
    }
    float area() const {
        float dx = std::max(0.0f, hi[0] - lo[0]);
        float dy = std::max(0.0f, hi[1] - lo[1]);
        float dz = std::max(0.0f, hi[2] - lo[2]);
        return 2.0f * (dx * dy + dy * dz + dz * dx);
    }
};

struct Builder {
    const float* positions;
    const int* indices;
    int leaf_size;
    std::vector<AABB> tri_bounds;
    std::vector<float> centroids;  // [T,3]
    std::vector<int> order;
    std::vector<std::pair<int, int>> leaves;  // (begin, end) into order
    std::atomic<int> active_threads{1};
    int max_threads = 1;

    void build(int begin, int end, int depth) {
        int count = end - begin;
        if (count <= leaf_size) {
            emit_leaf(begin, end);
            return;
        }
        // node centroid bounds
        AABB cb;
        for (int i = begin; i < end; ++i) {
            cb.grow(&centroids[3 * order[i]]);
        }
        int mid = -1;
        constexpr int kBins = 16;
        float best_cost = FLT_MAX;
        int best_axis = -1;
        int best_bin = -1;
        for (int axis = 0; axis < 3; ++axis) {
            float extent = cb.hi[axis] - cb.lo[axis];
            if (extent <= 1e-12f) continue;
            AABB bins[kBins];
            int counts[kBins] = {0};
            float scale = kBins / extent;
            for (int i = begin; i < end; ++i) {
                int t = order[i];
                int b = std::min(
                    kBins - 1,
                    (int)((centroids[3 * t + axis] - cb.lo[axis]) * scale));
                counts[b]++;
                bins[b].grow(tri_bounds[t]);
            }
            // sweep
            AABB left;
            float left_area[kBins];
            int left_count[kBins];
            int acc = 0;
            for (int b = 0; b < kBins; ++b) {
                left.grow(bins[b]);
                acc += counts[b];
                left_area[b] = left.area();
                left_count[b] = acc;
            }
            AABB right;
            for (int b = kBins - 1; b >= 1; --b) {
                right.grow(bins[b]);
                int lc = left_count[b - 1];
                int rc = count - lc;
                if (lc == 0 || rc == 0) continue;
                float cost = left_area[b - 1] * lc + right.area() * rc;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b;
                }
            }
        }
        if (best_axis >= 0) {
            float extent = cb.hi[best_axis] - cb.lo[best_axis];
            float scale = kBins / extent;
            auto pred = [&](int t) {
                int b = std::min(
                    kBins - 1,
                    (int)((centroids[3 * t + best_axis] - cb.lo[best_axis]) *
                          scale));
                return b < best_bin;
            };
            auto* base = order.data();
            int* split =
                std::partition(base + begin, base + end, pred);
            mid = (int)(split - base);
        }
        if (mid <= begin || mid >= end) {
            // median fallback on the widest axis
            int axis = 0;
            float w = -1;
            for (int a = 0; a < 3; ++a) {
                float e = cb.hi[a] - cb.lo[a];
                if (e > w) { w = e; axis = a; }
            }
            mid = begin + count / 2;
            std::nth_element(
                order.begin() + begin, order.begin() + mid,
                order.begin() + end, [&](int x, int y) {
                    return centroids[3 * x + axis] < centroids[3 * y + axis];
                });
        }
        if (depth < 4 && count > 4 * leaf_size &&
            active_threads.load() < max_threads) {
            active_threads.fetch_add(1);
            std::thread left([&] { build(begin, mid, depth + 1); });
            build(mid, end, depth + 1);
            left.join();
            active_threads.fetch_sub(1);
        } else {
            build(begin, mid, depth + 1);
            build(mid, end, depth + 1);
        }
    }

    std::vector<std::pair<int, int>> leaf_buffer;
    std::mutex leaf_mutex;
    void emit_leaf(int begin, int end) {
        std::lock_guard<std::mutex> g(leaf_mutex);
        leaf_buffer.emplace_back(begin, end);
    }
};

}  // namespace

extern "C" int sah_build(const float* positions, int num_vertices,
                         const int* indices, int num_tris, int leaf_size,
                         int* out_order, int* out_leaf_offsets,
                         int* out_num_leaves) {
    (void)num_vertices;
    if (num_tris <= 0 || leaf_size <= 0) return -1;
    Builder b;
    b.positions = positions;
    b.indices = indices;
    b.leaf_size = leaf_size;
    b.max_threads = std::max(1u, std::thread::hardware_concurrency());
    b.tri_bounds.resize(num_tris);
    b.centroids.resize(3 * num_tris);
    b.order.resize(num_tris);
    for (int t = 0; t < num_tris; ++t) {
        b.order[t] = t;
        AABB& tb = b.tri_bounds[t];
        float c[3] = {0, 0, 0};
        for (int v = 0; v < 3; ++v) {
            const float* p = positions + 3 * indices[3 * t + v];
            tb.grow(p);
            for (int a = 0; a < 3; ++a) c[a] += p[a];
        }
        for (int a = 0; a < 3; ++a) b.centroids[3 * t + a] = c[a] / 3.0f;
    }
    b.build(0, num_tris, 0);
    // leaves come out unordered (threads); sort by begin for determinism
    std::sort(b.leaf_buffer.begin(), b.leaf_buffer.end());
    std::memcpy(out_order, b.order.data(), sizeof(int) * num_tris);
    int nl = (int)b.leaf_buffer.size();
    for (int i = 0; i < nl; ++i) out_leaf_offsets[i] = b.leaf_buffer[i].first;
    out_leaf_offsets[nl] = num_tris;
    *out_num_leaves = nl;
    return 0;
}
