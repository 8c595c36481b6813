// Binned-SAH BVH builder of drmlt_mitsuba_tpu_torch (the port's own copy of
// the reference's native/bvh_builder.cpp; the port never loads the
// reference's library).
//
// A binned-SAH BVH over triangles (16 bins on the longest centroid axis,
// median split on a degenerate spread), flattened depth first with escape
// ("skip") pointers for a stackless walk, exposed through a C ABI that
// scene/bvh.py loads with ctypes.  ops/build.py:build_host compiles it with
// g++ into build/ at first use, with fixed flags (no -march=native,
// -ffp-contract=off) so that the tree is the same on every machine.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AABB {
    float lo[3], hi[3];
    AABB() {
        for (int i = 0; i < 3; i++) { lo[i] = 1e30f; hi[i] = -1e30f; }
    }
    void grow(const float* p) {
        for (int i = 0; i < 3; i++) {
            lo[i] = std::min(lo[i], p[i]);
            hi[i] = std::max(hi[i], p[i]);
        }
    }
    void grow(const AABB& b) {
        for (int i = 0; i < 3; i++) {
            lo[i] = std::min(lo[i], b.lo[i]);
            hi[i] = std::max(hi[i], b.hi[i]);
        }
    }
    float area() const {
        float d0 = std::max(0.f, hi[0] - lo[0]);
        float d1 = std::max(0.f, hi[1] - lo[1]);
        float d2 = std::max(0.f, hi[2] - lo[2]);
        return 2.f * (d0 * d1 + d1 * d2 + d2 * d0);
    }
};

struct BuildNode {
    AABB bounds;
    int first = 0, count = 0;     // leaf: first prim (in order[]), count
    int left = -1, right = -1;    // inner: children
};

struct Builder {
    const float* v0;
    const float* e1;
    const float* e2;
    int n;
    int max_leaf;
    std::vector<AABB> prim_bounds;
    std::vector<float> centroids;
    std::vector<int> order;
    std::vector<BuildNode> nodes;

    static constexpr int kBins = 16;

    int build(int first, int count) {
        BuildNode node;
        for (int i = first; i < first + count; i++)
            node.bounds.grow(prim_bounds[order[i]]);
        int self = (int)nodes.size();
        nodes.push_back(node);

        if (count <= max_leaf) {
            nodes[self].first = first;
            nodes[self].count = count;
            return self;
        }

        // centroid bounds for binning
        AABB cb;
        for (int i = first; i < first + count; i++)
            cb.grow(&centroids[3 * order[i]]);
        int axis = 0;
        float ext[3] = {cb.hi[0] - cb.lo[0], cb.hi[1] - cb.lo[1],
                        cb.hi[2] - cb.lo[2]};
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;
        if (ext[axis] < 1e-12f) {
            // degenerate spread: median split
            int mid = first + count / 2;
            int l = build(first, mid - first);
            int r = build(mid, first + count - mid);
            nodes[self].left = l;
            nodes[self].right = r;
            nodes[self].count = 0;
            return self;
        }

        // binned SAH
        AABB bins[kBins];
        int bin_count[kBins] = {0};
        float scale = kBins / ext[axis];
        for (int i = first; i < first + count; i++) {
            int b = std::min(
                kBins - 1,
                (int)((centroids[3 * order[i] + axis] - cb.lo[axis]) * scale));
            bins[b].grow(prim_bounds[order[i]]);
            bin_count[b]++;
        }
        float best_cost = 1e30f;
        int best_split = -1;
        AABB left_acc[kBins];
        int left_cnt[kBins];
        AABB acc;
        int cnt = 0;
        for (int b = 0; b < kBins - 1; b++) {
            acc.grow(bins[b]);
            cnt += bin_count[b];
            left_acc[b] = acc;
            left_cnt[b] = cnt;
        }
        AABB racc;
        int rcnt = 0;
        for (int b = kBins - 1; b >= 1; b--) {
            racc.grow(bins[b]);
            rcnt += bin_count[b];
            if (left_cnt[b - 1] == 0 || rcnt == 0) continue;
            float cost = left_acc[b - 1].area() * left_cnt[b - 1] +
                         racc.area() * rcnt;
            if (cost < best_cost) { best_cost = cost; best_split = b; }
        }
        int mid;
        if (best_split < 0) {
            mid = first + count / 2;
            std::nth_element(
                order.begin() + first, order.begin() + mid,
                order.begin() + first + count,
                [&](int a, int b) {
                    return centroids[3 * a + axis] < centroids[3 * b + axis];
                });
        } else {
            auto it = std::partition(
                order.begin() + first, order.begin() + first + count,
                [&](int p) {
                    int b = std::min(
                        kBins - 1,
                        (int)((centroids[3 * p + axis] - cb.lo[axis]) * scale));
                    return b < best_split;
                });
            mid = (int)(it - order.begin());
            if (mid == first || mid == first + count) mid = first + count / 2;
        }
        int l = build(first, mid - first);
        int r = build(mid, first + count - mid);
        nodes[self].left = l;
        nodes[self].right = r;
        nodes[self].count = 0;
        return self;
    }
};

void fill_skip(const std::vector<BuildNode>& nodes, int idx, int skip_to,
               int* skip) {
    skip[idx] = skip_to;
    const BuildNode& n = nodes[idx];
    if (n.count == 0) {
        fill_skip(nodes, n.left, n.right, skip);
        fill_skip(nodes, n.right, skip_to, skip);
    }
}

}  // namespace

extern "C" {

// Returns the node count (<= 2*n_tris), or -1 if max_nodes is too small.
// Outputs: nodes_min/max (max_nodes,3), first/count/skip (max_nodes,),
// tri_order (n_tris,) — triangle indices in BVH leaf order.
int drmlt_build_bvh(const float* v0, const float* e1, const float* e2,
                    int n_tris, int max_leaf,
                    float* nodes_min, float* nodes_max,
                    int* first, int* count, int* skip,
                    int* tri_order, int max_nodes) {
    Builder b;
    b.v0 = v0; b.e1 = e1; b.e2 = e2; b.n = n_tris;
    b.max_leaf = std::max(1, max_leaf);
    b.prim_bounds.resize(n_tris);
    b.centroids.resize(3 * n_tris);
    b.order.resize(n_tris);
    for (int i = 0; i < n_tris; i++) {
        const float* a = v0 + 3 * i;
        float p1[3] = {a[0] + e1[3 * i], a[1] + e1[3 * i + 1],
                       a[2] + e1[3 * i + 2]};
        float p2[3] = {a[0] + e2[3 * i], a[1] + e2[3 * i + 1],
                       a[2] + e2[3 * i + 2]};
        b.prim_bounds[i].grow(a);
        b.prim_bounds[i].grow(p1);
        b.prim_bounds[i].grow(p2);
        for (int c = 0; c < 3; c++)
            b.centroids[3 * i + c] =
                (b.prim_bounds[i].lo[c] + b.prim_bounds[i].hi[c]) * 0.5f;
        b.order[i] = i;
    }
    b.nodes.reserve(2 * n_tris);
    b.build(0, n_tris);
    int n_nodes = (int)b.nodes.size();
    if (n_nodes > max_nodes) return -1;

    std::vector<int> skips(n_nodes);
    fill_skip(b.nodes, 0, -1, skips.data());

    for (int i = 0; i < n_nodes; i++) {
        const BuildNode& n = b.nodes[i];
        std::memcpy(nodes_min + 3 * i, n.bounds.lo, 12);
        std::memcpy(nodes_max + 3 * i, n.bounds.hi, 12);
        if (n.count > 0) { first[i] = n.first; count[i] = n.count; }
        else { first[i] = n.left; count[i] = 0; }
        skip[i] = skips[i];
    }
    std::memcpy(tri_order, b.order.data(), sizeof(int) * n_tris);
    return n_nodes;
}

}  // extern "C"
