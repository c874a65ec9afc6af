// Sum-tree priority index for host-side prioritized replay (a copy of
// the JAX package's native/sumtree.cpp, for the PyTorch port).
//
// A classic binary sum-tree over per-episode priorities giving O(log n)
// set / prefix-sum sampling, called from Python through ctypes. The
// port's host-RAM replay (components/host_replay.py) samples on the
// device; this tree is the reference formulation its tests hold the
// device sample against.
//
// Layout: standard implicit binary tree in a flat array of 2*cap floats;
// leaves at [cap, 2*cap), internal node i sums children 2i/2i+1. Capacity is
// rounded up to a power of two by the Python wrapper.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

struct SumTree {
    int64_t cap;       // leaf count (power of two)
    double *tree;      // 2*cap nodes; [0] unused, root at [1]
};

SumTree *sumtree_create(int64_t cap) {
    SumTree *t = static_cast<SumTree *>(std::malloc(sizeof(SumTree)));
    if (!t) return nullptr;
    t->cap = cap;
    t->tree = static_cast<double *>(std::calloc(2 * cap, sizeof(double)));
    if (!t->tree) { std::free(t); return nullptr; }
    return t;
}

void sumtree_free(SumTree *t) {
    if (!t) return;
    std::free(t->tree);
    std::free(t);
}

void sumtree_set(SumTree *t, int64_t idx, double priority) {
    int64_t i = t->cap + idx;
    double delta = priority - t->tree[i];
    for (; i >= 1; i >>= 1) t->tree[i] += delta;
}

void sumtree_set_batch(SumTree *t, const int64_t *idx, const double *pri,
                       int64_t n) {
    for (int64_t j = 0; j < n; ++j) sumtree_set(t, idx[j], pri[j]);
}

double sumtree_total(const SumTree *t) { return t->tree[1]; }

double sumtree_get(const SumTree *t, int64_t idx) {
    return t->tree[t->cap + idx];
}

// Batched leaf read: one ctypes crossing for n leaves instead of the
// Python-side one-call-per-element loop (the O(n) FFI overhead the
// wrapper's old list comprehension paid on every priority readback).
void sumtree_get_batch(const SumTree *t, const int64_t *idx, int64_t n,
                       double *out) {
    for (int64_t j = 0; j < n; ++j) out[j] = t->tree[t->cap + idx[j]];
}

// Descend from the root following the prefix sum `u` in [0, total).
int64_t sumtree_find(const SumTree *t, double u) {
    int64_t i = 1;
    while (i < t->cap) {
        double left = t->tree[2 * i];
        if (u < left) {
            i = 2 * i;
        } else {
            u -= left;
            i = 2 * i + 1;
        }
    }
    return i - t->cap;
}

// Stratified sampling: one uniform per equal-mass stratum (the same scheme
// as the device buffer's inverse-CDF sampler). `us` are n uniforms in [0,1).
void sumtree_sample(const SumTree *t, const double *us, int64_t n,
                    int64_t *out_idx, double *out_pri) {
    double total = t->tree[1];
    for (int64_t j = 0; j < n; ++j) {
        double u = (static_cast<double>(j) + us[j]) / static_cast<double>(n);
        int64_t idx = sumtree_find(t, u * total);
        out_idx[j] = idx;
        out_pri[j] = t->tree[t->cap + idx];
    }
}

}  // extern "C"
