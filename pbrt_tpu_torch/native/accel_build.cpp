// Native accel-build stage: Morton codes + stable LSD radix sort over
// triangle centroids. Mirrors the reference's C++ HLBVH build front half
// (/root/reference/src/pbrt/cpu/aggregates.cpp:389-505 — MortonPrimitive
// computation + RadixSort), which feeds both this repo's Morton-cluster
// accel (ops/cluster.py) and the implicit-tree BVH (accel/bvh.py).
//
// Exported C ABI (ctypes):
//   morton_order(cent, n, order_out)
//     cent: (n, 3) float32 triangle centroids (row-major)
//     order_out: (n,) int64 — the stable ascending-Morton permutation,
//     bit-identical to numpy argsort(kind="stable") over the same codes.
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py on-demand builder).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t spread3(uint64_t v) {
    v = (v | (v << 16)) & 0x030000FFull;
    v = (v | (v << 8)) & 0x0300F00Full;
    v = (v | (v << 4)) & 0x030C30C3ull;
    v = (v | (v << 2)) & 0x09249249ull;
    return v;
}

}  // namespace

extern "C" {

// Stable LSD radix sort of 30-bit Morton codes computed from centroids
// normalized to the centroid bounding box (matching accel/bvh.py _morton3:
// q = clip(int(norm * 1024), 0, 1023) with float32 arithmetic).
void morton_order(const float* cent, long long n, long long* order_out) {
    if (n <= 0) return;
    // Centroid bounds.
    float lo[3], hi[3];
    for (int k = 0; k < 3; ++k) { lo[k] = cent[k]; hi[k] = cent[k]; }
    for (long long i = 1; i < n; ++i)
        for (int k = 0; k < 3; ++k) {
            float c = cent[3 * i + k];
            if (c < lo[k]) lo[k] = c;
            if (c > hi[k]) hi[k] = c;
        }
    // numpy path: norm = (cent - lo) / np.maximum(hi - lo, 1e-12).
    // True float32 division (not multiply-by-reciprocal) so the quantized
    // codes — and therefore tie order — are bit-identical to the numpy
    // build.
    float ext[3];
    for (int k = 0; k < 3; ++k) {
        float e = hi[k] - lo[k];
        ext[k] = e > 1e-12f ? e : 1e-12f;
    }

    std::vector<uint32_t> codes((size_t)n);
    for (long long i = 0; i < n; ++i) {
        uint64_t m = 0;
        for (int k = 0; k < 3; ++k) {
            float normk = (cent[3 * i + k] - lo[k]) / ext[k];
            float scaled = normk * 1024.0f;
            if (scaled < 0.0f) scaled = 0.0f;
            uint32_t q = (uint32_t)scaled;  // trunc, as numpy astype(uint32)
            if (q > 1023u) q = 1023u;
            m |= spread3(q) << k;
        }
        codes[(size_t)i] = (uint32_t)m;
    }

    // 3 x 10-bit stable LSD passes (the reference uses 5 x 6-bit,
    // aggregates.cpp RadixSort; 10-bit halves the passes at 4 KB/bucket).
    std::vector<long long> idx((size_t)n), tmp((size_t)n);
    for (long long i = 0; i < n; ++i) idx[(size_t)i] = i;
    constexpr int kBits = 10, kBuckets = 1 << kBits;
    long long count[kBuckets];
    for (int pass = 0; pass < 3; ++pass) {
        int shift = pass * kBits;
        std::memset(count, 0, sizeof(count));
        for (long long i = 0; i < n; ++i)
            ++count[(codes[(size_t)idx[(size_t)i]] >> shift) & (kBuckets - 1)];
        long long sum = 0;
        for (int b = 0; b < kBuckets; ++b) {
            long long c = count[b];
            count[b] = sum;
            sum += c;
        }
        for (long long i = 0; i < n; ++i) {
            long long j = idx[(size_t)i];
            tmp[(size_t)count[(codes[(size_t)j] >> shift) & (kBuckets - 1)]++] = j;
        }
        idx.swap(tmp);
    }
    std::memcpy(order_out, idx.data(), (size_t)n * sizeof(long long));
}

}  // extern "C"
