// Shared device helpers for the conflict-grid kernels.
//
// Key codes are L big-endian uint32 lanes; lexicographic lane order is
// key order. Torch holds them as int32 tensors carrying the same bits, and
// the kernels read those bytes as uint32_t. The all-0xFF code is the
// sentinel (unused slot / padding).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FDB_SENTINEL 0xFFFFFFFFu
// most lanes a kernel copies into registers (key width 64 bytes); wider
// codes are compared in memory (Code<0>)
#define FDB_MAX_LANES 16

constexpr unsigned FULL = 0xffffffffu;  // every lane of a warp

// -1 / 0 / +1: lexicographic compare of two L-lane codes
__device__ __forceinline__ int lex_cmp(const uint32_t* a, const uint32_t* b, int L) {
    for (int i = 0; i < L; ++i) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

__device__ __forceinline__ bool is_sentinel(const uint32_t* a, int L) {
    for (int i = 0; i < L; ++i) {
        if (a[i] != FDB_SENTINEL) return false;
    }
    return true;
}

// the code lanes of one key in registers; lanes >= L are never compared
template <int LM>
__device__ __forceinline__ void load_code(const uint32_t* p, int L, uint32_t (&x)[LM]) {
#pragma unroll
    for (int i = 0; i < LM; ++i) x[i] = i < L ? __ldg(p + i) : 0u;
}

// -1 / 0 / +1: lexicographic compare of two register codes of L <= LM lanes
template <int LM>
__device__ __forceinline__ int cmp_r(const uint32_t (&x)[LM], const uint32_t (&y)[LM], int L) {
    int c = 0;
#pragma unroll
    for (int i = LM - 1; i >= 0; --i) {
        if (i < L && x[i] != y[i]) c = x[i] < y[i] ? -1 : 1;
    }
    return c;
}

// a key code a warp compares: its L <= LM lanes in registers, or, for
// LM = 0, a pointer to its lanes in global memory (any L)
template <int LM>
struct Code {
    uint32_t x[LM];
};

template <>
struct Code<0> {
    const uint32_t* p;
};

template <int LM>
__device__ __forceinline__ void load(Code<LM>& c, const uint32_t* p, int L) {
    if constexpr (LM == 0) c.p = p;
    else load_code<LM>(p, L, c.x);
}

// -1 / 0 / +1: lexicographic compare of two codes of L lanes
template <int LM>
__device__ __forceinline__ int cmp(const Code<LM>& a, const Code<LM>& b, int L) {
    if constexpr (LM == 0) {
        for (int i = 0; i < L; ++i) {
            const uint32_t x = __ldg(a.p + i), y = __ldg(b.p + i);
            if (x != y) return x < y ? -1 : 1;
        }
        return 0;
    } else {
        return cmp_r<LM>(a.x, b.x, L);
    }
}

// floor division / modulo for a positive divisor (matches Python / jnp)
__device__ __forceinline__ int floordiv(int a, int b) {
    int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
    int r = a % b;
    return r < 0 ? r + b : r;
}

__device__ __forceinline__ int warp_max(int v) {
    for (int off = 16; off > 0; off >>= 1) {
        v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}
