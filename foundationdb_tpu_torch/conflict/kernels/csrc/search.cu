// K5 — batched lexicographic binary search, both sides in one launch.
//
// Replaces: foundationdb_tpu/conflict/grid.py:125 searchsorted_lex, run as
// the jitted `kernel` of foundationdb_tpu/ops/range_index.py:105-117
// (TpuRangeIndex._fn_for), which calls it twice (side "left" and "right")
// over the storage snapshot's sorted code array.
//
// What bounds it on the H100: memory latency. Each query walks
// steps = ceil(log2 P) + 1 levels per side, each a dependent read of one
// L-lane row (32 B at width 32): 2 × 21 dependent row reads at P = 2^20,
// while the bytes a batch needs (the queries in, two int32 out, ~2·log2 P
// rows per query) are a few MB at most. The first levels hit the same few
// rows for every query and stay in L1/L2; the last levels are scattered.
//
// Design: one thread per query keeps its query row in registers and runs
// the reference's fixed-step search for both sides (the same number of
// steps, and the same clamp of the probed row index to P - 1, so the
// results equal the reference's bit for bit, also where lo ends above P).
// The two sides are independent chains, interleaved in one loop so their
// loads overlap.
#include "common.cuh"

namespace {

__global__ void search_both(
    const uint32_t* __restrict__ codes, const uint32_t* __restrict__ q,
    int* __restrict__ lo_out, int* __restrict__ hi_out,
    int P, int Q, int L, int steps) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= Q) return;
    uint32_t key[FDB_MAX_LANES];
    for (int k = 0; k < L; ++k) key[k] = q[(size_t)i * L + k];
    // side "left": first row >= key; side "right": first row > key
    int lo_l = 0, hi_l = P, lo_r = 0, hi_r = P;
    for (int s = 0; s < steps; ++s) {
        int mid_l = (lo_l + hi_l) >> 1;
        int mid_r = (lo_r + hi_r) >> 1;
        const uint32_t* row_l = codes + (size_t)min(mid_l, P - 1) * L;
        const uint32_t* row_r = codes + (size_t)min(mid_r, P - 1) * L;
        if (lex_cmp(row_l, key, L) < 0) lo_l = mid_l + 1; else hi_l = mid_l;
        if (lex_cmp(row_r, key, L) <= 0) lo_r = mid_r + 1; else hi_r = mid_r;
    }
    lo_out[i] = lo_l;
    hi_out[i] = lo_r;
}

}  // namespace

extern "C" int fdb_search(
    const void* codes, const void* q, void* lo, void* hi,
    int P, int Q, int L, int steps, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 128;
    search_both<<<(Q + threads - 1) / threads, threads, 0, st>>>(
        (const uint32_t*)codes, (const uint32_t*)q, (int*)lo, (int*)hi,
        P, Q, L, steps);
    return (int)cudaGetLastError();
}
