// K5 — batched lexicographic search of the storage range index, both sides
// in one launch.
//
// Replaces: foundationdb_tpu/conflict/grid.py:125 searchsorted_lex, run as
// the jitted `kernel` of foundationdb_tpu/ops/range_index.py:105-117
// (TpuRangeIndex._fn_for), which calls it twice (side "left" and "right")
// over the storage snapshot's sorted code array.
//
// The function: for each query row q, lo = #rows < q and hi = #rows <= q
// among the P sorted rows, each then put through the reference's quirk. The
// reference runs ceil(log2 P) + 1 fixed steps and probes row min(mid, P - 1),
// so for every P >= 2 a count of P comes out as P + 1 (P = 1 gives 1); no
// other count differs. The result is count + (count == P && P >= 2).
//
// What bounds it on the H100: dependent round trips, not bytes. A batch
// needs the queries in, two int32 out and the ~2·log2 P rows a binary search
// probes: a few hundred KB at the bench round (P = 2^20 rows of L = 8 lanes,
// 32 MiB; Q = 4096). A binary search per thread is 21 dependent row loads a
// side, the last dozen scattered L2/HBM misses, on 32 of the 132 SMs.
//
// Design: a warp per query, both sides at once. Lanes 0-15 count the rows
// < q, lanes 16-31 the rows <= q, by a paired 16-ary search: the count n of a
// half lies in [base, base + 16·s]; lane i of the half probes row
// base + (i+1)·s - 1 (none past P), one ballot and a popc per half move base
// by c·s, and the next step searches s candidates. max(1, ⌈log16 P⌉) steps
// (5 at P = 2^20, not 21) reach every count in [0, P], P itself included;
// the last step (s = 1) reads 16 contiguous rows, a coalesced window. The
// query row is read once per warp (one address for all lanes: a broadcast).
// A lane compares a whole L-lane row in 4-word chunks (16-byte loads when L
// is a multiple of 4), lazily before the last step: the next chunk is read
// only while the row ties the query, so a probe of a distinct key costs one
// load and its sectors. The first two steps' 16 + 256 rows are shared by
// every query and stay in L1; staging them in shared memory per CTA was
// slower on the H100 (a staging round trip and a barrier before the first
// step), as was reading every chunk at once (PERF.md). Codes wider than 16
// lanes (64-byte keys) are compared with the query in memory, chunk by
// chunk (search_warp<0>): any L.
#include "common.cuh"

namespace {

constexpr int WARPS = 16;  // queries in flight per block

// words 4v .. 4v + 3 of a code row (0 past L); one 16-byte load when ``vec``
__device__ __forceinline__ uint4 load_chunk(const uint32_t* p, int v, int L, bool vec) {
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p) + v);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = 4 * v + e < L ? __ldg(p + 4 * v + e) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// -1 / 0 / +1: code row ``p`` against the query ``x``, in 4-word chunks. A
// lazy compare reads a chunk only while the row ties the query so far, so a
// probe costs one 16-byte load unless its first chunk equals the query's; an
// eager one issues every chunk's load at once
template <int LM>
__device__ __forceinline__ int cmp_row(const uint32_t* p, int L, bool vec, bool lazy,
                                       const uint32_t (&x)[LM]) {
    uint4 ch[LM / 4];
    if (!lazy) {
#pragma unroll
        for (int v = 0; v < LM / 4; ++v) {
            if (4 * v < L) ch[v] = load_chunk(p, v, L, vec);
        }
    }
    int c = 0;
#pragma unroll
    for (int v = 0; v < LM / 4; ++v) {
        if (4 * v < L && c == 0) {
            const uint4 t = lazy ? load_chunk(p, v, L, vec) : ch[v];
            const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = 4 * v + e;
                if (c == 0 && k < L && w[e] != x[k]) c = w[e] < x[k] ? -1 : 1;
            }
        }
    }
    return c;
}

// the same compare for codes wider than FDB_MAX_LANES: the query ``x`` is
// read in memory too (one address for a half-warp: a broadcast), chunk by
// chunk while the row ties it
__device__ __forceinline__ int cmp_row_mem(const uint32_t* p, int L, bool vec, const uint32_t* x,
                                           bool vec_x) {
    for (int v = 0; 4 * v < L; ++v) {
        const uint4 t = load_chunk(p, v, L, vec), u = load_chunk(x, v, L, vec_x);
        const uint32_t w[4] = {t.x, t.y, t.z, t.w}, y[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (w[e] != y[e]) return w[e] < y[e] ? -1 : 1;
        }
    }
    return 0;
}

// out[0, i] = lo, out[1, i] = hi of query i; LM = 0: any L, in memory
template <int LM>
__global__ void __launch_bounds__(WARPS * 32) search_warp(
    const uint32_t* __restrict__ codes, const uint32_t* __restrict__ q, int* __restrict__ out,
    int P, int Q, int L, int steps, bool vec, bool vec_q) {
    const int lane = threadIdx.x & 31;
    const bool le = lane >= 16;  // this half counts the rows <= q
    const int sub = lane & 15;
    for (int i = blockIdx.x * WARPS + (threadIdx.x >> 5); i < Q; i += gridDim.x * WARPS) {
        const uint32_t* qi = q + (size_t)i * L;
        uint32_t x[LM ? LM : 1];
        if constexpr (LM > 0) load_code<LM>(qi, L, x);
        long long base = 0;
        long long s = 1LL << (4 * (steps - 1));
        for (int k = 0; k < steps; ++k, s >>= 4) {
            const long long j = base + (sub + 1) * s - 1;
            bool below = false;
            if (j < P) {
                // the last step's 16 rows are one coalesced window: eager
                int c;
                if constexpr (LM > 0) c = cmp_row<LM>(codes + j * L, L, vec, k < steps - 1, x);
                else c = cmp_row_mem(codes + j * L, L, vec, qi, vec_q);
                below = le ? c <= 0 : c < 0;
            }
            const unsigned m = __ballot_sync(FULL, below);
            base += __popc(le ? m >> 16 : m & 0xffffu) * s;
        }
        if (sub == 0) out[(le ? Q : 0) + i] = (int)base + (base == P && P >= 2);
    }
}

}  // namespace

// out: int32[2, Q] (lo, then hi)
extern "C" int fdb_search(const void* codes, const void* q, void* out, int P, int Q, int L,
                          void* stream) {
    if (P < 1 || L < 1) return (int)cudaErrorInvalidValue;
    if (Q == 0) return 0;
    int steps = 1;
    while ((1LL << (4 * steps)) < P) ++steps;  // 16^steps >= P
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // a few blocks per SM; their warps stride over the queries
    const long long want = (Q + WARPS - 1) / WARPS;
    const int blocks = (int)(want < 2LL * sms ? want : 2LL * sms);
    const bool vec = L % 4 == 0 && (uintptr_t)codes % 16 == 0;
    const bool vec_q = L % 4 == 0 && (uintptr_t)q % 16 == 0;
    cudaStream_t st = (cudaStream_t)stream;
    const auto go = [&](auto kernel) {
        kernel<<<blocks, WARPS * 32, 0, st>>>((const uint32_t*)codes, (const uint32_t*)q, (int*)out,
                                             P, Q, L, steps, vec, vec_q);
    };
    if (L <= 4) go(search_warp<4>);
    else if (L <= 8) go(search_warp<8>);
    else if (L <= FDB_MAX_LANES) go(search_warp<16>);
    else go(search_warp<0>);
    return (int)cudaGetLastError();
}
