// K1 — history check of one commit batch against the bucket grid.
//
// Replaces: foundationdb_tpu/conflict/grid.py:210 history_conflicts (with
// _rank_le_lt :187, _rank_le :153, _rank_lt :172, lex_lt/le :110-122 and
// _split_factors :145), a jax.jit program run for every batch.
//
// What bounds it on the H100: memory latency, not bandwidth. Per read range
// it needs ~2·log2(B) pivot probes (15 at B = 32768), two S-slot bucket
// windows (2 × 512 B at S = 32, L = 3) and a handful of bmax/floor words:
// ~1.4 KB per range, ~3.6 MB per 2560-txn batch, about 1 µs at 3.35 TB/s.
// The probes are dependent loads, so a range costs ~17 round trips to L2.
//
// Design: the TPU version ranked by dense [Q, B1] compares and block
// gathers because the TPU is bad at data-dependent loads; a GPU thread
// does a binary search instead. One thread per transaction walks its KR
// read ranges: binary-search both endpoints over the sorted pivots (count
// of pivots <= a and < e, unused all-0xFF pivots included, exactly as
// _rank_le/_rank_lt count), scan the two S-slot windows, take the
// between-bucket max from a per-superblock max of bmax (computed by a
// first warp-per-superblock pass) plus the two partial edge superblocks,
// so a long range reads at most B1 + 2·B2 words instead of walking B
// buckets, and apply the floors last.
//
// K6 history (fdb_history_parts) is the same kernel over a stacked grid of
// P key-range partitions, replacing the history half of
// foundationdb_tpu/conflict/sharded.py:125 _local_resolve (its _clip :114
// of the reads and the pmax of H over the mesh). blockIdx.y is the
// partition: a thread clips its read range to [plo[p], phi[p]) in
// registers (an empty intersection fails the lex a < e activity check,
// as it does in the reference) and searches partition p's pivots and
// windows only. The OR over partitions is a store of 1 into a zeroed H[T]
// by any thread that hits. Bound: the single-device bound times the
// partitions a range touches; the superblock maxima are one pass over the
// flat [P·B] bmax, whose superblocks never straddle a partition.
#include "common.cuh"

namespace {

// number of pivots p with p < x (strict) or p <= x; pivots are sorted
__device__ int count_pivots(const uint32_t* piv, int B, int L, const uint32_t* x, bool strict) {
    int lo = 0, hi = B;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        int c = lex_cmp(piv + (size_t)mid * L, x, L);
        bool below = strict ? c < 0 : c <= 0;
        if (below) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// bmax_sup[k] = max(bmax[k*B2 .. k*B2+B2)), one warp per superblock
__global__ void superblock_max(const int* __restrict__ bmax, int* __restrict__ bmax_sup, int B1, int B2) {
    int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (warp >= B1) return;
    int m = 0;
    for (int j = lane; j < B2; j += 32) m = max(m, bmax[(size_t)warp * B2 + j]);
    m = warp_max(m);
    if (lane == 0) bmax_sup[warp] = m;
}

__global__ void history_kernel(
    const uint32_t* __restrict__ pivots, const uint32_t* __restrict__ grid,
    const int* __restrict__ count, const int* __restrict__ bmax,
    const int* __restrict__ floor_, const int* __restrict__ bmax_sup,
    const uint32_t* __restrict__ rb, const uint32_t* __restrict__ re,
    const int* __restrict__ t_snap, const uint32_t* __restrict__ plo,
    const uint32_t* __restrict__ phi, uint8_t* __restrict__ hit,
    int B, int S, int L, int T, int KR, int B1, int B2) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    // partition p's slice of the stacked state (p = 0 on a single grid)
    const int p = blockIdx.y;
    pivots += (size_t)p * B * L;
    grid += (size_t)p * B * S * (L + 1);
    count += (size_t)p * B;
    bmax += (size_t)p * B;
    floor_ += (size_t)p * B;
    bmax_sup += (size_t)p * B1;
    const int Lp1 = L + 1;
    const int snap = t_snap[t];
    uint8_t any = 0;
    uint32_t a_clip[FDB_MAX_LANES], e_clip[FDB_MAX_LANES];
    for (int r = 0; r < KR && !any; ++r) {
        const uint32_t* a = rb + ((size_t)t * KR + r) * L;
        const uint32_t* e = re + ((size_t)t * KR + r) * L;
        if (plo != nullptr) {
            // clip [a, e) to the partition [plo, phi)
            const uint32_t* lo = plo + (size_t)p * L;
            const uint32_t* hi = phi + (size_t)p * L;
            const uint32_t* a2 = lex_cmp(a, lo, L) < 0 ? lo : a;
            const uint32_t* e2 = lex_cmp(hi, e, L) < 0 ? hi : e;
            for (int i = 0; i < L; ++i) {
                a_clip[i] = a2[i];
                e_clip[i] = e2[i];
            }
            a = a_clip;
            e = e_clip;
        }
        if (lex_cmp(a, e, L) >= 0) continue;  // inactive (or empty) range

        int ba = count_pivots(pivots, B, L, a, false) - 1;  // bucket of a
        int be = count_pivots(pivots, B, L, e, true) - 1;   // bucket of e⁻
        int bac = max(ba, 0), bec = max(be, 0);
        bool diff = be > ba;

        // a's bucket: value at a, and gaps starting strictly inside (a, e)
        const uint32_t* win = grid + (size_t)bac * S * Lp1;
        int cnt = count[bac];
        int n_le = 0, v_in = 0;
        for (int s = 0; s < S && s < cnt; ++s) {
            const uint32_t* row = win + (size_t)s * Lp1;
            int ver = (int)row[L];
            if (lex_cmp(row, a, L) <= 0) {
                ++n_le;
            } else if (lex_cmp(row, e, L) < 0) {
                v_in = max(v_in, ver);
            }
        }
        int vmax = v_in;
        if (n_le > 0) vmax = max(vmax, (int)win[(size_t)(n_le - 1) * Lp1 + L]);

        // e's bucket when later: gaps starting before e
        if (diff) {
            const uint32_t* wine = grid + (size_t)bec * S * Lp1;
            int cnte = count[bec];
            for (int s = 0; s < S && s < cnte; ++s) {
                const uint32_t* row = wine + (size_t)s * Lp1;
                if (lex_cmp(row, e, L) < 0) vmax = max(vmax, (int)row[L]);
            }
        }

        // buckets strictly between ba and be
        int s1a = floordiv(ba, B2), s2a = floormod(ba, B2);
        int s1e = floordiv(be, B2), s2e = floormod(be, B2);
        for (int k = max(s1a + 1, 0); k < s1e && k < B1; ++k) vmax = max(vmax, bmax_sup[k]);
        const int* blk_a = bmax + (size_t)max(s1a, 0) * B2;
        int hi2 = (s1e == s1a) ? s2e : B2;
        for (int j = s2a + 1; j < hi2; ++j) vmax = max(vmax, blk_a[j]);
        if (s1e > s1a) {
            const int* blk_e = bmax + (size_t)max(s1e, 0) * B2;
            for (int j = 0; j < s2e; ++j) vmax = max(vmax, blk_e[j]);
        }

        // bucket floors: a's gap always overlaps; e⁻'s bucket when later
        vmax = max(vmax, floor_[bac]);
        if (diff) vmax = max(vmax, floor_[bec]);
        if (vmax > snap) any = 1;
    }
    if (plo == nullptr) hit[t] = any;
    else if (any) hit[t] = 1;  // OR over partitions into a zeroed H
}

}  // namespace

static int launch_history(
    const void* pivots, const void* grid, const void* count, const void* bmax,
    const void* floor_, const void* plo, const void* phi, const void* rb,
    const void* re, const void* t_snap, void* bmax_sup, void* hit,
    int P, int B, int S, int L, int T, int KR, int B1, int B2, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    superblock_max<<<(P * B1 * 32 + threads - 1) / threads, threads, 0, st>>>(
        (const int*)bmax, (int*)bmax_sup, P * B1, B2);
    dim3 blocks((T + threads - 1) / threads, P);
    history_kernel<<<blocks, threads, 0, st>>>(
        (const uint32_t*)pivots, (const uint32_t*)grid, (const int*)count,
        (const int*)bmax, (const int*)floor_, (const int*)bmax_sup,
        (const uint32_t*)rb, (const uint32_t*)re, (const int*)t_snap,
        (const uint32_t*)plo, (const uint32_t*)phi, (uint8_t*)hit,
        B, S, L, T, KR, B1, B2);
    return (int)cudaGetLastError();
}

extern "C" int fdb_history(
    const void* pivots, const void* grid, const void* count, const void* bmax,
    const void* floor_, const void* rb, const void* re, const void* t_snap,
    void* bmax_sup, void* hit,
    int B, int S, int L, int T, int KR, int B1, int B2, void* stream) {
    return launch_history(pivots, grid, count, bmax, floor_, nullptr, nullptr,
                          rb, re, t_snap, bmax_sup, hit, 1, B, S, L, T, KR,
                          B1, B2, stream);
}

// K6 history: P stacked partitions, reads clipped to [plo[p], phi[p]);
// hit must be zeroed by the caller
extern "C" int fdb_history_parts(
    const void* pivots, const void* grid, const void* count, const void* bmax,
    const void* floor_, const void* plo, const void* phi, const void* rb,
    const void* re, const void* t_snap, void* bmax_sup, void* hit,
    int P, int B, int S, int L, int T, int KR, int B1, int B2, void* stream) {
    return launch_history(pivots, grid, count, bmax, floor_, plo, phi, rb, re,
                          t_snap, bmax_sup, hit, P, B, S, L, T, KR, B1, B2,
                          stream);
}
