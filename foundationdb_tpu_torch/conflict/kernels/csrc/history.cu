// K1 — history check of one commit batch against the bucket grid — and K6
// history, the same check over P stacked key-range partitions.
//
// Replaces: foundationdb_tpu/conflict/grid.py:208-292 history_conflicts (with
// _rank_le_lt :187, lex_lt/le and _split_factors :145), a jax.jit program
// run for every batch; for K6 also foundationdb_tpu/conflict/sharded.py:114
// _clip of the reads and the history half of _local_resolve (:125-150, with
// the pmax of H over the mesh).
//
// What bounds it on the H100: dependent round trips to L2, not bytes. The
// batch needs ~3 MB at the bench shape (T = 2500, B = 32768, S = 32, L = 3),
// under 1 µs at 3.35 TB/s. But every read range is a chain: rank both ends
// among the B pivots, then read the two S-slot bucket windows those ranks
// name, then (for a long range) the superblock maxima. A binary search per
// thread made that 2·log2 B + 1 = 31 dependent loads at B = 32768, on 10 of
// the 132 SMs (one thread per transaction).
//
// Design: a warp per transaction, ⌈T/4⌉ blocks of 4 warps (2500 warps, one
// wave). The warp walks its KR read ranges and stops at the first hit; lane
// 0 writes hit[t] once, on both entry points.
// - Rank by a warp search: lanes 0-15 count the pivots <= a, lanes 16-31 the
//   pivots < e, each lane probing one pivot row a step; a ballot and popc
//   narrow both intervals 16-fold. ⌈log16 B⌉ = 4 dependent steps at B = 32768
//   instead of 30. The counts are exact partition points, all-0xFF unused
//   pivots included, as the plain version counts them. (Two 32-ary searches
//   one after the other, 2·⌈log32 B⌉ = 6 steps, were slower on the H100.)
// - Windows: lane s holds slot s (strides of 32 for S > 32), one 16-byte load
//   a lane when L + 1 is a multiple of 4, so each window is one coalesced
//   S·(L+1)·4-byte load, and both windows of a range are in flight together.
//   n_le is a ballot and popc; the value at a a shuffle from lane n_le - 1.
// - Buckets strictly between the two ends: the lanes stride over the two
//   partial edge superblocks (≤ B2 bmax words each) and the whole
//   superblocks' maxima (≤ B1 words), then warp_max with the floors.
// - The superblock maxima need every bmax word, so they stay a pass of their
//   own (superblock_max). history_kernel is launched behind it by Hopper's
//   programmatic dependent launch and waits for it (griddepcontrol) only
//   just before its first read of a superblock maximum, so the searches and
//   windows overlap that pass; most short ranges never wait.
// - K6: lanes 0..P-1 (chunks of 32 for P > 32) intersect the range with
//   their partition [plo, phi); a ballot names the partitions it touches,
//   and the warp checks only those, clipping in registers exactly as _clip
//   does. An empty or inverted range touches none. One launch of ⌈T/4⌉
//   blocks, not T × P threads, and no zeroed H: lane 0 stores every flag.
// - Codes of up to 16 lanes (64-byte keys) live in register arrays sized
//   for the width (4, 8 or 16 lanes); wider codes stay in memory (Code<0>,
//   common.cuh): a compare walks both codes' lanes through the read-only
//   cache, and a clip selects a pointer. Any L, the same search.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // transactions (warps) per block

// one grid row: its L bound lanes and the gap version; 16-byte loads when
// ``vec`` (L + 1 a multiple of 4 and the grid 16-byte aligned)
template <int LM>
__device__ __forceinline__ void load_row(const uint32_t* row, int L, bool vec, Code<LM>& code,
                                         int& ver) {
    if constexpr (LM == 0) {
        code.p = row;
        ver = (int)__ldg(row + L);
    } else if (vec) {
        uint32_t(&x)[LM] = code.x;
#pragma unroll
        for (int q = 0; q < (LM + 4) / 4; ++q) {
            if (4 * q <= L) {
                const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + q);
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int i = 4 * q + c;
                    if (i < LM && i < L) x[i] = w[c];
                    if (i == L) ver = (int)w[c];
                }
            }
        }
    } else {
        load_code<LM>(row, L, code.x);
        ver = (int)__ldg(row + L);
    }
}

// c ? a : b, lane by lane
template <int LM>
__device__ __forceinline__ Code<LM> pick(bool c, const Code<LM>& a, const Code<LM>& b) {
    if constexpr (LM == 0) {
        return {c ? a.p : b.p};
    } else {
        Code<LM> r;
#pragma unroll
        for (int i = 0; i < LM; ++i) r.x[i] = c ? a.x[i] : b.x[i];
        return r;
    }
}

// [a, e) ∩ [lo, hi) (in registers, or as pointers for LM = 0), as sharded._clip: a below lo starts at lo,
// e above hi ends at hi
template <int LM>
__device__ __forceinline__ void clip(const Code<LM>& a, const Code<LM>& e, const uint32_t* lo,
                                     const uint32_t* hi, int L, Code<LM>& a2, Code<LM>& e2) {
    Code<LM> l, h;
    load(l, lo, L);
    load(h, hi, L);
    const bool up = cmp(a, l, L) < 0;
    const bool down = cmp(h, e, L) < 0;
    a2 = pick(up, l, a);
    e2 = pick(down, h, e);
}

// one partition's slice of the (stacked) state
struct Grid {
    const uint32_t* pivots;  // [B, L]
    const uint32_t* grid;    // [B, S, L+1]
    const int* count;
    const int* bmax;
    const int* floor_;
    const int* bmax_sup;  // [B1], written by superblock_max
};

// (#pivots <= a, #pivots < e) among the B sorted pivots by a paired 16-ary
// warp search: lanes 0-15 rank a, lanes 16-31 rank e. Invariant: the count
// lies in [base, base + 16·s]; lane i of a half probes pivot
// base + (i+1)·s - 1 (none past B), and the c probes below the point move
// base by c·s, so the next step searches s candidates.
template <int LM>
__device__ __forceinline__ void rank_ends(const uint32_t* __restrict__ piv, int B, int L,
                                          const Code<LM>& a, const Code<LM>& e, int lane,
                                          int& n_le, int& n_lt) {
    const int steps = max((31 - __clz(B) + 3) / 4, 1);
    const bool strict = lane >= 16;  // this lane ranks e
    const int sub = lane & 15;
    const Code<LM> x = pick(strict, e, a);
    int base_a = 0, base_e = 0;
    int s = 1 << (4 * (steps - 1));
    for (int k = 0; k < steps; ++k, s >>= 4) {
        const int j = (strict ? base_e : base_a) + (sub + 1) * s - 1;
        bool below = false;
        if (j < B) {
            Code<LM> p;
            load(p, piv + (size_t)j * L, L);
            const int c = cmp(p, x, L);
            below = strict ? c < 0 : c <= 0;
        }
        const unsigned m = __ballot_sync(FULL, below);
        base_a += __popc(m & 0xffffu) * s;
        base_e += __popc(m >> 16) * s;
    }
    n_le = base_a;
    n_lt = base_e;
}

// does the active range [a, e) overlap a gap of ``g`` with a version above
// ``snap``? Warp-uniform result.
template <int LM>
__device__ __forceinline__ bool range_hits(const Grid& g, const Code<LM>& a, const Code<LM>& e, int snap, int B, int S, int L, int B1, int lgB2, bool vec, int lane) {
    const int Lp1 = L + 1;
    const int B2 = 1 << lgB2;
    int n_le, n_lt;
    rank_ends<LM>(g.pivots, B, L, a, e, lane, n_le, n_lt);
    const int ba = n_le - 1;  // bucket of a
    const int be = n_lt - 1;  // bucket of e⁻
    const int bac = max(ba, 0), bec = max(be, 0);
    const bool diff = be > ba;

    // both windows, counts and floors in flight together
    const uint32_t* win_a = g.grid + (size_t)bac * S * Lp1;
    const uint32_t* win_e = g.grid + (size_t)bec * S * Lp1;
    const int cnt_a = __ldg(g.count + bac);
    const int cnt_e = diff ? __ldg(g.count + bec) : 0;
    // bucket floors: a's gap always overlaps; e⁻'s bucket when later
    int v = max(max(__ldg(g.floor_ + bac), diff ? __ldg(g.floor_ + bec) : 0), 0);
    int n_a = 0, v_at = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        Code<LM> ra, re_;
        int va = 0, ve = 0;
        if (s < S) load_row<LM>(win_a + (size_t)s * Lp1, L, vec, ra, va);
        if (diff && s < S) load_row<LM>(win_e + (size_t)s * Lp1, L, vec, re_, ve);
        // a's bucket: rows <= a count toward the value at a; rows strictly
        // inside (a, e) start gaps the range overlaps
        const bool used_a = s < S && s < cnt_a;
        const bool le = used_a && cmp(ra, a, L) <= 0;
        if (used_a && !le && cmp(ra, e, L) < 0) v = max(v, va);
        // e's bucket when later: rows before e
        if (s < S && s < cnt_e && cmp(re_, e, L) < 0) v = max(v, ve);
        const int k = __popc(__ballot_sync(FULL, le));
        if (S <= 32 && k > 0) v_at = __shfl_sync(FULL, va, k - 1);
        n_a += k;
    }
    if (S > 32 && n_a > 0) v_at = (int)__ldg(win_a + (size_t)(n_a - 1) * Lp1 + L);
    v = max(v, v_at);

    // buckets strictly between ba and be: partial edge superblocks word by
    // word, whole superblocks through their maxima
    const int s1a = ba >> lgB2, s2a = ba & (B2 - 1);  // floor division / modulo
    const int s1e = be >> lgB2, s2e = be & (B2 - 1);
    const int* blk_a = g.bmax + (size_t)max(s1a, 0) * B2;
    const int hi2 = s1e == s1a ? s2e : B2;
    for (int j = s2a + 1 + lane; j < hi2; j += 32) v = max(v, __ldg(blk_a + j));
    if (s1e > s1a) {
        const int* blk_e = g.bmax + (size_t)max(s1e, 0) * B2;
        for (int j = lane; j < s2e; j += 32) v = max(v, __ldg(blk_e + j));
    }
    const int k0 = max(s1a + 1, 0), k1 = min(s1e, B1);
    if (k0 < k1) {
        cudaGridDependencySynchronize();  // superblock_max has finished
        for (int k = k0 + lane; k < k1; k += 32) v = max(v, __ldcg(g.bmax_sup + k));
    }
    return warp_max(v) > snap;
}

// bmax_sup[k] = max(bmax[k*B2 .. k*B2+B2)), one warp per superblock
__global__ void superblock_max(const int* __restrict__ bmax, int* __restrict__ bmax_sup, int n_sup,
                               int B2) {
    // history_kernel may start now: it waits for this grid's end, and its
    // memory, only before it reads a superblock maximum
    cudaTriggerProgrammaticLaunchCompletion();
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n_sup) return;
    int m = 0;
    for (int j = lane; j < B2; j += 32) m = max(m, bmax[(size_t)warp * B2 + j]);
    m = warp_max(m);
    if (lane == 0) bmax_sup[warp] = m;
}

// one warp per transaction; plo == nullptr on a single grid (P = 1)
template <int LM>
__global__ void __launch_bounds__(WARPS * 32) history_kernel(
    const uint32_t* __restrict__ pivots, const uint32_t* __restrict__ grid,
    const int* __restrict__ count, const int* __restrict__ bmax,
    const int* __restrict__ floor_, const int* bmax_sup,
    const uint32_t* __restrict__ rb, const uint32_t* __restrict__ re,
    const int* __restrict__ t_snap, const uint32_t* __restrict__ plo,
    const uint32_t* __restrict__ phi, uint8_t* __restrict__ hit,
    int P, int B, int S, int L, int T, int KR, int B1, int lgB2, bool vec) {
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (t >= T) return;
    const int snap = __ldg(t_snap + t);
    const auto part = [&](int p) {
        return Grid{pivots + (size_t)p * B * L, grid + (size_t)p * B * S * (L + 1),
                    count + (size_t)p * B, bmax + (size_t)p * B, floor_ + (size_t)p * B,
                    bmax_sup + (size_t)p * B1};
    };
    bool any = false;
    for (int r = 0; r < KR && !any; ++r) {
        Code<LM> a, e;
        load(a, rb + ((size_t)t * KR + r) * L, L);
        load(e, re + ((size_t)t * KR + r) * L, L);
        if (plo == nullptr) {
            if (cmp(a, e, L) < 0)  // inactive (or empty) ranges are skipped
                any = range_hits<LM>(part(0), a, e, snap, B, S, L, B1, lgB2, vec, lane);
            continue;
        }
        for (int p0 = 0; p0 < P && !any; p0 += 32) {
            Code<LM> a2, e2;
            bool touch = false;
            if (p0 + lane < P) {
                clip<LM>(a, e, plo + (size_t)(p0 + lane) * L, phi + (size_t)(p0 + lane) * L, L, a2, e2);
                touch = cmp(a2, e2, L) < 0;
            }
            for (unsigned m = __ballot_sync(FULL, touch); m && !any; m &= m - 1) {
                const int p = p0 + __ffs(m) - 1;
                clip<LM>(a, e, plo + (size_t)p * L, phi + (size_t)p * L, L, a2, e2);
                any = range_hits<LM>(part(p), a2, e2, snap, B, S, L, B1, lgB2, vec, lane);
            }
        }
    }
    if (lane == 0) hit[t] = any;
}

}  // namespace

static int launch_history(
    const void* pivots, const void* grid, const void* count, const void* bmax,
    const void* floor_, const void* plo, const void* phi, const void* rb,
    const void* re, const void* t_snap, void* bmax_sup, void* hit,
    int P, int B, int S, int L, int T, int KR, int B1, int B2, void* stream) {
    if (L < 1 || B < 1 || B1 * B2 != B || (B2 & (B2 - 1))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    superblock_max<<<(P * B1 * 32 + threads - 1) / threads, threads, 0, st>>>(
        (const int*)bmax, (int*)bmax_sup, P * B1, B2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || T == 0) return (int)err;

    // launched behind superblock_max without waiting for its end
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((T + WARPS - 1) / WARPS);
    cfg.blockDim = dim3(WARPS * 32);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int lgB2 = __builtin_ctz((unsigned)B2);
    const bool vec = (L + 1) % 4 == 0 && (uintptr_t)grid % 16 == 0;
    const auto go = [&](auto kernel) {
        return cudaLaunchKernelEx(
            &cfg, kernel, (const uint32_t*)pivots, (const uint32_t*)grid, (const int*)count,
            (const int*)bmax, (const int*)floor_, (const int*)bmax_sup, (const uint32_t*)rb,
            (const uint32_t*)re, (const int*)t_snap, (const uint32_t*)plo, (const uint32_t*)phi,
            (uint8_t*)hit, P, B, S, L, T, KR, B1, lgB2, vec);
    };
    // register arrays sized for the key width: 4 lanes at the bench's 12
    // bytes; above FDB_MAX_LANES the codes are compared in memory
    if (L <= 4) err = go(history_kernel<4>);
    else if (L <= 8) err = go(history_kernel<8>);
    else if (L <= FDB_MAX_LANES) err = go(history_kernel<16>);
    else err = go(history_kernel<0>);
    if (err != cudaSuccess) return (int)err;
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

// K6 history: P stacked partitions, reads clipped to [plo[p], phi[p]); every
// hit[t] is written
extern "C" int fdb_history_parts(
    const void* pivots, const void* grid, const void* count, const void* bmax,
    const void* floor_, const void* plo, const void* phi, const void* rb,
    const void* re, const void* t_snap, void* bmax_sup, void* hit,
    int P, int B, int S, int L, int T, int KR, int B1, int B2, void* stream) {
    return launch_history(pivots, grid, count, bmax, floor_, plo, phi, rb, re,
                          t_snap, bmax_sup, hit, P, B, S, L, T, KR, B1, B2,
                          stream);
}
