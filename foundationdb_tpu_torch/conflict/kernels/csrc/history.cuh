// The device code of K1 / K6 history (one transaction's check by one warp,
// and the superblock maxima), shared by the standalone kernels of
// history.cu and by the group scan (scan.cu). The design and what bounds it
// are described in history.cu.
//
// CG: the caller is the group scan, whose merge phase rewrites the grid
// between batches, so the state is read through L2 (ld_in<true>) and the
// superblock maxima are complete before the check starts (a grid-wide
// barrier, not a programmatic dependent launch).
#pragma once

#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // transactions (warps) per block of the standalone kernel

// one grid row: its L bound lanes and the gap version; 16-byte loads when
// ``vec`` (L + 1 a multiple of 4 and the grid 16-byte aligned)
template <int LM, bool CG>
__device__ __forceinline__ void load_row(const uint32_t* row, int L, bool vec, Code<LM>& code,
                                         int& ver) {
    if constexpr (LM == 0) {
        code.p = row;
        ver = (int)ld_in<CG>(row + L);
    } else if (vec) {
        uint32_t(&x)[LM] = code.x;
#pragma unroll
        for (int q = 0; q < (LM + 4) / 4; ++q) {
            if (4 * q <= L) {
                const uint4 v = ld_in<CG>(reinterpret_cast<const uint4*>(row) + q);
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
        load_code<LM, CG>(row, L, code.x);
        ver = (int)ld_in<CG>(row + L);
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
template <int LM, bool CG>
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
    const int cnt_a = ld_in<CG>(g.count + bac);
    const int cnt_e = diff ? ld_in<CG>(g.count + bec) : 0;
    // bucket floors: a's gap always overlaps; e⁻'s bucket when later
    int v = max(max(ld_in<CG>(g.floor_ + bac), diff ? ld_in<CG>(g.floor_ + bec) : 0), 0);
    int n_a = 0, v_at = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        Code<LM> ra, re_;
        int va = 0, ve = 0;
        if (s < S) load_row<LM, CG>(win_a + (size_t)s * Lp1, L, vec, ra, va);
        if (diff && s < S) load_row<LM, CG>(win_e + (size_t)s * Lp1, L, vec, re_, ve);
        // a's bucket: rows <= a count toward the value at a; rows strictly
        // inside (a, e) start gaps the range overlaps
        const bool used_a = s < S && s < cnt_a;
        const bool le = used_a && cmp<LM, CG>(ra, a, L) <= 0;
        if (used_a && !le && cmp<LM, CG>(ra, e, L) < 0) v = max(v, va);
        // e's bucket when later: rows before e
        if (s < S && s < cnt_e && cmp<LM, CG>(re_, e, L) < 0) v = max(v, ve);
        const int k = __popc(__ballot_sync(FULL, le));
        if (S <= 32 && k > 0) v_at = __shfl_sync(FULL, va, k - 1);
        n_a += k;
    }
    if (S > 32 && n_a > 0) v_at = (int)ld_in<CG>(win_a + (size_t)(n_a - 1) * Lp1 + L);
    v = max(v, v_at);

    // buckets strictly between ba and be: partial edge superblocks word by
    // word, whole superblocks through their maxima
    const int s1a = ba >> lgB2, s2a = ba & (B2 - 1);  // floor division / modulo
    const int s1e = be >> lgB2, s2e = be & (B2 - 1);
    const int* blk_a = g.bmax + (size_t)max(s1a, 0) * B2;
    const int hi2 = s1e == s1a ? s2e : B2;
    for (int j = s2a + 1 + lane; j < hi2; j += 32) v = max(v, ld_in<CG>(blk_a + j));
    if (s1e > s1a) {
        const int* blk_e = g.bmax + (size_t)max(s1e, 0) * B2;
        for (int j = lane; j < s2e; j += 32) v = max(v, ld_in<CG>(blk_e + j));
    }
    const int k0 = max(s1a + 1, 0), k1 = min(s1e, B1);
    if (k0 < k1) {
        if constexpr (!CG) cudaGridDependencySynchronize();  // superblock_max has finished
        for (int k = k0 + lane; k < k1; k += 32) v = max(v, __ldcg(g.bmax_sup + k));
    }
    return warp_max(v) > snap;
}

// bmax_sup[w] = max(bmax[w*B2 .. w*B2+B2)): superblock w by one warp
template <bool CG>
__device__ __forceinline__ void superblock_warp(const int* bmax, int* bmax_sup, int w, int lane, int B2) {
    int m = 0;
    for (int j = lane; j < B2; j += 32) m = max(m, ld_rw<CG>(bmax + (size_t)w * B2 + j));
    m = warp_max(m);
    if (lane == 0) bmax_sup[w] = m;
}

// what the history check of one batch reads; plo == nullptr on a single
// grid (P = 1), else the reads are clipped to each partition
struct HistArgs {
    const uint32_t* pivots;  // [P, B, L]
    const uint32_t* grid;    // [P, B, S, L + 1]
    const int* count;        // [P, B]
    const int* bmax;
    const int* floor_;
    const int* bmax_sup;  // [P, B1]
    const uint32_t* rb;   // [T, KR, L]
    const uint32_t* re;
    const int* t_snap;  // [T]
    const uint32_t* plo;  // [P, L]
    const uint32_t* phi;
    int P, B, S, L, KR, B1, lgB2;
    bool vec;
};

// transaction t's history verdict, by one warp (warp-uniform): does a read
// range, clipped to each partition it touches, overlap a gap with a version
// above its snapshot?
template <int LM, bool CG>
__device__ __forceinline__ bool history_txn(const HistArgs& A, int t, int lane) {
    const int B = A.B, S = A.S, L = A.L;
    const int snap = __ldg(A.t_snap + t);
    const auto part = [&](int p) {
        return Grid{A.pivots + (size_t)p * B * L, A.grid + (size_t)p * B * S * (L + 1),
                    A.count + (size_t)p * B, A.bmax + (size_t)p * B, A.floor_ + (size_t)p * B,
                    A.bmax_sup + (size_t)p * A.B1};
    };
    bool any = false;
    for (int r = 0; r < A.KR && !any; ++r) {
        Code<LM> a, e;
        load(a, A.rb + ((size_t)t * A.KR + r) * L, L);
        load(e, A.re + ((size_t)t * A.KR + r) * L, L);
        if (A.plo == nullptr) {
            if (cmp(a, e, L) < 0)  // inactive (or empty) ranges are skipped
                any = range_hits<LM, CG>(part(0), a, e, snap, B, S, L, A.B1, A.lgB2, A.vec, lane);
            continue;
        }
        for (int p0 = 0; p0 < A.P && !any; p0 += 32) {
            Code<LM> a2, e2;
            bool touch = false;
            if (p0 + lane < A.P) {
                clip<LM>(a, e, A.plo + (size_t)(p0 + lane) * L, A.phi + (size_t)(p0 + lane) * L, L, a2, e2);
                touch = cmp(a2, e2, L) < 0;
            }
            for (unsigned m = __ballot_sync(FULL, touch); m && !any; m &= m - 1) {
                const int p = p0 + __ffs(m) - 1;
                clip<LM>(a, e, A.plo + (size_t)p * L, A.phi + (size_t)p * L, L, a2, e2);
                any = range_hits<LM, CG>(part(p), a2, e2, snap, B, S, L, A.B1, A.lgB2, A.vec, lane);
            }
        }
    }
    return any;
}

}  // namespace
