// The device code of K2 (the overlap bitset's tiles and the greedy chain),
// shared by the standalone kernels of intra_batch.cu and by the group scan
// (scan.cu). The design and what bounds it are described in intra_batch.cu.
//
// A tile is the work of one CTA of the standalone build: reader block jb
// (32 readers) against writer words bx·WT .. bx·WT + WT - 1. Its endpoints
// are staged by every thread of the block that runs it; the bits are
// computed by the block's first 32·WT threads (all of them in the
// standalone kernel; the scan's blocks of 1024 threads take any WT <= 32).
#pragma once

#include "common.cuh"

namespace {

constexpr int kRowsPerCta = 32;
constexpr int kChainThreads = 1024;
constexpr int kAhead = 16;       // words loaded ahead of the chain
constexpr int kMaxWords = 2048;  // commit words: T <= 65536

// a < b on L uint32 lanes
__device__ __forceinline__ bool lex_lt(const uint32_t* a, const uint32_t* b, int L) {
    return lex_cmp(a, b, L) < 0;
}

// one tile of the overlap bitset with every endpoint of its readers and
// writers staged in shared memory ``sm``. LC: the lane count when it is
// known at compile time (the compares then unroll), 0 for any L
template <int LC>
__device__ void overlap_tile(
    const uint32_t* rb, const uint32_t* re, const uint32_t* wb, const uint32_t* we,
    uint32_t* pt, int T, int KR, int KW, int L_, int Tp, int WT, int bx, int jb, uint32_t* sm) {
    const int L = LC ? LC : L_;
    const int w0 = bx * WT;
    if (w0 > jb) return;  // every word strictly above the diagonal
    const int j0 = jb * kRowsPerCta;
    const int i0 = w0 * 32;
    const int n_w = 32 * WT;  // writers staged
    // readers: [32][KR][2][L] (begin, end) at an odd stride, since the
    // lanes of a warp read 32 different readers; writers: [32·WT][KW][2][L],
    // each read by a whole warp at once
    const int rrec = (KR * 2 * L) | 1;
    uint32_t* rd = sm;
    uint32_t* wr = sm + kRowsPerCta * rrec;
    const int wrec = KW * 2 * L;
    const int rd_words = kRowsPerCta * KR * L;
    for (int k = threadIdx.x; k < rd_words; k += blockDim.x) {
        int r = k / (KR * L), rest = k % (KR * L);
        int j = j0 + r;
        size_t src = (size_t)j * KR * L + rest;
        int ar = rest / L, l = rest % L;
        uint32_t* dst = rd + r * rrec + ar * 2 * L + l;
        dst[0] = j < T ? rb[src] : FDB_SENTINEL;
        dst[L] = j < T ? re[src] : FDB_SENTINEL;
    }
    const int wr_words = n_w * KW * L;
    for (int k = threadIdx.x; k < wr_words; k += blockDim.x) {
        int r = k / (KW * L), rest = k % (KW * L);
        int i = i0 + r;
        size_t src = (size_t)i * KW * L + rest;
        int aw = rest / L, l = rest % L;
        uint32_t* dst = wr + r * wrec + aw * 2 * L + l;
        dst[0] = i < T ? wb[src] : FDB_SENTINEL;
        dst[L] = i < T ? we[src] : FDB_SENTINEL;
    }
    __syncthreads();

    const int r = threadIdx.x & 31, wi = threadIdx.x >> 5, w = w0 + wi;
    const int j = j0 + r;
    if (wi >= WT || w > jb) return;  // only the tile's words at or below the diagonal
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
        int i = w * 32 + b;
        if (i >= j) break;  // strictly earlier writers only
        const uint32_t* wrow = wr + (i - i0) * wrec;
        bool o = false;
        for (int ar = 0; ar < KR && !o; ++ar) {
            const uint32_t* rbj = rd + r * rrec + ar * 2 * L;
            const uint32_t* rej = rbj + L;
            for (int aw = 0; aw < KW; ++aw) {
                const uint32_t* wbi = wrow + aw * 2 * L;
                const uint32_t* wei = wbi + L;
                // read j overlaps write i: rb_j < we_i and wb_i < re_j
                if (lex_lt(rbj, wei, L) && lex_lt(wbi, rej, L)) { o = true; break; }
            }
        }
        if (o) bits |= 1u << b;
    }
    if (j < T) pt[(size_t)w * Tp + j] = bits;
}

// overlap_tile where the endpoints do not fit one block: STAGED, they
// come in chunks of CR read slots and CW write slots, one (read chunk,
// write chunk) pair at a time, each row's bits ORed over the pairs; else
// straight from global memory
template <int LC, bool STAGED>
__device__ void overlap_tile_chunks(
    const uint32_t* rb, const uint32_t* re, const uint32_t* wb, const uint32_t* we,
    uint32_t* pt, int T, int KR, int KW, int L_, int Tp, int WT, int CR, int CW, int bx, int jb,
    uint32_t* sm) {
    const int L = LC ? LC : L_;
    const int w0 = bx * WT;
    if (w0 > jb) return;  // every word strictly above the diagonal
    const int j0 = jb * kRowsPerCta;
    const int i0 = w0 * 32;
    const int n_w = 32 * WT;  // writers staged
    const int cr = STAGED ? CR : KR, cw = STAGED ? CW : KW;
    // readers: [32][CR][2][L] (begin, end) at an odd stride, since the
    // lanes of a warp read 32 different readers; writers: [32·WT][CW][2][L],
    // each read by a whole warp at once
    const int rrec = (cr * 2 * L) | 1;
    uint32_t* rd = sm;
    uint32_t* wr = sm + kRowsPerCta * rrec;
    const int wrec = cw * 2 * L;

    const int r = threadIdx.x & 31, wi = threadIdx.x >> 5, w = w0 + wi;
    const int j = j0 + r;
    const bool active = wi < WT && w <= jb && j < T;  // only the tile's words at or below the diagonal
    uint32_t bits = 0;
    for (int r0 = 0; r0 < KR; r0 += cr) {
        const int nr = min(cr, KR - r0);
        for (int a0 = 0; a0 < KW; a0 += cw) {
            const int na = min(cw, KW - a0);
            if (STAGED) {
                if (r0 | a0) __syncthreads();  // every thread is done with the last chunk
                if (a0 == 0) {
                    const int rd_words = kRowsPerCta * nr * L;
                    for (int k = threadIdx.x; k < rd_words; k += blockDim.x) {
                        int rr = k / (nr * L), rest = k % (nr * L);
                        int jj = j0 + rr;
                        size_t src = ((size_t)jj * KR + r0) * L + rest;
                        int ar = rest / L, l = rest % L;
                        uint32_t* dst = rd + rr * rrec + ar * 2 * L + l;
                        dst[0] = jj < T ? rb[src] : FDB_SENTINEL;
                        dst[L] = jj < T ? re[src] : FDB_SENTINEL;
                    }
                }
                if (r0 == 0 || cw < KW) {  // one write chunk stays staged
                    const int wr_words = n_w * na * L;
                    for (int k = threadIdx.x; k < wr_words; k += blockDim.x) {
                        int rr = k / (na * L), rest = k % (na * L);
                        int i = i0 + rr;
                        size_t src = ((size_t)i * KW + a0) * L + rest;
                        int aw = rest / L, l = rest % L;
                        uint32_t* dst = wr + rr * wrec + aw * 2 * L + l;
                        dst[0] = i < T ? wb[src] : FDB_SENTINEL;
                        dst[L] = i < T ? we[src] : FDB_SENTINEL;
                    }
                }
                __syncthreads();
            }
            if (!active) continue;
            // reader j's read slots r0 .. r0 + nr - 1: begin at rbj, end at
            // rej, slot s at s·rs
            const uint32_t* rbj = STAGED ? rd + r * rrec : rb + ((size_t)j * KR + r0) * L;
            const uint32_t* rej = STAGED ? rbj + L : re + ((size_t)j * KR + r0) * L;
            const int rs = STAGED ? 2 * L : L;
            for (int b = 0; b < 32; ++b) {
                const int i = w * 32 + b;
                if (i >= j) break;              // strictly earlier writers only
                if ((bits >> b) & 1u) continue;  // found in an earlier chunk
                const uint32_t* wbi = STAGED ? wr + (i - i0) * wrec : wb + ((size_t)i * KW + a0) * L;
                const uint32_t* wei = STAGED ? wbi + L : we + ((size_t)i * KW + a0) * L;
                bool o = false;
                for (int ar = 0; ar < nr && !o; ++ar) {
                    for (int aw = 0; aw < na; ++aw) {
                        // read j overlaps write i: rb_j < we_i and wb_i < re_j
                        if (lex_lt(rbj + ar * rs, wei + aw * rs, L) && lex_lt(wbi + aw * rs, rej + ar * rs, L)) {
                            o = true;
                            break;
                        }
                    }
                }
                if (o) bits |= 1u << b;
            }
        }
    }
    if (active) pt[(size_t)w * Tp + j] = bits;
}

// the greedy chain by one CTA of kChainThreads threads, its commit words in
// ``cbits`` (shared memory, kMaxWords words). CG: the bitset and H were
// written by earlier phases of the same launch (the scan)
template <bool CG>
__device__ void greedy_chain_block(const uint32_t* pt, const uint8_t* H, uint8_t* commit, int T, int W,
                                   int Tp, uint32_t* cbits) {
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    constexpr int D = kAhead;
    for (int j0 = 0; j0 < T; j0 += kChainThreads) {
        // a panel: blocks k0 .. k0 + 31; this thread's row j is in block kb
        const int k0 = j0 >> 5, j = j0 + t, kb = k0 + warp;
        const int n_blocks = min(W - k0, 32);
        const bool in = j < T;
        // the row's words below the panel against the earlier commit
        // words, and its words k0 .. k0 + D - 1 into the ring
        uint32_t acc = 0, pf[D];
        if (in) {
#pragma unroll 8
            for (int w = 0; w < k0; ++w) acc |= ld_in<CG>(pt + (size_t)w * Tp + j) & cbits[w];
        }
        const bool ok = in && !ld_in<CG>(H + j);
#pragma unroll
        for (int d = 0; d < D; ++d) pf[d] = (in && k0 + d <= kb) ? ld_in<CG>(pt + (size_t)(k0 + d) * Tp + j) : 0u;
        for (int s0 = 0; s0 < 32; s0 += D) {
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const int s = s0 + d, k = k0 + s;  // block k, warp s
                if (s >= n_blocks) return;         // the last panel's end
                if (warp == s) {
                    const bool okr = ok && acc == 0;
                    const uint32_t diag = pf[d];  // word k of row 32k + lane
                    uint32_t c = __ballot_sync(0xffffffffu, okr);
                    while (true) {
                        const uint32_t nc = __ballot_sync(0xffffffffu, okr && (diag & c) == 0);
                        if (nc == c) break;
                        c = nc;
                    }
                    if (in) commit[j] = (c >> lane) & 1u;
                    if (lane == 0) cbits[k] = c;
                }
                __syncthreads();
                if (kb > k) {  // a later block (warp-uniform): fold word k, load word k + D
                    acc |= pf[d] & cbits[k];
                    const int kn = k + D;
                    pf[d] = (in && kn <= kb) ? ld_in<CG>(pt + (size_t)kn * Tp + j) : 0u;
                }
            }
        }
    }
}

}  // namespace
