// The device code of K2 (the overlap bitset's items and the greedy chain),
// shared by the standalone kernels of intra_batch.cu and by the group scan
// (scan.cu). The design and what bounds it are described in intra_batch.cu.
#pragma once

#include "common.cuh"

namespace {

constexpr int kAhead = 16;       // words loaded ahead of the chain
constexpr int kMaxWords = 2048;  // commit words: T <= 65536

// a < b for two codes of LM lanes (lanes past L zero in both), compared
// as LM / 2 big-endian 64-bit words
template <int LM>
__device__ __forceinline__ bool lt64(const uint32_t (&a)[LM], const uint32_t (&b)[LM]) {
    bool lt = false, eq = true;
#pragma unroll
    for (int k = 0; k < LM / 2; ++k) {
        const uint64_t x = ((uint64_t)a[2 * k] << 32) | a[2 * k + 1];
        const uint64_t y = ((uint64_t)b[2 * k] << 32) | b[2 * k + 1];
        lt = lt || (eq && x < y);
        eq = eq && x == y;
    }
    return lt;
}

// the batch's codes and K2's overlap items: R readers an item (a power of
// two up to 32), NS slices of the KW write slots (kernels.overlap_items)
struct OverlapArgs {
    const uint32_t* rb;  // [T, KR, L]
    const uint32_t* re;
    const uint32_t* wb;  // [T, KW, L]
    const uint32_t* we;
    uint32_t* pt;  // [W, 32 W]: the transposed bitset (zeroed first where NS > 1)
    int T, KR, KW, L, R, NS;
};

// K2's overlap items of a batch: reader groups × writer words × write-slot
// slices
__device__ __forceinline__ int overlap_count(const OverlapArgs& A) {
    const int W = (A.T + 31) / 32;
    return (A.T + A.R - 1) / A.R * W * A.NS;
}

// overlap item v (reader group jg of R readers, writer word w, write-slot
// slice c of NS) by one warp: lane b takes writer i = 32w + b and each
// reader j > i of the group; reader j's word w gets bit b where a read of j
// overlaps a write of i (rb_j < we_i and wb_i < re_j). Items wholly above
// the diagonal return at once. Read slot by read slot, the group's
// readers are staged in the warp's ``ws`` (2·32·LM words of shared
// memory) and every lane reads each reader back as one broadcast, its
// writer's codes in registers; the codes compare as 64-bit words. Lane r
// stores reader j0 + r's word (ORed in where the write slots are sliced).
// The codes are read-only inputs; LM = 0 compares them in memory (any L).
template <int LM>
__device__ __forceinline__ void overlap_item(const OverlapArgs& A, int v, int lane, uint32_t* ws) {
    const int T = A.T, L = A.L, KR = A.KR, KW = A.KW, R = A.R;
    const int W = (T + 31) / 32, Tp = 32 * W;
    const int c = v % A.NS, jw = v / A.NS, jg = jw / W, w = jw % W;
    if (w > jg * R / 32) return;  // every word above the diagonal
    const int j0 = jg * R, i = 32 * w + lane, n_r = min(R, T - j0);
    const int per = (KW + A.NS - 1) / A.NS, a0 = c * per, a1 = min(KW, a0 + per);
    const int im = min(i, T - 1);
    uint32_t m = 0;  // bit r: reader j0 + r overlaps writer i
    for (int ar = 0; ar < KR; ++ar) {
        if constexpr (LM > 0) {  // lane r stages reader j0 + r's read slot ar
            if (lane < n_r) {
                Code<LM> mb, me;
                load(mb, A.rb + ((size_t)(j0 + lane) * KR + ar) * L, L);
                load(me, A.re + ((size_t)(j0 + lane) * KR + ar) * L, L);
#pragma unroll
                for (int k = 0; k < LM; ++k) {
                    ws[lane * 2 * LM + k] = mb.x[k];
                    ws[lane * 2 * LM + LM + k] = me.x[k];
                }
            }
            __syncwarp();
        }
        for (int aw = a0; aw < a1; ++aw) {
            Code<LM> wbi, wei;
            load(wbi, A.wb + ((size_t)im * KW + aw) * L, L);
            load(wei, A.we + ((size_t)im * KW + aw) * L, L);
            for (int r = 0; r < n_r; ++r) {
                if (i >= j0 + r || ((m >> r) & 1u)) continue;  // strictly earlier writers; found already
                bool o;
                if constexpr (LM == 0) {
                    Code<0> rbj, rej;
                    load(rbj, A.rb + ((size_t)(j0 + r) * KR + ar) * L, L);
                    load(rej, A.re + ((size_t)(j0 + r) * KR + ar) * L, L);
                    o = cmp(rbj, wei, L) < 0 && cmp(wbi, rej, L) < 0;
                } else {
                    uint32_t rbj[LM], rej[LM];
#pragma unroll
                    for (int q = 0; q < LM / 4; ++q) {
                        const uint4 x = reinterpret_cast<const uint4*>(ws + r * 2 * LM)[q];
                        const uint4 y = reinterpret_cast<const uint4*>(ws + r * 2 * LM + LM)[q];
                        rbj[4 * q] = x.x, rbj[4 * q + 1] = x.y, rbj[4 * q + 2] = x.z, rbj[4 * q + 3] = x.w;
                        rej[4 * q] = y.x, rej[4 * q + 1] = y.y, rej[4 * q + 2] = y.z, rej[4 * q + 3] = y.w;
                    }
                    o = lt64<LM>(rbj, wei.x) && lt64<LM>(wbi.x, rej);
                }
                if (o) m |= 1u << r;
            }
        }
        if constexpr (LM > 0) __syncwarp();  // the next read slot restages ws
    }
    uint32_t mine = 0;
    for (int r = 0; r < R; ++r) {
        const uint32_t word = __ballot_sync(FULL, (m >> r) & 1u);
        if (lane == r) mine = word;
    }
    const int j = j0 + lane;
    if (lane < R && j < T) {
        uint32_t* dst = A.pt + (size_t)w * Tp + j;
        if (A.NS == 1) *dst = mine;
        else if (mine) atomicOr(dst, mine);
    }
}

// the greedy chain by one CTA of NT threads, its commit words in ``cbits``
// (shared memory, kMaxWords words), panels of NT / 32 blocks. CG: the
// bitset and H were written by earlier phases of the same launch (the
// scan)
template <int NT, bool CG>
__device__ void greedy_chain_block(const uint32_t* pt, const uint8_t* H, uint8_t* commit, int T, int W,
                                   int Tp, uint32_t* cbits) {
    constexpr int NW = NT / 32, D = NW < kAhead ? NW : kAhead;
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    for (int j0 = 0; j0 < T; j0 += NT) {
        // a panel: blocks k0 .. k0 + NW - 1; this thread's row j is in block kb
        const int k0 = j0 >> 5, j = j0 + t, kb = k0 + warp;
        const int n_blocks = min(W - k0, NW);
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
        for (int s0 = 0; s0 < NW; s0 += D) {
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const int s = s0 + d, k = k0 + s;  // block k, warp s
                if (s >= n_blocks) return;         // the last panel's end
                if (warp == s) {
                    const bool okr = ok && acc == 0;
                    const uint32_t diag = pf[d];  // word k of row 32k + lane
                    uint32_t c = __ballot_sync(FULL, okr);
                    while (true) {
                        const uint32_t nc = __ballot_sync(FULL, okr && (diag & c) == 0);
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
