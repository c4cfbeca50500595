// The device code of K3 merge (one touched bucket by one warp, and the
// floor raise of the untouched buckets before it that a write spans), shared by the standalone kernel of
// merge.cu and by the group scan (scan.cu). The design and what bounds it
// are described in merge.cu.
#pragma once

#include "common.cuh"

#define EV_OFF (1 << 20)

namespace {

__device__ __forceinline__ unsigned lanemask_le(int lane) {
    return lane == 31 ? 0xffffffffu : (2u << lane) - 1u;
}

// value at the last position <= lane whose `have` bit is set, else `carry`
__device__ __forceinline__ int fill_last(unsigned have, int val, int carry, int lane) {
    unsigned m = have & lanemask_le(lane);
    int src = m ? 31 - __clz(m) : lane;
    int v = __shfl_sync(0xffffffffu, val, src);
    return m ? v : carry;
}

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += y;
    }
    return v;
}

// one warp merges touched bucket u (= tid[u] < B) with its staged rows,
// ``code`` its 64·(L + 2) words of shared memory or global scratch. No
// pointer is __restrict__: in the scan the staging rows were written by an
// earlier phase of the same launch and must not be read through the
// non-coherent cache. The 64 elements are put in order by ranks: the
// bucket's live rows and its staged rows are each sorted already, so
// element i of one list lands at i plus its rank in the other, found by a
// binary search (5 compares); the last 64 words of ``code`` hold the order
__device__ __forceinline__ void merge_bucket(
    uint32_t* grid, int* count, int* bmax, int* floor_, const uint32_t* st_code,
    const int* st_ev, const int* carry_in, int now, int oldest,
    int* max_kept, int B_part, int S, int S2, int L, int u, int b,
    uint32_t* code, int lane) {
    const int Lp1 = L + 1;
    // code: [64, L] element codes
    int* pk = (int*)(code + 64 * L);        // [64] packed payloads
    uint32_t* brow = grid + (size_t)b * S * Lp1;

    // load: element lane = old row lane, element 32 + lane = staged row lane
    {
        const bool live = lane < S && lane < count[b];
        int ver = 0;
        if (live && Lp1 == 4) {
            const uint4 v = reinterpret_cast<const uint4*>(brow)[lane];
            code[lane * 3] = v.x;
            code[lane * 3 + 1] = v.y;
            code[lane * 3 + 2] = v.z;
            ver = (int)v.w;
        } else {
            for (int i = 0; i < L; ++i) code[lane * L + i] = live ? brow[(size_t)lane * Lp1 + i] : FDB_SENTINEL;
            if (live) ver = (int)brow[(size_t)lane * Lp1 + L];
        }
        // fold the bucket floor into the rows now that they are rewritten
        pk[lane] = live ? ((max(ver, floor_[b]) << 1) | 1) : (EV_OFF << 1);
        const int e = 32 + lane;
        const bool st = lane < S2;
        const uint32_t* src = st_code + ((size_t)u * S2 + lane) * L;
        for (int i = 0; i < L; ++i) code[e * L + i] = st ? src[i] : FDB_SENTINEL;
        pk[e] = ((st ? st_ev[(size_t)u * S2 + lane] : 0) + EV_OFF) << 1;
    }
    __syncwarp();

    // the 64 element indices in (code, index) order: a live row precedes
    // a staged row of its code, so a row counts the staged codes below it
    // and a staged row the row codes at or below it; position p = h·32 + lane
    int idx[2];
    {
        int* order = pk + 64;
        int lo = 0, hi = 32;  // staged codes < row lane
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (lex_cmp(code + (32 + mid) * L, code + lane * L, L) < 0) lo = mid + 1;
            else hi = mid;
        }
        order[lane + lo] = lane;
        lo = 0, hi = 32;  // row codes <= staged code lane
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (lex_cmp(code + mid * L, code + (32 + lane) * L, L) <= 0) lo = mid + 1;
            else hi = mid;
        }
        order[lane + lo] = 32 + lane;
        __syncwarp();
        idx[0] = order[lane];
        idx[1] = order[32 + lane];
    }

    // the scan over sorted positions: half 0, then half 1 from its end
    int nv[2], first[2], pval[2];
    int base_c = 0, cov_c = carry_in[u], pval_c = -1, prev_nv = -1, prev_idx = -1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int me = idx[h];
        const int g = pk[me];
        const bool old = (g & 1) != 0;
        const int ver = old ? g >> 1 : 0;
        const int ev = old ? 0 : (g >> 1) - EV_OFF;
        const int base = fill_last(__ballot_sync(0xffffffffu, old), ver, base_c, lane);
        const int cov = cov_c + warp_incl_sum(ev, lane);
        int v = cov > 0 ? max(base, now) : base;
        if (v < oldest) v = 0;
        // the element before this position, and its value
        int pidx = __shfl_up_sync(0xffffffffu, me, 1);
        int pnv = __shfl_up_sync(0xffffffffu, v, 1);
        if (lane == 0) {
            pidx = prev_idx;
            pnv = prev_nv;
        }
        const bool f = pidx < 0 || lex_cmp(code + pidx * L, code + me * L, L) != 0;
        // coalesce: the value before this run (-1 before the first run)
        const int pv = fill_last(__ballot_sync(0xffffffffu, f), pnv, pval_c, lane);
        nv[h] = v;
        first[h] = f;
        pval[h] = pv;
        base_c = __shfl_sync(0xffffffffu, base, 31);
        cov_c = __shfl_sync(0xffffffffu, cov, 31);
        pval_c = __shfl_sync(0xffffffffu, pv, 31);
        prev_nv = __shfl_sync(0xffffffffu, v, 31);
        prev_idx = __shfl_sync(0xffffffffu, me, 31);
    }
    // keep a run's last row, unless it is a sentinel or repeats the value
    // before its run
    bool keep[2];
    const int first1_lane0 = __shfl_sync(0xffffffffu, first[1], 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int nxt = __shfl_down_sync(0xffffffffu, first[h], 1);
        if (lane == 31) nxt = h == 0 ? first1_lane0 : 1;
        keep[h] = nxt && !is_sentinel(code + idx[h] * L, L) && nv[h] != pval[h];
    }

    // compaction: the kept rows in order, to slots 0..S-1
    const unsigned kb0 = __ballot_sync(0xffffffffu, keep[0]);
    const unsigned kb1 = __ballot_sync(0xffffffffu, keep[1]);
    const int k = __popc(kb0) + __popc(kb1);
    const int n = min(k, S);
    const unsigned lt = (1u << lane) - 1u;
    int bm = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int pos = (h ? __popc(kb0) + __popc(kb1 & lt) : __popc(kb0 & lt));
        if (keep[h] && pos < S) {
            const uint32_t* c = code + idx[h] * L;
            uint32_t* dst = brow + (size_t)pos * Lp1;
            if (Lp1 == 4) {
                reinterpret_cast<uint4*>(dst)[0] = make_uint4(c[0], c[1], c[2], (uint32_t)nv[h]);
            } else {
                for (int i = 0; i < L; ++i) dst[i] = c[i];
                dst[L] = (uint32_t)nv[h];
            }
            bm = max(bm, nv[h]);
        }
    }
    if (lane >= n && lane < S) {  // the rest of the bucket: empty slots
        uint32_t* dst = brow + (size_t)lane * Lp1;
        if (Lp1 == 4) {
            reinterpret_cast<uint4*>(dst)[0] = make_uint4(FDB_SENTINEL, FDB_SENTINEL, FDB_SENTINEL, 0u);
        } else {
            for (int i = 0; i < L; ++i) dst[i] = FDB_SENTINEL;
            dst[L] = 0;
        }
    }
    bm = warp_max(bm);
    if (lane == 0) {
        count[b] = n;
        bmax[b] = bm;
        floor_[b] = 0;
        atomicMax(max_kept + b / B_part, k);
    }
}

// the floor raise by the warp of touched bucket u (= tid[u] = b) of the
// untouched buckets before it in its partition, back to the touched bucket
// before it: a committed write spans them exactly when the event prefix at
// b (carry_in[u]) is positive. Each partition's events sum to 0, so the
// buckets after its last touched bucket are never spanned. Touched
// buckets are not written, so it runs beside the merge of every bucket.
// A lane loads kRaiseAhead buckets' words before it stores any, so a long
// gap (a keyspace-wide clear) is not one memory round trip a bucket. Not
// inlined: its registers stay out of the scan's other phases (inlined,
// the scan's chain took twice as long)
constexpr int kRaiseAhead = 16;

__device__ __noinline__ void raise_spanned(int* bmax, int* floor_, const int* tid, const int* carry_in,
                                              int now, int B_part, int u, int b, int lane) {
    if (carry_in[u] <= 0) return;
    int lo = b / B_part * B_part;
    if (u > 0) lo = max(lo, tid[u - 1] + 1);
    for (int x0 = lo + lane; x0 < b; x0 += 32 * kRaiseAhead) {
        int f[kRaiseAhead], m[kRaiseAhead];
#pragma unroll
        for (int k = 0; k < kRaiseAhead; ++k) {
            const int x = x0 + 32 * k;
            if (x < b) f[k] = floor_[x], m[k] = bmax[x];
        }
#pragma unroll
        for (int k = 0; k < kRaiseAhead; ++k) {
            const int x = x0 + 32 * k;
            if (x < b) floor_[x] = max(f[k], now), bmax[x] = max(m[k], now);
        }
    }
}

}  // namespace
