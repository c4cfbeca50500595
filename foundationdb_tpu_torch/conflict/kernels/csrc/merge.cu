// K3 — per-bucket merge of a batch's staged writes into the grid, and the
// floor raise of the buckets a committed write spans.
//
// Replaces: the merge half of foundationdb_tpu/conflict/grid.py:402
// merge_writes (:526-642): the [U, S+S2] gather, the multi-key lax.sort by
// code, the _log_shift_fill forward fills (:382), the coverage prefix, GC,
// dedupe/coalesce, the stable flag-sort compaction to S rows, the scatter
// back, and the floor raise of covered untouched buckets (:635-642). The
// staging before it is stage.cu.
//
// What bounds it on the H100: bytes. Each touched bucket reads its live
// rows and S2 staged rows and writes max(old, new) rows back: ~2.6 MB at
// the bench shape, under a microsecond at 3.35 TB/s. The per-bucket work is
// a 64-element sort and a handful of scans, which one warp does in
// registers.
//
// Design: one warp per touched bucket, eight buckets per CTA. Lane l holds
// element l (old row l; S ≤ 32) and element 32 + l (staged row l; S2 ≤ 32),
// as an index into the warp's shared-memory copy of the rows (16-byte row
// loads and stores at L = 3, a lane loop for other L; above L = 112, where
// eight warps' rows outgrow a block's shared memory, the copy is a plane of
// global scratch per touched bucket). The 64 elements are
// sorted by code — ties broken by index, since tie order inside an
// equal-code run cannot change the result — with a warp bitonic network
// (shuffles of the indices). The sequential scan of the JAX passes becomes
// warp-wide operations over the two halves (positions 0-31, 32-63), the
// second continuing from the first:
//   - forward fill of old-row versions: ballot + find-last-set + shuffle;
//   - coverage prefix: an inclusive warp scan of the events plus carry_in;
//   - run first / last: a neighbour shuffle of the indices;
//   - coalesce: the previous run's value, filled like the versions;
//   - compaction: ballot + popc gives each kept row its slot.
// The packed int32 payload is the JAX one (ver << 1 | 1 for an old row,
// (ev + EV_OFF) << 1 for a staged event).
//
// The floor raise runs in the same launch, over all B buckets in a
// grid-stride loop (the grid has at least B threads): an untouched bucket
// takes the carry of the next touched bucket of its partition, found by a
// binary search of the sorted tid, and its floor (and bmax) rise to `now`
// when that carry is positive. Each partition's events sum to 0, so the
// buckets after its last touched bucket are never covered. Touched and
// untouched buckets are disjoint, so the two parts of the launch write
// disjoint words. A keyspace-wide clear (every bucket spanned) costs each
// thread a bucket or two, not one warp a serial walk over the gap.
//
// K6 merge (foundationdb_tpu/conflict/sharded.py:125 _local_resolve) is the
// same launch over the flat [P·B] view of a stacked grid: bucket ids are
// offset by p·B, so a warp never mixes partitions, gaps stop at a
// partition's end, and the pressure word is one per partition
// (max_kept[b / B_part]). The single grid is P = 1, B_part = B.
#include "common.cuh"

#define EV_OFF (1 << 20)

namespace {

constexpr int kWarps = 8;  // touched buckets per CTA

// (code, index) order of two elements held as indices into the rows
__device__ __forceinline__ bool elem_lt(const uint32_t* code, int a, int b, int L) {
    int c = lex_cmp(code + a * L, code + b * L, L);
    return c < 0 || (c == 0 && a < b);
}

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

// one warp merges touched bucket u (= tid[u] < B) with its staged rows
__device__ __forceinline__ void merge_bucket(
    uint32_t* __restrict__ grid, int* __restrict__ count, int* __restrict__ bmax,
    int* __restrict__ floor_, const uint32_t* __restrict__ st_code,
    const int* __restrict__ st_ev, const int* __restrict__ carry_in, int now, int oldest,
    int* __restrict__ max_kept, int B_part, int S, int S2, int L, int u, int b,
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

    // warp bitonic sort of the 64 element indices; position p = h·32 + lane
    int idx[2] = {lane, 32 + lane};
    for (int k = 2; k <= 64; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            if (j == 32) {  // partner in the other half, same lane
                if (elem_lt(code, idx[1], idx[0], L)) {
                    int t = idx[0];
                    idx[0] = idx[1];
                    idx[1] = t;
                }
                continue;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = h * 32 + lane;
                const int other = __shfl_xor_sync(0xffffffffu, idx[h], j);
                const bool asc = (p & k) == 0;
                const bool lower = (lane & j) == 0;
                const bool other_lt = elem_lt(code, other, idx[h], L);
                // the lower position keeps the min when ascending
                if (lower == asc ? other_lt : !other_lt) idx[h] = other;
            }
        }
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

// SCRATCH: each warp's rows in ``rows`` (global), else in shared memory
template <bool SCRATCH>
__global__ void __launch_bounds__(kWarps * 32) merge_buckets(
    uint32_t* __restrict__ grid, int* __restrict__ count, int* __restrict__ bmax,
    int* __restrict__ floor_, const uint32_t* __restrict__ st_code,
    const int* __restrict__ st_ev, const int* __restrict__ tid,
    const int* __restrict__ carry_in, int now, int oldest,
    int* __restrict__ max_kept, uint32_t* __restrict__ rows, int B, int B_part, int S, int S2, int L,
    int U) {
    extern __shared__ uint32_t sm[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int u = blockIdx.x * kWarps + warp;
    if (u < U) {  // warp-uniform; tid[u] = B marks an unused staging slot
        const int b = tid[u];
        if (b < B)
            merge_bucket(grid, count, bmax, floor_, st_code, st_ev, carry_in, now, oldest,
                         max_kept, B_part, S, S2, L, u, b,
                         SCRATCH ? rows + (size_t)u * 64 * (L + 1) : sm + warp * 64 * (L + 1), lane);
    }

    // the floor raise of the untouched buckets a committed write spans
    for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < B; x += gridDim.x * blockDim.x) {
        int lo = 0, hi = U;  // first slot with tid >= x
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (tid[mid] < x) lo = mid + 1;
            else hi = mid;
        }
        if (lo == U) continue;
        const int nb = tid[lo];
        if (nb < B && nb != x && nb / B_part == x / B_part && carry_in[lo] > 0) {
            floor_[x] = max(floor_[x], now);
            bmax[x] = max(bmax[x], now);
        }
    }
}

}  // namespace

// rows: nullptr, or [U, 64, L + 1] scratch where a CTA's rows outgrow
// shared memory (L > 112)
extern "C" int fdb_merge(
    void* grid, void* count, void* bmax, void* floor_,
    const void* st_code, const void* st_ev, const void* tid, const void* carry_in,
    int now, int oldest, void* max_kept, void* rows,
    int B, int B_part, int S, int S2, int L, int U, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    size_t smem = rows ? 0 : (size_t)kWarps * 64 * (L + 1) * sizeof(uint32_t);
    auto kernel = rows ? merge_buckets<true> : merge_buckets<false>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int grid_n = max((U + kWarps - 1) / kWarps, (B + kWarps * 32 - 1) / (kWarps * 32));
    kernel<<<grid_n, kWarps * 32, smem, st>>>(
        (uint32_t*)grid, (int*)count, (int*)bmax, (int*)floor_,
        (const uint32_t*)st_code, (const int*)st_ev, (const int*)tid,
        (const int*)carry_in, now, oldest, (int*)max_kept, (uint32_t*)rows, B, B_part, S, S2, L, U);
    return (int)cudaGetLastError();
}
