// The device code of K3 staging (records, the tile sort, the merge passes
// and the aggregation), shared by the standalone kernels of stage.cu and by
// the group scan (scan.cu). The design and what bounds it are described in
// stage.cu. Each piece takes its block's or row's coordinates as arguments,
// so the scan's resident blocks can walk the standalone grids.
#pragma once

#include <climits>

#include "common.cuh"

namespace {

struct StageArgs {
    const uint32_t* wb;      // [P, T, KW, L] clipped per partition, or [T, KW, L] when plo is set
    const uint32_t* we;
    const uint8_t* commit;   // [T]
    const uint32_t* pivots;  // [P, B, L]
    const uint32_t* plo;     // [P, L]: clip each write to [plo[p], phi[p]) here (nullptr: clipped already)
    const uint32_t* phi;
    uint32_t* st_code;       // [U, S2, L]
    int* st_ev;              // [U, S2]
    int* tid;                // [U]
    int* carry;              // [U]
    int* max_staged;         // [P] (zeroed)
    int* n_valid;            // [P] (zeroed): valid rows of each partition
    int P, T, KW, L, B, U, S2, N2, N2pad;
};

__device__ __forceinline__ int rec_cmp(const uint32_t* a, const uint32_t* b, int L) {
    if ((int)a[0] != (int)b[0]) return (int)a[0] < (int)b[0] ? -1 : 1;
    return lex_cmp(a + 1, b + 1, L);
}

// record of row q of partition p: begins (event +1) then ends (-1); a
// valid row's bucket and code (nullptr: invalid, bucket P·B or INT_MAX)
__device__ int record_bucket(const StageArgs& A, int p, int q, const uint32_t*& code, int& ev) {
    const int L = A.L, W = A.T * A.KW;
    code = nullptr;
    ev = 0;
    if (q >= A.N2) return INT_MAX;
    bool end = q >= W;
    int qq = end ? q - W : q;
    const size_t row = (size_t)(A.plo ? 0 : p) * W + qq;
    const uint32_t* b = A.wb + row * L;
    const uint32_t* e = A.we + row * L;
    if (A.plo) {  // sharded.clip: a begin below plo starts at plo, an end above phi ends at phi
        const uint32_t* lo = A.plo + (size_t)p * L;
        const uint32_t* hi = A.phi + (size_t)p * L;
        if (lex_cmp(b, lo, L) < 0) b = lo;
        if (lex_cmp(hi, e, L) < 0) e = hi;
    }
    if (!A.commit[qq / A.KW] || lex_cmp(b, e, L) >= 0) return A.P * A.B;
    code = end ? e : b;
    const uint32_t* piv = A.pivots + (size_t)p * A.B * L;
    int lo = 0, hi = A.B;  // #pivots <= code
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (lex_cmp(piv + (size_t)mid * L, code, L) <= 0) lo = mid + 1;
        else hi = mid;
    }
    ev = end ? -1 : 1;
    return p * A.B + lo - 1;
}

// ---- block-wide scan of four (segment head, value) sums -------------------

struct Scan4 {
    int f[4];
    int v[4];
};

// (a ⊕ b): b's value restarts at a head inside b
__device__ __forceinline__ void scan_combine(Scan4& acc, const Scan4& prev) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (!acc.f[c]) acc.v[c] += prev.v[c];
        acc.f[c] |= prev.f[c];
    }
}

__device__ __forceinline__ Scan4 shfl_up4(const Scan4& x, int off) {
    Scan4 y;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        y.f[c] = __shfl_up_sync(0xffffffffu, x.f[c], off);
        y.v[c] = __shfl_up_sync(0xffffffffu, x.v[c], off);
    }
    return y;
}

__device__ __forceinline__ void warp_scan4(Scan4& x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        Scan4 y = shfl_up4(x, off);
        if (lane >= off) scan_combine(x, y);
    }
}

// inclusive scan over the block, continuing from `carry` (shared, updated
// to the block's total); blockDim.x is a multiple of 32
__device__ void block_scan4(Scan4& x, Scan4* warp_tot, Scan4* carry) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    warp_scan4(x);
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
        Scan4 t = lane < n_warps ? warp_tot[lane] : Scan4{{0, 0, 0, 0}, {0, 0, 0, 0}};
        warp_scan4(t);  // inclusive over the warps
        Scan4 c = *carry;
        Scan4 ex = shfl_up4(t, 1);
        Scan4 pre = ex;
        if (lane == 0) pre = Scan4{{0, 0, 0, 0}, {0, 0, 0, 0}};
        scan_combine(pre, c);  // carry ⊕ exclusive prefix of the warps
        if (lane < n_warps) warp_tot[lane] = pre;
        if (lane == n_warps - 1) {  // t: inclusive over every warp
            scan_combine(t, c);
            *carry = t;
        }
    }
    __syncthreads();
    scan_combine(x, warp_tot[warp]);
    __syncthreads();  // warp_tot is rewritten by the next chunk
}

// ---- the aggregation over sorted records (one CTA) ------------------------

__device__ void aggregate(const StageArgs& A, const uint32_t* rec, size_t part_words,
                          const int* n_valid, const uint16_t* order) {
    __shared__ Scan4 warp_tot[32];
    __shared__ Scan4 carry;
    const int L = A.L, RW = L + 2;
    if (threadIdx.x == 0) carry = Scan4{{0, 0, 0, 0}, {0, 0, 0, 0}};
    __syncthreads();
    for (int p = 0; p < A.P; ++p) {
        const uint32_t* part_rec = rec + p * part_words;
        const int n_rec = n_valid[p];
        // sorted record x: in place, or at order[x] (the index sort)
        auto at = [&](int x) { return part_rec + (size_t)(order ? order[x] : x) * RW; };
        for (int c0 = 0; c0 < n_rec; c0 += blockDim.x) {
            const int r = c0 + threadIdx.x;
            const bool valid = r < n_rec;
            const uint32_t* me = at(valid ? r : 0);
            bool bkt_new = false, code_new = false, bkt_last = false, code_last = false;
            int ev = 0;
            if (valid) {
                const int bkt = (int)me[0];
                ev = (int)me[L + 1];
                if (r > 0) {
                    const uint32_t* pv = at(r - 1);
                    bkt_new = (int)pv[0] != bkt;
                    code_new = bkt_new || lex_cmp(pv + 1, me + 1, L) != 0;
                } else {
                    bkt_new = code_new = true;
                }
                if (r < n_rec - 1) {
                    const uint32_t* nx = at(r + 1);
                    bkt_last = (int)nx[0] != bkt;
                    code_last = bkt_last || lex_cmp(nx + 1, me + 1, L) != 0;
                } else {
                    bkt_last = code_last = true;
                }
            }
            // 0: touched-bucket count; 1: distinct codes in the bucket;
            // 2: events of the equal-code run; 3: event prefix
            Scan4 x = {{0, bkt_new, code_new, 0}, {bkt_new, code_new, ev, ev}};
            block_scan4(x, warp_tot, &carry);
            int run_max = 0;
            if (valid) {
                const int bkt = (int)me[0];
                const int u = x.v[0] - 1;
                if (code_last) {
                    const int slot = x.v[1] - 1;
                    run_max = slot + 1;
                    if (slot < A.S2) {
                        uint32_t* dst = A.st_code + ((size_t)u * A.S2 + slot) * L;
                        for (int i = 0; i < L; ++i) dst[i] = me[1 + i];
                        A.st_ev[(size_t)u * A.S2 + slot] = x.v[2];
                    }
                }
                if (bkt_new) {
                    A.tid[u] = bkt;
                    A.carry[u] = x.v[3] - ev;
                }
            }
            // the partition's max over run ends: one atomic per warp
            const int m = __reduce_max_sync(0xffffffffu, run_max);
            if ((threadIdx.x & 31) == 0 && m > 0) atomicMax(A.max_staged + p, m);
        }
    }
}

// (bucket, code, index) order of two sort keys: bucket kb of record x.
// Padding keys (bucket INT_MAX) have no record; indices are distinct, so
// the order is strict and two threads comparing one pair agree
__device__ __forceinline__ bool key_lt(int ka, int xa, int kb, int xb, const uint32_t* rec, int L) {
    if (ka != kb) return ka < kb;
    if (ka != INT_MAX) {
        const int c = lex_cmp(rec + (size_t)xa * (L + 2) + 1, rec + (size_t)xb * (L + 2) + 1, L);
        if (c) return c < 0;
    }
    return xa < xb;
}

// bitonic sort of n (a power of two) keys kb/ix in shared memory. Only the
// 6-byte keys move; the records stay put. A pass of stride j <= 32 keeps
// each warp inside its own windows of 64 keys (compare t touches keys of
// window t / 32), so it needs only __syncwarp; the block waits around the
// passes of stride >= 64 and at the end
__device__ void bitonic_sort(int* kb, uint16_t* ix, const uint32_t* rec, int n, int L) {
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
                const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // 2j·(t / j) + t % j
                const int a = kb[i], b = kb[i + j], xa = ix[i], xb = ix[i + j];
                if (key_lt(b, xb, a, xa, rec, L) == ((i & k) == 0)) {  // out of order for the stage
                    kb[i] = b, ix[i] = (uint16_t)xb;
                    kb[i + j] = a, ix[i + j] = (uint16_t)xa;
                }
            }
            // the next pass is (k, j / 2), or (2k, k) after j = 1
            if (j >= 64 || (j == 1 && (k >= 64 || k == n))) __syncthreads();
            else __syncwarp();
        }
    }
}

// row e of the P·N2pad rows (e past them: none) as a record, compacted to
// the front of its partition's region of ``rec`` in any order (the sort
// follows; ties cannot change the result), written by its own thread
// straight from the code. A warp's rows may span partitions: the lanes of
// one partition share an atomic. Every lane of the warp calls it
__device__ __forceinline__ void stage_record_at(const StageArgs& A, uint32_t* rec, size_t e, int lane) {
    const int L = A.L, RW = L + 2;
    const bool in = e < (size_t)A.P * A.N2pad;
    const int p = in ? (int)(e / A.N2pad) : 0;
    const uint32_t* code = nullptr;
    int ev = 0, bkt = INT_MAX;
    if (in) bkt = record_bucket(A, p, (int)(e % A.N2pad), code, ev);
    const bool valid = code != nullptr;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const unsigned vm = __ballot_sync(0xffffffffu, valid) & peers;
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader && vm) base = atomicAdd(A.n_valid + p, __popc(vm));
    base = __shfl_sync(0xffffffffu, base, leader) + __popc(vm & ((1u << lane) - 1u));
    if (valid) {
        uint32_t* dst = rec + ((size_t)p * A.N2pad + base) * RW;
        dst[0] = (uint32_t)bkt;
        for (int i = 0; i < L; ++i) dst[1 + i] = code[i];
        dst[L + 1] = (uint32_t)ev;
    }
}

// the empty staging slots, unused touched-bucket ids and zero carries,
// by threads e, e + stride, ...
__device__ __forceinline__ void stage_clear_at(const StageArgs& A, size_t e, size_t stride) {
    const size_t n_slot = (size_t)A.U * A.S2;
    for (size_t x = e; x < n_slot * A.L; x += stride) A.st_code[x] = FDB_SENTINEL;
    for (size_t x = e; x < n_slot; x += stride) A.st_ev[x] = 0;
    for (size_t x = e; x < (size_t)A.U; x += stride) {
        A.tid[x] = A.P * A.B;
        A.carry[x] = 0;
    }
}

__device__ __forceinline__ void pad_record(uint32_t* r, int L) {
    r[0] = (uint32_t)INT_MAX;
    for (int i = 0; i < L; ++i) r[1 + i] = FDB_SENTINEL;
    r[L + 1] = 0;
}

// tile vx of partition vy's compacted records, sorted in shared memory
// ``rec`` by an index sort padded to a power of two; then aggregated here
// (``fused``) or written back in order, padded to the tile
__device__ void sort_tile(const StageArgs& A, int tile, const uint32_t* in, uint32_t* out, int fused,
                          int vx, int vy, uint32_t* rec) {
    // rec: [tile, L + 2] records, [tile] buckets, [tile] indices
    const int RW = A.L + 2;
    int* kb = (int*)(rec + (size_t)tile * RW);
    uint16_t* ix = (uint16_t*)(kb + tile);
    const int q0 = vx * tile;
    const size_t t0 = (size_t)vy * A.N2pad + q0;
    const int n_valid = min(max(A.n_valid[vy] - q0, 0), tile);
    int n = 1;
    while (n < n_valid) n <<= 1;
    const uint32_t* src = in + t0 * RW;
    for (int x = threadIdx.x; x < n_valid * RW; x += blockDim.x) rec[x] = src[x];
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
        kb[x] = x < n_valid ? (int)src[(size_t)x * RW] : INT_MAX;
        ix[x] = (uint16_t)x;
    }
    __syncthreads();
    bitonic_sort(kb, ix, rec, n, A.L);
    if (fused) {
        aggregate(A, rec, 0, A.n_valid, ix);
        return;
    }
    uint32_t* dst = out + t0 * RW;
    for (int x = threadIdx.x; x < n_valid * RW; x += blockDim.x) dst[x] = rec[(size_t)ix[x / RW] * RW + x % RW];
    for (int x = n_valid + threadIdx.x; x < tile; x += blockDim.x) pad_record(dst + (size_t)x * RW, A.L);
}

// record e (< P·N2pad) of a merge pass over sorted runs of width w: its
// place in the merged run of 2w is a binary search of the sibling run (a
// stable merge)
__device__ __forceinline__ void merge_pass_at(const uint32_t* src, uint32_t* dst, int N2pad, int w, int L,
                                              size_t e) {
    const int RW = L + 2;
    const int p = (int)(e / N2pad), i = (int)(e % N2pad);
    const int base = i / (2 * w) * (2 * w), off = i - base;
    const bool left = off < w;
    const uint32_t* part = src + (size_t)p * N2pad * RW;
    const uint32_t* me = part + (size_t)i * RW;
    const uint32_t* other = part + (size_t)(left ? base + w : base) * RW;
    // left rows count the sibling rows < them, right rows those <= them
    int lo = 0, hi = w;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        int c = rec_cmp(other + (size_t)mid * RW, me, L);
        if (c < 0 || (!left && c == 0)) lo = mid + 1;
        else hi = mid;
    }
    const int pos = base + (left ? off : off - w) + lo;
    uint32_t* d = dst + ((size_t)p * N2pad + pos) * RW;
    for (int x = 0; x < RW; ++x) d[x] = me[x];
}

}  // namespace
