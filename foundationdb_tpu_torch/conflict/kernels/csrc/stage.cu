// K3 staging — a batch's committed write endpoints, staged per touched
// bucket for the merge (merge.cu).
//
// Replaces: the staging half of foundationdb_tpu/conflict/grid.py:402
// merge_writes (:430-524): the write events, the two-level rank of every
// endpoint against the pivots (_rank_le), the (bucket, code) lax.sort,
// the run aggregation by forward fills and cumsums, the staging-plane and
// touched-bucket scatters, the per-bucket event sums and the carry
// prefix. The same launch stages the partitioned resolver's writes
// (foundationdb_tpu/conflict/sharded.py:125 _local_resolve, merge_writes
// on each partition's clipped writes): partition p ranks against its own
// pivots and its bucket ids are offset by p·B.
//
// What bounds it on the H100: the sort. 2·T·KW endpoint rows of L + 2
// words (5120 rows of 20 B at the bench shape) must be ordered by
// (bucket, code); the rest is a few scans over them. Bytes: the batch's
// write codes in, U·S2 staged rows out (the output planes dominate:
// 5120 × 16 × 16 B = 1.3 MB).
//
// Design. Every row becomes a record [bucket, lanes…, event] (bucket =
// p·B + #(pivots of p ≤ code) − 1 by binary search; an invalid row — an
// uncommitted or empty range, or a padding slot — gets bucket P·B).
//   1. stage_records (one thread a row, all SMs) builds the records and
//      compacts the valid ones to the front of their partition's region
//      in global memory (warp-aggregated atomics; any order), so the
//      binary searches' dependent loads run in parallel and the sort sees
//      only valid rows; it also writes the empty staging slots.
//   2. stage_sort: one CTA per tile of a partition's region (TILE = the
//      largest power of two, at most 8192, whose records and keys fit one
//      block's shared memory) loads the tile's valid rows and bitonic-sorts
//      their keys, padded to a power of two. A key is the record's bucket
//      and a 16-bit index to the record: the records stay put, a compare
//      reads two buckets (and the codes only on a tie), a swap moves 6
//      bytes; the passes of stride <= 32 (57 of the 78 at 4096 keys)
//      need only a warp barrier. With one
//      partition in one tile (the single grid at every T·KW ≤ 4096) the
//      same CTA then aggregates from shared memory: two launches in all.
//   3. Otherwise the sorted tiles (valid rows first, padding after) go to
//      global memory and stage_merge merges sorted runs pairwise (each
//      record finds its place by a binary search of the sibling run: a
//      stable merge), doubling the run width up to the partition's row
//      count. Partitions are never merged with each other: each one's
//      region is sorted, with its padding at its end.
//   4. stage_aggregate (one CTA, or the tail of stage_sort) walks each
//      partition's sorted valid records in chunks of blockDim with one
//      block-wide scan of
//      four sums: touched-bucket ordinal, distinct-code slot within the
//      bucket (segmented at bucket starts), event sum of each equal-code
//      run (segmented at run starts) and the event prefix. A run's last
//      row writes staging slot (u, slot) if slot < S2; a bucket's first
//      row writes tid[u] and the event prefix before it (the carry at
//      that bucket: each partition's events sum to 0, since both ends of
//      a range land in the same partition, so the global prefix is the
//      partition's). Per-partition max_staged is a max over run ends.
// The carry of an untouched bucket follows from the sorted touched list
// (the carry at the next touched bucket of its partition), so no dense
// [B] sum is formed; merge.cu reads it so.
#include <climits>

#include "common.cuh"

namespace {

struct StageArgs {
    const uint32_t* wb;      // [P, T, KW, L]
    const uint32_t* we;
    const uint8_t* commit;   // [T]
    const uint32_t* pivots;  // [P, B, L]
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
    const uint32_t* b = A.wb + ((size_t)p * W + qq) * L;
    const uint32_t* e = A.we + ((size_t)p * W + qq) * L;
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

// ---- kernels --------------------------------------------------------------

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

// the valid rows' records, compacted to the front of each partition's
// region in any order (the sort follows; ties cannot change the result),
// each written by its own thread straight from the code; the empty staging
// slots, unused touched-bucket ids and zero carries
__global__ void stage_records(StageArgs A, uint32_t* __restrict__ rec) {
    const int L = A.L, RW = L + 2, lane = threadIdx.x & 31;
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    // a block never straddles two partitions: N2pad is a multiple of it
    const int p = (int)(((size_t)blockIdx.x * blockDim.x) / A.N2pad);
    const uint32_t* code;
    int ev;
    const int bkt = record_bucket(A, p, (int)(e % A.N2pad), code, ev);
    const bool valid = code != nullptr;
    const unsigned vm = __ballot_sync(0xffffffffu, valid);
    int base = 0;
    if (lane == 0 && vm) base = atomicAdd(A.n_valid + p, __popc(vm));
    base = __shfl_sync(0xffffffffu, base, 0) + __popc(vm & ((1u << lane) - 1u));
    if (valid) {
        uint32_t* dst = rec + ((size_t)p * A.N2pad + base) * RW;
        dst[0] = (uint32_t)bkt;
        for (int i = 0; i < L; ++i) dst[1 + i] = code[i];
        dst[L + 1] = (uint32_t)ev;
    }
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

// one tile of a partition's compacted records, sorted in shared memory by
// an index sort padded to a power of two; then aggregated here (`fused`)
// or written back in order, padded to the tile
__global__ void __launch_bounds__(1024) stage_sort(StageArgs A, int tile, const uint32_t* __restrict__ in,
                                                   uint32_t* __restrict__ out, int fused) {
    extern __shared__ uint32_t rec[];  // [tile, L + 2] records, [tile] buckets, [tile] indices
    const int RW = A.L + 2;
    int* kb = (int*)(rec + (size_t)tile * RW);
    uint16_t* ix = (uint16_t*)(kb + tile);
    const int q0 = blockIdx.x * tile;
    const size_t t0 = (size_t)blockIdx.y * A.N2pad + q0;
    const int n_valid = min(max(A.n_valid[blockIdx.y] - q0, 0), tile);
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

__global__ void stage_merge(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                            int P, int N2pad, int w, int L) {
    const int RW = L + 2;
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (size_t)P * N2pad) return;
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

__global__ void stage_aggregate(StageArgs A, const uint32_t* rec) {
    aggregate(A, rec, (size_t)A.N2pad * (A.L + 2), A.n_valid, nullptr);
}

}  // namespace

extern "C" int fdb_stage(
    const void* wb, const void* we, const void* commit, const void* pivots,
    void* st_code, void* st_ev, void* tid, void* carry, void* max_staged, void* n_valid,
    void* scratch_a, void* scratch_b,
    int P, int T, int KW, int L, int B, int U, int S2, int N2pad, int tile,
    void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    StageArgs A = {
        (const uint32_t*)wb, (const uint32_t*)we, (const uint8_t*)commit,
        (const uint32_t*)pivots, (uint32_t*)st_code, (int*)st_ev, (int*)tid,
        (int*)carry, (int*)max_staged, (int*)n_valid, P, T, KW, L, B, U, S2, 2 * T * KW, N2pad,
    };
    const int RW = L + 2;
    const int tiles = N2pad / tile;
    const int fused = P == 1 && tiles == 1;
    uint32_t* a = (uint32_t*)scratch_a;
    uint32_t* b = (uint32_t*)scratch_b;
    const size_t n = (size_t)P * N2pad;
    const int rec_threads = min(N2pad, 256);
    stage_records<<<(unsigned)(n / rec_threads), rec_threads, 0, st>>>(A, a);
    size_t smem = (size_t)tile * (RW * sizeof(uint32_t) + sizeof(int) + sizeof(uint16_t));
    cudaError_t err = cudaFuncSetAttribute(
        stage_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = 1024;
    stage_sort<<<dim3(tiles, P), threads, smem, st>>>(A, tile, a, b, fused);
    if (fused) return (int)cudaGetLastError();
    for (int w = tile; w < N2pad; w <<= 1) {  // sorted runs b -> a -> b ...
        stage_merge<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(b, a, P, N2pad, w, L);
        uint32_t* t = a;
        a = b;
        b = t;
    }
    stage_aggregate<<<1, threads, 0, st>>>(A, b);
    return (int)cudaGetLastError();
}
