// K3 — per-bucket merge of a batch's committed writes into the grid.
//
// Replaces: the per-bucket half of foundationdb_tpu/conflict/grid.py:402
// merge_writes (:526-633): the [U, S+S2] gather, the multi-key lax.sort by
// code, _log_shift_fill forward fills (:382), the coverage prefix, GC,
// dedupe/coalesce, the stable flag-sort compaction to S rows and the
// scatter back. The flat endpoint sort, run aggregation, staging scatter,
// carry prefix sum and the spanned-bucket floor raise (:430-524, :635-642)
// stay torch glue around it.
//
// What bounds it on the H100: bytes. Each touched bucket reads S old rows
// and S2 staged rows and writes S rows back: at bench shape U = 5120
// buckets × (48 rows in + 32 rows out) × 16 B ≈ 6.5 MB per batch, ~2 µs at
// 3.35 TB/s. The arithmetic per bucket is a 48-row sort and one scan.
//
// Design: one block per touched bucket, one thread per row. The whole
// bucket lives in shared memory. Rows are sorted by a rank sort (each
// thread counts the rows below it, ties broken by index — stable, and tie
// order inside an equal-code run does not change the result because only
// the run's last row is kept and it sees the whole run). Thread 0 then
// runs the fill / coverage / GC / coalesce / compaction as one sequential
// scan of at most S+S2 rows — exact integer semantics of the JAX passes,
// with the packed int32 payload (ver << 1 | 1 for an old row,
// (ev + _EV_OFF) << 1 for a staged event) kept as it was. All threads
// write the compacted rows back; the block folds the floor (floor := 0)
// and max-reduces the kept-row count into the pressure word.
//
// K6 merge (the merge half of foundationdb_tpu/conflict/sharded.py:125
// _local_resolve, merge_writes on each partition's clipped writes) is the
// same launch over the flat [P·B] view of a stacked grid: the staging glue
// ranks each clipped write endpoint against its own partition's pivots
// and offsets its bucket id by p·B, so a block never mixes partitions, and
// the pressure word becomes one per partition (max_kept[b / B_part]). The
// single-grid call is P = 1, B_part = B.
#include "common.cuh"

#define EV_OFF (1 << 20)

namespace {

__global__ void merge_buckets(
    uint32_t* __restrict__ grid, int* __restrict__ count, int* __restrict__ bmax,
    int* __restrict__ floor_, const uint32_t* __restrict__ st_code,
    const int* __restrict__ st_ev, const int* __restrict__ tid,
    const int* __restrict__ carry_in, int now, int oldest,
    int* __restrict__ max_kept, int B, int B_part, int S, int S2, int L) {
    extern __shared__ uint32_t sm[];
    const int M = S + S2;
    const int Lp1 = L + 1;
    uint32_t* in_code = sm;               // [M, L]
    int* in_pk = (int*)(in_code + M * L); // [M]
    uint32_t* g_code = (uint32_t*)(in_pk + M);  // [M, L] sorted
    int* g_pk = (int*)(g_code + M * L);   // [M]
    int* out_idx = g_pk + M;              // [S] sorted row of each kept slot
    int* out_ver = out_idx + S;           // [S]
    int* kept = out_ver + S;              // [1]

    const int u = blockIdx.x;
    const int b = tid[u];
    if (b >= B) return;  // unused staging slot: nothing to write
    const int m = threadIdx.x;
    uint32_t* brow = grid + (size_t)b * S * Lp1;

    if (m < S) {
        bool used = m < count[b];
        const uint32_t* row = brow + (size_t)m * Lp1;
        for (int i = 0; i < L; ++i) in_code[m * L + i] = used ? row[i] : FDB_SENTINEL;
        // fold the bucket floor into the rows now that they are rewritten
        int ver = max((int)row[L], floor_[b]);
        in_pk[m] = used ? ((ver << 1) | 1) : (EV_OFF << 1);
    } else if (m < M) {
        int s = m - S;
        const uint32_t* src = st_code + ((size_t)u * S2 + s) * L;
        for (int i = 0; i < L; ++i) in_code[m * L + i] = src[i];
        in_pk[m] = (st_ev[(size_t)u * S2 + s] + EV_OFF) << 1;
    }
    __syncthreads();

    if (m < M) {
        int pos = 0;
        const uint32_t* mine = in_code + m * L;
        for (int k = 0; k < M; ++k) {
            int c = lex_cmp(in_code + k * L, mine, L);
            if (c < 0 || (c == 0 && k < m)) ++pos;
        }
        for (int i = 0; i < L; ++i) g_code[pos * L + i] = mine[i];
        g_pk[pos] = in_pk[m];
    }
    __syncthreads();

    if (m == 0) {
        int base = 0, cov = carry_in[u], pval = -1, prev_nv = -1, k = 0;
        for (int i = 0; i < M; ++i) {
            int pk = g_pk[i];
            bool old = (pk & 1) != 0;
            if (old) base = pk >> 1;  // forward fill of old-row versions
            else cov += (pk >> 1) - EV_OFF;  // coverage prefix
            int nv = cov > 0 ? max(base, now) : base;
            if (nv < oldest) nv = 0;
            const uint32_t* code = g_code + i * L;
            bool first = i == 0 || lex_cmp(code - L, code, L) != 0;
            if (first) pval = prev_nv;  // previous run's value (-1 first)
            bool last = i == M - 1 || lex_cmp(code, code + L, L) != 0;
            if (last && !is_sentinel(code, L) && nv != pval) {
                if (k < S) {
                    out_idx[k] = i;
                    out_ver[k] = nv;
                }
                ++k;
            }
            prev_nv = nv;
        }
        kept[0] = k;
    }
    __syncthreads();

    const int k = kept[0];
    const int n = min(k, S);
    if (m < S) {
        uint32_t* dst = brow + (size_t)m * Lp1;
        if (m < n) {
            const uint32_t* src = g_code + out_idx[m] * L;
            for (int i = 0; i < L; ++i) dst[i] = src[i];
            dst[L] = (uint32_t)out_ver[m];
        } else {
            for (int i = 0; i < L; ++i) dst[i] = FDB_SENTINEL;
            dst[L] = 0;
        }
    }
    if (m == 0) {
        int bm = 0;
        for (int s = 0; s < n; ++s) bm = max(bm, out_ver[s]);
        count[b] = n;
        bmax[b] = bm;
        floor_[b] = 0;
        atomicMax(max_kept + b / B_part, k);
    }
}

}  // namespace

extern "C" int fdb_merge(
    void* grid, void* count, void* bmax, void* floor_,
    const void* st_code, const void* st_ev, const void* tid, const void* carry_in,
    int now, int oldest, void* max_kept,
    int B, int B_part, int S, int S2, int L, int U, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int M = S + S2;
    int threads = ((M + 31) / 32) * 32;
    size_t smem = (size_t)(2 * M * L + 2 * M + 2 * S + 1) * sizeof(uint32_t);
    merge_buckets<<<U, threads, smem, st>>>(
        (uint32_t*)grid, (int*)count, (int*)bmax, (int*)floor_,
        (const uint32_t*)st_code, (const int*)st_ev, (const int*)tid,
        (const int*)carry_in, now, oldest, (int*)max_kept, B, B_part, S, S2, L);
    return (int)cudaGetLastError();
}
