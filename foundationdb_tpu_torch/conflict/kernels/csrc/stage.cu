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
// The device code is stage.cuh, which the group scan (scan.cu) shares; the
// scan also clips each write to its partition there (StageArgs.plo).
#include "stage.cuh"

namespace {

// the valid rows' records, compacted to the front of each partition's
// region; the empty staging slots, unused touched-bucket ids and zero
// carries (one thread a row, every SM)
__global__ void stage_records(StageArgs A, uint32_t* __restrict__ rec) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    stage_record_at(A, rec, e, threadIdx.x & 31);
    stage_clear_at(A, e, (size_t)gridDim.x * blockDim.x);
}

// one CTA per tile of a partition's compacted records
__global__ void __launch_bounds__(1024) stage_sort(StageArgs A, int tile, const uint32_t* __restrict__ in,
                                                   uint32_t* __restrict__ out, int fused) {
    extern __shared__ uint32_t rec[];
    sort_tile(A, tile, in, out, fused, blockIdx.x, blockIdx.y, rec);
}

__global__ void stage_merge(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                            int P, int N2pad, int w, int L) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (size_t)P * N2pad) return;
    merge_pass_at(src, dst, N2pad, w, L, e);
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
        (const uint32_t*)pivots, nullptr, nullptr, (uint32_t*)st_code, (int*)st_ev, (int*)tid,
        (int*)carry, (int*)max_staged, (int*)n_valid, P, T, KW, L, B, U, S2, 2 * T * KW, N2pad,
    };
    const int RW = L + 2;
    const int tiles = N2pad / tile;
    const int fused = P == 1 && tiles == 1;
    uint32_t* a = (uint32_t*)scratch_a;
    uint32_t* b = (uint32_t*)scratch_b;
    const size_t n = (size_t)P * N2pad;
    stage_records<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(A, a);
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
