// K3 — per-bucket merge of a batch's staged writes into the grid, and the
// floor raise of the buckets a committed write spans.
//
// Replaces: the merge half of foundationdb_tpu/conflict/grid.py:402
// merge_writes (:526-642): the [U, S+S2] gather, the multi-key lax.sort by
// code, the _log_shift_fill forward fills (:382), the coverage prefix, GC,
// dedupe/coalesce, the stable flag-sort compaction to S rows, the scatter
// back, and the floor raise of covered untouched buckets (:635-642). The
// staging before it is stage.cu. The device code is merge.cuh, which the
// group scan (scan.cu) shares.
//
// What bounds it on the H100: bytes. Each touched bucket reads its live
// rows and S2 staged rows and writes max(old, new) rows back: ~2.6 MB at
// the bench shape, under a microsecond at 3.35 TB/s. The per-bucket work is
// a 64-element merge and a handful of scans, which one warp does in
// registers.
//
// Design: one warp per touched bucket, eight buckets per CTA. Lane l holds
// element l (old row l; S ≤ 32) and element 32 + l (staged row l; S2 ≤ 32),
// as an index into the warp's shared-memory copy of the rows (16-byte row
// loads and stores at L = 3, a lane loop for other L; above L = 111, where
// eight warps' rows outgrow a block's shared memory, the copy is a plane of
// global scratch per touched bucket). The 64 elements are put in order by
// code — ties broken by index, since tie order inside an equal-code run
// cannot change the result: the live rows and the staged rows are each
// sorted, so each element's place is its index plus its rank in the other
// list (a binary search of 32 codes). The sequential scan of the JAX
// passes becomes warp-wide operations over the two halves (positions 0-31,
// 32-63), the second continuing from the first:
//   - forward fill of old-row versions: ballot + find-last-set + shuffle;
//   - coverage prefix: an inclusive warp scan of the events plus carry_in;
//   - run first / last: a neighbour shuffle of the indices;
//   - coalesce: the previous run's value, filled like the versions;
//   - compaction: ballot + popc gives each kept row its slot.
// The packed int32 payload is the JAX one (ver << 1 | 1 for an old row,
// (ev + EV_OFF) << 1 for a staged event).
//
// The floor raise runs in the same launch, by the warp of each touched
// bucket: where its carry (the event prefix at it) is positive, a write
// spans the untouched buckets back to the touched bucket before it in its
// partition, and their floors (and bmax) rise to `now`. Each partition's
// events sum to 0, so the buckets after its last touched bucket are never
// spanned. Touched and untouched buckets are disjoint, so the two parts of
// the launch write disjoint words. The launch is as large as the touched
// buckets, not the grid: a keyspace-wide clear is one warp's walk over
// the buckets it spans.
//
// K6 merge (foundationdb_tpu/conflict/sharded.py:125 _local_resolve) is the
// same launch over the flat [P·B] view of a stacked grid: bucket ids are
// offset by p·B, so a warp never mixes partitions, gaps stop at a
// partition's end, and the pressure word is one per partition
// (max_kept[b / B_part]). The single grid is P = 1, B_part = B.
#include "merge.cuh"

namespace {

constexpr int kWarps = 8;  // touched buckets per CTA

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
    if (u >= U) return;  // warp-uniform; tid[u] = B marks an unused staging slot
    const int b = tid[u];
    if (b >= B) return;
    merge_bucket(grid, count, bmax, floor_, st_code, st_ev, carry_in, now, oldest, max_kept, B_part, S, S2, L,
                 u, b, SCRATCH ? rows + (size_t)u * 64 * (L + 2) : sm + warp * 64 * (L + 2), lane);
    raise_spanned(bmax, floor_, tid, carry_in, now, B_part, u, b, lane);
}

}  // namespace

// rows: nullptr, or [U, 64, L + 2] scratch where a CTA's rows outgrow
// shared memory (L > 111)
extern "C" int fdb_merge(
    void* grid, void* count, void* bmax, void* floor_,
    const void* st_code, const void* st_ev, const void* tid, const void* carry_in,
    int now, int oldest, void* max_kept, void* rows,
    int B, int B_part, int S, int S2, int L, int U, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    size_t smem = rows ? 0 : (size_t)kWarps * 64 * (L + 2) * sizeof(uint32_t);
    auto kernel = rows ? merge_buckets<true> : merge_buckets<false>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(U + kWarps - 1) / kWarps, kWarps * 32, smem, st>>>(
        (uint32_t*)grid, (int*)count, (int*)bmax, (int*)floor_,
        (const uint32_t*)st_code, (const int*)st_ev, (const int*)tid,
        (const int*)carry_in, now, oldest, (int*)max_kept, (uint32_t*)rows, B, B_part, S, S2, L, U);
    return (int)cudaGetLastError();
}
