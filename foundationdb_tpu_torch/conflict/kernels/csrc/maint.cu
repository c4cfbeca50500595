// K4a / K4b — grid maintenance: on-device reshard and version rebase.
//
// Replaces: foundationdb_tpu/conflict/grid.py:718 reshard_device (floor
// fold, prefix-sum compaction scatter of the live rows, block partition
// into q = ceil(live / n_buckets) rows, pivots from block starts, count and
// bmax recompute) and grid.py:704 rebase (subtract delta from the used
// rows' versions and the floors, clamp at 0, recompute bmax).
//
// What bounds it on the H100: bytes. Both touch the whole grid: at bench
// shape B·S = 1,048,576 rows × 16 B = 16 MiB in and 16 MiB out (reshard
// also writes and reads back a compacted copy of the live rows), ~10 µs
// at 3.35 TB/s. Neither is on the per-batch path; they run on a reshard
// or when the version origin moves by 2^30.
//
// Design: the compaction destinations come from a torch.cumsum prefix sum
// in the wrapper (exactly the JAX form), so the scatter is one thread per
// row writing its live row to dest[r] — stable and never out of range,
// because only used rows write. The bucket build is one warp per new
// bucket, a lane per slot: the warp reads its q contiguous live rows,
// recomputes count with a ballot and bmax with a shuffle max. Rebase is
// one warp per bucket, a lane per slot, writing a fresh grid (the old one
// may still be the backend's snapshot).
//
// K7 replaces the vmaps over partitions in
// foundationdb_tpu/conflict/mesh_backend.py:477 (_grow, vmap of
// reshard_device) and :499 (_maybe_rebase, vmap of rebase), and
// sharded.py:291 reshard_partition. Reshard gains a partition axis: the
// wrapper's prefix sum restarts at each partition (dest is [P, N]), the
// compaction writes partition p's live rows into its own [N] slice of the
// scratch, and one warp builds bucket b of partition p from that slice,
// with one pressure word per partition. Rebase is independent per bucket,
// so a stack of P grids is rebased as one flat grid of P·B buckets.
#include "common.cuh"

namespace {

// rows r of all P partitions (N rows each); dest[r] is partition-local
__global__ void compact_live(
    const uint32_t* __restrict__ grid, const int* __restrict__ floor_,
    const uint8_t* __restrict__ used, const int* __restrict__ dest,
    uint32_t* __restrict__ lrows, long long PN, int N, int S, int L) {
    long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= PN || !used[r]) return;
    const int Lp1 = L + 1;
    const uint32_t* src = grid + (size_t)r * Lp1;
    uint32_t* dst = lrows + ((size_t)(r / N) * N + dest[r]) * Lp1;
    for (int i = 0; i < L; ++i) dst[i] = src[i];
    dst[L] = (uint32_t)max((int)src[L], floor_[r / S]);  // fold the floor
}

__global__ void build_buckets(
    const uint32_t* __restrict__ lrows, const int* __restrict__ dest,
    uint32_t* __restrict__ pivots, uint32_t* __restrict__ out,
    int* __restrict__ count, int* __restrict__ bmax, int* __restrict__ floor_,
    int* __restrict__ pressure, int P, int N, int L, int nb, int ns) {
    long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (w >= (long long)P * nb) return;
    const int p = (int)(w / nb), b = (int)(w % nb);
    const int Lp1 = L + 1;
    // partition p's slices; the outputs are [P, nb, ...]
    lrows += (size_t)p * N * Lp1;
    pivots += (size_t)p * nb * L;
    out += (size_t)p * nb * ns * Lp1;
    count += (size_t)p * nb;
    bmax += (size_t)p * nb;
    floor_ += (size_t)p * nb;
    pressure += p;
    // dest = cumsum(used) - 1 within the partition
    const long long n_live = (long long)dest[(size_t)p * N + N - 1] + 1;
    const long long q = max((n_live + nb - 1) / nb, 1LL);
    const long long start = (long long)b * q;
    if (lane == 0) {
        for (int i = 0; i < L; ++i) {
            pivots[(size_t)b * L + i] = start < n_live ? lrows[start * Lp1 + i] : FDB_SENTINEL;
        }
        floor_[b] = 0;  // floors are folded into the rows
        if (b == 0) *pressure = n_live > 0 ? (int)min(q, n_live) : 0;
    }
    int cnt = 0, bm = 0;
    for (int s = lane; s < ns; s += 32) {
        long long j = start + s;
        bool have = s < q && j < n_live;
        uint32_t* dst = out + ((size_t)b * ns + s) * Lp1;
        const uint32_t* src = lrows + (have ? j : 0) * Lp1;
        bool row = have && !is_sentinel(src, L);
        for (int i = 0; i < L; ++i) dst[i] = have ? src[i] : FDB_SENTINEL;
        int ver = row ? (int)src[L] : 0;
        dst[L] = (uint32_t)ver;
        cnt += row ? 1 : 0;
        bm = max(bm, ver);
    }
    cnt = warp_sum(cnt);
    bm = warp_max(bm);
    if (lane == 0) {
        count[b] = cnt;
        bmax[b] = bm;
    }
}

__global__ void rebase_kernel(
    const uint32_t* __restrict__ grid, const int* __restrict__ count,
    const int* __restrict__ floor_, uint32_t* __restrict__ out,
    int* __restrict__ bmax_out, int* __restrict__ floor_out,
    int delta, int B, int S, int L) {
    int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (b >= B) return;
    const int Lp1 = L + 1;
    const int cnt = count[b];
    int m = 0;
    for (int s = lane; s < S; s += 32) {
        const uint32_t* src = grid + ((size_t)b * S + s) * Lp1;
        uint32_t* dst = out + ((size_t)b * S + s) * Lp1;
        for (int i = 0; i < L; ++i) dst[i] = src[i];
        int ver = s < cnt ? max((int)src[L] - delta, 0) : 0;
        dst[L] = (uint32_t)ver;
        m = max(m, ver);
    }
    m = warp_max(m);
    if (lane == 0) {
        int fl = max(floor_[b] - delta, 0);
        floor_out[b] = fl;
        bmax_out[b] = max(m, fl);
    }
}

}  // namespace

// P stacked grids of N = B·S rows each (P = 1: a single grid)
extern "C" int fdb_reshard(
    const void* grid, const void* floor_, const void* used, const void* dest,
    void* lrows, void* pivots, void* out, void* count, void* bmax,
    void* floor_out, void* pressure, int P, int N, int S, int L, int nb,
    int ns, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    long long PN = (long long)P * N;
    compact_live<<<(unsigned)((PN + threads - 1) / threads), threads, 0, st>>>(
        (const uint32_t*)grid, (const int*)floor_, (const uint8_t*)used,
        (const int*)dest, (uint32_t*)lrows, PN, N, S, L);
    long long warps = (long long)P * nb * 32;
    build_buckets<<<(unsigned)((warps + threads - 1) / threads), threads, 0, st>>>(
        (const uint32_t*)lrows, (const int*)dest, (uint32_t*)pivots,
        (uint32_t*)out, (int*)count, (int*)bmax, (int*)floor_out,
        (int*)pressure, P, N, L, nb, ns);
    return (int)cudaGetLastError();
}

extern "C" int fdb_rebase(
    const void* grid, const void* count, const void* floor_, void* out,
    void* bmax_out, void* floor_out, int delta, int B, int S, int L,
    void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    long long warps = (long long)B * 32;
    rebase_kernel<<<(unsigned)((warps + threads - 1) / threads), threads, 0, st>>>(
        (const uint32_t*)grid, (const int*)count, (const int*)floor_,
        (uint32_t*)out, (int*)bmax_out, (int*)floor_out, delta, B, S, L);
    return (int)cudaGetLastError();
}
