// K1 — history check of one commit batch against the bucket grid — and K6
// history, the same check over P stacked key-range partitions.
//
// Replaces: foundationdb_tpu/conflict/grid.py:208-292 history_conflicts (with
// _rank_le_lt :187, lex_lt/le and _split_factors :145), a jax.jit program
// run for every batch; for K6 also foundationdb_tpu/conflict/sharded.py:114
// _clip of the reads and the history half of _local_resolve (:125-150, with
// the pmax of H over the mesh).
//
// What bounds it on the H100: dependent round trips to L2, not bytes. The
// batch needs ~3 MB at the bench shape (T = 2500, B = 32768, S = 32, L = 3),
// under 1 µs at 3.35 TB/s. But every read range is a chain: rank both ends
// among the B pivots, then read the two S-slot bucket windows those ranks
// name, then (for a long range) the superblock maxima. A binary search per
// thread made that 2·log2 B + 1 = 31 dependent loads at B = 32768, on 10 of
// the 132 SMs (one thread per transaction).
//
// Design: a warp per transaction, ⌈T/4⌉ blocks of 4 warps (2500 warps, one
// wave). The warp walks its KR read ranges and stops at the first hit; lane
// 0 writes hit[t] once, on both entry points.
// - Rank by a warp search: lanes 0-15 count the pivots <= a, lanes 16-31 the
//   pivots < e, each lane probing one pivot row a step; a ballot and popc
//   narrow both intervals 16-fold. ⌈log16 B⌉ = 4 dependent steps at B = 32768
//   instead of 30. The counts are exact partition points, all-0xFF unused
//   pivots included, as the plain version counts them. (Two 32-ary searches
//   one after the other, 2·⌈log32 B⌉ = 6 steps, were slower on the H100.)
// - Windows: lane s holds slot s (strides of 32 for S > 32), one 16-byte load
//   a lane when L + 1 is a multiple of 4, so each window is one coalesced
//   S·(L+1)·4-byte load, and both windows of a range are in flight together.
//   n_le is a ballot and popc; the value at a a shuffle from lane n_le - 1.
// - Buckets strictly between the two ends: the lanes stride over the two
//   partial edge superblocks (≤ B2 bmax words each) and the whole
//   superblocks' maxima (≤ B1 words), then warp_max with the floors.
// - The superblock maxima need every bmax word, so they stay a pass of their
//   own (superblock_max). history_kernel is launched behind it by Hopper's
//   programmatic dependent launch and waits for it (griddepcontrol) only
//   just before its first read of a superblock maximum, so the searches and
//   windows overlap that pass; most short ranges never wait.
// - K6: lanes 0..P-1 (chunks of 32 for P > 32) intersect the range with
//   their partition [plo, phi); a ballot names the partitions it touches,
//   and the warp checks only those, clipping in registers exactly as _clip
//   does. An empty or inverted range touches none. One launch of ⌈T/4⌉
//   blocks, not T × P threads, and no zeroed H: lane 0 stores every flag.
// - Codes of up to 16 lanes (64-byte keys) live in register arrays sized
//   for the width (4, 8 or 16 lanes); wider codes stay in memory (Code<0>,
//   common.cuh): a compare walks both codes' lanes through the read-only
//   cache, and a clip selects a pointer. Any L, the same search.
// The device code is history.cuh, which the group scan (scan.cu) shares.
#include "history.cuh"

namespace {

// bmax_sup[k] = max(bmax[k*B2 .. k*B2+B2)), one warp per superblock
__global__ void superblock_max(const int* __restrict__ bmax, int* __restrict__ bmax_sup, int n_sup,
                               int B2) {
    // history_kernel may start now: it waits for this grid's end, and its
    // memory, only before it reads a superblock maximum
    cudaTriggerProgrammaticLaunchCompletion();
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n_sup) return;
    superblock_warp<false>(bmax, bmax_sup, warp, lane, B2);
}

// one warp per transaction
template <int LM>
__global__ void __launch_bounds__(WARPS * 32) history_kernel(HistArgs A, uint8_t* __restrict__ hit, int T) {
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (t >= T) return;
    const bool any = history_txn<LM, false>(A, t, lane);
    if (lane == 0) hit[t] = any;
}

}  // namespace

static int launch_history(
    const void* pivots, const void* grid, const void* count, const void* bmax,
    const void* floor_, const void* plo, const void* phi, const void* rb,
    const void* re, const void* t_snap, void* bmax_sup, void* hit,
    int P, int B, int S, int L, int T, int KR, int B1, int B2, void* stream) {
    if (L < 1 || B < 1 || B1 * B2 != B || (B2 & (B2 - 1))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    superblock_max<<<(P * B1 * 32 + threads - 1) / threads, threads, 0, st>>>(
        (const int*)bmax, (int*)bmax_sup, P * B1, B2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || T == 0) return (int)err;

    // launched behind superblock_max without waiting for its end
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((T + WARPS - 1) / WARPS);
    cfg.blockDim = dim3(WARPS * 32);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int lgB2 = __builtin_ctz((unsigned)B2);
    const bool vec = (L + 1) % 4 == 0 && (uintptr_t)grid % 16 == 0;
    const HistArgs A = {
        (const uint32_t*)pivots, (const uint32_t*)grid, (const int*)count, (const int*)bmax,
        (const int*)floor_, (const int*)bmax_sup, (const uint32_t*)rb, (const uint32_t*)re,
        (const int*)t_snap, (const uint32_t*)plo, (const uint32_t*)phi, P, B, S, L, KR, B1, lgB2, vec,
    };
    const auto go = [&](auto kernel) { return cudaLaunchKernelEx(&cfg, kernel, A, (uint8_t*)hit, T); };
    // register arrays sized for the key width: 4 lanes at the bench's 12
    // bytes; above FDB_MAX_LANES the codes are compared in memory
    if (L <= 4) err = go(history_kernel<4>);
    else if (L <= 8) err = go(history_kernel<8>);
    else if (L <= FDB_MAX_LANES) err = go(history_kernel<16>);
    else err = go(history_kernel<0>);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" int fdb_history(
    const void* pivots, const void* grid, const void* count, const void* bmax,
    const void* floor_, const void* rb, const void* re, const void* t_snap,
    void* bmax_sup, void* hit,
    int B, int S, int L, int T, int KR, int B1, int B2, void* stream) {
    return launch_history(pivots, grid, count, bmax, floor_, nullptr, nullptr,
                          rb, re, t_snap, bmax_sup, hit, 1, B, S, L, T, KR,
                          B1, B2, stream);
}

// K6 history: P stacked partitions, reads clipped to [plo[p], phi[p]); every
// hit[t] is written
extern "C" int fdb_history_parts(
    const void* pivots, const void* grid, const void* count, const void* bmax,
    const void* floor_, const void* plo, const void* phi, const void* rb,
    const void* re, const void* t_snap, void* bmax_sup, void* hit,
    int P, int B, int S, int L, int T, int KR, int B1, int B2, void* stream) {
    return launch_history(pivots, grid, count, bmax, floor_, plo, phi, rb, re,
                          t_snap, bmax_sup, hit, P, B, S, L, T, KR, B1, B2,
                          stream);
}
