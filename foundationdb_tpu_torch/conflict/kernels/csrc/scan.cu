// The group scan — a group of G commit batches resolved in ONE cooperative
// launch, the grid state kept on the card from batch to batch.
//
// Replaces: foundationdb_tpu/conflict/grid.py:681 resolve_many, a jax.jit
// program whose lax.scan runs _resolve_one (:655: too_old → history_conflicts
// → intra_batch_commits → merge_writes → verdicts) over a stacked group with
// the state donated; and foundationdb_tpu/conflict/sharded.py:220
// build_sharded_resolver_many, the same scan of _local_resolve (:125) over P
// key-range partitions with per-batch pressures [G, P, 2]. Before this
// kernel the port ran both as host loops of eight launches a batch (K1 or
// K6 history, K2's two passes, K3 staging's two to four, K3 merge), each
// with its torch.empty outputs and the torch ops of the verdicts (and, over
// partitions, of the write clip) between them.
//
// What bounds it on the H100: the chain of dependent phases. Each batch
// needs the state its predecessor merged, and each phase of a batch needs
// all of the one before it: the superblock maxima, the history check, K2's
// bitset, K2's chain (one CTA), the staging records, the tile sort (one CTA
// for the bench's 8192 rows), the merge passes above one tile, the
// aggregation (one CTA), the merge. The bytes are the phases' own (about
// 3 MB a batch at the bench shape, under 1 µs at 3.35 TB/s); what a batch
// costs is the phases' serial parts and one grid-wide barrier between each
// two (7 a batch at the bench shape).
//
// Design. One CTA of 1024 threads a resident slot (the chain and the tile
// sort are written for 1024; at that size a thread has at most 64
// registers, and the occupancy query gives one CTA an SM), the grid as
// large as is co-resident, launched by cudaLaunchCooperativeKernel.
// The CTAs walk the phases of batch g = 0 .. G - 1 in order, with
// cooperative_groups' grid.sync() between phases. Every phase is the body
// of the standalone kernel (history.cuh, intra_batch.cuh, stage.cuh,
// merge.cuh): a warp's work (a transaction's history, a touched bucket's
// merge) goes to the grid's warps in turn, a CTA's (an overlap tile, a
// sort tile) to its CTAs in turn, and a one-CTA pass (the chain, the
// aggregation) to CTA 0 while the others wait at the next barrier. One
// dynamic shared buffer serves every phase: the largest phase's need, up
// to the tile sort's 230,400 bytes. What an earlier phase of the launch
// wrote is read as coherent loads after the barrier (no non-coherent
// read-only loads of it: history reads the state through L2, ld_in<true>).
// Over partitions the history check clips each read and the staging clips
// each write to [plo[p], phi[p]) in registers, so nothing of the batch is
// clipped or copied on the host side. The verdicts (COMMITTED 0, CONFLICT 1,
// TOO_OLD 2) are written beside the staging records; the per-batch
// pressures [G, P, 2] and the group's maxima [P, 2] after the last batch.
// Scratch (K2's bitset, the staging planes and records, H and commit, the
// superblock maxima, the counters) is allocated once a group by the
// wrapper, sized by kernels.scan_plan.
#include <cooperative_groups.h>

#include "history.cuh"
#include "intra_batch.cuh"
#include "merge.cuh"
#include "stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kScanThreads = 1024;  // threads of a CTA (the chain's and the tile sort's)
constexpr int kScanWarps = kScanThreads / 32;

struct ScanArgs {
    // the state, updated in place: [P, B, ...] (one grid: P = 1)
    const uint32_t* pivots;  // [P, B, L]
    uint32_t* grid;          // [P, B, S, L + 1]
    int* count;              // [P, B]
    int* bmax;
    int* floor_;
    const uint32_t* plo;  // [P, L]; nullptr: one grid, nothing clipped
    const uint32_t* phi;
    // the group
    const uint32_t* rb;  // [G, T, KR, L]
    const uint32_t* re;
    const uint32_t* wb;  // [G, T, KW, L]
    const uint32_t* we;
    const int* t_snap;           // [G, T]
    const uint8_t* t_has_reads;  // [G, T]
    const int* vers;             // [3, G]: now, oldest before, oldest after each batch
    // outputs
    int8_t* verdicts;  // [G, T]
    int* pressures;    // [G, P, 2]: most staged rows, most kept rows in a bucket
    int* gmax;         // [P, 2]: their maxima over the group
    // scratch
    int* bmax_sup;   // [P, B1]
    uint8_t* H;      // [T]
    uint8_t* commit;  // [T]
    uint32_t* pt;    // [W, 32 W]
    uint32_t* st_code;  // [U, S2, L]
    int* st_ev;         // [U, S2]
    int* tid;           // [U]
    int* carry;         // [U]
    uint32_t* rec_a;    // [P, N2pad, L + 2]
    uint32_t* rec_b;    // the same, or nullptr where one tile holds every row
    uint32_t* rows;     // merge rows in global memory, [warps of the grid, 64, L + 1]; nullptr: shared
    int* counters;      // [3, G, P]: most staged rows, most kept rows, valid rows, per batch and partition
    int G, P, B, S, L, T, KR, KW, B1, B2, lgB2, vec;
    int WT, CR, CW;  // K2's overlap tiling
    int S2, U, N2pad, tile;
};

template <int LM>
__global__ void __launch_bounds__(kScanThreads, 1) resolve_many_kernel(ScanArgs A) {
    extern __shared__ __align__(16) uint32_t smem[];
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x & 31;
    const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t nthreads = (size_t)gridDim.x * blockDim.x;
    const int gwarp = (int)(gtid >> 5), nwarps = (int)(nthreads >> 5);
    const int G = A.G, P = A.P, T = A.T, L = A.L;
    const int PB = P * A.B;  // buckets of the flat view
    const int W = (T + 31) / 32, Tp = 32 * W;
    int* const max_staged = A.counters;
    int* const max_kept = A.counters + (size_t)G * P;
    int* const n_valid = A.counters + (size_t)2 * G * P;
    const size_t n_rows = (size_t)P * A.N2pad;  // staging rows of a batch, padded
    const int tiles = A.N2pad / A.tile;
    const int fused = P == 1 && tiles == 1;  // one CTA sorts and aggregates
    const size_t row_words = (size_t)64 * (L + 1);
    uint32_t* merge_rows = A.rows ? A.rows + (size_t)gwarp * row_words
                                  : smem + (size_t)(threadIdx.x >> 5) * row_words;

    for (size_t x = gtid; x < (size_t)3 * G * P; x += nthreads) A.counters[x] = 0;
    grid.sync();

    for (int g = 0; g < G; ++g) {
        const int now = A.vers[g], old_pre = A.vers[G + g], old_post = A.vers[2 * G + g];
        const uint32_t* rb = A.rb + (size_t)g * T * A.KR * L;
        const uint32_t* re = A.re + (size_t)g * T * A.KR * L;
        const uint32_t* wb = A.wb + (size_t)g * T * A.KW * L;
        const uint32_t* we = A.we + (size_t)g * T * A.KW * L;
        const int* t_snap = A.t_snap + (size_t)g * T;
        const uint8_t* has_reads = A.t_has_reads + (size_t)g * T;

        // 1. K1 / K6 history: the superblock maxima, then a warp a
        // transaction; H = a history conflict or too old
        for (int w = gwarp; w < P * A.B1; w += nwarps) superblock_warp<true>(A.bmax, A.bmax_sup, w, lane, A.B2);
        grid.sync();
        const HistArgs HA = {A.pivots, A.grid, A.count, A.bmax, A.floor_, A.bmax_sup, rb, re, t_snap,
                             A.plo, A.phi, P, A.B, A.S, L, A.KR, A.B1, A.lgB2, A.vec != 0};
        for (int t = gwarp; t < T; t += nwarps) {
            const bool hit = history_txn<LM, true>(HA, t, lane);
            if (lane == 0) A.H[t] = hit || (has_reads[t] && t_snap[t] < old_pre);
        }
        grid.sync();

        // 2. K2's overlap bitset, a tile a CTA in turn (on the unclipped
        // ranges, as the loop's K2 runs)
        const int nbx = (W + A.WT - 1) / A.WT;
        for (int v = blockIdx.x; v < nbx * W; v += gridDim.x) {
            const int bx = v % nbx, jb = v / nbx;
            if (bx * A.WT > jb) continue;  // every word above the diagonal (block-uniform)
            if (A.CR == A.KR && A.CW == A.KW) {
                if (L == 3) overlap_tile<3>(rb, re, wb, we, A.pt, T, A.KR, A.KW, L, Tp, A.WT, bx, jb, smem);
                else overlap_tile<0>(rb, re, wb, we, A.pt, T, A.KR, A.KW, L, Tp, A.WT, bx, jb, smem);
            } else if (A.CR == 0) {
                overlap_tile_chunks<0, false>(rb, re, wb, we, A.pt, T, A.KR, A.KW, L, Tp, A.WT, A.CR, A.CW,
                                              bx, jb, smem);
            } else if (L == 3) {
                overlap_tile_chunks<3, true>(rb, re, wb, we, A.pt, T, A.KR, A.KW, L, Tp, A.WT, A.CR, A.CW,
                                             bx, jb, smem);
            } else {
                overlap_tile_chunks<0, true>(rb, re, wb, we, A.pt, T, A.KR, A.KW, L, Tp, A.WT, A.CR, A.CW,
                                             bx, jb, smem);
            }
            __syncthreads();  // the next tile restages the shared memory
        }
        grid.sync();

        // 3. K2's greedy chain on CTA 0
        if (blockIdx.x == 0) greedy_chain_block<true>(A.pt, A.H, A.commit, T, W, Tp, smem);
        grid.sync();

        // 4. the verdicts; K3 staging's records (each write clipped to its
        // partition where P > 1) and its cleared planes
        const StageArgs SA = {wb, we, A.commit, A.pivots, A.plo, A.phi, A.st_code, A.st_ev, A.tid, A.carry,
                              max_staged + (size_t)g * P, n_valid + (size_t)g * P,
                              P, T, A.KW, L, A.B, A.U, A.S2, 2 * T * A.KW, A.N2pad};
        for (size_t t = gtid; t < (size_t)T; t += nthreads) {
            const bool too_old = has_reads[t] && t_snap[t] < old_pre;
            A.verdicts[(size_t)g * T + t] = (int8_t)(too_old ? 2 : A.commit[t] ? 0 : 1);
        }
        for (size_t e0 = gtid - lane; e0 < n_rows; e0 += nthreads) stage_record_at(SA, A.rec_a, e0 + lane, lane);
        stage_clear_at(SA, gtid, nthreads);
        grid.sync();

        // 5. the sort tiles, a tile a CTA in turn (one CTA also aggregates
        // where one tile holds one grid's rows); then the merge passes and
        // the aggregation on CTA 0
        for (int v = blockIdx.x; v < tiles * P; v += gridDim.x) {
            sort_tile(SA, A.tile, A.rec_a, A.rec_b, fused, v % tiles, v / tiles, smem);
            __syncthreads();  // the next tile reloads the shared memory
        }
        grid.sync();
        if (!fused) {
            uint32_t* a = A.rec_a;
            uint32_t* b = A.rec_b;
            for (int w = A.tile; w < A.N2pad; w <<= 1) {  // sorted runs b -> a -> b ...
                for (size_t e = gtid; e < n_rows; e += nthreads) merge_pass_at(b, a, A.N2pad, w, L, e);
                grid.sync();
                uint32_t* t = a;
                a = b;
                b = t;
            }
            if (blockIdx.x == 0) aggregate(SA, b, (size_t)A.N2pad * (L + 2), SA.n_valid, nullptr);
            grid.sync();
        }

        // 6. K3 merge, a touched bucket a warp in turn, and the floor raise
        for (int u = gwarp; u < A.U; u += nwarps) {
            const int b = A.tid[u];  // warp-uniform; PB marks an unused staging slot
            if (b < PB)
                merge_bucket(A.grid, A.count, A.bmax, A.floor_, A.st_code, A.st_ev, A.carry, now, old_post,
                             max_kept + (size_t)g * P, A.B, A.S, A.S2, L, u, b, merge_rows, lane);
            __syncwarp();  // the warp's rows are rewritten by its next bucket
        }
        for (size_t x = gtid; x < (size_t)PB; x += nthreads)
            raise_spanned(A.bmax, A.floor_, A.tid, A.carry, now, PB, A.B, A.U, (int)x);
        grid.sync();
    }

    // the per-batch pressures, and their maxima over the group
    for (size_t x = gtid; x < (size_t)G * P; x += nthreads) {
        A.pressures[2 * x] = max_staged[x];
        A.pressures[2 * x + 1] = max_kept[x];
    }
    for (size_t p = gtid; p < (size_t)P; p += nthreads) {
        int ms = 0, mk = 0;
        for (int g = 0; g < G; ++g) {
            ms = max(ms, max_staged[(size_t)g * P + p]);
            mk = max(mk, max_kept[(size_t)g * P + p]);
        }
        A.gmax[2 * p] = ms;
        A.gmax[2 * p + 1] = mk;
    }
}

using ScanKernel = void (*)(ScanArgs);

// register arrays sized for the key width, as K1's: 4 lanes at the bench's
// 12 bytes; above FDB_MAX_LANES the codes are compared in memory
ScanKernel scan_kernel(int L) {
    if (L <= 4) return resolve_many_kernel<4>;
    if (L <= 8) return resolve_many_kernel<8>;
    if (L <= FDB_MAX_LANES) return resolve_many_kernel<16>;
    return resolve_many_kernel<0>;
}

// CTAs of the L-lane kernel co-resident on one SM with ``smem`` bytes of
// dynamic shared memory, and the SMs of the current device
int occupancy(int L, int smem, int* per_sm, int* sms) {
    const ScanKernel kernel = scan_kernel(L);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kScanThreads, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// out: int[2] on the host — CTAs of the scan co-resident on an SM at
// ``smem`` bytes of dynamic shared memory, and the device's SMs
extern "C" int fdb_scan_occupancy(int L, int smem, void* out) {
    int* o = (int*)out;
    return occupancy(L, smem, &o[0], &o[1]);
}

// one group through the scan on ``blocks`` CTAs, which must all be
// co-resident: the cooperative launch itself refuses a larger grid
// (cudaErrorCooperativeLaunchTooLarge); plo/phi nullptr for one grid.
// Scratch as ScanArgs lists it (kernels.scan_plan)
extern "C" int fdb_resolve_many(
    const void* pivots, void* grid, void* count, void* bmax, void* floor_,
    const void* plo, const void* phi, const void* rb, const void* re, const void* wb, const void* we,
    const void* t_snap, const void* t_has_reads, const void* vers,
    void* verdicts, void* pressures, void* gmax,
    void* bmax_sup, void* H, void* commit, void* pt, void* st_code, void* st_ev, void* tid, void* carry,
    void* rec_a, void* rec_b, void* rows, void* counters,
    int G, int P, int B, int S, int L, int T, int KR, int KW, int B1, int B2,
    int WT, int CR, int CW, int S2, int U, int N2pad, int tile, int smem, int blocks,
    void* stream) {
    const int W = (T + 31) / 32;
    if (G < 1 || P < 1 || L < 1 || T < 1 || B < 1 || B1 * B2 != B || (B2 & (B2 - 1)) || S > 32 || S2 > 32
        || W > kMaxWords || WT < 1 || WT > kScanWarps || CR < 0 || CR > KR || CW < 0 || CW > KW
        || (CR > 0) != (CW > 0) || tile < 1 || N2pad % tile || (rec_b == nullptr && (P > 1 || tile < N2pad))
        || (P > 1 && plo == nullptr) || blocks < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const ScanKernel kernel = scan_kernel(L);
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ScanArgs A = {
        (const uint32_t*)pivots, (uint32_t*)grid, (int*)count, (int*)bmax, (int*)floor_,
        (const uint32_t*)plo, (const uint32_t*)phi,
        (const uint32_t*)rb, (const uint32_t*)re, (const uint32_t*)wb, (const uint32_t*)we,
        (const int*)t_snap, (const uint8_t*)t_has_reads, (const int*)vers,
        (int8_t*)verdicts, (int*)pressures, (int*)gmax,
        (int*)bmax_sup, (uint8_t*)H, (uint8_t*)commit, (uint32_t*)pt, (uint32_t*)st_code, (int*)st_ev,
        (int*)tid, (int*)carry, (uint32_t*)rec_a, (uint32_t*)rec_b, (uint32_t*)rows, (int*)counters,
        G, P, B, S, L, T, KR, KW, B1, B2, __builtin_ctz((unsigned)B2),
        (L + 1) % 4 == 0 && (uintptr_t)grid % 16 == 0,
        WT, CR, CW, S2, U, N2pad, tile,
    };
    void* args[] = {&A};
    err = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kScanThreads), args,
                                           (size_t)smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return err;
    return (int)cudaGetLastError();
}
