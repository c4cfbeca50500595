// The group scan — a group of G commit batches resolved in ONE cooperative
// launch a card, the grid state kept on the card from batch to batch.
//
// Replaces: foundationdb_tpu/conflict/grid.py:681 resolve_many, a jax.jit
// program whose lax.scan runs _resolve_one (:655: too_old → history_conflicts
// → intra_batch_commits → merge_writes → verdicts) over a stacked group with
// the state donated; and foundationdb_tpu/conflict/sharded.py:220
// build_sharded_resolver_many, the same scan of _local_resolve (:125) over a
// ("part", "data") mesh of devices with per-batch pressures [G, P, 2] and
// two pmax collectives a batch (:131-132: H at :149, the overlap matrix at
// :151-157). Before this kernel the port ran both as host loops of eight
// launches a batch (K1 or K6 history, K2's two passes, K3 staging's two to
// four, K3 merge), each with its torch.empty outputs and the torch ops of
// the verdicts (and, over partitions, of the write clip) between them; a
// spread of several entries also exchanged H with cross-device copies.
//
// Entries. A launch resolves the group for every ENTRY of a spread that sits
// on its card (kernels.spread_plan; one entry on one grid or one stack):
// each entry is a stack of P partitions with its own state, partition
// bounds and read slots (a data replica checks its slice of them), given in
// an entry table in the launch's __grid_constant__ arguments, its scratch
// pieces at a fixed stride. History and merge run for each entry; the
// entries' history verdicts OR into one H of the card (the reference's pmax
// over the card's devices, before a grid barrier, with no copies); K2 and
// the verdicts run once a card on the whole batch with that H (as the
// port computes combine_pji's pmax: every entry the same H, so one commit
// mask); every entry stages and merges the committed writes, each clipped
// to its partitions in registers, so data replicas stay equal with no copy.
// Across cards, each card's launch publishes its H (T bits) into a slot of
// an exchange buffer in mapped, pinned host memory (one slot a batch a card
// a launch parity), bumps the slot's flag to the launch's epoch with a
// system-scope release, and CTA 0 waits for every other card's flag with
// system-scope acquires and ORs their words into H; a grid barrier releases
// the rest. The wait is bounded (%globaltimer against the wrapper's bound):
// a card that never publishes sets the launch's status word, every CTA
// leaves, and the wrapper's caller raises a kernel fault. A launch only
// needs the other cards' launches in flight together, never co-resident.
//
// What bounds it on the H100: the chain of dependent phases. Each batch
// needs the state its predecessor merged, and each phase of a batch needs
// all of the one before it. The bytes are the phases' own (about 3 MB a
// batch at the bench shape, under 1 µs at 3.35 TB/s); what a batch costs
// is each phase's longest serial path — one warp's or one CTA's work — and
// one grid-wide barrier between each two phases. The per-phase timer
// (``phase_ns``: thread 0 of CTA 0 reads %globaltimer after each barrier)
// names the phases' share.
//
// Design. Every phase hands the grid's warps or CTAs work items small
// enough that the longest one is short, so no phase leaves the card to one
// SM unless its work is one CTA's by nature (the chain):
//  1. the superblock maxima of every entry (a warp a superblock), and H
//     seeded with the too-old test (a thread a transaction);
//  2. the history check and K2's overlap bitset, in one phase: a warp a
//     (entry, transaction, read slot) — a hit sets H — and a warp a (group
//     of R readers, writer word w, slice of the write slots): lane b tests
//     writer 32w + b against the group's readers, staged in the warp's
//     shared memory, and one ballot a reader forms the word, so a batch of
//     64 transactions spreads over the card (R and the write-slot slices
//     NS from kernels.scan_plan; with NS > 1 the words are ORed into the
//     bitset phase 1 zeroed);
//  (the exchange of H across cards, where the spread spans more than one;)
//  3. K2's greedy chain on CTA 0 (the chain's steps are serial by nature);
//  4. the verdicts, K3 staging's records of every entry (each write clipped
//     to its partition where P > 1) and its cleared planes;
//  5. the records sorted in tiles of at most kernels.SCAN_TILE_ROWS, a tile
//     a CTA in turn, only the tiles that hold valid records; where one
//     tile holds one grid's batch, its CTA also aggregates (phases 6 and 7
//     take no time);
//  6. merge passes over the grid, over the valid records only, until one
//     run holds every partition's (none where one tile does);
//  7. the aggregation over the sorted records in chunks of a CTA's
//     threads: each CTA its chunks' scan totals, then each its chunks'
//     scan from the totals before them, so no CTA walks the batch alone;
//  8. K3 merge, a touched bucket a warp in turn (its rows and staged rows
//     put in order by their ranks), and the floor raise of the untouched
//     buckets a committed write spans, walked from the touched bucket
//     after them (not a pass over every bucket).
// Each phase's device code is the standalone kernels' own (history.cuh,
// intra_batch.cuh, stage.cuh, merge.cuh); the scan adds the history check a
// warp a read slot (history_read), the split of the work over its
// resident grid, the exchange and the barriers.
// One CTA of kScanThreads threads a resident slot, the grid as large as is
// co-resident, launched by cudaLaunchCooperativeKernel; a CTA of 512
// threads leaves a thread 128 registers (at 1024 a thread has 64, and
// every phase spilled), and no phase needs more threads. One dynamic
// shared buffer serves every phase: the largest phase's need. What an
// earlier phase of the launch wrote is read as coherent loads after the
// barrier (no non-coherent read-only loads of it: history reads the state
// through L2, ld_in<true>); the group's inputs, which nothing writes, go
// through the read-only cache. Over partitions the history check clips
// each read and the staging clips each write to [plo[p], phi[p]) in
// registers, so nothing of the batch is clipped or copied on the host
// side. The verdicts (COMMITTED 0, CONFLICT 1, TOO_OLD 2) are written beside
// the staging records; the per-batch pressures [E, G, P, 2] and the group's
// maxima [E, P, 2] after the last batch. Scratch (K2's bitset, H and
// commit; for each entry the staging planes and records, the aggregation's
// chunk totals, the superblock maxima and the counters) is allocated once a
// group by the wrapper, sized by kernels.scan_plan.
#include <cooperative_groups.h>

#include <cstring>

#include "history.cuh"
#include "intra_batch.cuh"
#include "merge.cuh"
#include "stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kScanThreads = 512;  // threads of a CTA: 128 registers a thread at one CTA an SM
constexpr int kScanPhases = 8;  // the phases a batch's stamps delimit (kernels.SCAN_PHASES)
constexpr int kMaxEntries = 32;  // entries of a spread on one card (kernels.MAX_CARD_ENTRIES)

// the card's nanosecond clock, which every SM reads alike
__device__ __forceinline__ long long globaltimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// system-scope accesses to the exchange buffer (mapped host memory, which
// other cards write): the flag's release and acquire, the words relaxed
__device__ __forceinline__ void st_release_sys(int* p, int v) {
    asm volatile("st.release.sys.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire_sys(const int* p) {
    int v;
    asm volatile("ld.acquire.sys.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ void st_relaxed_sys(uint32_t* p, uint32_t v) {
    asm volatile("st.relaxed.sys.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_relaxed_sys(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.relaxed.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// one entry of the card: its stacked state, partition bounds and read slots
struct ScanEntry {
    const uint32_t* pivots;  // [P, B, L]
    uint32_t* grid;          // [P, B, S, L + 1], updated in place
    int* count;              // [P, B]
    int* bmax;
    int* floor_;
    const uint32_t* plo;  // [P, L]; nullptr: one grid, nothing clipped
    const uint32_t* phi;
    const uint32_t* rb;  // [G, T, KRe, L]: the read slots this entry checks
    const uint32_t* re;
};

struct ScanArgs {
    ScanEntry ent[kMaxEntries];
    int E;       // entries on this card
    size_t ew;   // int32 words of one entry's scratch pieces (entry e's at + e·ew)
    // the group, shared by the card's entries
    const uint32_t* rb;  // [G, T, KR, L]: every read slot (K2)
    const uint32_t* re;
    const uint32_t* wb;  // [G, T, KW, L]
    const uint32_t* we;
    const int* t_snap;           // [G, T]
    const uint8_t* t_has_reads;  // [G, T]
    const int* vers;             // [3, G]: now, oldest before, oldest after each batch
    // outputs
    int8_t* verdicts;  // [G, T]
    int* pressures;    // [E, G, P, 2]: most staged rows, most kept rows in a bucket
    int* gmax;         // [E, P, 2]: their maxima over the group; nullptr: not written
    // scratch of the card
    uint8_t* H;       // [T]
    uint8_t* commit;  // [T]
    uint32_t* pt;     // [W, 32 W]
    uint32_t* rows;   // merge rows in global memory, [warps of the grid, 64, L + 2]; nullptr: shared
    // scratch of entry 0 (entry e's at + e·ew words)
    int* bmax_sup;      // [P, B1]
    uint32_t* st_code;  // [U, S2, L]
    int* st_ev;         // [U, S2]
    int* tid;           // [U]
    int* carry;         // [U]
    uint32_t* rec_a;    // [P, N2pad, L + 2]
    uint32_t* rec_b;    // the same, or nullptr where one tile holds every row
    Scan4* agg;         // [P, N2pad / kScanThreads]: the aggregation's chunk totals
    int* counters;      // [3, G, P]: most staged rows, most kept rows, valid rows, per batch and partition
    long long* stamps;  // [G, kScanPhases + 1, or + 2 for a spread]: the clock at each phase boundary; nullptr: none
    int spread;         // the spread's launch (resolve_many_kernel<LM, true>), else the one-entry scan
    // the exchange across cards (n_cards > 1)
    uint32_t* xwords;  // [2, Gx, n_cards, Wx]: H's bits a (launch parity, batch, card)
    int* xflags;       // [2, Gx, n_cards]: the epoch of the launch that published the slot
    int* status;       // [1] on the card: 0, or 1 where a card's H did not come in time
    long long timeout_ns;
    int card, n_cards, epoch, Gx, Wx;
    int G, P, B, S, L, T, KR, KRe, KW, B1, B2, lgB2, vec;
    int R, NS;  // K2's overlap items: readers an item, slices of the write slots
    int S2, U, N2pad, tile;
};

// entry e's piece of the scratch, ``p`` entry 0's (nullptr stays nullptr)
template <typename T>
__device__ __forceinline__ T* at_entry(T* p, size_t ew, int e) {
    return p == nullptr ? nullptr : reinterpret_cast<T*>(reinterpret_cast<uint32_t*>(p) + (size_t)e * ew);
}

// read r of transaction t against the state (HistArgs as history_txn
// takes it), by one warp: does it, clipped to each partition it touches,
// overlap a gap with a version above t's snapshot? Warp-uniform.
template <int LM>
__device__ __forceinline__ bool history_read(const HistArgs& A, int t, int r, int lane) {
    const int B = A.B, S = A.S, L = A.L;
    const int snap = __ldg(A.t_snap + t);
    const auto part = [&](int p) {
        return Grid{A.pivots + (size_t)p * B * L, A.grid + (size_t)p * B * S * (L + 1),
                    A.count + (size_t)p * B, A.bmax + (size_t)p * B, A.floor_ + (size_t)p * B,
                    A.bmax_sup + (size_t)p * A.B1};
    };
    Code<LM> a, e;
    load(a, A.rb + ((size_t)t * A.KR + r) * L, L);
    load(e, A.re + ((size_t)t * A.KR + r) * L, L);
    if (A.plo == nullptr)  // inactive (or empty) ranges are skipped
        return cmp(a, e, L) < 0 && range_hits<LM, true>(part(0), a, e, snap, B, S, L, A.B1, A.lgB2, A.vec, lane);
    bool any = false;
    for (int p0 = 0; p0 < A.P && !any; p0 += 32) {
        Code<LM> a2, e2;
        bool touch = false;
        if (p0 + lane < A.P) {
            clip<LM>(a, e, A.plo + (size_t)(p0 + lane) * L, A.phi + (size_t)(p0 + lane) * L, L, a2, e2);
            touch = cmp(a2, e2, L) < 0;
        }
        for (unsigned m = __ballot_sync(FULL, touch); m && !any; m &= m - 1) {
            const int p = p0 + __ffs(m) - 1;
            clip<LM>(a, e, A.plo + (size_t)p * L, A.phi + (size_t)p * L, L, a2, e2);
            any = range_hits<LM, true>(part(p), a2, e2, snap, B, S, L, A.B1, A.lgB2, A.vec, lane);
        }
    }
    return any;
}

// the exchange of batch g's H across cards, by CTA 0: publish this card's
// bits into its slot, raise the slot's flag to the launch's epoch, wait
// (bounded) for every other card's flag and OR their bits into H. Returns
// whether every card's bits came in time (block-uniform). Not inlined, as
// the chain below: their registers stay out of the other phases
__device__ __noinline__ bool exchange_h(const ScanArgs& A, int g) {
    __shared__ int late;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int T = A.T, W = (T + 31) / 32, C = A.n_cards;
    const size_t slot0 = ((size_t)(A.epoch & 1) * A.Gx + g) * C;  // slot of (parity, g, card 0)
    uint32_t* mine = A.xwords + (slot0 + A.card) * A.Wx;
    for (int w = warp; w < W; w += n_warps) {
        const int t = 32 * w + lane;
        const uint32_t word = __ballot_sync(FULL, t < T && __ldcg(A.H + t));
        if (lane == 0) st_relaxed_sys(mine + w, word);
    }
    __threadfence_system();
    if (threadIdx.x == 0) late = 0;
    __syncthreads();
    if (threadIdx.x == 0) st_release_sys(A.xflags + slot0 + A.card, A.epoch);
    const int c = threadIdx.x;
    if (c < C && c != A.card) {
        const long long t0 = globaltimer();
        while (ld_acquire_sys(A.xflags + slot0 + c) != A.epoch) {
            if (globaltimer() - t0 > A.timeout_ns) {
                late = 1;
                break;
            }
            __nanosleep(256);
        }
    }
    __syncthreads();
    if (late) return false;
    for (int w = warp; w < W; w += n_warps) {
        uint32_t word = 0;
        if (lane < C && lane != A.card) {
            ld_acquire_sys(A.xflags + slot0 + lane);  // orders this lane's read of the words after the flag
            word = ld_relaxed_sys(A.xwords + (slot0 + lane) * A.Wx + w);
        }
        word = __reduce_or_sync(FULL, word);
        const int t = 32 * w + lane;
        if (t < T && ((word >> lane) & 1u)) A.H[t] = 1;
    }
    return true;
}

// K2's greedy chain of one batch on the CTA that calls it. Not inlined:
// the chain keeps kAhead words of every row in flight in registers, and
// inlined beside the entry loops of the other phases they spilled (on the
// H100 the chain took 22.8 µs a batch of the bench group, 19.7 out of line)
__device__ __noinline__ void scan_chain(const uint32_t* pt, const uint8_t* H, uint8_t* commit, int T, int W,
                                        int Tp, uint32_t* smem) {
    greedy_chain_block<kScanThreads, true>(pt, H, commit, T, W, Tp, smem);
}

// MULTI: the spread's launch (an entry table, the exchange, the exchange's
// timer column); without it the kernel is the one-entry scan, every entry
// index a constant 0, so it keeps the one-stack scan's registers
template <int LM, bool MULTI>
__global__ void __launch_bounds__(kScanThreads, 1) resolve_many_kernel(const __grid_constant__ ScanArgs A) {
    extern __shared__ __align__(16) uint32_t smem[];
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x & 31;
    const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t nthreads = (size_t)gridDim.x * blockDim.x;
    const int gwarp = (int)(gtid >> 5), nwarps = (int)(nthreads >> 5);
    const int G = A.G, P = A.P, T = A.T, L = A.L, E = MULTI ? A.E : 1;
    const int PB = P * A.B;  // buckets of an entry's flat view
    const int W = (T + 31) / 32, Tp = 32 * W;
    const size_t n_rows = (size_t)P * A.N2pad;  // staging rows of an entry's batch, padded
    const size_t n_rows32 = (n_rows + 31) / 32 * 32;  // the same, whole warps (a warp's rows are one entry's)
    const int tiles = A.N2pad / A.tile;
    const int fused = P == 1 && tiles == 1;  // one CTA sorts and aggregates
    const int chunks = (A.N2pad + kScanThreads - 1) / kScanThreads;  // aggregation chunks a partition
    const size_t row_words = (size_t)64 * (L + 2);  // a warp's merge rows, payloads and order
    uint32_t* merge_rows = A.rows ? A.rows + (size_t)gwarp * row_words
                                  : smem + (size_t)(threadIdx.x >> 5) * row_words;
    const int n_hist_e = T * A.KRe;  // an entry's history items
    const int n_hist = E * n_hist_e;
    constexpr int n_stamps = kScanPhases + (MULTI ? 2 : 1);  // a spread stamps the exchange's phase apart
    // entry and item within it of a work item v of n items an entry
    const auto entry_of = [](size_t v, size_t n) { return MULTI ? (int)(v / n) : 0; };
    const auto item_of = [](size_t v, size_t n) { return MULTI ? v % n : v; };
    // entry e's counters, [3, G, P]: most staged, most kept, valid rows
    const auto counters = [&](int e) { return at_entry(A.counters, A.ew, e); };
    // what stage_record_at and the rest of K3 staging read of entry e at batch g
    const auto stage_args = [&](int e, int g, const uint32_t* wb, const uint32_t* we) {
        int* const c = counters(e);
        return StageArgs{wb, we, A.commit, A.ent[e].pivots, A.ent[e].plo, A.ent[e].phi,
                         at_entry(A.st_code, A.ew, e), at_entry(A.st_ev, A.ew, e), at_entry(A.tid, A.ew, e),
                         at_entry(A.carry, A.ew, e), c + (size_t)g * P, c + (size_t)2 * G * P + (size_t)g * P,
                         P, T, A.KW, L, A.B, A.U, A.S2, 2 * T * A.KW, A.N2pad};
    };

    // the clock after the barrier that ends phase k of batch g (k = 0: the
    // batch's start; k = 3: the exchange, stamped only where the timer has
    // its column), by one thread where the caller asked for stamps
    const auto stamp = [&](int g, int k) {
        if (A.stamps == nullptr || blockIdx.x != 0 || threadIdx.x != 0) return;
        if (!MULTI) {
            if (k == 3) return;
            if (k > 3) --k;
        }
        A.stamps[(size_t)g * n_stamps + k] = globaltimer();
    };

    for (int e = 0; e < E; ++e)
        for (size_t x = gtid; x < (size_t)3 * G * P; x += nthreads) counters(e)[x] = 0;
    if (gtid == 0 && A.status != nullptr) *A.status = 0;
    grid.sync();

    for (int g = 0; g < G; ++g) {
        stamp(g, 0);
        const int now = A.vers[g], old_pre = A.vers[G + g], old_post = A.vers[2 * G + g];
        const uint32_t* rb = A.rb + (size_t)g * T * A.KR * L;
        const uint32_t* re = A.re + (size_t)g * T * A.KR * L;
        const uint32_t* wb = A.wb + (size_t)g * T * A.KW * L;
        const uint32_t* we = A.we + (size_t)g * T * A.KW * L;
        const int* t_snap = A.t_snap + (size_t)g * T;
        const uint8_t* has_reads = A.t_has_reads + (size_t)g * T;

        // 1. the superblock maxima of every entry; H seeded with the
        // too-old test; the bitset zeroed where its words are ORed together
        for (int v = gwarp; v < E * P * A.B1; v += nwarps) {
            const int e = entry_of(v, P * A.B1);
            superblock_warp<true>(A.ent[e].bmax, at_entry(A.bmax_sup, A.ew, e), (int)item_of(v, P * A.B1), lane,
                                  A.B2);
        }
        for (size_t t = gtid; t < (size_t)T; t += nthreads) A.H[t] = has_reads[t] && t_snap[t] < old_pre;
        if (A.NS > 1)
            for (size_t x = gtid; x < (size_t)W * Tp; x += nthreads) A.pt[x] = 0;
        grid.sync();
        stamp(g, 1);

        // 2. the history check, a warp an (entry, transaction, read slot)
        // into the card's one H, and K2's overlap bitset, a warp an item,
        // in turn over the grid's warps
        const OverlapArgs OA = {rb, re, wb, we, A.pt, T, A.KR, A.KW, L, A.R, A.NS};
        const int n_items = n_hist + overlap_count(OA);
        for (int v = gwarp; v < n_items; v += nwarps) {
            if (v < n_hist) {
                const int e = entry_of(v, n_hist_e), x = (int)item_of(v, n_hist_e), t = x / A.KRe;
                if (__shfl_sync(FULL, (int)__ldcg(A.H + t), 0)) continue;  // too old, or a read of t hit already
                const ScanEntry& en = A.ent[e];
                const size_t off = (size_t)g * T * A.KRe * L;
                const HistArgs HA = {en.pivots, en.grid, en.count, en.bmax, en.floor_, at_entry(A.bmax_sup, A.ew, e),
                                     en.rb + off, en.re + off, t_snap, en.plo, en.phi, P, A.B, A.S, L, A.KRe,
                                     A.B1, A.lgB2, A.vec != 0};
                if (history_read<LM>(HA, t, x % A.KRe, lane) && lane == 0) A.H[t] = 1;
                continue;
            }
            overlap_item<LM>(OA, v - n_hist, lane, smem + (threadIdx.x >> 5) * 64 * LM);
        }
        grid.sync();
        stamp(g, 2);

        // the exchange of H across cards (the reference's pmax over the
        // mesh), by CTA 0; a card that never publishes ends the launch
        if (MULTI && A.n_cards > 1) {
            if (blockIdx.x == 0 && !exchange_h(A, g) && threadIdx.x == 0) *A.status = 1;
            grid.sync();
            if (__ldcg(A.status)) return;  // every CTA leaves; the caller raises
        }
        stamp(g, 3);

        // 3. K2's greedy chain on CTA 0, once a card
        if (blockIdx.x == 0) scan_chain(A.pt, A.H, A.commit, T, W, Tp, smem);
        grid.sync();
        stamp(g, 4);

        // 4. the verdicts; K3 staging's records of every entry (each write
        // clipped to its partition where P > 1) and its cleared planes
        for (size_t t = gtid; t < (size_t)T; t += nthreads) {
            const bool too_old = has_reads[t] && t_snap[t] < old_pre;
            A.verdicts[(size_t)g * T + t] = (int8_t)(too_old ? 2 : A.commit[t] ? 0 : 1);
        }
        for (size_t x0 = gtid - lane; x0 < (size_t)E * n_rows32; x0 += nthreads) {
            const int e = entry_of(x0, n_rows32);
            const size_t r = item_of(x0, n_rows32) + lane;  // past n_rows: no record (stage_record_at)
            stage_record_at(stage_args(e, g, wb, we), at_entry(A.rec_a, A.ew, e), r, lane);
        }
        for (int e = 0; e < E; ++e) stage_clear_at(stage_args(e, g, wb, we), gtid, nthreads);
        grid.sync();
        stamp(g, 5);

        // 5. the sort tiles that hold valid records, a tile a CTA in turn
        // (one CTA also aggregates where one tile holds one grid's rows)
        int nv_max = 0;  // the most valid records of a partition: as every CTA reads it
        for (int e = 0; e < E; ++e)
            for (int p = 0; p < P; ++p) nv_max = max(nv_max, __ldcg(counters(e) + (size_t)(2 * G + g) * P + p));
        for (int v = blockIdx.x; v < E * tiles * P; v += gridDim.x) {
            const int e = entry_of(v, tiles * P), vt = (int)item_of(v, tiles * P);
            if (!fused && vt % tiles * A.tile >= __ldcg(counters(e) + (size_t)(2 * G + g) * P + vt / tiles)) continue;
            sort_tile(stage_args(e, g, wb, we), A.tile, at_entry(A.rec_a, A.ew, e), at_entry(A.rec_b, A.ew, e),
                      fused, vt % tiles, vt / tiles, smem);
            __syncthreads();  // the next tile reloads the shared memory
        }
        grid.sync();
        stamp(g, 6);

        // 6. the merge passes, over the valid records, until one run holds
        // every partition's (every entry's records move in each pass)
        int flips = 0;  // passes made: the sorted runs are in rec_b after an even number
        if (!fused) {
            for (int w = A.tile; w < nv_max; w <<= 1, ++flips) {  // sorted runs b -> a -> b ...
                for (size_t x = gtid; x < (size_t)E * n_rows; x += nthreads) {
                    const int e = entry_of(x, n_rows);
                    const size_t r = item_of(x, n_rows);
                    uint32_t* a = at_entry(A.rec_a, A.ew, e);
                    uint32_t* b = at_entry(A.rec_b, A.ew, e);
                    merge_pass_at(flips & 1 ? a : b, flips & 1 ? b : a, A.N2pad, w, L, r,
                                  __ldcg(counters(e) + (size_t)(2 * G + g) * P + r / A.N2pad));
                }
                grid.sync();
            }
        }
        stamp(g, 7);

        // 7. the aggregation: each chunk's scan total, then each chunk's
        // scan from the totals before it
        if (!fused) {
            Scan4* warp_tot = reinterpret_cast<Scan4*>(smem);  // [32], then the carry
            for (int pass = 0; pass < 2; ++pass) {
                for (int v = blockIdx.x; v < E * P * chunks; v += gridDim.x) {
                    const int e = entry_of(v, P * chunks), vp = (int)item_of(v, P * chunks);
                    const uint32_t* sorted = at_entry(flips & 1 ? A.rec_a : A.rec_b, A.ew, e);
                    aggregate_chunk(stage_args(e, g, wb, we), at_entry(A.agg, A.ew, e), sorted, vp / chunks,
                                    vp % chunks, chunks, pass, warp_tot, warp_tot + 32);
                    __syncthreads();  // the next chunk resets the carry
                }
                grid.sync();
            }
        }
        stamp(g, 8);

        // 8. K3 merge, a touched bucket of an entry a warp in turn, and the
        // floor raise of the untouched buckets below it that a committed
        // write spans (carry > 0), back to the touched bucket before it in
        // its partition
        for (int v = gwarp; v < E * A.U; v += nwarps) {
            const int e = entry_of(v, A.U), u = (int)item_of(v, A.U);
            const int* tid = at_entry(A.tid, A.ew, e);
            const int b = tid[u];  // warp-uniform; PB marks an unused staging slot
            if (b >= PB) continue;
            const ScanEntry& en = A.ent[e];
            const int* carry = at_entry(A.carry, A.ew, e);
            merge_bucket(en.grid, en.count, en.bmax, en.floor_, at_entry(A.st_code, A.ew, e),
                         at_entry(A.st_ev, A.ew, e), carry, now, old_post, counters(e) + (size_t)(G + g) * P,
                         A.B, A.S, A.S2, L, u, b, merge_rows, lane);
            raise_spanned(en.bmax, en.floor_, tid, carry, now, A.B, u, b, lane);
            __syncwarp();  // the warp's rows are rewritten by its next bucket
        }
        grid.sync();
        stamp(g, 9);
    }

    // the per-batch pressures of every entry, and their maxima over the group
    for (size_t x = gtid; x < (size_t)E * G * P; x += nthreads) {
        const int e = entry_of(x, (size_t)G * P);
        const size_t i = item_of(x, (size_t)G * P);
        A.pressures[2 * x] = counters(e)[i];
        A.pressures[2 * x + 1] = counters(e)[(size_t)G * P + i];
    }
    for (size_t x = gtid; A.gmax != nullptr && x < (size_t)E * P; x += nthreads) {
        const int e = entry_of(x, P), p = (int)item_of(x, P);
        int ms = 0, mk = 0;
        for (int g = 0; g < G; ++g) {
            ms = max(ms, counters(e)[(size_t)g * P + p]);
            mk = max(mk, counters(e)[(size_t)(G + g) * P + p]);
        }
        A.gmax[2 * x] = ms;
        A.gmax[2 * x + 1] = mk;
    }
}

using ScanKernel = void (*)(ScanArgs);

// register arrays sized for the key width, as K1's: 4 lanes at the bench's
// 12 bytes; above FDB_MAX_LANES the codes are compared in memory
template <bool MULTI>
ScanKernel scan_kernel(int L) {
    if (L <= 4) return resolve_many_kernel<4, MULTI>;
    if (L <= 8) return resolve_many_kernel<8, MULTI>;
    if (L <= FDB_MAX_LANES) return resolve_many_kernel<16, MULTI>;
    return resolve_many_kernel<0, MULTI>;
}

// CTAs of the L-lane kernel co-resident on one SM with ``smem`` bytes of
// dynamic shared memory (the spread's kernel, which takes as many
// registers and no more shared memory), and the SMs of the current device
int occupancy(int L, int smem, int* per_sm, int* sms) {
    const ScanKernel kernel = scan_kernel<true>(L);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kScanThreads, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// the shared arguments' checks, then the cooperative launch of ``A`` on
// ``blocks`` CTAs, which must all be co-resident: the launch itself
// refuses a larger grid (cudaErrorCooperativeLaunchTooLarge)
int launch(ScanArgs& A, int smem, int blocks, void* stream) {
    const int W = (A.T + 31) / 32;
    if (A.E < 1 || A.E > kMaxEntries || (!A.spread && (A.E > 1 || A.n_cards > 1)) || A.G < 1 || A.P < 1
        || A.L < 1 || A.T < 1 || A.KR < 1 || A.KRe < 1 || A.KW < 1 || A.B < 1 || A.B1 * A.B2 != A.B
        || (A.B2 & (A.B2 - 1)) || A.S > 32 || A.S2 > 32 || W > kMaxWords || A.R < 1 || A.R > 32 || (32 % A.R) || A.NS < 1 || A.NS > A.KW || A.tile < 1
        || A.N2pad % A.tile || (A.rec_b == nullptr && (A.P > 1 || A.tile < A.N2pad)) || blocks < 1
        || (A.n_cards > 1 && (A.n_cards > 32 || A.card < 0 || A.card >= A.n_cards || A.xwords == nullptr
                              || A.xflags == nullptr || A.status == nullptr || A.Wx < W || A.Gx < A.G))) {
        return (int)cudaErrorInvalidValue;
    }
    for (int e = 0; e < A.E; ++e) {
        if (A.P > 1 && A.ent[e].plo == nullptr) return (int)cudaErrorInvalidValue;
        A.vec = A.vec && (uintptr_t)A.ent[e].grid % 16 == 0;
    }
    A.lgB2 = __builtin_ctz((unsigned)A.B2);
    const ScanKernel kernel = A.spread ? scan_kernel<true>(A.L) : scan_kernel<false>(A.L);
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    void* args[] = {&A};
    err = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kScanThreads), args,
                                           (size_t)smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return err;
    return (int)cudaGetLastError();
}

// the scratch pieces in kernels.SCAN_PIECES order
void set_scratch(ScanArgs& A, void* const* s) {
    A.bmax_sup = (int*)s[0];
    A.H = (uint8_t*)s[1];
    A.commit = (uint8_t*)s[2];
    A.pt = (uint32_t*)s[3];
    A.st_code = (uint32_t*)s[4];
    A.st_ev = (int*)s[5];
    A.tid = (int*)s[6];
    A.carry = (int*)s[7];
    A.rec_a = (uint32_t*)s[8];
    A.rec_b = (uint32_t*)s[9];
    A.rows = (uint32_t*)s[10];
    A.agg = (Scan4*)s[11];
    A.counters = (int*)s[12];
}

}  // namespace

// out: int[2] on the host — CTAs of the scan co-resident on an SM at
// ``smem`` bytes of dynamic shared memory, and the device's SMs
extern "C" int fdb_scan_occupancy(int L, int smem, void* out) {
    int* o = (int*)out;
    return occupancy(L, smem, &o[0], &o[1]);
}

// one group through the scan on one grid or one stack (one entry, one
// card): plo/phi nullptr for one grid. Scratch as ScanArgs lists it
// (kernels.scan_plan); phase_ns int64 [G, kScanPhases + 1] for the
// per-phase timer, nullptr on every path
extern "C" int fdb_resolve_many(
    const void* pivots, void* grid, void* count, void* bmax, void* floor_,
    const void* plo, const void* phi, const void* rb, const void* re, const void* wb, const void* we,
    const void* t_snap, const void* t_has_reads, const void* vers,
    void* verdicts, void* pressures, void* gmax,
    void* bmax_sup, void* H, void* commit, void* pt, void* st_code, void* st_ev, void* tid, void* carry,
    void* rec_a, void* rec_b, void* rows, void* agg, void* counters, void* phase_ns,
    int G, int P, int B, int S, int L, int T, int KR, int KW, int B1, int B2,
    int R, int NS, int S2, int U, int N2pad, int tile, int smem, int blocks,
    void* stream) {
    if (P > 1 && plo == nullptr) return (int)cudaErrorInvalidValue;
    ScanArgs A = {};
    A.ent[0] = {(const uint32_t*)pivots, (uint32_t*)grid, (int*)count, (int*)bmax, (int*)floor_,
                (const uint32_t*)plo, (const uint32_t*)phi, (const uint32_t*)rb, (const uint32_t*)re};
    A.E = 1;
    A.rb = (const uint32_t*)rb, A.re = (const uint32_t*)re, A.wb = (const uint32_t*)wb, A.we = (const uint32_t*)we;
    A.t_snap = (const int*)t_snap, A.t_has_reads = (const uint8_t*)t_has_reads, A.vers = (const int*)vers;
    A.verdicts = (int8_t*)verdicts, A.pressures = (int*)pressures, A.gmax = (int*)gmax;
    void* const s[] = {bmax_sup, H, commit, pt, st_code, st_ev, tid, carry, rec_a, rec_b, rows, agg, counters};
    set_scratch(A, s);
    A.stamps = (long long*)phase_ns;
    A.n_cards = 1;
    A.G = G, A.P = P, A.B = B, A.S = S, A.L = L, A.T = T, A.KR = KR, A.KRe = KR, A.KW = KW, A.B1 = B1, A.B2 = B2;
    A.vec = (L + 1) % 4 == 0;
    A.R = R, A.NS = NS, A.S2 = S2, A.U = U, A.N2pad = N2pad, A.tile = tile;
    return launch(A, smem, blocks, stream);
}

// one group through the scan for the E entries of a spread on this card
// (kernels.resolve_many_spread): ``entries`` a host array of E × 9
// pointers (pivots, grid, count, bmax, floor, plo, phi, and the entry's
// read slots rb, re [G, T, KRe, L]); rb/re [G, T, KR, L] every read slot,
// for K2; ``scratch`` the 13 pieces of entry 0 in kernels.SCAN_PIECES
// order, entry e's at + e·ew int32 words; pressures [E, G, P, 2], gmax
// [E, P, 2] or nullptr. Across n_cards > 1 cards this launch is card ``card`` of the
// exchange: ``xwords`` [2, Gx, n_cards, Wx] and ``xflags`` [2, Gx, n_cards]
// in mapped host memory, ``epoch`` this group's launch counter (above 0),
// ``status`` [1] on the card. phase_ns int64 [G, kScanPhases + 2] (the
// exchange's phase after history) for the timer, nullptr on every path
extern "C" int fdb_resolve_many_spread(
    const void* entries, int E, const void* rb, const void* re, const void* wb, const void* we,
    const void* t_snap, const void* t_has_reads, const void* vers, void* verdicts, void* pressures, void* gmax,
    const void* scratch, long long ew, void* phase_ns,
    void* xwords, void* xflags, void* status, long long timeout_ns, int card, int n_cards, int epoch, int Gx,
    int Wx, int G, int P, int B, int S, int L, int T, int KR, int KRe, int KW, int B1, int B2,
    int R, int NS, int S2, int U, int N2pad, int tile, int smem, int blocks, void* stream) {
    if (E < 1 || E > kMaxEntries || ew < 0) return (int)cudaErrorInvalidValue;
    ScanArgs A = {};
    const void* const* ep = (const void* const*)entries;
    for (int e = 0; e < E; ++e) {
        const void* const* x = ep + 9 * e;
        A.ent[e] = {(const uint32_t*)x[0], (uint32_t*)x[1], (int*)x[2], (int*)x[3], (int*)x[4],
                    (const uint32_t*)x[5], (const uint32_t*)x[6], (const uint32_t*)x[7], (const uint32_t*)x[8]};
    }
    A.E = E;
    A.ew = (size_t)ew;
    A.rb = (const uint32_t*)rb, A.re = (const uint32_t*)re, A.wb = (const uint32_t*)wb, A.we = (const uint32_t*)we;
    A.t_snap = (const int*)t_snap, A.t_has_reads = (const uint8_t*)t_has_reads, A.vers = (const int*)vers;
    A.verdicts = (int8_t*)verdicts, A.pressures = (int*)pressures, A.gmax = (int*)gmax;
    set_scratch(A, (void* const*)scratch);
    A.stamps = (long long*)phase_ns, A.spread = 1;
    A.xwords = (uint32_t*)xwords, A.xflags = (int*)xflags, A.status = (int*)status;
    A.timeout_ns = timeout_ns, A.card = card, A.n_cards = n_cards, A.epoch = epoch, A.Gx = Gx, A.Wx = Wx;
    A.G = G, A.P = P, A.B = B, A.S = S, A.L = L, A.T = T, A.KR = KR, A.KRe = KRe, A.KW = KW, A.B1 = B1, A.B2 = B2;
    A.vec = (L + 1) % 4 == 0;
    A.R = R, A.NS = NS, A.S2 = S2, A.U = U, A.N2pad = N2pad, A.tile = tile;
    if (n_cards > 1 && epoch < 1) return (int)cudaErrorInvalidValue;
    return launch(A, smem, blocks, stream);
}

// the exchange buffer: ``bytes`` of pinned host memory, mapped into every
// card's address space (portable), zeroed; *out its pointer, which the
// cards use as it is (unified addressing)
extern "C" int fdb_host_alloc(long long bytes, void* out) {
    void* p = nullptr;
    cudaError_t err = cudaHostAlloc(&p, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) return (int)err;
    memset(p, 0, (size_t)bytes);
    *(void**)out = p;
    return 0;
}

extern "C" int fdb_host_free(void* p) { return (int)cudaFreeHost(p); }
