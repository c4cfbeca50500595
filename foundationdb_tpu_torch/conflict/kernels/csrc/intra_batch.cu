// K2 — intra-batch in-order greedy commit, from the batch's key codes.
//
// Replaces: foundationdb_tpu/conflict/grid.py:297 _endpoint_ranks and :337
// intra_batch_commits (the dense [T, T] "read of j overlaps write of i"
// matrix over dense endpoint ranks and the bf16 matvec fixpoint in a
// lax.while_loop, :362-374).
//
// No ranks. Dense ranks are order-isomorphic to the unsigned lexicographic
// order of the L-lane codes, so "rb_j < we_i && wb_i < re_j" evaluated on
// the uint32 lanes has the rank form's truth value for every input: empty
// reads inside a write (an overlap, as in JAX), inverted ranges, a write
// ending at the all-0xFF code, and the all-0xFF padding slots (which never
// overlap: nothing is above the sentinel).
//
// What bounds it on the H100: the dependency chain. commit[j] needs every
// commit[i], i < j. The overlap test is T²/2·KR·KW range pairs (3.3 M at
// the bench shape, microseconds on 132 SMs); the chain is what is left.
//
// Design. Pass 1 (build_overlap, every SM) writes the lower triangle of
// the bitset, transposed: PT[w][j], bit b = txn j reads what txn 32w+b < j
// writes. Its work comes in items a warp each: R readers (a power of two up
// to 32) × one writer word × one of NS slices of the write slots. Lane b
// takes writer 32w + b, its codes in registers, and tests it against the
// item's readers, which the warp stages in its shared memory one read slot
// at a time and every lane reads back as one broadcast; the codes compare
// as 64-bit words (above 16 lanes in memory, any L). One ballot a reader
// forms its word. kernels.intra_batch_plan (kernels.overlap_items) grows R
// while the items still give every warp of the card one, so a batch of 64
// transactions spreads over the card as one of 2500 does, and slices the
// write slots (the slices' words ORed into a zeroed bitset) where a batch
// of a few transactions gives fewer items than warps and each lane would
// test many slot pairs. Items wholly above the diagonal return at once.
// Pass 2 (greedy_chain, ONE CTA of 1024 threads) resolves the chain 32
// transactions at a time: ceil(T/32) dependent steps (80 at the bench
// shape) instead of T. Thread t owns row t of each panel of 1024 rows
// (32 blocks) and keeps the OR of its words so far ANDed with the commit
// words (`acc`). Block k (rows 32k..32k+31) belongs to warp k mod 32.
// Step k:
//   - that warp resolves the 32 × 32 diagonal word in registers: a row is
//     ok if not H and acc = 0; from c = ballot(ok) it iterates
//     c ← ballot(ok ∧ ¬(diag ∧ c)). The diagonal is strictly lower
//     triangular, so this is the JAX fixpoint restricted to 32 rows: it
//     reaches the unique fixpoint, the sequential greedy pass, in at most
//     depth + 1 ≤ 32 rounds (usually 1-3). It writes commit word k to
//     shared memory;
//   - one __syncthreads; every thread whose row is in a later block folds
//     its word k ANDed with commit word k into `acc`.
// Word k of a thread's row is loaded kAhead steps before it is needed (a
// register ring; a warp's loads are 128 contiguous bytes of PT[k]), so no
// step waits on memory, and warps whose rows are resolved skip the fold:
// the chain's step is a ballot loop, a barrier and a shared load. A panel
// after the first starts by folding its rows' words below the panel
// against the earlier commit words, all loads in flight at once. One row
// a thread is the fastest choice on the card: more rows a thread (larger
// panels, fewer such folds) made every step's fold longer. The overlap
// words live in a global bitset of 32·ceil(T/32)² words (0.8 MB at the
// bench shape) rather than inside the chain's CTA: building them is the
// parallel part of the work, and one CTA would serialise it.
// The device code is intra_batch.cuh, which the group scan (scan.cu)
// shares.
#include "intra_batch.cuh"

namespace {

constexpr int kChainThreads = 1024;  // the chain's CTA
constexpr int kOverlapThreads = 256;  // 8 warps, an overlap item each at a time

// K2's overlap items over the grid's warps in turn. LM: the code lanes in
// registers (4, 8 or 16), 0 in memory
template <int LM>
__global__ void __launch_bounds__(kOverlapThreads) build_overlap(const OverlapArgs A) {
    extern __shared__ __align__(16) uint32_t sm[];  // a warp's staged readers: 64·LM words
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = kOverlapThreads / 32;
    const int n = overlap_count(A);
    for (int v = blockIdx.x * n_warps + warp; v < n; v += gridDim.x * n_warps)
        overlap_item<LM>(A, v, lane, sm + warp * 64 * LM);
}

__global__ void __launch_bounds__(kChainThreads) greedy_chain(
    const uint32_t* __restrict__ pt, const uint8_t* __restrict__ H,
    uint8_t* __restrict__ commit, int T, int W, int Tp) {
    __shared__ uint32_t cbits[kMaxWords];
    greedy_chain_block<kChainThreads, false>(pt, H, commit, T, W, Tp, cbits);
}

}  // namespace

// R readers an overlap item, NS slices of the write slots
// (kernels.intra_batch_plan)
extern "C" int fdb_intra_batch(
    const void* rb, const void* re, const void* wb, const void* we,
    const void* H, void* pt, void* commit,
    int T, int KR, int KW, int L, int R, int NS, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int W = (T + 31) / 32;
    if (T < 1 || W > kMaxWords || R < 1 || R > 32 || (32 % R) || NS < 1 || NS > KW) {
        return (int)cudaErrorInvalidValue;
    }
    const int Tp = 32 * W;  // PT row pitch: 128-byte aligned rows
    const OverlapArgs A = {(const uint32_t*)rb, (const uint32_t*)re, (const uint32_t*)wb, (const uint32_t*)we,
                           (uint32_t*)pt, T, KR, KW, L, R, NS};
    cudaError_t err;
    if (NS > 1) {  // the slices' words are ORed together
        err = cudaMemsetAsync(pt, 0, (size_t)W * Tp * sizeof(uint32_t), st);
        if (err != cudaSuccess) return (int)err;
    }
    // register codes as the scan's: 4 lanes at the bench's 12 bytes;
    // above FDB_MAX_LANES the codes are compared in memory
    const int LM = L <= 4 ? 4 : L <= 8 ? 8 : L <= FDB_MAX_LANES ? 16 : 0;
    auto build = LM == 4 ? build_overlap<4> : LM == 8 ? build_overlap<8> : LM == 16 ? build_overlap<16>
                                                                                    : build_overlap<0>;
    const int n_items = (T + R - 1) / R * W * NS;
    const int blocks = min((n_items + kOverlapThreads / 32 - 1) / (kOverlapThreads / 32), 65536);
    build<<<blocks, kOverlapThreads, (size_t)kOverlapThreads / 32 * 64 * LM * sizeof(uint32_t), st>>>(A);
    greedy_chain<<<1, kChainThreads, 0, st>>>(
        (const uint32_t*)pt, (const uint8_t*)H, (uint8_t*)commit, T, W, Tp);
    return (int)cudaGetLastError();
}
