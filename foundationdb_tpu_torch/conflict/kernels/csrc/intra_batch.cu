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
// Design. Pass 1 (build_overlap, many CTAs) writes the lower triangle of
// the bitset, transposed: PT[w][j], bit b = txn j reads what txn 32w+b < j
// writes. A CTA takes 32 readers × WT words; it stages the readers' and
// the 32·WT writers' endpoints in shared memory, so every (j, i) test
// reads shared memory; warp w builds word w of the 32 rows, a lane a row,
// and stores the 32 words side by side. CTAs wholly above the diagonal
// exit at once. When the KR read and KW write slots do not fit one block's
// shared memory (at L = 8: 65 reads, or 33 of each), the CTA stages them
// in chunks of CR read and CW write slots, one (read chunk, write chunk)
// pair at a time, and ORs each row's bits over the pairs in registers; a
// bit already set skips its writer. kernels.intra_batch_plan picks WT, CR
// and CW; where not even one slot of each fits (L > 453), the endpoints
// are read from global memory (CR = 0).
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

template <int LC>
__global__ void build_overlap(
    const uint32_t* __restrict__ rb, const uint32_t* __restrict__ re,
    const uint32_t* __restrict__ wb, const uint32_t* __restrict__ we,
    uint32_t* __restrict__ pt, int T, int KR, int KW, int L_, int Tp, int WT) {
    extern __shared__ uint32_t sm[];
    overlap_tile<LC>(rb, re, wb, we, pt, T, KR, KW, L_, Tp, WT, blockIdx.x, blockIdx.y, sm);
}

template <int LC, bool STAGED>
__global__ void build_overlap_chunks(
    const uint32_t* __restrict__ rb, const uint32_t* __restrict__ re,
    const uint32_t* __restrict__ wb, const uint32_t* __restrict__ we,
    uint32_t* __restrict__ pt, int T, int KR, int KW, int L_, int Tp, int WT, int CR, int CW) {
    extern __shared__ uint32_t sm[];
    overlap_tile_chunks<LC, STAGED>(rb, re, wb, we, pt, T, KR, KW, L_, Tp, WT, CR, CW, blockIdx.x,
                                    blockIdx.y, sm);
}

__global__ void __launch_bounds__(kChainThreads) greedy_chain(
    const uint32_t* __restrict__ pt, const uint8_t* __restrict__ H,
    uint8_t* __restrict__ commit, int T, int W, int Tp) {
    __shared__ uint32_t cbits[kMaxWords];
    greedy_chain_block<false>(pt, H, commit, T, W, Tp, cbits);
}

}  // namespace

extern "C" int fdb_intra_batch(
    const void* rb, const void* re, const void* wb, const void* we,
    const void* H, void* pt, void* commit,
    int T, int KR, int KW, int L, int WT, int CR, int CW, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int W = (T + 31) / 32;
    if (W > kMaxWords || CR < 0 || CR > KR || CW < 0 || CW > KW || (CR > 0) != (CW > 0)) {
        return (int)cudaErrorInvalidValue;
    }
    const int Tp = 32 * W;  // PT row pitch: 128-byte aligned rows
    size_t smem1 = CR ? ((size_t)kRowsPerCta * ((CR * 2 * L) | 1) + (size_t)32 * WT * CW * 2 * L) * sizeof(uint32_t) : 0;
    dim3 grid1((W + WT - 1) / WT, W);
    cudaError_t err;
    if (CR == KR && CW == KW) {  // the one-chunk plan (the bench's)
        auto build = L == 3 ? build_overlap<3> : build_overlap<0>;  // 12-byte keys: the bench's
        err = cudaFuncSetAttribute(build, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
        if (err != cudaSuccess) return (int)err;
        build<<<grid1, 32 * WT, smem1, st>>>(
            (const uint32_t*)rb, (const uint32_t*)re, (const uint32_t*)wb, (const uint32_t*)we,
            (uint32_t*)pt, T, KR, KW, L, Tp, WT);
    } else {
        auto build = !CR ? build_overlap_chunks<0, false>
                         : L == 3 ? build_overlap_chunks<3, true> : build_overlap_chunks<0, true>;
        err = cudaFuncSetAttribute(build, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
        if (err != cudaSuccess) return (int)err;
        build<<<grid1, 32 * WT, smem1, st>>>(
            (const uint32_t*)rb, (const uint32_t*)re, (const uint32_t*)wb, (const uint32_t*)we,
            (uint32_t*)pt, T, KR, KW, L, Tp, WT, CR, CW);
    }
    greedy_chain<<<1, kChainThreads, 0, st>>>(
        (const uint32_t*)pt, (const uint8_t*)H, (uint8_t*)commit, T, W, Tp);
    return (int)cudaGetLastError();
}
