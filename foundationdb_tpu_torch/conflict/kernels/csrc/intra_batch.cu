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
#include "common.cuh"

namespace {

constexpr int kRowsPerCta = 32;
constexpr int kChainThreads = 1024;
constexpr int kAhead = 16;       // words loaded ahead of the chain
constexpr int kMaxWords = 2048;  // commit words: T <= 65536

// a < b on L uint32 lanes
__device__ __forceinline__ bool lex_lt(const uint32_t* a, const uint32_t* b, int L) {
    return lex_cmp(a, b, L) < 0;
}

// LC: the lane count when it is known at compile time (the compares then
// unroll), 0 for any L
template <int LC>
__global__ void build_overlap(
    const uint32_t* __restrict__ rb, const uint32_t* __restrict__ re,
    const uint32_t* __restrict__ wb, const uint32_t* __restrict__ we,
    uint32_t* __restrict__ pt, int T, int KR, int KW, int L_, int Tp, int WT) {
    const int L = LC ? LC : L_;
    const int w0 = blockIdx.x * WT;
    const int jb = blockIdx.y;  // reader block: rows 32·jb .. 32·jb + 31
    if (w0 > jb) return;        // every word strictly above the diagonal
    const int j0 = jb * kRowsPerCta;
    const int i0 = w0 * 32;
    const int n_w = 32 * WT;  // writers staged
    extern __shared__ uint32_t sm[];
    // readers: [32][KR][2][L] (begin, end) at an odd stride, since the
    // lanes of a warp read 32 different readers; writers: [32·WT][KW][2][L],
    // each read by a whole warp at once
    const int rrec = (KR * 2 * L) | 1;
    uint32_t* rd = sm;
    uint32_t* wr = sm + kRowsPerCta * rrec;
    const int wrec = KW * 2 * L;
    const int rd_words = kRowsPerCta * KR * L;
    for (int k = threadIdx.x; k < rd_words; k += blockDim.x) {
        int r = k / (KR * L), rest = k % (KR * L);
        int j = j0 + r;
        size_t src = (size_t)j * KR * L + rest;
        int ar = rest / L, l = rest % L;
        uint32_t* dst = rd + r * rrec + ar * 2 * L + l;
        dst[0] = j < T ? rb[src] : FDB_SENTINEL;
        dst[L] = j < T ? re[src] : FDB_SENTINEL;
    }
    const int wr_words = n_w * KW * L;
    for (int k = threadIdx.x; k < wr_words; k += blockDim.x) {
        int r = k / (KW * L), rest = k % (KW * L);
        int i = i0 + r;
        size_t src = (size_t)i * KW * L + rest;
        int aw = rest / L, l = rest % L;
        uint32_t* dst = wr + r * wrec + aw * 2 * L + l;
        dst[0] = i < T ? wb[src] : FDB_SENTINEL;
        dst[L] = i < T ? we[src] : FDB_SENTINEL;
    }
    __syncthreads();

    const int r = threadIdx.x & 31, w = w0 + (threadIdx.x >> 5);
    const int j = j0 + r;
    if (w > jb) return;  // only words at or below the diagonal
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
        int i = w * 32 + b;
        if (i >= j) break;  // strictly earlier writers only
        const uint32_t* wrow = wr + (i - i0) * wrec;
        bool o = false;
        for (int ar = 0; ar < KR && !o; ++ar) {
            const uint32_t* rbj = rd + r * rrec + ar * 2 * L;
            const uint32_t* rej = rbj + L;
            for (int aw = 0; aw < KW; ++aw) {
                const uint32_t* wbi = wrow + aw * 2 * L;
                const uint32_t* wei = wbi + L;
                // read j overlaps write i: rb_j < we_i and wb_i < re_j
                if (lex_lt(rbj, wei, L) && lex_lt(wbi, rej, L)) { o = true; break; }
            }
        }
        if (o) bits |= 1u << b;
    }
    if (j < T) pt[(size_t)w * Tp + j] = bits;
}

// build_overlap where the endpoints do not fit one block: STAGED, they
// come in chunks of CR read slots and CW write slots, one (read chunk,
// write chunk) pair at a time, each row's bits ORed over the pairs; else
// straight from global memory
template <int LC, bool STAGED>
__global__ void build_overlap_chunks(
    const uint32_t* __restrict__ rb, const uint32_t* __restrict__ re,
    const uint32_t* __restrict__ wb, const uint32_t* __restrict__ we,
    uint32_t* __restrict__ pt, int T, int KR, int KW, int L_, int Tp, int WT, int CR, int CW) {
    const int L = LC ? LC : L_;
    const int w0 = blockIdx.x * WT;
    const int jb = blockIdx.y;  // reader block: rows 32·jb .. 32·jb + 31
    if (w0 > jb) return;        // every word strictly above the diagonal
    const int j0 = jb * kRowsPerCta;
    const int i0 = w0 * 32;
    const int n_w = 32 * WT;  // writers staged
    const int cr = STAGED ? CR : KR, cw = STAGED ? CW : KW;
    extern __shared__ uint32_t sm[];
    // readers: [32][CR][2][L] (begin, end) at an odd stride, since the
    // lanes of a warp read 32 different readers; writers: [32·WT][CW][2][L],
    // each read by a whole warp at once
    const int rrec = (cr * 2 * L) | 1;
    uint32_t* rd = sm;
    uint32_t* wr = sm + kRowsPerCta * rrec;
    const int wrec = cw * 2 * L;

    const int r = threadIdx.x & 31, w = w0 + (threadIdx.x >> 5);
    const int j = j0 + r;
    const bool active = w <= jb && j < T;  // only words at or below the diagonal
    uint32_t bits = 0;
    for (int r0 = 0; r0 < KR; r0 += cr) {
        const int nr = min(cr, KR - r0);
        for (int a0 = 0; a0 < KW; a0 += cw) {
            const int na = min(cw, KW - a0);
            if (STAGED) {
                if (r0 | a0) __syncthreads();  // every thread is done with the last chunk
                if (a0 == 0) {
                    const int rd_words = kRowsPerCta * nr * L;
                    for (int k = threadIdx.x; k < rd_words; k += blockDim.x) {
                        int rr = k / (nr * L), rest = k % (nr * L);
                        int jj = j0 + rr;
                        size_t src = ((size_t)jj * KR + r0) * L + rest;
                        int ar = rest / L, l = rest % L;
                        uint32_t* dst = rd + rr * rrec + ar * 2 * L + l;
                        dst[0] = jj < T ? rb[src] : FDB_SENTINEL;
                        dst[L] = jj < T ? re[src] : FDB_SENTINEL;
                    }
                }
                if (r0 == 0 || cw < KW) {  // one write chunk stays staged
                    const int wr_words = n_w * na * L;
                    for (int k = threadIdx.x; k < wr_words; k += blockDim.x) {
                        int rr = k / (na * L), rest = k % (na * L);
                        int i = i0 + rr;
                        size_t src = ((size_t)i * KW + a0) * L + rest;
                        int aw = rest / L, l = rest % L;
                        uint32_t* dst = wr + rr * wrec + aw * 2 * L + l;
                        dst[0] = i < T ? wb[src] : FDB_SENTINEL;
                        dst[L] = i < T ? we[src] : FDB_SENTINEL;
                    }
                }
                __syncthreads();
            }
            if (!active) continue;
            // reader j's read slots r0 .. r0 + nr - 1: begin at rbj, end at
            // rej, slot s at s·rs
            const uint32_t* rbj = STAGED ? rd + r * rrec : rb + ((size_t)j * KR + r0) * L;
            const uint32_t* rej = STAGED ? rbj + L : re + ((size_t)j * KR + r0) * L;
            const int rs = STAGED ? 2 * L : L;
            for (int b = 0; b < 32; ++b) {
                const int i = w * 32 + b;
                if (i >= j) break;              // strictly earlier writers only
                if ((bits >> b) & 1u) continue;  // found in an earlier chunk
                const uint32_t* wbi = STAGED ? wr + (i - i0) * wrec : wb + ((size_t)i * KW + a0) * L;
                const uint32_t* wei = STAGED ? wbi + L : we + ((size_t)i * KW + a0) * L;
                bool o = false;
                for (int ar = 0; ar < nr && !o; ++ar) {
                    for (int aw = 0; aw < na; ++aw) {
                        // read j overlaps write i: rb_j < we_i and wb_i < re_j
                        if (lex_lt(rbj + ar * rs, wei + aw * rs, L) && lex_lt(wbi + aw * rs, rej + ar * rs, L)) {
                            o = true;
                            break;
                        }
                    }
                }
                if (o) bits |= 1u << b;
            }
        }
    }
    if (active) pt[(size_t)w * Tp + j] = bits;
}

__global__ void __launch_bounds__(kChainThreads) greedy_chain(
    const uint32_t* __restrict__ pt, const uint8_t* __restrict__ H,
    uint8_t* __restrict__ commit, int T, int W, int Tp) {
    __shared__ uint32_t cbits[kMaxWords];
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    constexpr int D = kAhead;
    for (int j0 = 0; j0 < T; j0 += kChainThreads) {
        // a panel: blocks k0 .. k0 + 31; this thread's row j is in block kb
        const int k0 = j0 >> 5, j = j0 + t, kb = k0 + warp;
        const int n_blocks = min(W - k0, 32);
        const bool in = j < T;
        // the row's words below the panel against the earlier commit
        // words, and its words k0 .. k0 + D - 1 into the ring
        uint32_t acc = 0, pf[D];
        if (in) {
#pragma unroll 8
            for (int w = 0; w < k0; ++w) acc |= pt[(size_t)w * Tp + j] & cbits[w];
        }
        const bool ok = in && !H[j];
#pragma unroll
        for (int d = 0; d < D; ++d) pf[d] = (in && k0 + d <= kb) ? pt[(size_t)(k0 + d) * Tp + j] : 0u;
        for (int s0 = 0; s0 < 32; s0 += D) {
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const int s = s0 + d, k = k0 + s;  // block k, warp s
                if (s >= n_blocks) return;         // the last panel's end
                if (warp == s) {
                    const bool okr = ok && acc == 0;
                    const uint32_t diag = pf[d];  // word k of row 32k + lane
                    uint32_t c = __ballot_sync(0xffffffffu, okr);
                    while (true) {
                        const uint32_t nc = __ballot_sync(0xffffffffu, okr && (diag & c) == 0);
                        if (nc == c) break;
                        c = nc;
                    }
                    if (in) commit[j] = (c >> lane) & 1u;
                    if (lane == 0) cbits[k] = c;
                }
                __syncthreads();
                if (kb > k) {  // a later block (warp-uniform): fold word k, load word k + D
                    acc |= pf[d] & cbits[k];
                    const int kn = k + D;
                    pf[d] = (in && kn <= kb) ? pt[(size_t)kn * Tp + j] : 0u;
                }
            }
        }
    }
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
