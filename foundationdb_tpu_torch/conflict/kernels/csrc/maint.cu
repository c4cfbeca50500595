// K4a / K4b — grid maintenance: on-device reshard and version rebase.
//
// Replaces: foundationdb_tpu/conflict/grid.py:718 reshard_device (floor
// fold, the live rows in key order cut into blocks of q = ceil(live /
// n_buckets) rows, pivots from block starts, count and bmax recompute) and
// grid.py:704 rebase (subtract delta from the used rows' versions and the
// floors, clamp at 0, recompute bmax). K7 replaces the vmaps over partitions
// in foundationdb_tpu/conflict/mesh_backend.py:477 (_grow, vmap of
// reshard_device) and :499 (_maybe_rebase, vmap of rebase), and
// sharded.py:291 reshard_partition.
//
// What bounds them on the H100: bytes. Both write a whole grid: at the bench
// shape B·S = 1,048,576 rows × 16 B = 16 MiB, ~5 µs at 3.35 TB/s (a torch
// fill of it takes 0.006 ms); reshard reads only the live rows and the B
// counts, rebase the whole grid. Neither is on the per-batch path; they run
// on a reshard or when the version origin moves by 2^30.
//
// Reshard, from the bucket counts: live row (b, s) is a slot s < count[b], so
// its global rank is C[b] + s, C the exclusive prefix sum of the B counts
// (clamped to [0, S], as the reference's slot mask reads them). No per-row
// mask, prefix sum or compacted copy of the live rows is made.
// - reshard_scan: a CTA per chunk of 32^K counts (at most 32 chunks: 1,024
//   counts at the bench's B), each thread holding 8 coalesced 4-count groups
//   in flight, writes C relative to its chunk, every 32nd (1,024th, ...) of
//   those words as the sampled levels, and the chunk's total.
// - reshard_build: launched behind the scan by programmatic dependent launch
//   (it waits for the scan after its first writes). A CTA builds 32 new
//   buckets of one partition, 4 a warp, a lane per slot, so each lane holds 4
//   slots whose loads are in flight together. It scans the ≤ 32 chunk totals
//   (their prefixes and n_live), computes q and each bucket's live ranks
//   [b'·q, b'·q + min(q, n_slots)) ∩ [0, n_live), and stores the slots past
//   them first: sentinel rows (version 0), most of the new grid, with no
//   wait on the scan. Then rounds: warp 0 descends a 32-ary ballot search
//   (the chunk, the sampled levels, one coalesced load each) to the 32-bucket
//   tile holding the source bucket of the CTA's first unplaced rank, the CTA
//   loads C over the 128 buckets from there into shared memory, and each lane
//   places its ranks by fixed-step searches of that window, interleaved. Each
//   live slot gathers its row straight from the old grid (one 16-byte load
//   and store when L + 1 == 4, the bench's L = 3), folding its source
//   bucket's floor. count (rows whose code is not all 0xFF, as the
//   reference's is_row) is a ballot, bmax a warp max; pivot b' is slot 0's
//   code; floors are 0 and pressure = min(q, n_live) (0 when empty), per
//   partition. A 1,024-bucket window was slower on the H100 (PERF.md).
//
// Rebase writes a fresh grid (the old one may still be the backend's
// snapshot): every key lane copied, used slots' versions max(ver - delta,
// 0), unused slots' 0, floors max(floor - delta, 0), bmax the bucket's
// largest version or its floor. It is a streaming copy with one patched
// word per row and one max per bucket: it reads the whole grid and writes
// it whole, 2 × 16 MiB at the bench shape, ~10 µs at 3.35 TB/s. A CTA of
// 256 threads takes whole buckets (a multiple of 4, ~16 KB of words: 32
// buckets at the bench shape) as one run of 16-byte elements, four loads in
// flight per thread before its first store, the counts in shared memory.
// An element's version words are found by their index (at L = 3 an element
// is one slot row and .w its version); the bucket maxima are a warp
// reduction (a segmented scan where a warp's elements span buckets) and a
// shared atomic, then the floor. Misaligned grids take 4-byte accesses in
// the same kernel. A stack of P grids is rebased as one flat grid of P·B
// buckets, since rebase is independent per bucket.
#include <climits>

#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_GROUPS = 8;  // 4-count groups a scan thread holds per round
constexpr int BUILD_WARPS = 8;
constexpr int BUCKETS_PER_WARP = 4;
constexpr int BUILD_BUCKETS = BUILD_WARPS * BUCKETS_PER_WARP;  // new buckets per CTA
constexpr int WIN = 128;  // source buckets one window of C spans (a power of two, >= 32)
constexpr int MAX_LEVELS = 8;

// The scan's layout per partition. Chunks of 32^K counts (K >= 1, at most
// 32 chunks); level 0 is C, level k holds every 32^k-th C word, k < K, all
// relative to their chunk's start; the chunk totals go to their own array
struct Levels {
    int K;
    int n_chunks;
    int off[MAX_LEVELS];
    int len[MAX_LEVELS];
};

static Levels scan_levels(int B) {
    Levels lv = {};
    int K = 0;
    for (long long n = B; n > 32; n = (n + 31) / 32) ++K;
    lv.K = K > 1 ? K : 1;
    long long n = B, off = 0;
    for (int k = 0; k < lv.K; ++k, n = (n + 31) / 32) {
        lv.off[k] = (int)off;
        lv.len[k] = (int)n;
        off += n;
    }
    lv.n_chunks = (int)n;
    return lv;
}

__device__ __forceinline__ int live_slots(int count, int S) { return min(max(count, 0), S); }

// counts 4·g .. 4·g + 3 of a partition, each clamped by live_slots, 0 past ``end``
__device__ __forceinline__ int4 load_group(const int* count, int g, int end, int S, bool vec) {
    int c[4];
    if (vec) {
        const int4 v = 4 * g < end ? __ldg(reinterpret_cast<const int4*>(count) + g) : make_int4(0, 0, 0, 0);
        c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
    } else {
        for (int e = 0; e < 4; ++e) c[e] = 4 * g + e < end ? __ldg(count + 4 * g + e) : 0;
    }
    return make_int4(live_slots(c[0], S), live_slots(c[1], S), live_slots(c[2], S),
                     live_slots(c[3], S));
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
    for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += u;
    }
    return v;
}

// CTA (c, p) scans chunk c of partition p: C relative to the chunk's start
// (C[b] = Σ live_slots(count[b']), chunk start <= b' < b), its levels, and
// the chunk's total. A round holds SCAN_GROUPS coalesced 4-count groups per
// thread, all loads in flight at once
__global__ void __launch_bounds__(SCAN_THREADS) reshard_scan(
    const int* __restrict__ count, int* __restrict__ scan, int* __restrict__ totals, int B,
    int S, int stride, Levels lv, bool vec) {
    // reshard_build may start now: it waits for this grid before reading the scan
    cudaTriggerProgrammaticLaunchCompletion();
    constexpr int WARPS = SCAN_THREADS / 32, PER_LANE = SCAN_GROUPS * WARPS / 32;
    count += (size_t)blockIdx.y * B;
    scan += (size_t)blockIdx.y * stride;
    const int lg = 5 * lv.K;
    const int start = blockIdx.x << lg, end = min(start + (1 << lg), B);
    __shared__ int part[SCAN_GROUPS * WARPS];  // per (group, warp): its total, then its offset
    __shared__ int carry;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (threadIdx.x == 0) carry = 0;
    for (int g0 = start / 4; 4 * g0 < end; g0 += SCAN_GROUPS * SCAN_THREADS) {
        int4 c[SCAN_GROUPS];
        int inc[SCAN_GROUPS];
#pragma unroll
        for (int k = 0; k < SCAN_GROUPS; ++k) {
            c[k] = load_group(count, g0 + k * SCAN_THREADS + threadIdx.x, end, S, vec);
        }
#pragma unroll
        for (int k = 0; k < SCAN_GROUPS; ++k) {
            inc[k] = warp_incl_scan(c[k].x + c[k].y + c[k].z + c[k].w, lane);
            if (lane == 31) part[k * WARPS + w] = inc[k];
        }
        __syncthreads();
        if (w == 0) {  // exclusive offsets of the (group, warp) totals, in count order
            int t[PER_LANE], sum = 0;
#pragma unroll
            for (int e = 0; e < PER_LANE; ++e) {
                t[e] = part[lane * PER_LANE + e];
                sum += t[e];
            }
            int run = carry;  // read by every lane before lane 31 moves it (the scan syncs the warp)
            run += warp_incl_scan(sum, lane) - sum;
#pragma unroll
            for (int e = 0; e < PER_LANE; ++e) {
                part[lane * PER_LANE + e] = run;
                run += t[e];
            }
            if (lane == 31) carry = run;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < SCAN_GROUPS; ++k) {
            const int g = g0 + k * SCAN_THREADS + threadIdx.x;
            const int b = 4 * g;
            if (b >= end) continue;
            int4 o;
            o.x = part[k * WARPS + w] + inc[k] - (c[k].x + c[k].y + c[k].z + c[k].w);
            o.y = o.x + c[k].x;
            o.z = o.y + c[k].y;
            o.w = o.z + c[k].z;
            if (vec) {
                reinterpret_cast<int4*>(scan)[g] = o;
            } else {
                const int v[4] = {o.x, o.y, o.z, o.w};
                for (int e = 0; e < 4 && b + e < end; ++e) scan[b + e] = v[e];
            }
            for (int k2 = 1; k2 < lv.K && (b & ((1 << 5 * k2) - 1)) == 0; ++k2) {
                scan[lv.off[k2] + (b >> 5 * k2)] = o.x;
            }
        }
        __syncthreads();  // part is reused by the next round
    }
    if (threadIdx.x == 0) totals[blockIdx.y * 32 + blockIdx.x] = carry;
}

// #{lanes i : v_i <= x} of 32 nondecreasing values, one per lane
__device__ __forceinline__ int count_le32(int v, int x) {
    const int v31 = __shfl_sync(FULL, v, 31);
    int n = 0;
    for (int st = 16; st; st >>= 1) {
        if (__shfl_sync(FULL, v, n + st - 1) <= x) n += st;
    }
    return n + (n == 31 && v31 <= x);
}

__device__ __forceinline__ int warp_min(int v) {
    for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

// CTA (x, p) builds the new buckets x·BUILD_BUCKETS .. + BUILD_BUCKETS - 1 of
// partition p, BUCKETS_PER_WARP a warp, a lane per slot; the outputs are
// [P, nb, ...]
__global__ void __launch_bounds__(BUILD_WARPS * 32) reshard_build(
    const uint32_t* __restrict__ grid, const int* __restrict__ floor_, const int* scan,
    const int* totals, uint32_t* __restrict__ pivots, uint32_t* __restrict__ out,
    int* __restrict__ count, int* __restrict__ bmax, int* __restrict__ floor_out,
    int* __restrict__ pressure, int B, int S, int L, int nb, int ns, int stride, Levels lv,
    bool vec) {
    constexpr int G = BUCKETS_PER_WARP;
    __shared__ int s_top[32];     // the chunks' starts in the global order
    __shared__ int win[WIN + 1];  // C[base .. base + WIN], global order
    __shared__ int s_live, s_first, s_base;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int p = blockIdx.y;
    const int b0 = blockIdx.x * BUILD_BUCKETS + warp * G;  // this warp's first bucket
    const int Lp1 = L + 1;
    const int lg = 5 * lv.K;  // counts per chunk: 2^lg
    grid += (size_t)p * B * S * Lp1;
    floor_ += (size_t)p * B;
    scan += (size_t)p * stride;
    if (lane < G && b0 + lane < nb) floor_out[(size_t)p * nb + b0 + lane] = 0;  // folded into the rows
    cudaGridDependencySynchronize();  // reshard_scan has finished

    if (threadIdx.x == 0) s_first = INT_MAX;
    if (warp == 0) {
        const int tot = lane < lv.n_chunks ? __ldcg(totals + p * 32 + lane) : 0;
        const int inc = warp_incl_scan(tot, lane);
        s_top[lane] = lane < lv.n_chunks ? inc - tot : INT_MAX;
        if (lane == 31) s_live = inc;
    }
    __syncthreads();
    const int n_live = s_live;
    const int q = max((int)(((unsigned)n_live + nb - 1) / (unsigned)nb), 1);
    if (blockIdx.x == 0 && threadIdx.x == 0) pressure[p] = n_live > 0 ? min(q, n_live) : 0;
    // C[k] in the global order, n_live at B, no bound past it
    const auto C_at = [&](int k) {
        return k < B ? __ldcg(scan + k) + s_top[k >> lg] : (k == B ? n_live : INT_MAX);
    };
    // bucket b0 + t takes the live ranks (b0 + t)·q .. + m[t] - 1 in slots 0 .. m[t] - 1
    int m[G], cnt[G], bm[G];
#pragma unroll
    for (int t = 0; t < G; ++t) {
        const long long j0 = (long long)(b0 + t) * q;
        m[t] = b0 + t < nb && j0 < n_live ? (int)min((long long)min(q, ns), n_live - j0) : 0;
        cnt[t] = 0;
        bm[t] = INT_MIN;
    }
    // the slots past the live ranks first: sentinel rows (version 0), most of
    // the new grid, stored before any wait on the scan's window
    const uint4 sent4 = make_uint4(FDB_SENTINEL, FDB_SENTINEL, FDB_SENTINEL, 0u);
    for (int s = lane; s < ns; s += 32) {
#pragma unroll
        for (int t = 0; t < G; ++t) {
            if (s < m[t] || b0 + t >= nb) continue;
            const size_t w = (size_t)p * nb + b0 + t;
            uint32_t* dst = out + (w * ns + s) * Lp1;
            if (vec) {
                *reinterpret_cast<uint4*>(dst) = sent4;
            } else {
                for (int i = 0; i < L; ++i) dst[i] = FDB_SENTINEL;
                dst[L] = 0u;
            }
            if (s == 0) {
                for (int i = 0; i < L; ++i) pivots[w * L + i] = FDB_SENTINEL;
            }
            bm[t] = max(bm[t], 0);
        }
    }
    for (int s0 = 0; s0 < ns; s0 += 32) {
        const int s = s0 + lane;
        int j[G], src_b[G], src_s[G];  // the rank of slot s, its row in the old grid
        bool done[G];
#pragma unroll
        for (int t = 0; t < G; ++t) {
            done[t] = s >= m[t];
            j[t] = done[t] ? 0 : (b0 + t) * q + s;
            src_b[t] = src_s[t] = 0;
        }
        // rounds: a window of C from the source bucket of the CTA's first
        // unplaced rank; each lane places the ranks it holds there
        for (;;) {
            int mine = INT_MAX;
#pragma unroll
            for (int t = 0; t < G; ++t) mine = done[t] ? mine : min(mine, j[t]);
            mine = warp_min(mine);
            if (lane == 0 && mine != INT_MAX) atomicMin(&s_first, mine);
            __syncthreads();
            const int jf = s_first;
            if (jf == INT_MAX) break;  // (every thread has read s_first: it is reset after the next barrier)
            if (warp == 0) {
                // a 32-ary descent to the 32-bucket tile holding jf's source
                // bucket: its chunk, then the sampled levels down to level 1
                // (one coalesced load at the bench's B)
                int i = count_le32(s_top[lane], jf) - 1;
                const int pre = s_top[i];
                for (int k = lv.K - 1; k >= 1; --k) {
                    const int e = i * 32 + lane;
                    const bool le = e < lv.len[k] && __ldcg(scan + lv.off[k] + e) + pre <= jf;
                    i = i * 32 + __popc(__ballot_sync(FULL, le)) - 1;
                }
                if (lane == 0) s_base = i * 32;
            }
            __syncthreads();
            const int base = s_base;
            {  // every load of the window in flight at once
                constexpr int R = (WIN + BUILD_WARPS * 32) / (BUILD_WARPS * 32);
                int v[R];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int k = r * BUILD_WARPS * 32 + threadIdx.x;
                    v[r] = k <= WIN ? C_at(base + k) : 0;
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int k = r * BUILD_WARPS * 32 + threadIdx.x;
                    if (k <= WIN) win[k] = v[r];
                }
            }
            if (threadIdx.x == 0) s_first = INT_MAX;  // for the next round
            __syncthreads();
            const int end = win[WIN];  // > jf: the run ends inside the window
            // c = #{1 <= k < WIN : win[k] <= j} by fixed steps, the G searches
            // interleaved; win[0] <= j < win[WIN] puts j in bucket base + c
            int c[G] = {};
#pragma unroll
            for (int st = WIN / 2; st; st >>= 1) {
#pragma unroll
                for (int t = 0; t < G; ++t) c[t] += win[c[t] + st] <= j[t] ? st : 0;
            }
#pragma unroll
            for (int t = 0; t < G; ++t) {
                if (done[t] || j[t] >= end) continue;
                src_b[t] = base + c[t];
                src_s[t] = j[t] - win[c[t]];
                done[t] = true;
            }
        }
        // the live slots: rows folded with their source bucket's floor; at
        // L + 1 == 4 the G rows and floors are loaded before any store
        uint4 rv[G];
        int fv[G];
#pragma unroll
        for (int t = 0; t < G; ++t) {
            const bool have = s < m[t];
            rv[t] = vec && have
                ? __ldg(reinterpret_cast<const uint4*>(grid + ((size_t)src_b[t] * S + src_s[t]) * Lp1))
                : sent4;
            fv[t] = have ? __ldg(floor_ + src_b[t]) : 0;
        }
#pragma unroll
        for (int t = 0; t < G; ++t) {
            const size_t w = (size_t)p * nb + b0 + t;
            bool row = false;
            if (s < m[t]) {
                const uint32_t* src = grid + ((size_t)src_b[t] * S + src_s[t]) * Lp1;
                uint32_t* dst = out + (w * ns + s) * Lp1;
                int ver;
                if (vec) {
                    uint4 v = rv[t];
                    if (s == 0) {
                        pivots[w * L] = v.x;
                        pivots[w * L + 1] = v.y;
                        pivots[w * L + 2] = v.z;
                    }
                    row = !(v.x == FDB_SENTINEL && v.y == FDB_SENTINEL && v.z == FDB_SENTINEL);
                    ver = row ? max((int)v.w, fv[t]) : 0;
                    v.w = (uint32_t)ver;
                    *reinterpret_cast<uint4*>(dst) = v;
                } else {
                    bool sent = true;
                    for (int i = 0; i < L; ++i) {
                        const uint32_t x = __ldg(src + i);
                        sent &= x == FDB_SENTINEL;
                        dst[i] = x;
                        if (s == 0) pivots[w * L + i] = x;
                    }
                    row = !sent;
                    ver = row ? max((int)__ldg(src + L), fv[t]) : 0;
                    dst[L] = (uint32_t)ver;
                }
                bm[t] = max(bm[t], ver);
            }
            cnt[t] += __popc(__ballot_sync(FULL, row));
        }
    }
#pragma unroll
    for (int t = 0; t < G; ++t) {
        const int v = warp_max(bm[t]);
        if (lane == 0 && b0 + t < nb) {
            count[(size_t)p * nb + b0 + t] = cnt[t];
            bmax[(size_t)p * nb + b0 + t] = v;
        }
    }
}

// ---- rebase ---------------------------------------------------------------

constexpr int REBASE_THREADS = 256;
constexpr int REBASE_VECS = 4;  // 16-byte elements in flight per thread
constexpr int REBASE_WORDS = REBASE_THREADS * REBASE_VECS * 4;  // words a CTA aims at

// element e (words 4e .. 4e + 3, the last one cut at nw) of a CTA's words
__device__ __forceinline__ uint4 load4(const uint32_t* p, int e, int nw, bool vec) {
    if (vec && 4 * e + 4 <= nw) return __ldg(reinterpret_cast<const uint4*>(p) + e);
    uint32_t w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = 4 * e + c < nw ? __ldg(p + 4 * e + c) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// plain stores: the next batch reads the new grid, and streaming ones
// (__stcs, evict first) were slower on the H100 (PERF.md)
__device__ __forceinline__ void store4(uint32_t* p, int e, int nw, bool vec, uint4 v) {
    if (vec && 4 * e + 4 <= nw) {
        reinterpret_cast<uint4*>(p)[e] = v;
        return;
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (4 * e + c < nw) p[4 * e + c] = w[c];
    }
}

// s_max[key] = max(s_max[key], m) for the warp's (key, m) pairs; keys are
// non-decreasing over the lanes, so equal keys are neighbours: one
// reduction when the warp holds one bucket (the bench), else a segmented
// max scan and an atomic from each run's last lane
__device__ __forceinline__ void bucket_max(int* s_max, int key, int m, int lane) {
    const int k0 = __shfl_sync(FULL, key, 0);
    if (__all_sync(FULL, key == k0)) {
        m = __reduce_max_sync(FULL, m);
        if (lane == 0 && m > 0) atomicMax(s_max + k0, m);
        return;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int kk = __shfl_up_sync(FULL, key, off), mm = __shfl_up_sync(FULL, m, off);
        if (lane >= off && kk == key) m = max(m, mm);
    }
    const int kn = __shfl_down_sync(FULL, key, 1);
    if (m > 0 && (lane == 31 || kn != key)) atomicMax(s_max + key, m);
}

// a CTA rebases buckets b0 .. b0 + bpc - 1: their words are one contiguous
// run (w0 a multiple of 4), walked as 16-byte elements, REBASE_VECS loads
// in flight per thread before the first store. ROW4: L = 3, an element is
// one slot row and .w its version
template <bool ROW4>
__global__ void __launch_bounds__(REBASE_THREADS) rebase_kernel(
    const uint32_t* __restrict__ grid, const int* __restrict__ count,
    const int* __restrict__ floor_, uint32_t* __restrict__ out,
    int* __restrict__ bmax_out, int* __restrict__ floor_out,
    int delta, int B, int S, int L, int bpc, bool vec) {
    extern __shared__ int sh[];  // [bpc] counts, then [bpc] bucket maxima
    int* s_cnt = sh;
    int* s_max = sh + bpc;
    const int Lp1 = L + 1, lane = threadIdx.x & 31;
    const int b0 = blockIdx.x * bpc, nb = min(bpc, B - b0);
    const size_t w0 = (size_t)b0 * S * Lp1;
    const int nw = nb * S * Lp1, ne = (nw + 3) / 4;
    const uint32_t* src = grid + w0;
    uint32_t* dst = out + w0;
    const uint32_t ud = (uint32_t)delta;  // int32 wrap-around, as the plain version's
    for (int x = threadIdx.x; x < nb; x += blockDim.x) {
        s_cnt[x] = count[b0 + x];
        s_max[x] = 0;
    }
    for (int e0 = 0; e0 < ne; e0 += REBASE_THREADS * REBASE_VECS) {
        uint4 v[REBASE_VECS];
#pragma unroll
        for (int k = 0; k < REBASE_VECS; ++k) {
            const int e = e0 + k * REBASE_THREADS + threadIdx.x;
            if (e < ne) v[k] = load4(src, e, nw, vec);
        }
        if (e0 == 0) __syncthreads();  // the counts are in shared memory
#pragma unroll
        for (int k = 0; k < REBASE_VECS; ++k) {
            const int e = e0 + k * REBASE_THREADS + threadIdx.x;
            // the element's last bucket with a version word (else its
            // first) and its largest new version there
            int key = INT_MAX, m = 0;
            if (e < ne) {
                if (ROW4) {
                    const int lb = e / S, s = e - lb * S;
                    m = s < s_cnt[lb] ? max((int)(v[k].w - ud), 0) : 0;
                    v[k].w = (uint32_t)m;
                    key = lb;
                } else {
                    const int row = 4 * e / Lp1;
                    int off = 4 * e - row * Lp1, lb = row / S, s = row - lb * S;
                    uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
                    key = lb;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        if (off == L && 4 * e + c < nw) {
                            const int ver = s < s_cnt[lb] ? max((int)(w[c] - ud), 0) : 0;
                            w[c] = (uint32_t)ver;
                            if (lb != key) {  // a second bucket in this element
                                if (m > 0) atomicMax(s_max + key, m);
                                key = lb;
                                m = ver;
                            } else {
                                m = max(m, ver);
                            }
                        }
                        if (++off == Lp1) {
                            off = 0;
                            if (++s == S) s = 0, ++lb;
                        }
                    }
                    v[k] = make_uint4(w[0], w[1], w[2], w[3]);
                }
                store4(dst, e, nw, vec, v[k]);
            }
            bucket_max(s_max, key, m, lane);
        }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < nb; x += blockDim.x) {
        const int fl = max((int)((uint32_t)floor_[b0 + x] - ud), 0);
        floor_out[b0 + x] = fl;
        bmax_out[b0 + x] = max(s_max[x], fl);
    }
}

}  // namespace

// P stacked grids of B buckets × S slots (P = 1: a single grid) into P
// grids of nb × ns; ``scan`` [P, stride] and ``totals`` [P, 32] are scratch
extern "C" int fdb_reshard(
    const void* grid, const void* count, const void* floor_, void* scan, void* totals,
    void* pivots, void* out, void* count_out, void* bmax, void* floor_out, void* pressure, int P,
    int B, int S, int L, int nb, int ns, int stride, void* stream) {
    const Levels lv = scan_levels(B);
    if (P < 1 || B < 1 || S < 1 || L < 1 || nb < 1 || ns < 1 || lv.K >= MAX_LEVELS
        || stride < lv.off[lv.K - 1] + lv.len[lv.K - 1]) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec_scan = B % 4 == 0 && stride % 4 == 0 && (uintptr_t)count % 16 == 0
                          && (uintptr_t)scan % 16 == 0;
    reshard_scan<<<dim3(lv.n_chunks, P), SCAN_THREADS, 0, st>>>(
        (const int*)count, (int*)scan, (int*)totals, B, S, stride, lv, vec_scan);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    // launched behind reshard_scan without waiting for its end
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((nb + BUILD_BUCKETS - 1) / BUILD_BUCKETS, P);
    cfg.blockDim = dim3(BUILD_WARPS * 32);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const bool vec = L == 3 && (uintptr_t)grid % 16 == 0 && (uintptr_t)out % 16 == 0;
    err = cudaLaunchKernelEx(
        &cfg, reshard_build, (const uint32_t*)grid, (const int*)floor_, (const int*)scan,
        (const int*)totals, (uint32_t*)pivots, (uint32_t*)out, (int*)count_out, (int*)bmax,
        (int*)floor_out, (int*)pressure, B, S, L, nb, ns, stride, lv, vec);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// B buckets of S slots × (L + 1) words (P stacked grids as one of P·B)
extern "C" int fdb_rebase(
    const void* grid, const void* count, const void* floor_, void* out,
    void* bmax_out, void* floor_out, int delta, int B, int S, int L,
    void* stream) {
    if (B < 0 || S < 1 || L < 1) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    // buckets per CTA: a multiple of 4, so every CTA starts 16-byte aligned
    const int bpc = max(4, (REBASE_WORDS / (S * (L + 1))) & ~3);
    const bool vec = (uintptr_t)grid % 16 == 0 && (uintptr_t)out % 16 == 0;
    const size_t smem = 2 * (size_t)bpc * sizeof(int);
    auto kernel = L == 3 ? rebase_kernel<true> : rebase_kernel<false>;
    kernel<<<(B + bpc - 1) / bpc, REBASE_THREADS, smem, st>>>(
        (const uint32_t*)grid, (const int*)count, (const int*)floor_, (uint32_t*)out,
        (int*)bmax_out, (int*)floor_out, delta, B, S, L, bpc, vec);
    return (int)cudaGetLastError();
}
