// Blocked rational-Bloom kernels for Hopper (sm_90a): K1-K4 of the
// video codec's main path, and K5a/K5b of its multi-device programs.
//
// Each kernel replaces one Pallas kernel of
// new_bloom_filter_repo_tpu/ops/pallas/blocked.py:
//
//   K1  nbf_k1_encode        <- blocked_encode_h     (_encode_kernel_h)
//   K2  nbf_k2_membership    <- blocked_membership_h (_member_kernel_h)
//   K3  nbf_k3_expand_chain  <- blocked_expand_chain (_expand_chain_kernel)
//   K4  nbf_k4_expand        <- blocked_expand       (_expand_kernel)
//   K5a nbf_k5a_encode       <- blocked_encode       (_encode_kernel)
//   K5b nbf_k5b_membership   <- blocked_membership   (_member_kernel)
//
// The work is integer bit manipulation over 1024-item blocks: each item
// is read and written once, so the least time the card could take is
// set by device-memory bytes.  The kernels keep everything a block needs
// between its passes (the <= 12 sub-filter words, the 32 witness words,
// warp counts, compacted values) in shared memory, so no intermediate
// touches device memory.  What holds K1 and K2 back is instruction issue
// and latency (K1 most of all its per-item work on changed items), not
// bytes; K3 and K4 come closer to their bytes (PERF.md).
//
// K1/K2 and K5a/K5b (encode_frames, membership_frames).  One CTA of 256
// threads owns one block and a group of up to GMAX frames, and walks
// them in a loop; each thread owns IPT = 4 consecutive items.  What
// this buys against one item per thread and one CTA per (block, frame):
//
// * the hash tables (h1, h2 and the activation halves, 16 B an item)
//   are read once per launch, not once per frame: a 1080p chunk of 15
//   frames walks all its frames in one CTA per block (the wrapper picks
//   the group so the grid still holds about 8 CTAs per SM at small NB);
// * the per-frame scalars (m, a reciprocal of m, the threshold, floor
//   k) are staged once in shared memory, and K2 stages all the sub-
//   filter words of its frames up front (GMAX x 12 words);
// * loads and stores are vectors: uchar4 bits and passes, int4 tables,
//   values and value segments, one u32 per witness word; K1 loads the
//   next frame's bits a frame ahead;
// * `h mod m` is a multiply-high by the frame's reciprocal and one
//   conditional subtract (mod_rcp), in place of a 32-bit `%` per item;
// * ranks come from the thread's own counts, one warp scan (the pass
//   and change counts packed in one int) and a warp reduction of the 8
//   warp totals: K1 passes 2 barriers per (block, frame), K2 none.
//
// K5a/K5b are the same bodies fed with materialized per-frame tables
// a = h1 mod m, b = h2 mod m and act (uint8), which the caller built
// (models/blocked_pipeline._frame_mod_tables): only the per-item
// (a, b, act) come from global memory, per frame, instead of the hash
// prelude.  They read ~9 B per item per frame more than K1/K2.
//
// K3/K4 (expand_frames) take the same shape: a CTA of 256 threads walks
// one block through its frames (K3 all of them, chaining the running
// pixels; K4 a group), 4 items a thread, ranks by warp scans, witness
// bits by funnel shifts of words held one a lane, values staged in
// shared memory, the next frame's loads issued a frame ahead.
//
// What the TPU kernels needed and these do not: Mosaic had no scatter
// and no integer divide, so the Pallas code routed compaction through a
// butterfly network, folded packed words with static rolls and took
// `h mod m` through an f32 reciprocal.  Here the ranks come from warp
// scans (or __ballot_sync + __popc), compaction is a direct scatter to
// the item's rank, and `h mod m` an integer multiply-high.
//
// Bit conventions (the stream's): sub-filter bit p is bit 31 - (p & 31)
// of u32 word p >> 5 (np.packbits order per word); witness bit r is bit
// 7 - (r & 7) of byte r >> 3, i.e. MSB-first, which equals big-endian
// u32 words.  The u64 activation test is an unsigned compare of
// (act_hi, act_lo) against (thi, tlo), high halves first.
//
// Every entry point is a plain C function: it launches on the stream it
// is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// The per-item arrays, witness and value segments must be 16-byte
// aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IPB = 1024;         // items per block
constexpr int NW = 12;            // max u32 sub-filter words per block
constexpr int WW = IPB / 32;      // witness u32 words per block
constexpr int WIT_BYTES = IPB / 8;
constexpr unsigned FULL = 0xffffffffu;

constexpr int IPT = 4;                // items per thread
constexpr int THREADS = IPB / IPT;    // threads per CTA
constexpr int WARPS = THREADS / 32;
// Most frames one CTA walks; defined once, by ops/_build.py, which also
// gives it to the wrappers that choose the frame groups.
#ifndef NBF_GMAX
#error "build with -DNBF_GMAX=<frames> (ops/_build.py)"
#endif
constexpr int GMAX = NBF_GMAX;
// CTAs an SM must hold: caps registers at 64 a thread, without spills.
// K1 is bound by latency, not by its bytes, and runs faster with this
// occupancy than with the registers ptxas gives it uncapped (2 CTAs an
// SM).
constexpr int MIN_CTAS = 4;

// ---------------------------------------------------------------------------
// K1, K2, K5a, K5b
// ---------------------------------------------------------------------------

// h mod m for any u32 h and m >= 1, given rcp = floor((2^32 - 1) / m).
// Exact with one correction: rcp * m = 2^32 - 1 - e with 0 <= e < m, so
// h * rcp / 2^32 = h/m - d with d = h (1 + e) / (m 2^32) <= h / 2^32 < 1;
// the quotient umulhi(h, rcp) is floor(h/m) or one less, and h - q m
// lies in [0, 2m).  (The tables hold h < 2^24 and the stream m = 1 or
// 16..384, well inside; tests/test_torch_kernels.py checks the recipe
// against `%` over every h < 2^24.)
__device__ __forceinline__ uint32_t mod_rcp(uint32_t h, uint32_t m,
                                            uint32_t rcp) {
    const uint32_t r = h - __umulhi(h, rcp) * m;
    return r >= m ? r - m : r;
}

// Per-frame scalars, staged in shared memory by the CTA.  Lane j of an
// item (0 <= j < nl) is active when j < det, or when the item's
// activation test fired (then j == det: the fractional lane).
struct Frame {
    uint32_t m, rcp, thi, tlo;
    int det, nl, flag;
};

struct FrameArgs {
    const int32_t* m;
    const int32_t* thi;      // null for K5a/K5b
    const int32_t* tlo;
    const int32_t* fk;
    const int32_t* flags;    // null for K1/K5a
};

__device__ __forceinline__ Frame stage_frame(const FrameArgs& fa, int f,
                                             int k_lanes) {
    Frame fr;
    fr.m = (uint32_t)fa.m[f];
    fr.rcp = fr.m ? 0xffffffffu / fr.m : 0u;   // once per frame and CTA
    fr.thi = fa.thi ? (uint32_t)fa.thi[f] : 0u;
    fr.tlo = fa.tlo ? (uint32_t)fa.tlo[f] : 0u;
    const int fk = fa.fk[f];
    fr.det = min(max(fk, 0), k_lanes + 1);
    fr.nl = fr.det + ((fk >= 0 && fk <= k_lanes) ? 1 : 0);
    fr.flag = fa.flags ? (fa.flags[f] != 0) : 0;
    return fr;
}

__device__ __forceinline__ void load4(const int32_t* __restrict__ p,
                                      size_t quad, uint32_t out[IPT]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + quad);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// K1/K2's items: the thread's four items' hash tables, read once per
// launch and kept in registers; per frame, a = h1 mod m, b = h2 mod m
// and the activation test against the frame's threshold.
struct HashItems {
    uint32_t h1[IPT], h2[IPT], hi[IPT], lo[IPT];

    __device__ HashItems(const int32_t* __restrict__ t1,
                         const int32_t* __restrict__ t2,
                         const int32_t* __restrict__ thi,
                         const int32_t* __restrict__ tlo, size_t quad) {
        load4(t1, quad, h1);
        load4(t2, quad, h2);
        load4(thi, quad, hi);
        load4(tlo, quad, lo);
    }

    __device__ __forceinline__ void frame(const Frame& fr, size_t,
                                          uint32_t a[IPT], uint32_t b[IPT],
                                          bool act[IPT]) const {
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            a[i] = mod_rcp(h1[i], fr.m, fr.rcp);
            b[i] = mod_rcp(h2[i], fr.m, fr.rcp);
            act[i] = hi[i] < fr.thi || (hi[i] == fr.thi && lo[i] < fr.tlo);
        }
    }
};

// K5a/K5b's items: (a, b, act) of each frame, read from the
// materialized (F, NB, 1024) tables.
struct ModItems {
    const int32_t* a;
    const int32_t* b;
    const uint8_t* act;

    __device__ __forceinline__ void frame(const Frame&, size_t quad,
                                          uint32_t a_[IPT], uint32_t b_[IPT],
                                          bool act_[IPT]) const {
        load4(a, quad, a_);
        load4(b, quad, b_);
        const uchar4 v = reinterpret_cast<const uchar4*>(act)[quad];
        act_[0] = v.x != 0; act_[1] = v.y != 0;
        act_[2] = v.z != 0; act_[3] = v.w != 0;
    }
};

// Word of sub-filter bit `pos`, or 0 past `cap` where CHECKED.  Rows
// hold NW words, zero past the filter's nw, so a frame with m <= 32 NW
// (every frame of a stream) needs no check: its positions stay in the
// row and those at or past cap read zero words.
template <bool CHECKED>
__device__ __forceinline__ uint32_t word_at(const uint32_t* filt,
                                            uint32_t pos, uint32_t cap) {
    return (!CHECKED || pos < cap) ? filt[pos >> 5] : 0u;
}

__device__ __forceinline__ uint32_t step(uint32_t pos, uint32_t b,
                                         uint32_t m) {
    pos += b;
    return pos >= m ? pos - m : pos;
}

// Membership of the thread's four items in the sub-filter `filt`
// (shared words): every deterministic lane's bit, and the fractional
// lane's where the item's activation test fired.  Bit pos of a word is
// its top bit after a left shift by pos & 31 (the funnel shift's wrap).
// a, b < m.
template <bool CHECKED>
__device__ __forceinline__ void member4(const uint32_t* filt,
                                        const uint32_t a[IPT],
                                        const uint32_t b[IPT],
                                        const bool act[IPT], const Frame& fr,
                                        uint32_t cap, bool pass[IPT]) {
    uint32_t pos[IPT], acc[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        pos[i] = a[i];
        acc[i] = FULL;
    }
    for (int j = 0; j < fr.det; ++j) {
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            acc[i] &= __funnelshift_l(
                0u, word_at<CHECKED>(filt, pos[i], cap), pos[i]);
            pos[i] = step(pos[i], b[i], fr.m);
        }
    }
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        if (fr.nl > fr.det && act[i]) {
            acc[i] &= __funnelshift_l(
                0u, word_at<CHECKED>(filt, pos[i], cap), pos[i]);
        }
        pass[i] = (int32_t)acc[i] < 0;
    }
}

__device__ __forceinline__ void member4(const uint32_t* filt,
                                        const uint32_t a[IPT],
                                        const uint32_t b[IPT],
                                        const bool act[IPT], const Frame& fr,
                                        uint32_t cap, bool pass[IPT]) {
    if (fr.m <= 32u * NW) {
        member4<false>(filt, a, b, act, fr, cap, pass);
    } else {
        member4<true>(filt, a, b, act, fr, cap, pass);
    }
}

struct EncodeOut {
    int32_t* words;
    uint8_t* wit;
    int32_t* wcnt;
    int32_t* vseg;
    int32_t* vcnt;
};

// Witness segment, value segment and counts of one encoded (block,
// frame) from the CTA's shared buffers: big-endian witness words, the
// compacted values with zeros past vcnt.
__device__ __forceinline__ void write_frame(const EncodeOut& out,
                                            size_t row, const uint32_t* witw,
                                            const int32_t* vbuf, int npass,
                                            int nchg, int vslots) {
    const int t = threadIdx.x;
    if (t < WW) {
        reinterpret_cast<uint32_t*>(out.wit + row * WIT_BYTES)[t] =
            __byte_perm(witw[t], 0u, 0x0123);
    }
    for (int i = IPT * t; i < vslots; i += IPB) {
        const int4 q = *reinterpret_cast<const int4*>(vbuf + i);
        const int4 o = make_int4(i < nchg ? q.x : 0, i + 1 < nchg ? q.y : 0,
                                 i + 2 < nchg ? q.z : 0,
                                 i + 3 < nchg ? q.w : 0);
        reinterpret_cast<int4*>(out.vseg + row * vslots)[i / IPT] = o;
    }
    if (t == 0) {
        out.wcnt[row] = npass;
        out.vcnt[row] = nchg;
    }
}

// Bloom encode of one block over the CTA's frames (K1, K5a): per frame,
// OR-insert of the changed items into the shared sub-filter, membership
// of every item, witness bits of the passing items at their rank,
// values of the changed items compacted to their rank, the two counts.
// Two barriers a frame: the filter is complete (which also completes
// the previous frame's witness and values, written out right after it
// from the other half of the double buffers); the warp totals are in.
// The sub-filter is double-buffered too: frame g inserts into and reads
// filt[g & 1], and clears filt[(g + 1) & 1] between its two barriers,
// after frame g - 1's last read of it (before g - 1's second barrier)
// and before frame g + 1's first insert (after g's second barrier).
// The frame loop is unrolled by two so that the buffer parity P is a
// constant and every shared address static.  The next frame's change
// bits are loaded a frame ahead.
struct EncodeSmem {
    int32_t vbuf[2][IPB];        // first, so 16-byte aligned
    uint32_t witw[2][WW];
    uint32_t filt[2][NW];
    Frame frs[GMAX];
    int wtot[WARPS];
};

// What a thread carries from one frame to the next.
struct EncodeCarry {
    size_t quad;                 // its first item's quad in this frame
    uchar4 c4;                   // this frame's change bits
    int npass, nchg;             // the previous frame's counts
};

template <int P, class Items>
__device__ __forceinline__ void encode_frame(
        EncodeSmem& sh, EncodeCarry& c, const Items& items,
        const uint8_t* __restrict__ bits, const int32_t* __restrict__ vals,
        const EncodeOut& out, int g, int nfr, size_t row, size_t stride,
        int nb, uint32_t cap, int nw, int vslots) {
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const Frame fr = sh.frs[g];
    const uchar4 c4 = c.c4;
    const bool chg[IPT] = {c4.x != 0, c4.y != 0, c4.z != 0, c4.w != 0};
    const int nc = chg[0] + chg[1] + chg[2] + chg[3];
    int4 v4 = make_int4(0, 0, 0, 0);
    if (nc) v4 = __ldg(reinterpret_cast<const int4*>(vals) + c.quad);
    if (g + 1 < nfr)
        c.c4 = reinterpret_cast<const uchar4*>(bits)[c.quad + stride];
    uint32_t a[IPT], b[IPT];
    bool act[IPT];
    items.frame(fr, c.quad, a, b, act);
    if (nc) {                                           // OR-insert
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            if (!chg[i]) continue;
            uint32_t pos = a[i];
            for (int j = 0; j < fr.nl; ++j) {
                if ((j < fr.det || act[i]) && pos < cap) {
                    atomicOr(&sh.filt[P][pos >> 5],
                             0x80000000u >> (pos & 31u));
                }
                pos = step(pos, b[i], fr.m);
            }
        }
    }
    __syncthreads();                // filt; the previous frame's buffers

    if (g > 0) {
        write_frame(out, row - nb, sh.witw[P ^ 1], sh.vbuf[P ^ 1], c.npass,
                    c.nchg, vslots);
    }
    if (t < WW) sh.witw[P][t] = 0u;
    if (t < NW) sh.filt[P ^ 1][t] = 0u;                 // the next frame's
    if (t < nw) out.words[row * nw + t] = (int32_t)sh.filt[P][t];
    bool pass[IPT];
    member4(sh.filt[P], a, b, act, fr, cap, pass);
    const int np = pass[0] + pass[1] + pass[2] + pass[3];
    // Ranks in item order: pass counts in the low 16 bits, change counts
    // in the high 16 (each at most 1024, so no carry).
    const int own = np | (nc << 16);
    int incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += n;
    }
    if (lane == 31) sh.wtot[warp] = incl;
    __syncthreads();                                    // warp totals

    const int wv = lane < WARPS ? sh.wtot[lane] : 0;
    const int total = __reduce_add_sync(FULL, wv);
    const int before = __reduce_add_sync(FULL, lane < warp ? wv : 0);
    c.npass = total & 0xffff;
    c.nchg = total >> 16;
    if (nc) {           // witness bits and values of the changed items
        const int excl = before + incl - own;
        int r = excl & 0xffff;
        int s = excl >> 16;
        const int32_t vv[IPT] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            if (pass[i]) {
                if (chg[i])
                    atomicOr(&sh.witw[P][r >> 5], 0x80000000u >> (r & 31));
                ++r;
            }
            if (chg[i]) {
                if (s < vslots) sh.vbuf[P][s] = vv[i];
                ++s;
            }
        }
    }
    c.quad += stride;
}

template <class Items>
__device__ __forceinline__ void encode_frames(
        const Items& items, const uint8_t* __restrict__ bits,
        const int32_t* __restrict__ vals, const FrameArgs& fa,
        const EncodeOut& out, int nf, int nb, int k_lanes, int nw,
        int vslots, int fpc) {
    __shared__ __align__(16) EncodeSmem sh;
    const int t = threadIdx.x;
    const int blk = blockIdx.x;
    const int f0 = blockIdx.y * fpc;
    const int nfr = min(fpc, nf - f0);
    const uint32_t cap = 32u * (uint32_t)nw;
    const size_t stride = (size_t)nb * THREADS;     // quads per frame
    if (t < nfr) sh.frs[t] = stage_frame(fa, f0 + t, k_lanes);
    if (t < NW) sh.filt[0][t] = 0u;
    EncodeCarry c;
    c.quad = ((size_t)f0 * nb + blk) * THREADS + t;
    c.c4 = reinterpret_cast<const uchar4*>(bits)[c.quad];
    c.npass = c.nchg = 0;
    __syncthreads();

    for (int g = 0; g < nfr; g += 2) {
        encode_frame<0>(sh, c, items, bits, vals, out, g, nfr,
                        (size_t)(f0 + g) * nb + blk, stride, nb, cap, nw,
                        vslots);
        if (g + 1 < nfr) {
            encode_frame<1>(sh, c, items, bits, vals, out, g + 1, nfr,
                            (size_t)(f0 + g + 1) * nb + blk, stride, nb, cap,
                            nw, vslots);
        }
    }
    __syncthreads();
    const int p = (nfr - 1) & 1;
    write_frame(out, (size_t)(f0 + nfr - 1) * nb + blk, sh.witw[p],
                sh.vbuf[p], c.npass, c.nchg, vslots);
}

// Decode pass mask of one block over the CTA's frames (K2, K5b), with
// the per-block pass count summed by warp reductions into shared
// counters; flagged frames pass nothing.  No barrier inside the loop.
template <class Items>
__device__ __forceinline__ void membership_frames(
        const Items& items, const int32_t* __restrict__ words, int wstride,
        const FrameArgs& fa, uint8_t* __restrict__ passes,
        int32_t* __restrict__ wcnt, int nf, int nb, int k_lanes, int nw,
        int fpc) {
    __shared__ Frame frs[GMAX];
    __shared__ uint32_t filt[GMAX][NW];
    __shared__ int cnt[GMAX];
    const int t = threadIdx.x;
    const int blk = blockIdx.x;
    const int f0 = blockIdx.y * fpc;
    const int nfr = min(fpc, nf - f0);
    const uint32_t cap = 32u * (uint32_t)nw;
    if (t < nfr) {
        frs[t] = stage_frame(fa, f0 + t, k_lanes);
        cnt[t] = 0;
    }
    for (int i = t; i < nfr * NW; i += THREADS) {
        const int g = i / NW;
        const int w = i - g * NW;
        filt[g][w] = w < nw
            ? (uint32_t)words[((size_t)(f0 + g) * nb + blk) * wstride + w]
            : 0u;
    }
    __syncthreads();

    for (int g = 0; g < nfr; ++g) {
        const Frame fr = frs[g];
        const size_t quad = ((size_t)(f0 + g) * nb + blk) * THREADS + t;
        uchar4 o = make_uchar4(0, 0, 0, 0);
        int np = 0;
        if (!fr.flag) {
            uint32_t a[IPT], b[IPT];
            bool act[IPT], pass[IPT];
            items.frame(fr, quad, a, b, act);
            member4(filt[g], a, b, act, fr, cap, pass);
            o = make_uchar4(pass[0], pass[1], pass[2], pass[3]);
            np = pass[0] + pass[1] + pass[2] + pass[3];
        }
        reinterpret_cast<uchar4*>(passes)[quad] = o;
        np = __reduce_add_sync(FULL, np);
        if ((t & 31) == 0 && np) atomicAdd(&cnt[g], np);
    }
    __syncthreads();
    if (t < nfr) wcnt[(size_t)(f0 + t) * nb + blk] = cnt[t];
}

// K1: grid = (NB, frame groups of fpc), block = THREADS.
__global__ void __launch_bounds__(THREADS, MIN_CTAS) k1_encode(
        const uint8_t* __restrict__ bits, const int32_t* __restrict__ h1,
        const int32_t* __restrict__ h2, const int32_t* __restrict__ act_hi,
        const int32_t* __restrict__ act_lo, const int32_t* __restrict__ vals,
        FrameArgs fa, EncodeOut out, int nf, int nb, int k_lanes, int nw,
        int vslots, int fpc) {
    const HashItems items(h1, h2, act_hi, act_lo,
                          (size_t)blockIdx.x * THREADS + threadIdx.x);
    encode_frames(items, bits, vals, fa, out, nf, nb, k_lanes, nw, vslots,
                  fpc);
}

// K5a: K1 on materialized (F, NB, 1024) a, b and act.
__global__ void __launch_bounds__(THREADS, MIN_CTAS) k5a_encode(
        const uint8_t* __restrict__ bits, ModItems items,
        const int32_t* __restrict__ vals, FrameArgs fa, EncodeOut out,
        int nf, int nb, int k_lanes, int nw, int vslots, int fpc) {
    encode_frames(items, bits, vals, fa, out, nf, nb, k_lanes, nw, vslots,
                  fpc);
}

// K2: grid = (NB, frame groups of fpc), block = THREADS.
__global__ void __launch_bounds__(THREADS, MIN_CTAS) k2_membership(
        const int32_t* __restrict__ words, int wstride,
        const int32_t* __restrict__ h1, const int32_t* __restrict__ h2,
        const int32_t* __restrict__ act_hi,
        const int32_t* __restrict__ act_lo, FrameArgs fa,
        uint8_t* __restrict__ passes, int32_t* __restrict__ wcnt, int nf,
        int nb, int k_lanes, int nw, int fpc) {
    const HashItems items(h1, h2, act_hi, act_lo,
                          (size_t)blockIdx.x * THREADS + threadIdx.x);
    membership_frames(items, words, wstride, fa, passes, wcnt, nf, nb,
                      k_lanes, nw, fpc);
}

// K5b: K2 on materialized (F, NB, 1024) a, b and act.
__global__ void __launch_bounds__(THREADS, MIN_CTAS) k5b_membership(
        const int32_t* __restrict__ words, int wstride, ModItems items,
        FrameArgs fa, uint8_t* __restrict__ passes,
        int32_t* __restrict__ wcnt, int nf, int nb, int k_lanes, int nw,
        int fpc) {
    membership_frames(items, words, wstride, fa, passes, wcnt, nf, nb,
                      k_lanes, nw, fpc);
}

// ---------------------------------------------------------------------------
// K3, K4
// ---------------------------------------------------------------------------

// K3 and K4 (expand_frames).  One CTA of 256 threads walks one block
// through a run of frames, 4 consecutive items a thread, like K1/K2:
//
// * the thread's passes (or, on a flagged frame, raw mask bytes) come
//   as one uchar4, the block's 32 witness words as one u32 a lane (each
//   warp loads all 32), the value segment as one int4 a thread, staged
//   in shared memory; a frame's loads are issued before the previous
//   frame's scans, so the walk overlaps memory with work;
// * ranks come from a warp scan of the thread's counts and a warp
//   reduction of the 8 warp totals: one barrier a scan, two a frame
//   (one on a flagged frame, which needs no pass ranks);
// * a thread's passing items have consecutive ranks r0.., so their
//   witness bits are the top bits of one funnel shift of witness words
//   r0 / 32 and r0 / 32 + 1, taken from their lanes with __shfl_sync;
//   its changed items read consecutive value slots from shared memory;
// * the warp totals and the staged value segment are double-buffered by
//   frame parity, and the frame loop is unrolled by two, so the parity
//   is a constant.  Every frame passes at least one barrier after its
//   writes to buffer P and before its reads of it, and frame f + 2
//   writes buffer P only after passing a barrier of frame f + 1, which
//   every thread reaches after its last read of frame f;
// * inputs read once and outputs are streamed past the caches (__ldcs,
//   __stcs).
//
// K3 chains a block column through all its frames, with the running
// pixels (4 a thread) in registers; K4 writes mask and values, with the
// frames split into groups so the grid fills the card.  What bounds
// them now is device-memory traffic: besides the outputs (5 B an item
// for K4), each frame reads its whole value segment, vh * 32 slots, of
// which only the changed items' are used; gathering those slots from
// device memory after the mask scan instead reads fewer bytes but puts a
// load on the frame's critical path: it measured faster for K4, slower
// for K3.  One frame of loads ahead is all the 32 registers allow: two
// frames ahead spill.
// K4 splits the frames into the fewest groups that give NB x groups >=
// this many CTAs (5 frames a CTA at 1080p): fewer frames a CTA lose the
// overlap of one frame's loads with the last one's work, more leave the
// card a tail of waves.
constexpr int K4_TARGET_CTAS = 4096;
// CTAs an SM must hold: caps registers at 32 a thread, without spills;
// 8 CTAs an SM ran faster than 6 (40 registers) or 4.
constexpr int EXPAND_MIN_CTAS = 8;

struct ExpandIn {
    const uint8_t* passes;
    const uint8_t* wit;
    const uint8_t* raw;
    const int32_t* flags;
    const int32_t* vseg;
    int nb, vslots;
};

struct ExpandSmem {
    int4 vseg[2][IPB / IPT];     // first, so 16-byte aligned
    int ptot[2][WARPS];          // per-warp pass counts
    int mtot[2][WARPS];          // per-warp change counts
};

// What a thread loads for one (frame, block).
struct ExpandLoad {
    uchar4 b4;       // passes, or raw mask bytes when flagged
    uint32_t ww;     // witness word `lane` of the block (0 when flagged)
    int4 v4;         // value slots 4t..4t+3 (when inside the segment)
    bool flagged;
};

__device__ __forceinline__ ExpandLoad expand_load(const ExpandIn& in, int f,
                                                  int blk) {
    const int t = threadIdx.x;
    const size_t row = (size_t)f * in.nb + blk;
    ExpandLoad ld;
    ld.flagged = __ldg(in.flags + f) != 0;
    const uint8_t* src = ld.flagged ? in.raw : in.passes;
    ld.b4 = __ldcs(reinterpret_cast<const uchar4*>(src) + row * THREADS + t);
    ld.ww = ld.flagged ? 0u : __byte_perm(
        __ldg(reinterpret_cast<const uint32_t*>(in.wit) + row * WW
              + (t & 31)), 0u, 0x0123);
    ld.v4 = IPT * t < in.vslots
        ? __ldcs(reinterpret_cast<const int4*>(in.vseg)
                + row * (in.vslots / IPT) + t)
        : make_int4(0, 0, 0, 0);
    return ld;
}

// Inclusive warp scan of v (lane order).
__device__ __forceinline__ int warp_incl(int v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += n;
    }
    return v;
}

// Exclusive rank, among the CTA's items in item order, of the first of
// the thread's `own` items; one barrier.
__device__ __forceinline__ int cta_rank(int own, int* wtot) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int incl = warp_incl(own);
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    const int wv = lane < WARPS ? wtot[lane] : 0;
    return __reduce_add_sync(FULL, lane < warp ? wv : 0) + incl - own;
}

// Change mask and values of the thread's four items of one frame: a
// passing item of rank r takes witness bit r; a flagged (pass-through,
// sparse or empty) frame takes its raw mask instead; the i-th changed
// item takes value slot i, or 0 past the segment.
template <int P>
__device__ __forceinline__ void expand_frame(ExpandSmem& sh,
                                             const ExpandLoad& ld,
                                             int vslots, bool mask[IPT],
                                             int32_t val[IPT]) {
    const int t = threadIdx.x;
    if (IPT * t < vslots) sh.vseg[P][t] = ld.v4;
    const bool b[IPT] = {ld.b4.x != 0, ld.b4.y != 0, ld.b4.z != 0,
                         ld.b4.w != 0};
    if (ld.flagged) {
#pragma unroll
        for (int i = 0; i < IPT; ++i) mask[i] = b[i];
    } else {
        const int r0 = cta_rank(b[0] + b[1] + b[2] + b[3], sh.ptot[P]);
        // witness bits r0, r0 + 1, ... from bit 31 down (r0 + 3 < 1024,
        // so word r0 / 32 + 1 exists where a bit of it is taken)
        const uint32_t hi = __shfl_sync(FULL, ld.ww, (r0 >> 5) & 31);
        const uint32_t lo = __shfl_sync(FULL, ld.ww, ((r0 >> 5) + 1) & 31);
        uint32_t bits = __funnelshift_l(lo, hi, (uint32_t)r0);
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            mask[i] = b[i] && (int32_t)bits < 0;
            if (b[i]) bits <<= 1;
        }
    }
    int s = cta_rank(mask[0] + mask[1] + mask[2] + mask[3], sh.mtot[P]);
    const int32_t* vs = reinterpret_cast<const int32_t*>(sh.vseg[P]);
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        val[i] = (mask[i] && s < vslots) ? vs[s] : 0;
        s += mask[i];
    }
}

// Frame g of the CTA's run f0.. (buffer parity P): loads frame g + 1
// into `cur` once frame g's loads are used.  K3 (CHAIN) replaces the
// running pixels `run` with the frame's changed values and writes them to
// vals_out; K4 writes the frame's mask and values.
template <int P, bool CHAIN>
__device__ __forceinline__ void expand_step(
        ExpandSmem& sh, const ExpandIn& in, ExpandLoad& cur, int f0, int g,
        int nfr, int32_t run[IPT], uint8_t* __restrict__ mask_out,
        int32_t* __restrict__ vals_out) {
    const int blk = blockIdx.x;
    const ExpandLoad ld = cur;
    if (g + 1 < nfr) cur = expand_load(in, f0 + g + 1, blk);
    bool mask[IPT];
    int32_t val[IPT];
    expand_frame<P>(sh, ld, in.vslots, mask, val);
    const size_t quad = ((size_t)(f0 + g) * in.nb + blk) * THREADS
        + threadIdx.x;
    if (CHAIN) {
#pragma unroll
        for (int i = 0; i < IPT; ++i)
            if (mask[i]) run[i] = val[i];
        __stcs(reinterpret_cast<int4*>(vals_out) + quad,
               make_int4(run[0], run[1], run[2], run[3]));
    } else {
        __stcs(reinterpret_cast<uchar4*>(mask_out) + quad,
               make_uchar4(mask[0], mask[1], mask[2], mask[3]));
        __stcs(reinterpret_cast<int4*>(vals_out) + quad,
               make_int4(val[0], val[1], val[2], val[3]));
    }
}

// Frames f0 .. f0 + nfr - 1 of block blockIdx.x, two a trip so that the
// buffer parity is a constant.
template <bool CHAIN>
__device__ __forceinline__ void expand_frames(const ExpandIn& in, int f0,
                                              int nfr, int32_t run[IPT],
                                              uint8_t* __restrict__ mask_out,
                                              int32_t* __restrict__ vals_out) {
    __shared__ __align__(16) ExpandSmem sh;
    ExpandLoad cur = expand_load(in, f0, blockIdx.x);
    for (int g = 0; g < nfr; g += 2) {
        expand_step<0, CHAIN>(sh, in, cur, f0, g, nfr, run, mask_out,
                              vals_out);
        if (g + 1 < nfr) {
            expand_step<1, CHAIN>(sh, in, cur, f0, g + 1, nfr, run,
                                  mask_out, vals_out);
        }
    }
}

// K3: expansion fused with the frame chain.  The TPU kernel carried the
// running frame in VMEM across a sequential grid axis; CTAs here run in
// no order, so each CTA owns one block column and walks all its frames.
// grid = (NB), block = THREADS.
__global__ void __launch_bounds__(THREADS, EXPAND_MIN_CTAS) k3_expand_chain(
        ExpandIn in, const int32_t* __restrict__ base,
        int32_t* __restrict__ out, int nf) {
    const int4 b = __ldg(reinterpret_cast<const int4*>(base)
                         + (size_t)blockIdx.x * THREADS + threadIdx.x);
    int32_t run[IPT] = {b.x, b.y, b.z, b.w};
    expand_frames<true>(in, 0, nf, run, nullptr, out);
}

// K4: expansion without the chain.  grid = (NB, frame groups of fpc),
// block = THREADS.
__global__ void __launch_bounds__(THREADS, EXPAND_MIN_CTAS) k4_expand(
        ExpandIn in, uint8_t* __restrict__ mask_out,
        int32_t* __restrict__ vals_out, int nf, int fpc) {
    const int f0 = blockIdx.y * fpc;
    int32_t unused[IPT];
    expand_frames<false>(in, f0, min(fpc, nf - f0), unused, mask_out,
                         vals_out);
}

// Grid of K1, K2, K5a and K5b: NB blocks by the frame groups of fpc.
bool frame_grid(int nf, int nb, int fpc, dim3* grid) {
    if (fpc < 1 || fpc > GMAX) return false;
    *grid = dim3(nb, (nf + fpc - 1) / fpc);
    return true;
}

}  // namespace

extern "C" {

int nbf_k1_encode(const void* bits, const void* h1, const void* h2,
                  const void* act_hi, const void* act_lo, const void* vals,
                  const void* m, const void* thi, const void* tlo,
                  const void* fk, void* words, void* wit, void* wcnt,
                  void* vseg, void* vcnt, int nf, int nb, int k_lanes,
                  int nw, int vslots, int fpc, void* stream) {
    dim3 grid;
    if (!frame_grid(nf, nb, fpc, &grid)) return (int)cudaErrorInvalidValue;
    const FrameArgs fa = {(const int32_t*)m, (const int32_t*)thi,
                          (const int32_t*)tlo, (const int32_t*)fk, nullptr};
    const EncodeOut out = {(int32_t*)words, (uint8_t*)wit, (int32_t*)wcnt,
                           (int32_t*)vseg, (int32_t*)vcnt};
    k1_encode<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bits, (const int32_t*)h1, (const int32_t*)h2,
        (const int32_t*)act_hi, (const int32_t*)act_lo, (const int32_t*)vals,
        fa, out, nf, nb, k_lanes, nw, vslots, fpc);
    return (int)cudaGetLastError();
}

int nbf_k2_membership(const void* words, int wstride, const void* h1,
                      const void* h2, const void* act_hi, const void* act_lo,
                      const void* m, const void* thi, const void* tlo,
                      const void* fk, const void* flags, void* passes,
                      void* wcnt, int nf, int nb, int k_lanes, int nw,
                      int fpc, void* stream) {
    dim3 grid;
    if (!frame_grid(nf, nb, fpc, &grid)) return (int)cudaErrorInvalidValue;
    const FrameArgs fa = {(const int32_t*)m, (const int32_t*)thi,
                          (const int32_t*)tlo, (const int32_t*)fk,
                          (const int32_t*)flags};
    k2_membership<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, wstride, (const int32_t*)h1,
        (const int32_t*)h2, (const int32_t*)act_hi, (const int32_t*)act_lo,
        fa, (uint8_t*)passes, (int32_t*)wcnt, nf, nb, k_lanes, nw, fpc);
    return (int)cudaGetLastError();
}

int nbf_k3_expand_chain(const void* passes, const void* wit, const void* raw,
                        const void* flags, const void* vseg, const void* base,
                        void* out, int nf, int nb, int vslots,
                        void* stream) {
    if (vslots < 0 || vslots > IPB || vslots % IPT)
        return (int)cudaErrorInvalidValue;
    const ExpandIn in = {(const uint8_t*)passes, (const uint8_t*)wit,
                         (const uint8_t*)raw, (const int32_t*)flags,
                         (const int32_t*)vseg, nb, vslots};
    k3_expand_chain<<<dim3(nb), THREADS, 0, (cudaStream_t)stream>>>(
        in, (const int32_t*)base, (int32_t*)out, nf);
    return (int)cudaGetLastError();
}

int nbf_k4_expand(const void* passes, const void* wit, const void* raw,
                  const void* flags, const void* vseg, void* mask_out,
                  void* vals_out, int nf, int nb, int vslots, void* stream) {
    if (vslots < 0 || vslots > IPB || vslots % IPT || nb < 1 || nf < 1)
        return (int)cudaErrorInvalidValue;
    const ExpandIn in = {(const uint8_t*)passes, (const uint8_t*)wit,
                         (const uint8_t*)raw, (const int32_t*)flags,
                         (const int32_t*)vseg, nb, vslots};
    const int want = (K4_TARGET_CTAS + nb - 1) / nb;   // frame groups
    const int groups = want < nf ? want : nf;
    const int fpc = (nf + groups - 1) / groups;
    k4_expand<<<dim3(nb, (nf + fpc - 1) / fpc), THREADS, 0,
                (cudaStream_t)stream>>>(in, (uint8_t*)mask_out,
                                        (int32_t*)vals_out, nf, fpc);
    return (int)cudaGetLastError();
}

int nbf_k5a_encode(const void* bits, const void* a, const void* b,
                   const void* act, const void* vals, const void* m,
                   const void* fk, void* words, void* wit, void* wcnt,
                   void* vseg, void* vcnt, int nf, int nb, int k_lanes,
                   int nw, int vslots, int fpc, void* stream) {
    dim3 grid;
    if (!frame_grid(nf, nb, fpc, &grid)) return (int)cudaErrorInvalidValue;
    const ModItems items = {(const int32_t*)a, (const int32_t*)b,
                            (const uint8_t*)act};
    const FrameArgs fa = {(const int32_t*)m, nullptr, nullptr,
                          (const int32_t*)fk, nullptr};
    const EncodeOut out = {(int32_t*)words, (uint8_t*)wit, (int32_t*)wcnt,
                           (int32_t*)vseg, (int32_t*)vcnt};
    k5a_encode<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bits, items, (const int32_t*)vals, fa, out, nf, nb,
        k_lanes, nw, vslots, fpc);
    return (int)cudaGetLastError();
}

int nbf_k5b_membership(const void* words, int wstride, const void* a,
                       const void* b, const void* act, const void* m,
                       const void* fk, const void* flags, void* passes,
                       void* wcnt, int nf, int nb, int k_lanes, int nw,
                       int fpc, void* stream) {
    dim3 grid;
    if (!frame_grid(nf, nb, fpc, &grid)) return (int)cudaErrorInvalidValue;
    const ModItems items = {(const int32_t*)a, (const int32_t*)b,
                            (const uint8_t*)act};
    const FrameArgs fa = {(const int32_t*)m, nullptr, nullptr,
                          (const int32_t*)fk, (const int32_t*)flags};
    k5b_membership<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, wstride, items, fa, (uint8_t*)passes,
        (int32_t*)wcnt, nf, nb, k_lanes, nw, fpc);
    return (int)cudaGetLastError();
}

}  // extern "C"
