// Phase A of the blocked encoder for Hopper (sm_90a): K6, K7 and K8.
//
// None replaces a Pallas kernel.  Each replaces a program that the
// JAX package leaves to XLA, which fuses it into one device pass
// (new_bloom_filter_repo_tpu/models/blocked_pipeline.py):
//
//   K6 nbf_k6_phase_a_diff       <- _phase_a_pair :359 and
//                                   _phase_a_motion_pair :681
//   K7 nbf_k7_motion_counts      <- _motion_counts_pair :406
//   K8 nbf_k8_tile_motion_best   <- _tile_motion_best :528
//
// The port ran them as eager torch ops, one device pass per op, each
// reading and writing whole (F, n) int32 intermediates; these kernels
// read the frames once and write only the outputs.
//
// K6: masks (F, NB, 1024) u8, counts (F, NB) i32 and vals (F, NB, 1024)
// i32 from (prev, curr) frame pairs of h x w pixels of C bytes.  A
// pixel is packed c0 | c1 << 8 | c2 << 16 (the first three bytes, C <=
// 3 on every path); item i of frame f is the pixel (y, x) = (i / w,
// i % w); its mask is curr[y, x] != prev[sy, sx], with (sy, sx) the
// pixel that np.roll by the frame's shift (dy, dx) brings to (y, x), or
// (y, x) itself without shifts; its val is curr[y, x].  Items n..npad-1
// get mask 0 and val 0 and are not counted.  Each item is read and
// written once, so device-memory bytes bound it (about 11 B an item:
// C bytes of each frame, 1 B of mask, 4 B of val).  One CTA of 256
// threads owns one (frame, block), 4 items a thread: the outputs go out
// as one uchar4 and one int4 a thread, the inputs come in as C u32
// words a thread where the frame starts on a 4-byte boundary and the
// pixels are the thread's own (no shift, or a shift that maps every
// item to itself), byte by byte otherwise (a frame of odd size starts
// anywhere; a rolled source crosses rows).  The count is a warp
// reduction and a sum of the 8 warp totals.  The CTAs take the frames
// of one block in turn, so frame f's previous frame, which was frame f
// - 1's current frame a CTA before, is still in L2.
//
// The roll is the JAX package's to the bit: it computes the source row
// as (y - dy) % h in int32, so the difference wraps by 2^32 from y =
// 2^31 + dy on (only for dy < -2^31 + h); % is then a floor modulo.
// Thread 0 reduces each shift once per CTA, in 64 bits, to two offsets
// a and b in [0, h) and the row c where the wrap starts (roll_of):
// sy = y + (y < c ? a : b), less h if it reaches h.  The same for x.
//
// K7 and K8, the motion search: for every frame pair and every shift
// (dy, dx) in [-R, R]^2, the samples (y, x) = (ys, xs), ys = 0, s, 2s,
// ... < h and xs = 0, s, ... < w, whose current pixel differs from
// prev[(y - dy) mod h, (x - dx) mod w]; candidate index (dy + R) * (2R +
// 1) + (dx + R).  K7 sums them over the frame into (F, 225) i32; K8 sums
// them over square tiles of spt x spt samples and keeps, per tile, the
// first candidate of least count, that count and the zero shift's count
// ((F, ty, tx, 3) i32; samples past the frame count 0).  One body, a
// template flag apart.  The bytes that bound them are one read of each
// previous frame and of the current samples; the work is 225 compares a
// sample.  A CTA of 15 warps owns one frame, a band of sample rows (K8:
// whole tile rows) and a strip of at most 32 sample columns (K8: whole
// tiles).  Each previous row the band needs, rows first * s - R to last *
// s + R mod h over the strip's columns and an R-column halo, comes into
// shared memory once: 16-byte cp.async copies of the row's bytes (two
// runs where the halo wraps at the frame's edge; granules past the
// tensor's ends byte by byte) land three sample rows ahead, so the loads
// overlap the compares; then each staged pixel is packed to its 24-bit
// int once, into a ring of 15 packed rows (row y - dy of sample row y in
// slot (y - dy - first + R) mod 15).  The ring row is polyphase: staged
// column q * s + ph (ph < min(s, 15)) lies at ph * Q + q, so the 32 lanes
// of a warp, one sample column each, read 32 consecutive words.  Warp i
// compares the row of dy = i - R with every sample and keeps the 15 dx
// counts in registers.  K7 reduces them across the warp with redux.sync
// and adds them into counts[f, :] with one integer atomicAdd per CTA and
// candidate, exact in any order (the wrapper zeroes counts); K8 reduces
// them across the lanes of a tile at the end of each tile row into the
// tile's 225 counts in shared memory, and a warp a tile takes the first
// argmin with two redux.sync mins.
//
// Every entry point is a plain C function: it launches on the stream it
// is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry it does
// not take.  All byte offsets are size_t: the bench batch holds 249.7 M
// items.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IPB = 1024;         // items per block
constexpr int IPT = 4;            // items per thread (K6)
constexpr int THREADS = IPB / IPT;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// The motion search's radius; defined once, by ops/_build.py.
#ifndef NBF_MOTION_RADIUS
#error "build with -DNBF_MOTION_RADIUS=<radius> (ops/_build.py)"
#endif
constexpr int R = NBF_MOTION_RADIUS;
constexpr int SIDE = 2 * R + 1;
constexpr int CANDS = SIDE * SIDE;
constexpr int ZERO_CAND = R * SIDE + R;
// K7/K8: a warp a dy, a lane a sample column of the strip
constexpr int MS_WARPS = SIDE;
constexpr int MS_THREADS = MS_WARPS * 32;
constexpr int MS_LANES = 32;
// The fast path's staged columns past the strip's 32 * s: the window's
// 2R and up to 3 more for the lead (ops/phase_a.search_geometry)
constexpr int MS_EXTRA = 2 * R + 3;
// The fast path's landing rows a staging warp: rows in flight, and the
// one packed (ops/phase_a.SEARCH_LAND)
constexpr int MS_LAND = 4;
// The shared memory a CTA may opt into (H100: 227 KB)
constexpr int SMEM_MAX = 232448;

// ---------------------------------------------------------------------------
// Pixels.  Template C: 1, 2 or 3 bytes a pixel, all packed; 4 stands for
// any wider pixel (cs bytes, cs >= 4), whose first three bytes are packed.
// ---------------------------------------------------------------------------

template <int C>
__device__ __forceinline__ int pixel_bytes(int cs) {
    return C <= 3 ? C : cs;
}

// The packed pixel idx of a frame.
template <int C>
__device__ __forceinline__ uint32_t load1(const uint8_t* frame, size_t idx,
                                          int cs) {
    const uint8_t* p = frame + idx * (size_t)pixel_bytes<C>(cs);
    uint32_t v = __ldg(p);
    if (C >= 2) v |= (uint32_t)__ldg(p + 1) << 8;
    if (C >= 3) v |= (uint32_t)__ldg(p + 2) << 16;
    return v;
}

// Four consecutive packed pixels from 4 * C bytes at a 4-byte boundary
// (C <= 3), as C u32 loads; bytes are little-endian in a word.
template <int C>
__device__ __forceinline__ void load4(const uint8_t* p, uint32_t (&px)[IPT]) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
    uint32_t wv[C];
#pragma unroll
    for (int j = 0; j < C; ++j) wv[j] = __ldg(q + j);
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
        uint32_t v = 0;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
            const int byte = k * C + ch;
            v |= ((wv[byte >> 2] >> (8 * (byte & 3))) & 0xffu) << (8 * ch);
        }
        px[k] = v;
    }
}

// The thread's four items [i0, i0 + 4) of a frame of n pixels; items at
// or past n are 0.
template <int C>
__device__ __forceinline__ void load_items(const uint8_t* frame, int i0,
                                           int n, int cs,
                                           uint32_t (&px)[IPT]) {
    if constexpr (C <= 3) {
        if (i0 + IPT <= n && (reinterpret_cast<uintptr_t>(frame) & 3) == 0) {
            load4<C>(frame + (size_t)i0 * C, px);
            return;
        }
    }
#pragma unroll
    for (int k = 0; k < IPT; ++k)
        px[k] = i0 + k < n ? load1<C>(frame, (size_t)(i0 + k), cs) : 0u;
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// The roll of an axis of length n by a shift d, as the JAX package's
// _roll2d computes it in int32: source(v) = wrap32(v - d) floor-mod n,
// where v - d passes 2^31 - 1 (and wraps by -2^32) from v = 2^31 + d
// on.  Returned as source(v) = v + (v < c ? a : b), less n if >= n.
struct Roll {
    int a, b, c;
};

__device__ Roll roll_of(int32_t d, int n) {
    const long long dd = d;
    const long long c = (1LL << 31) + dd;          // in [0, 2^32)
    if (-n < d && d < n && c >= n) {
        // |d| < n and no wrap (every shift the search picks): no
        // division, which in 64 bits costs each CTA about as much as
        // its loads
        const int a = d <= 0 ? -d : n - d;
        return Roll{a, a, n};
    }
    long long a = (-dd) % n;
    if (a < 0) a += n;
    long long b = (-dd - (1LL << 32)) % n;
    if (b < 0) b += n;
    return Roll{(int)a, (int)b, (int)(c < n ? c : n)};
}

__device__ __forceinline__ int rolled(int v, const Roll& r, int n) {
    const int s = v + (v < r.c ? r.a : r.b);
    return s >= n ? s - n : s;
}

__device__ __forceinline__ bool is_identity(const Roll& r, int n) {
    return r.a == 0 && (r.c >= n || r.b == 0);
}

template <int C>
__global__ void __launch_bounds__(THREADS) k6_phase_a_diff(
        const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
        const int32_t* __restrict__ shifts, uint8_t* __restrict__ masks,
        int32_t* __restrict__ counts, int32_t* __restrict__ vals, int nf,
        int nb, int h, int w, int cs) {
    __shared__ Roll s_ry, s_rx;
    __shared__ int s_same;
    __shared__ int s_warp[WARPS];
    const int b = blockIdx.x / nf;
    const int f = blockIdx.x - b * nf;
    const int t = threadIdx.x;
    const int n = h * w;
    if (t == 0) {
        Roll ry = {0, 0, h}, rx = {0, 0, w};
        if (shifts != nullptr) {
            ry = roll_of(shifts[2 * f], h);
            rx = roll_of(shifts[2 * f + 1], w);
        }
        s_ry = ry;
        s_rx = rx;
        s_same = is_identity(ry, h) && is_identity(rx, w);
    }
    __syncthreads();
    const size_t fo = (size_t)f * (size_t)n * (size_t)pixel_bytes<C>(cs);
    const uint8_t* cf = curr + fo;
    const uint8_t* pf = prev + fo;
    const int i0 = b * IPB + t * IPT;
    uint32_t pc[IPT], pp[IPT];
    load_items<C>(cf, i0, n, cs, pc);
    if (s_same) {
        load_items<C>(pf, i0, n, cs, pp);
    } else {
        const Roll ry = s_ry, rx = s_rx;
        int y = 0, x = 0;
        if (i0 < n) {
            y = i0 / w;
            x = i0 - y * w;
        }
#pragma unroll
        for (int k = 0; k < IPT; ++k) {
            pp[k] = 0u;
            if (i0 + k < n) {
                const int sy = rolled(y, ry, h), sx = rolled(x, rx, w);
                pp[k] = load1<C>(pf, (size_t)sy * (size_t)w + sx, cs);
            }
            if (++x == w) {
                x = 0;
                ++y;
            }
        }
    }
    uchar4 m;
    m.x = pc[0] != pp[0];
    m.y = pc[1] != pp[1];
    m.z = pc[2] != pp[2];
    m.w = pc[3] != pp[3];
    const size_t o = ((size_t)f * nb + b) * IPB + (size_t)t * IPT;
    *reinterpret_cast<uchar4*>(masks + o) = m;
    *reinterpret_cast<int4*>(vals + o) =
        make_int4((int)pc[0], (int)pc[1], (int)pc[2], (int)pc[3]);
    const int cnt = __reduce_add_sync(FULL, m.x + m.y + m.z + m.w);
    if ((t & 31) == 0) s_warp[t >> 5] = cnt;
    __syncthreads();
    if (t == 0) {
        int sum = 0;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) sum += s_warp[i];
        counts[(size_t)f * nb + b] = sum;
    }
}

// ---------------------------------------------------------------------------
// K7 and K8: the motion search
// ---------------------------------------------------------------------------

// Geometry of a search launch (search_geometry).
struct Search {
    int nf, h, w, cs, stride;
    int sh, sw;             // sample rows and columns
    int rows, strip;        // sample rows a band, sample columns a strip
    int bands, strips;
    int P, Q;               // phases (min(s, 15)) and columns a phase
    int fast;               // the fast path's stride (4 or 8), else 0
    int lrow;               // fast: landing bytes a row
    int wsmem;              // shared-memory bytes a warp
    int spt, ty, tx, tiles; // K8: samples a tile side, tiles, tiles a strip
    int o_cur, o_tile, smem;   // the band's samples, K8's tiles; in all
};

// The packed pixel at p, byte by byte.
template <int C>
__device__ __forceinline__ uint32_t pixel_at(const uint8_t* p) {
    uint32_t v = __ldg(p);
    if (C >= 2) v |= (uint32_t)__ldg(p + 1) << 8;
    if (C >= 3) v |= (uint32_t)__ldg(p + 2) << 16;
    return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four packed pixels from the 4 * C bytes at byte b of a row in shared
// memory (C <= 3): the C + 1 words around them, funnel-shifted to b.
template <int C>
__device__ __forceinline__ void four_pixels(const uint8_t* row, int b,
                                            uint32_t (&px)[4]) {
    const uint32_t* wv = reinterpret_cast<const uint32_t*>(row + (b & ~3));
    const unsigned sh = 8u * (unsigned)(b & 3);
    const uint32_t v0 = __funnelshift_r(wv[0], wv[1], sh);
    if constexpr (C == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) px[k] = (v0 >> (8 * k)) & 0xffu;
    } else if constexpr (C == 2) {
        const uint32_t v1 = __funnelshift_r(wv[1], wv[2], sh);
        px[0] = v0 & 0xffffu;
        px[1] = v0 >> 16;
        px[2] = v1 & 0xffffu;
        px[3] = v1 >> 16;
    } else {
        const uint32_t v1 = __funnelshift_r(wv[1], wv[2], sh);
        const uint32_t v2 = __funnelshift_r(wv[2], wv[3], sh);
        px[0] = v0 & 0xffffffu;
        px[1] = (v0 >> 24) | ((v1 & 0xffffu) << 8);
        px[2] = (v1 >> 16) | ((v2 & 0xffu) << 16);
        px[3] = v2 >> 8;
    }
}

// One CTA's view of its work.  Staged column (q, ph) of a warp's row is
// image column a + q * s + ph (mod w): a = x0 - R rounded down to a
// multiple of 4 where s < 15 (lead = x0 - R - a), a = x0 - R else.
struct Cta {
    int f, r0, nrows, k0, nk, a, lead;
    const uint8_t* pf;   // its previous frame
    const uint8_t* cf;   // its current frame
};

__device__ __forceinline__ Cta cta_of(const Search& g,
                                      const uint8_t* prev,
                                      const uint8_t* curr) {
    Cta c;
    int b = blockIdx.x;
    const int si = b % g.strips;
    b /= g.strips;
    const int band = b % g.bands;
    c.f = b / g.bands;
    c.r0 = band * g.rows;
    c.nrows = min(g.sh, c.r0 + g.rows) - c.r0;
    c.k0 = si * g.strip;
    c.nk = min(g.strip, g.sw - c.k0);
    const int xr = c.k0 * g.stride - R;
    c.a = g.stride < SIDE ? (xr & ~3) : xr;
    c.lead = xr - c.a;
    const size_t frame = (size_t)g.h * g.w * g.cs;
    c.pf = prev + (size_t)c.f * frame;
    c.cf = curr + (size_t)c.f * frame;
    return c;
}

// The previous row y - dy (mod h) of sample row r for warp wi.
__device__ __forceinline__ const uint8_t* prev_row(const Search& g,
                                                   const Cta& c, int r,
                                                   int wi) {
    long long py = (long long)r * g.stride + R - wi;
    if (py < 0 || py >= g.h) {
        py %= g.h;
        if (py < 0) py += g.h;
    }
    return c.pf + (size_t)py * g.w * g.cs;
}

// The band's current samples into s_cur (row-major, strip a row),
// loaded by all the CTA's threads at once.
template <int C>
__device__ __forceinline__ void load_samples(const Search& g, const Cta& c,
                                             int32_t* s_cur) {
    for (int e = threadIdx.x; e < c.nrows * g.strip; e += MS_THREADS) {
        const int j = e / g.strip, k = e - j * g.strip;
        if (k < c.nk) {
            const size_t y = (size_t)(c.r0 + j) * g.stride;
            s_cur[e] = (int32_t)pixel_at<C>(
                c.cf + (y * g.w + (size_t)(c.k0 + k) * g.stride) * g.cs);
        }
    }
}

// K8: a warp's 15 counts of each lane, reduced over the lanes of a tile
// (aligned groups of g2 lanes) into the tile's counts in shared memory;
// then, once every warp has added its own, a warp a tile takes the first
// least count (ties to the lower candidate), writes the tile's row and
// zeroes the counts.  The tile rows alternate between two sets of counts,
// so the next tile row's barrier orders this one's reads and zeroes
// before the set is added to again.
__device__ __forceinline__ void tile_row_end(const Search& g, const Cta& c,
                                             int r, int wi, int lane,
                                             int mytile, int g2,
                                             int (&cnt)[SIDE],
                                             int32_t* s_tile,
                                             int32_t* __restrict__ out) {
    for (int m = 1; m < g2; m <<= 1) {
#pragma unroll
        for (int i = 0; i < SIDE; ++i)
            cnt[i] += __shfl_xor_sync(FULL, cnt[i], m);
    }
    if (mytile >= 0) {
        int32_t* mine = s_tile + ((r / g.spt) & 1) * g.tiles * CANDS
                      + mytile * CANDS + wi * SIDE;
#pragma unroll
        for (int i = 0; i < SIDE; ++i)
            if ((i & (g2 - 1)) == (lane & (g2 - 1)))
                atomicAdd(mine + i, cnt[i]);
    }
#pragma unroll
    for (int i = 0; i < SIDE; ++i) cnt[i] = 0;
    __syncthreads();                   // the tile row's counts are whole
    const int tyi = r / g.spt;
    s_tile += (tyi & 1) * g.tiles * CANDS;
    for (int tt = wi; tt < g.tiles; tt += MS_WARPS) {
        const int txi = c.k0 / g.spt + tt;
        if (txi >= g.tx) break;
        int32_t* ct = s_tile + tt * CANDS;
        const int c0 = ct[ZERO_CAND];
        unsigned bv = 0xffffffffu, bi = CANDS;
        for (int i = lane; i < CANDS; i += 32) {
            const unsigned v = (unsigned)ct[i];
            if (v < bv) {
                bv = v;
                bi = (unsigned)i;
            }
        }
        const unsigned mn = __reduce_min_sync(FULL, bv);
        const unsigned best =
            __reduce_min_sync(FULL, bv == mn ? bi : (unsigned)CANDS);
        for (int i = lane; i < CANDS; i += 32) ct[i] = 0;
        if (lane == 0) {
            int32_t* o = out + (((size_t)c.f * g.ty + tyi) * g.tx + txi) * 3;
            o[0] = (int32_t)best;
            o[1] = (int32_t)mn;
            o[2] = c0;
        }
    }
}

// K7: a warp's counts summed over its lanes, one atomicAdd a candidate.
__device__ __forceinline__ void counts_out(const Cta& c, int wi, int lane,
                                           const int (&cnt)[SIDE],
                                           int32_t* __restrict__ out) {
#pragma unroll
    for (int i = 0; i < SIDE; ++i) {
        const unsigned v = __reduce_add_sync(FULL, (unsigned)cnt[i]);
        if (lane == 0 && v)
            atomicAdd(out + (size_t)c.f * CANDS + wi * SIDE + i, (int)v);
    }
}

// K8's tile of a lane and the lanes a tile shares (a power of two).
__device__ __forceinline__ void tile_lanes(const Search& g, int lane,
                                           int& mytile, int& g2) {
    if (g.spt >= MS_LANES) {
        mytile = 0;
        g2 = 32;
    } else {
        g2 = g.spt & -g.spt;
        mytile = lane < g.tiles * g.spt ? lane / g.spt : -1;
    }
}

// Wait at named barrier id for n threads (the warps of one group).
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The fast path, for strides 4 and 8, pixels of 1-3 bytes, 32-column
// strips, w a multiple of 4 and rows of a multiple of 16 bytes from a
// 16-byte boundary.  Warp wi = b + S * t needs, at sample row y, the
// previous row y + R - wi: the row that warp b needs t sample rows
// earlier.  So each previous row the band needs is loaded once: warp b <
// S stages the rows of its group {b, b + S, ...} and keeps the last T +
// 1 of them (T = ceil((2R + 1) / S)), and a group meets at a named
// barrier once a sample row.  A staged row's bytes (one run of 16-byte
// granules, two where the halo wraps at the frame's edge) land by
// cp.async MS_LAND - 1 rows ahead, so the loads overlap the compares;
// the staging warp's lanes pack them four columns at a time (C + 1 word
// loads, funnel shifts) into a polyphase row, staged column q * S + ph at
// word ph * Q + q, Q = 32 + (2R + 3) / S; lane k of each warp reads the
// window of its sample at compile-time offsets.
template <int C, int S, bool TILES>
__device__ __forceinline__ void search_fast(const uint8_t* __restrict__ prev,
                                            const uint8_t* __restrict__ curr,
                                            int32_t* __restrict__ out,
                                            const Search& g) {
    constexpr int Q = MS_LANES + MS_EXTRA / S;
    constexpr int COLS = S * Q;               // staged columns of a row
    constexpr int GROUPS = COLS / 4;          // of four columns
    constexpr int GL = (GROUPS + 31) / 32;    // groups a lane
    constexpr int LEAD = 1;                   // x0 = k0 * S is 4-aligned
    constexpr int T = (SIDE + S - 1) / S;     // rows back a group reads
    constexpr int H = T + 1;                  // rows a staging warp keeps
    static_assert(COLS % 4 == 0, "whole groups");
    extern __shared__ __align__(16) uint8_t search_smem[];
    const int t = threadIdx.x, wi = t >> 5, lane = t & 31;
    const int gb = wi % S, back = wi / S;     // group, rows back
    const int members = (SIDE - 1 - gb) / S + 1;
    uint8_t* mine = search_smem + gb * g.wsmem;
    int32_t* hist = reinterpret_cast<int32_t*>(mine);
    uint8_t* land = mine + H * COLS * 4;
    int32_t* s_cur = reinterpret_cast<int32_t*>(search_smem + g.o_cur);
    int32_t* s_tile = reinterpret_cast<int32_t*>(search_smem + g.o_tile);
    const Cta c = cta_of(g, prev, curr);
    const int first = c.r0 - (T - 1), end = c.r0 + c.nrows;

    // the staged columns as runs of the row: A = [alo, ahi), then B =
    // [0, bhi) where the halo wraps
    int alo = c.a, ahi = c.a + COLS, bhi = 0;
    if (c.a < 0) {
        alo = c.a + g.w;
        ahi = g.w;
        bhi = c.a + COLS;
    } else if (c.a + COLS > g.w) {
        ahi = g.w;
        bhi = c.a + COLS - g.w;
    }
    const int a0 = alo * C, amis = a0 & 15;
    const int na = (ahi * C - (a0 & ~15) + 15) >> 4;   // granules of A
    const int nb = (bhi * C + 15) >> 4;                // granules of B
    // this lane's granules (g = lane + 32 * v) and groups of four
    int gsrc[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        const int gi = lane + 32 * v;
        gsrc[v] = gi < na ? (a0 & ~15) + 16 * gi
                : gi < na + nb ? 16 * (gi - na) : -1;
    }
    int gbyte[GL];
#pragma unroll
    for (int v = 0; v < GL; ++v) {
        const int u = lane + 32 * v;
        int x = c.a + 4 * u;
        x = x < 0 ? x + g.w : x >= g.w ? x - g.w : x;
        gbyte[v] = u >= GROUPS ? -1
                 : x >= alo && x < ahi ? amis + (x - alo) * C
                                       : 16 * na + x * C;
    }
    // a staging warp's copies of its row of sample row r, and its pack
    auto issue = [&](int r) {
        if (r < end) {
            const uint8_t* row = prev_row(g, c, r, gb);
            uint8_t* dst = land + ((r - first) % MS_LAND) * g.lrow;
#pragma unroll
            for (int v = 0; v < 2; ++v)
                if (gsrc[v] >= 0)
                    cp_async16(dst + 16 * (lane + 32 * v), row + gsrc[v]);
        }
        cp_async_commit();
    };
    auto stage = [&](int r) {
        cp_async_wait<MS_LAND - 2>();
        __syncwarp();                  // row r landed
        const uint8_t* lr = land + ((r - first) % MS_LAND) * g.lrow;
        int32_t* poly = hist + ((r - first) % H) * COLS;
#pragma unroll
        for (int v = 0; v < GL; ++v) {
            if (gbyte[v] >= 0) {
                uint32_t px[4];
                four_pixels<C>(lr, gbyte[v], px);
                const int ci = 4 * (lane + 32 * v);
                int32_t* d = poly + (ci % S) * Q + ci / S;
#pragma unroll
                for (int k = 0; k < 4; ++k) d[k * Q] = (int32_t)px[k];
            }
        }
        __syncwarp();                  // its landing row is free
        issue(r + MS_LAND - 1);
    };

    int cnt[SIDE];
#pragma unroll
    for (int i = 0; i < SIDE; ++i) cnt[i] = 0;
    if (back == 0) {
#pragma unroll
        for (int d = 0; d < MS_LAND - 1; ++d) issue(first + d);
    }
    load_samples<C>(g, c, s_cur);
    int mytile = -1, g2 = 32;
    if (TILES) {
        tile_lanes(g, lane, mytile, g2);
        for (int i = t; i < 2 * g.tiles * CANDS; i += MS_THREADS)
            s_tile[i] = 0;
    }
    __syncthreads();                   // the band's samples are in
    if (back == 0) {
        for (int r = first; r < c.r0; ++r) stage(r);
    }
#pragma unroll 1
    for (int r = c.r0; r < end; ++r) {
        // the group's rows r - back are staged once this row's is; the
        // row it overwrites, r - T, no member reads from here on
        if (back == 0) stage(r);
        bar_sync(1 + gb, 32 * members);
        if (lane < c.nk) {
            const int32_t cur = s_cur[(r - c.r0) * g.strip + lane];
            const int32_t* p = hist + ((r - back - first) % H) * COLS + lane;
#pragma unroll
            for (int j = 0; j < SIDE; ++j)
                cnt[SIDE - 1 - j] +=
                    p[((LEAD + j) % S) * Q + (LEAD + j) / S] != cur;
        }
        if (TILES && ((r + 1) % g.spt == 0 || r + 1 == end))
            tile_row_end(g, c, r, wi, lane, mytile, g2, cnt, s_tile, out);
    }
    if (back == 0) cp_async_wait<0>();
    if (!TILES) counts_out(c, wi, lane, cnt, out);
}

// The generic path: any stride, pixel width, frame width and alignment.
// Each warp stages its own previous rows pixel by pixel (the staged
// columns of any stride: q * s + ph, ph < min(s, 15)); a lane walks its
// samples k = lane, lane + 32, ... (K8's tiles wider than 32 samples).
template <int C, bool TILES>
__device__ __forceinline__ void search_generic(
        const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
        int32_t* __restrict__ out, const Search& g) {
    extern __shared__ __align__(16) uint8_t search_smem[];
    const int t = threadIdx.x, wi = t >> 5, lane = t & 31;
    int32_t* poly = reinterpret_cast<int32_t*>(search_smem + wi * g.wsmem);
    int32_t* s_cur = reinterpret_cast<int32_t*>(search_smem + g.o_cur);
    int32_t* s_tile = reinterpret_cast<int32_t*>(search_smem + g.o_tile);
    const Cta c = cta_of(g, prev, curr);
    const int s = g.stride, rw = g.P * g.Q;
    int off[SIDE];
#pragma unroll
    for (int j = 0; j < SIDE; ++j)
        off[j] = ((c.lead + j) % g.P) * g.Q + (c.lead + j) / g.P;
    load_samples<C>(g, c, s_cur);
    int mytile = -1, g2 = 32;
    if (TILES) {
        tile_lanes(g, lane, mytile, g2);
        for (int i = t; i < 2 * g.tiles * CANDS; i += MS_THREADS)
            s_tile[i] = 0;
    }
    __syncthreads();                   // the band's samples are in
    int cnt[SIDE];
#pragma unroll
    for (int i = 0; i < SIDE; ++i) cnt[i] = 0;
#pragma unroll 1
    for (int r = c.r0; r < c.r0 + c.nrows; ++r) {
        const uint8_t* row = prev_row(g, c, r, wi);
        __syncwarp();                  // the last compares done
        for (int e = lane; e < rw; e += 32) {
            const int ph = e / g.Q, q = e - ph * g.Q;
            int x = (c.a + q * s + ph) % g.w;
            if (x < 0) x += g.w;
            poly[e] = (int32_t)pixel_at<C>(row + (size_t)x * g.cs);
        }
        __syncwarp();
        for (int k = lane; k < c.nk; k += MS_LANES) {
            const int32_t cur = s_cur[(r - c.r0) * g.strip + k];
            const int32_t* p = poly + k;
#pragma unroll
            for (int j = 0; j < SIDE; ++j) cnt[SIDE - 1 - j] += p[off[j]] != cur;
        }
        if (TILES && ((r + 1) % g.spt == 0 || r + 1 == c.r0 + c.nrows))
            tile_row_end(g, c, r, wi, lane, mytile, g2, cnt, s_tile, out);
    }
    if (!TILES) counts_out(c, wi, lane, cnt, out);
}

template <int C, bool TILES>
__device__ __forceinline__ void search_body(const uint8_t* __restrict__ prev,
                                            const uint8_t* __restrict__ curr,
                                            int32_t* __restrict__ out,
                                            const Search& g) {
    if constexpr (C <= 3) {
        if (g.fast == 8) return search_fast<C, 8, TILES>(prev, curr, out, g);
        if (g.fast == 4) return search_fast<C, 4, TILES>(prev, curr, out, g);
    }
    search_generic<C, TILES>(prev, curr, out, g);
}

template <int C>
__global__ void __launch_bounds__(MS_THREADS, 2) k7_motion_counts(
        const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
        int32_t* __restrict__ counts, const Search g) {
    search_body<C, false>(prev, curr, counts, g);
}

template <int C>
__global__ void __launch_bounds__(MS_THREADS, 2) k8_tile_motion_best(
        const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
        int32_t* __restrict__ out, const Search g) {
    search_body<C, true>(prev, curr, out, g);
}

// The geometry of a search over nf frame pairs of h x w pixels of c bytes
// at this stride, previous frames from `prev`, in bands of `rows` sample
// rows and strips of `strip` sample columns (at most 32), or for K8 (spt
// >= 1) tiles of spt x spt samples, `rows` a multiple of spt and the strip
// whole tiles within 32 lanes (one tile where spt > 32); false where the
// kernel does not take it (the shared memory past SMEM_MAX).  The fast
// path takes strides 4 and 8, pixels of at most 3 bytes, 32-column
// strips, w a multiple of 4, rows of a multiple of 16 bytes from a
// 16-byte boundary, and a staged row no wider than the frame.
bool search_geometry(Search& g, const void* prev, int nf, int h, int w,
                     int c, int stride, int rows, int strip, int spt) {
    if (nf < 1 || h < 1 || w < 1 || c < 1 || stride < 1 || rows < 1 ||
        (long long)h * w > 0x7fffffffLL)
        return false;
    g.nf = nf;
    g.h = h;
    g.w = w;
    g.cs = c;
    g.stride = stride;
    g.sh = (h + stride - 1) / stride;
    g.sw = (w + stride - 1) / stride;
    g.spt = spt;
    g.ty = g.tx = g.tiles = 0;
    if (spt > 0) {
        if (rows % spt || strip < spt || strip % spt ||
            strip > (spt > MS_LANES ? spt : MS_LANES))
            return false;
        g.ty = (g.sh + spt - 1) / spt;
        g.tx = (g.sw + spt - 1) / spt;
        g.tiles = strip / spt;
    } else if (strip < 1 || strip > MS_LANES) {
        return false;
    }
    g.rows = rows;
    g.strip = strip;
    g.bands = (g.sh + rows - 1) / rows;
    g.strips = (g.sw + strip - 1) / strip;
    g.P = stride < SIDE ? stride : SIDE;
    g.Q = strip + (stride < SIDE ? MS_EXTRA / stride : 0);
    const long long cols = (long long)g.P * g.Q;
    g.fast = (stride == 4 || stride == 8) && c <= 3 && strip == MS_LANES &&
                     w % 4 == 0 && ((long long)w * c) % 16 == 0 &&
                     ((uintptr_t)prev & 15) == 0 && cols <= w
                 ? stride
                 : 0;
    // a staging warp's region: fast, the last T + 1 staged rows (T =
    // ceil((2R + 1) / s)) and MS_LAND landing rows of the staged columns'
    // bytes (16-byte granules of up to two runs, and the word past the
    // last), s of them; generic, its one staged row, 2R + 1 of them
    g.lrow = (int)((cols * c + 2 * 16 + 15 + 4) / 16 * 16);
    const int hist = (SIDE + stride - 1) / stride + 1;
    g.wsmem = (int)(g.fast ? hist * cols * 4 + MS_LAND * g.lrow : cols * 4);
    long long o = (long long)(g.fast ? stride : MS_WARPS) * g.wsmem;
    g.o_cur = (int)o;
    o += ((long long)rows * strip * 4 + 15) / 16 * 16;
    g.o_tile = (int)o;
    o += 2LL * g.tiles * CANDS * 4;
    if (o > SMEM_MAX || (long long)nf * g.bands * g.strips > 0x7fffffffLL)
        return false;
    g.smem = (int)o;
    return true;
}

// The instance of a kernel template for c bytes a pixel.
template <typename Kernel>
Kernel by_channels(int c, Kernel k1, Kernel k2, Kernel k3, Kernel kw) {
    return c == 1 ? k1 : c == 2 ? k2 : c == 3 ? k3 : kw;
}

// Launch a K7/K8 instance with g's shared memory (opting in past 48 KB).
template <typename Kernel>
int launch_search(Kernel kern, const Search& g, const void* prev,
                  const void* curr, void* out, void* stream) {
    if (g.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<dim3((unsigned)((long long)g.nf * g.bands * g.strips)),
           MS_THREADS, (size_t)g.smem, (cudaStream_t)stream>>>(
        (const uint8_t*)prev, (const uint8_t*)curr, (int32_t*)out, g);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int nbf_k6_phase_a_diff(const void* prev, const void* curr,
                        const void* shifts, void* masks, void* counts,
                        void* vals, int nf, int nb, int h, int w, int c,
                        void* stream) {
    const long long items = (long long)nb * IPB;
    if (nf < 1 || nb < 1 || h < 1 || w < 1 || c < 1 ||
        (long long)h * w > items || items > 0x7fffffffLL ||
        (long long)nf * nb > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    by_channels(c, k6_phase_a_diff<1>, k6_phase_a_diff<2>,
                k6_phase_a_diff<3>, k6_phase_a_diff<4>)
        <<<dim3((unsigned)(nf * nb)), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)prev, (const uint8_t*)curr,
            (const int32_t*)shifts, (uint8_t*)masks, (int32_t*)counts,
            (int32_t*)vals, nf, nb, h, w, c);
    return (int)cudaGetLastError();
}

int nbf_k7_motion_counts(const void* prev, const void* curr, void* counts,
                         int nf, int h, int w, int c, int stride,
                         int rows_per_cta, int strip, void* stream) {
    Search g;
    if (!search_geometry(g, prev, nf, h, w, c, stride, rows_per_cta, strip,
                         0))
        return (int)cudaErrorInvalidValue;
    return launch_search(
        by_channels(c, k7_motion_counts<1>, k7_motion_counts<2>,
                    k7_motion_counts<3>, k7_motion_counts<4>),
        g, prev, curr, counts, stream);
}

int nbf_k8_tile_motion_best(const void* prev, const void* curr, void* out,
                            int nf, int h, int w, int c, int stride, int spt,
                            int rows_per_cta, int strip, void* stream) {
    Search g;
    if (spt < 1 || !search_geometry(g, prev, nf, h, w, c, stride,
                                    rows_per_cta, strip, spt))
        return (int)cudaErrorInvalidValue;
    return launch_search(
        by_channels(c, k8_tile_motion_best<1>, k8_tile_motion_best<2>,
                    k8_tile_motion_best<3>, k8_tile_motion_best<4>),
        g, prev, curr, out, stream);
}

}  // extern "C"
