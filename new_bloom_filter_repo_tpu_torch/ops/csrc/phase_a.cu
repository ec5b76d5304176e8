// Phase A of the blocked encoder for Hopper (sm_90a): K6 and K7.
//
// Neither replaces a Pallas kernel.  Each replaces a program that the
// JAX package leaves to XLA, which fuses it into one device pass
// (new_bloom_filter_repo_tpu/models/blocked_pipeline.py):
//
//   K6 nbf_k6_phase_a_diff    <- _phase_a_pair :359 and
//                                _phase_a_motion_pair :681
//   K7 nbf_k7_motion_counts   <- _motion_counts_pair :406
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
// K7: for every frame pair and every shift (dy, dx) in [-R, R]^2, the
// number of samples (y, x) = (ys, xs), ys = 0, s, 2s, ... < h and xs =
// 0, s, ... < w, whose current pixel differs from prev[(y - dy) mod h,
// (x - dx) mod w]; candidate index (dy + R) * (2R + 1) + (dx + R).  A
// CTA owns a band of sample rows of one frame.  For each sample row and
// each tile of up to tw sample columns it stages in shared memory the
// 2R + 1 previous-frame rows y - R .. y + R over the tile's columns and
// a halo of R on each side (packed; each thread issues all its loads
// for the 2R + 1 rows, at most 3 columns a row, before it waits on
// one), and the tile's current samples;
// then each of its first (2R + 1)^2 threads counts one candidate over
// the tile in a register.  At the end each candidate's count goes into
// counts[f, :] with one integer atomicAdd per CTA, exact in any order
// (the wrapper zeroes counts).  Its bytes are one read of each previous
// frame and of the current samples; what holds it back is the staging
// (each previous row is staged for every sample row within R of it)
// and the 225 compares per sample, not bytes.
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
constexpr int K7_THREADS = 256;
static_assert(CANDS <= K7_THREADS, "one candidate a thread");
// Most staged columns a thread (a tile stages at most K7_COLS *
// K7_THREADS columns: ops/phase_a.K7_MAX_SPAN)
constexpr int K7_COLS = 3;

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
// K7
// ---------------------------------------------------------------------------

__device__ __forceinline__ int wrap(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
}

template <int C>
__global__ void __launch_bounds__(K7_THREADS) k7_motion_counts(
        const uint8_t* __restrict__ prev, const uint8_t* __restrict__ curr,
        int32_t* __restrict__ counts, int nf, int h, int w, int cs,
        int stride, int rows_per_cta, int tw) {
    extern __shared__ int32_t smem[];
    const int span = (tw - 1) * stride + SIDE;  // staged columns a tile
    int32_t* s_prev = smem;                     // [SIDE][span]
    int32_t* s_cur = smem + SIDE * span;        // [tw]
    const int band = blockIdx.x / nf;
    const int f = blockIdx.x - band * nf;
    const int sh = (h + stride - 1) / stride;
    const int sw = (w + stride - 1) / stride;
    const int r0 = band * rows_per_cta;
    const int r1 = min(sh, r0 + rows_per_cta);
    const int t = threadIdx.x;
    const int dyi = t / SIDE, dxi = t - dyi * SIDE;
    const int pb = pixel_bytes<C>(cs);
    const size_t fo = (size_t)f * (size_t)h * (size_t)w * (size_t)pb;
    const uint8_t* pf = prev + fo;
    const uint8_t* cf = curr + fo;
    // the staged column of the reference pixel of a tile's sample 0 for
    // this thread's candidate: x - dx - (x0 - R) with dx = dxi - R
    const int32_t* mine = s_prev + dyi * span + (2 * R - dxi);
    int cnt = 0;
    for (int r = r0; r < r1; ++r) {
        const int y = r * stride;
        for (int k0 = 0; k0 < sw; k0 += tw) {
            const int nk = min(tw, sw - k0);
            const int x0 = k0 * stride;
            const int cols = (nk - 1) * stride + SIDE;
            // this thread's staged columns ci = t + j * K7_THREADS hold
            // prev column (x0 - R + ci) mod w
            int pxs[K7_COLS];
            int px = wrap(x0 - R + t, w);
#pragma unroll
            for (int j = 0; j < K7_COLS; ++j) {
                pxs[j] = px;
                px += K7_THREADS;
                while (px >= w) px -= w;
            }
            __syncthreads();             // the last tile's compares are done
            // staged row ri holds prev row (y - dy) mod h, dy = ri - R;
            // unrolled, so the 15 * K7_COLS loads are all in flight
            int py = wrap(y + R, h);
#pragma unroll
            for (int ri = 0; ri < SIDE; ++ri) {
                const uint8_t* row = pf + (size_t)py * (size_t)w * pb;
#pragma unroll
                for (int j = 0; j < K7_COLS; ++j) {
                    const int ci = t + j * K7_THREADS;
                    if (ci < cols)
                        s_prev[ri * span + ci] =
                            load1<C>(row, (size_t)pxs[j], cs);
                }
                py = py == 0 ? h - 1 : py - 1;
            }
            const uint8_t* crow = cf + (size_t)y * (size_t)w * pb;
            for (int k = t; k < nk; k += K7_THREADS)
                s_cur[k] = load1<C>(crow, (size_t)x0 + (size_t)k * stride,
                                    cs);
            __syncthreads();
            if (t < CANDS) {
                for (int k = 0; k < nk; ++k)
                    cnt += mine[k * stride] != s_cur[k];
            }
        }
    }
    if (t < CANDS && cnt) atomicAdd(counts + (size_t)f * CANDS + t, cnt);
}

// The instance of a kernel template for c bytes a pixel.
template <typename Kernel>
Kernel by_channels(int c, Kernel k1, Kernel k2, Kernel k3, Kernel kw) {
    return c == 1 ? k1 : c == 2 ? k2 : c == 3 ? k3 : kw;
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
                         int rows_per_cta, int tw, void* stream) {
    if (nf < 1 || h < 1 || w < 1 || c < 1 || stride < 1 ||
        rows_per_cta < 1 || tw < 1 || (long long)h * w > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const long long span = (long long)(tw - 1) * stride + SIDE;
    const long long smem = (SIDE * span + tw) * (long long)sizeof(int32_t);
    const int sh = (h + stride - 1) / stride;
    const long long bands = (sh + rows_per_cta - 1) / rows_per_cta;
    if (span > K7_COLS * K7_THREADS || smem > 48 * 1024 ||
        bands * nf > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    by_channels(c, k7_motion_counts<1>, k7_motion_counts<2>,
                k7_motion_counts<3>, k7_motion_counts<4>)
        <<<dim3((unsigned)(bands * nf)), K7_THREADS, (size_t)smem,
           (cudaStream_t)stream>>>((const uint8_t*)prev, (const uint8_t*)curr,
                                   (int32_t*)counts, nf, h, w, c, stride,
                                   rows_per_cta, tw);
    return (int)cudaGetLastError();
}

}  // extern "C"
