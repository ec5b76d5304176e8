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
// K5a and K5b are K1 and K2 fed with materialized per-frame tables
// a = h1 mod m, b = h2 mod m and act (uint8), which the caller built
// (models/blocked_pipeline._frame_mod_tables): the bodies are shared,
// only the per-item (a, b, lanes) come from global memory instead of
// the hash prelude.  K5a reads ~14 B per item (bits, a, b, act, vals)
// against K1's ~5 B plus the (NB, 1024) tables, so it moves more bytes
// than K1 for the same output.
//
// The work is integer bit manipulation over 1024-item blocks: each item
// is read and written once, so every kernel is bound by device-memory
// bytes, not by arithmetic.  The design keeps one block (1024 items) per
// CTA, one item per thread, and everything a block needs between its
// passes (the <= 12 sub-filter words, the 32 witness words, warp counts)
// in shared memory, so no intermediate touches device memory.
//
// What the TPU kernels needed and these do not: Mosaic had no scatter
// and no integer divide, so the Pallas code routed compaction through a
// butterfly network, folded packed words with static rolls and took
// `h mod m` through an f32 reciprocal.  Here the ranks come from
// __ballot_sync + __popc and a scan over the 32 warp totals, compaction
// is a direct scatter to the item's rank, and `%` is the integer one.
//
// Bit conventions (the stream's): sub-filter bit p is bit 31 - (p & 31)
// of u32 word p >> 5 (np.packbits order per word); witness bit r is bit
// 7 - (r & 7) of byte r >> 3, i.e. MSB-first, which equals big-endian
// u32 words.  The u64 activation test is a real 64-bit compare of
// (act_hi << 32 | act_lo) against (thi << 32 | tlo).
//
// Every entry point is a plain C function: it launches on the stream it
// is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IPB = 1024;         // items per block = threads per CTA
constexpr int NW = 12;            // max u32 sub-filter words per block
constexpr int WW = IPB / 32;      // witness u32 words per block
constexpr int WIT_BYTES = IPB / 8;
constexpr unsigned FULL = 0xffffffffu;

// Exclusive rank of this thread among the threads of the CTA whose
// `pred` is true, in thread order; `*total` receives the count.  Needs
// blockDim.x == IPB.  `warp_buf` is 32 ints of shared memory.  Ends with
// a barrier, so the buffer may be reused by the next call.
__device__ __forceinline__ int block_rank(bool pred, int* warp_buf,
                                          int* total_buf, int* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned bal = __ballot_sync(FULL, pred);
    if (lane == 0) warp_buf[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
        const int v = warp_buf[lane];
        int inc = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int n = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += n;
        }
        warp_buf[lane] = inc - v;             // exclusive warp prefix
        if (lane == 31) *total_buf = inc;
    }
    __syncthreads();
    const int rank = warp_buf[warp] + __popc(bal & ((1u << lane) - 1u));
    *total = *total_buf;
    __syncthreads();
    return rank;
}

// Active lanes of one item: lane j (0 <= j <= k_lanes) is active when
// j < fk, or when j == fk and the item's activation test fired.  Active
// lanes are always a prefix 0..lanes-1.
__device__ __forceinline__ int lanes_of(bool act, int fk, int k_lanes) {
    int det = fk < k_lanes + 1 ? fk : k_lanes + 1;
    if (det < 0) det = 0;
    return det + ((act && fk >= 0 && fk <= k_lanes) ? 1 : 0);
}

// Per-item hash prelude of K1 and K2: a = h1 mod m, b = h2 mod m and
// the number of active lanes, the activation test being the u64 hash
// below the frame's threshold.
__device__ __forceinline__ void prelude(
        const int32_t* __restrict__ h1, const int32_t* __restrict__ h2,
        const int32_t* __restrict__ act_hi, const int32_t* __restrict__ act_lo,
        size_t tab, int m, uint32_t thi, uint32_t tlo, int fk, int k_lanes,
        uint32_t* a, uint32_t* b, int* lanes) {
    const uint32_t um = (uint32_t)m;
    *a = (uint32_t)h1[tab] % um;
    *b = (uint32_t)h2[tab] % um;
    const uint64_t hv = ((uint64_t)(uint32_t)act_hi[tab] << 32)
                        | (uint32_t)act_lo[tab];
    const uint64_t tv = ((uint64_t)thi << 32) | tlo;
    *lanes = lanes_of(hv < tv, fk, k_lanes);
}

// Membership of one item in its block's sub-filter (shared words).
__device__ __forceinline__ bool member(const uint32_t* filt, uint32_t a,
                                       uint32_t b, uint32_t m, int lanes,
                                       uint32_t cap) {
    bool pass = true;
    uint32_t pos = a;
    for (int j = 0; j < lanes; ++j) {
        const uint32_t w = pos < cap ? filt[pos >> 5] : 0u;
        pass = pass && ((w >> (31u - (pos & 31u))) & 1u);
        pos += b;
        if (pos >= m) pos -= m;
    }
    return pass;
}

// Bloom encode of one (block, frame) by its CTA, given every item's
// (a, b, lanes): OR-insert into the shared sub-filter, membership of
// every item, witness bits of the passing items at their rank, values
// of the changed items compacted to their rank, and the two counts.
// Shared by K1 and K5a; `filt`, `witw`, `warp_buf` and `total_buf` are
// the caller's shared memory.
__device__ __forceinline__ void encode_body(
        uint32_t a, uint32_t b, int lanes, int m, bool changed,
        const int32_t* __restrict__ vals, size_t row, int nw, int vslots,
        int32_t* __restrict__ words, uint8_t* __restrict__ wit,
        int32_t* __restrict__ wcnt, int32_t* __restrict__ vseg,
        int32_t* __restrict__ vcnt, uint32_t* filt, uint32_t* witw,
        int* warp_buf, int* total_buf) {
    const int t = threadIdx.x;
    const size_t item = row * IPB + t;
    if (t < NW) filt[t] = 0u;
    if (t < WW) witw[t] = 0u;
    const uint32_t cap = 32u * (uint32_t)nw;
    __syncthreads();                                  // filt, witw zeroed

    if (changed) {                                    // OR-insert
        uint32_t pos = a;
        for (int j = 0; j < lanes; ++j) {
            if (pos < cap) atomicOr(&filt[pos >> 5], 1u << (31u - (pos & 31u)));
            pos += b;
            if (pos >= (uint32_t)m) pos -= (uint32_t)m;
        }
    }
    __syncthreads();

    const bool pass = member(filt, a, b, (uint32_t)m, lanes, cap);
    if (t < nw) words[row * nw + t] = (int32_t)filt[t];

    int npass, nchg;
    const int r = block_rank(pass, warp_buf, total_buf, &npass);
    if (pass && changed) atomicOr(&witw[r >> 5], 1u << (31 - (r & 31)));
    const int slot = block_rank(changed, warp_buf, total_buf, &nchg);
    int32_t* vrow = vseg + row * vslots;
    if (changed && slot < vslots) vrow[slot] = vals[item];
    if (t >= nchg && t < vslots) vrow[t] = 0;       // tail beyond vcnt
    __syncthreads();                                  // witw complete
    if (t < WIT_BYTES) {
        wit[row * WIT_BYTES + t] =
            (uint8_t)(witw[t >> 2] >> (24 - 8 * (t & 3)));
    }
    if (t == 0) {
        wcnt[row] = npass;
        vcnt[row] = nchg;
    }
}

// K1: per (block, frame) Bloom encode with the hash prelude.
// grid = (NB, F), block = 1024.
__global__ void __launch_bounds__(IPB) k1_encode(
        const uint8_t* __restrict__ bits, const int32_t* __restrict__ h1,
        const int32_t* __restrict__ h2, const int32_t* __restrict__ act_hi,
        const int32_t* __restrict__ act_lo, const int32_t* __restrict__ vals,
        const int32_t* __restrict__ m_arr, const int32_t* __restrict__ thi,
        const int32_t* __restrict__ tlo, const int32_t* __restrict__ fk_arr,
        int32_t* __restrict__ words, uint8_t* __restrict__ wit,
        int32_t* __restrict__ wcnt, int32_t* __restrict__ vseg,
        int32_t* __restrict__ vcnt, int nb, int k_lanes, int nw,
        int vslots) {
    __shared__ uint32_t filt[NW];
    __shared__ uint32_t witw[WW];
    __shared__ int warp_buf[32];
    __shared__ int total_buf;
    const int blk = blockIdx.x;
    const int f = blockIdx.y;
    const size_t row = (size_t)f * nb + blk;
    const size_t tab = (size_t)blk * IPB + threadIdx.x;
    const int m = m_arr[f];
    uint32_t a, b;
    int lanes;
    prelude(h1, h2, act_hi, act_lo, tab, m, (uint32_t)thi[f],
            (uint32_t)tlo[f], fk_arr[f], k_lanes, &a, &b, &lanes);
    encode_body(a, b, lanes, m, bits[row * IPB + threadIdx.x] != 0, vals,
                row, nw, vslots, words, wit, wcnt, vseg, vcnt, filt, witw,
                warp_buf, &total_buf);
}

// K5a: K1 on materialized (F, NB, 1024) a, b and act.
// grid = (NB, F), block = 1024.
__global__ void __launch_bounds__(IPB) k5a_encode(
        const uint8_t* __restrict__ bits, const int32_t* __restrict__ a_arr,
        const int32_t* __restrict__ b_arr, const uint8_t* __restrict__ act,
        const int32_t* __restrict__ vals, const int32_t* __restrict__ m_arr,
        const int32_t* __restrict__ fk_arr, int32_t* __restrict__ words,
        uint8_t* __restrict__ wit, int32_t* __restrict__ wcnt,
        int32_t* __restrict__ vseg, int32_t* __restrict__ vcnt, int nb,
        int k_lanes, int nw, int vslots) {
    __shared__ uint32_t filt[NW];
    __shared__ uint32_t witw[WW];
    __shared__ int warp_buf[32];
    __shared__ int total_buf;
    const int f = blockIdx.y;
    const size_t row = (size_t)f * nb + blockIdx.x;
    const size_t item = row * IPB + threadIdx.x;
    const int lanes = lanes_of(act[item] != 0, fk_arr[f], k_lanes);
    encode_body((uint32_t)a_arr[item], (uint32_t)b_arr[item], lanes,
                m_arr[f], bits[item] != 0, vals, row, nw, vslots, words,
                wit, wcnt, vseg, vcnt, filt, witw, warp_buf, &total_buf);
}

// Decode pass mask of one (block, frame) by its CTA, given every item's
// (a, b, lanes), with the per-block pass count fused in.  Shared by K2
// and K5b; `filt` is the caller's shared memory, already loaded with
// the block's words (the caller syncs).
__device__ __forceinline__ void membership_body(
        uint32_t a, uint32_t b, int lanes, int m, bool flagged, size_t row,
        int nw, const uint32_t* filt, uint8_t* __restrict__ passes,
        int32_t* __restrict__ wcnt) {
    const bool pass = !flagged
        && member(filt, a, b, (uint32_t)m, lanes, 32u * (uint32_t)nw);
    passes[row * IPB + threadIdx.x] = pass ? 1 : 0;
    const int cnt = __syncthreads_count(pass);
    if (threadIdx.x == 0) wcnt[row] = cnt;
}

// K2: per (block, frame) decode pass mask with the hash prelude.
// grid = (NB, F), block = 1024.
__global__ void __launch_bounds__(IPB) k2_membership(
        const int32_t* __restrict__ words, int wstride,
        const int32_t* __restrict__ h1, const int32_t* __restrict__ h2,
        const int32_t* __restrict__ act_hi, const int32_t* __restrict__ act_lo,
        const int32_t* __restrict__ m_arr, const int32_t* __restrict__ thi,
        const int32_t* __restrict__ tlo, const int32_t* __restrict__ fk_arr,
        const int32_t* __restrict__ flags, uint8_t* __restrict__ passes,
        int32_t* __restrict__ wcnt, int nb, int k_lanes, int nw) {
    __shared__ uint32_t filt[NW];
    const int t = threadIdx.x;
    const int blk = blockIdx.x;
    const int f = blockIdx.y;
    const size_t row = (size_t)f * nb + blk;
    const size_t tab = (size_t)blk * IPB + t;
    if (t < nw) filt[t] = (uint32_t)words[row * wstride + t];
    const int m = m_arr[f];
    uint32_t a, b;
    int lanes;
    prelude(h1, h2, act_hi, act_lo, tab, m, (uint32_t)thi[f],
            (uint32_t)tlo[f], fk_arr[f], k_lanes, &a, &b, &lanes);
    __syncthreads();
    membership_body(a, b, lanes, m, flags[f] != 0, row, nw, filt, passes,
                    wcnt);
}

// K5b: K2 on materialized (F, NB, 1024) a, b and act.
// grid = (NB, F), block = 1024.
__global__ void __launch_bounds__(IPB) k5b_membership(
        const int32_t* __restrict__ words, int wstride,
        const int32_t* __restrict__ a_arr, const int32_t* __restrict__ b_arr,
        const uint8_t* __restrict__ act, const int32_t* __restrict__ m_arr,
        const int32_t* __restrict__ fk_arr, const int32_t* __restrict__ flags,
        uint8_t* __restrict__ passes, int32_t* __restrict__ wcnt, int nb,
        int k_lanes, int nw) {
    __shared__ uint32_t filt[NW];
    const int t = threadIdx.x;
    const int f = blockIdx.y;
    const size_t row = (size_t)f * nb + blockIdx.x;
    const size_t item = row * IPB + t;
    if (t < nw) filt[t] = (uint32_t)words[row * wstride + t];
    const int lanes = lanes_of(act[item] != 0, fk_arr[f], k_lanes);
    const uint32_t a = (uint32_t)a_arr[item];
    const uint32_t b = (uint32_t)b_arr[item];
    __syncthreads();
    membership_body(a, b, lanes, m_arr[f], flags[f] != 0, row, nw, filt,
                    passes, wcnt);
}

// Change mask and value of one item of one frame (K3 and K4): a passing
// item of rank r among the block's passes reads witness bit r; a flagged
// (pass-through, sparse or empty) frame uses its raw mask instead; the
// i-th changed item takes vseg[i] (0 beyond the segment's slots).
__device__ __forceinline__ bool expand_item(
        const uint8_t* __restrict__ passes, const uint8_t* __restrict__ wit,
        const uint8_t* __restrict__ raw, bool flagged,
        const int32_t* __restrict__ vseg, size_t row, int vslots,
        int* warp_buf, int* total_buf, int32_t* val) {
    const int t = threadIdx.x;
    const size_t item = row * IPB + t;
    const bool p = passes[item] != 0;
    int total;
    const int r = block_rank(p, warp_buf, total_buf, &total);
    bool mask;
    if (flagged) {
        mask = raw[item] != 0;
    } else {
        mask = p && ((wit[row * WIT_BYTES + (r >> 3)] >> (7 - (r & 7))) & 1);
    }
    const int slot = block_rank(mask, warp_buf, total_buf, &total);
    *val = (mask && slot < vslots) ? vseg[row * vslots + slot] : 0;
    return mask;
}

// K3: expansion fused with the frame chain.  The TPU kernel carried the
// running frame in VMEM across a sequential grid axis; CTAs here run in
// no order, so each CTA owns one block column and loops over the frames
// itself, with the running pixel in a register.  grid = (NB), block = 1024.
__global__ void __launch_bounds__(IPB) k3_expand_chain(
        const uint8_t* __restrict__ passes, const uint8_t* __restrict__ wit,
        const uint8_t* __restrict__ raw, const int32_t* __restrict__ flags,
        const int32_t* __restrict__ vseg, const int32_t* __restrict__ base,
        int32_t* __restrict__ out, int nf, int nb, int vslots) {
    __shared__ int warp_buf[32];
    __shared__ int total_buf;
    const int t = threadIdx.x;
    const int blk = blockIdx.x;
    int32_t run = base[(size_t)blk * IPB + t];
    for (int f = 0; f < nf; ++f) {
        const size_t row = (size_t)f * nb + blk;
        int32_t val;
        const bool mask = expand_item(passes, wit, raw, flags[f] != 0, vseg,
                                      row, vslots, warp_buf, &total_buf,
                                      &val);
        if (mask) run = val;
        out[row * IPB + t] = run;
    }
}

// K4: expansion without the chain.  grid = (NB, F), block = 1024.
__global__ void __launch_bounds__(IPB) k4_expand(
        const uint8_t* __restrict__ passes, const uint8_t* __restrict__ wit,
        const uint8_t* __restrict__ raw, const int32_t* __restrict__ flags,
        const int32_t* __restrict__ vseg, uint8_t* __restrict__ mask_out,
        int32_t* __restrict__ vals_out, int nb, int vslots) {
    __shared__ int warp_buf[32];
    __shared__ int total_buf;
    const int f = blockIdx.y;
    const size_t row = (size_t)f * nb + blockIdx.x;
    int32_t val;
    const bool mask = expand_item(passes, wit, raw, flags[f] != 0, vseg, row,
                                  vslots, warp_buf, &total_buf, &val);
    const size_t item = row * IPB + threadIdx.x;
    mask_out[item] = mask ? 1 : 0;
    vals_out[item] = val;
}

}  // namespace

extern "C" {

int nbf_k1_encode(const void* bits, const void* h1, const void* h2,
                  const void* act_hi, const void* act_lo, const void* vals,
                  const void* m, const void* thi, const void* tlo,
                  const void* fk, void* words, void* wit, void* wcnt,
                  void* vseg, void* vcnt, int nf, int nb, int k_lanes,
                  int nw, int vslots, void* stream) {
    k1_encode<<<dim3(nb, nf), IPB, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bits, (const int32_t*)h1, (const int32_t*)h2,
        (const int32_t*)act_hi, (const int32_t*)act_lo, (const int32_t*)vals,
        (const int32_t*)m, (const int32_t*)thi, (const int32_t*)tlo,
        (const int32_t*)fk, (int32_t*)words, (uint8_t*)wit, (int32_t*)wcnt,
        (int32_t*)vseg, (int32_t*)vcnt, nb, k_lanes, nw, vslots);
    return (int)cudaGetLastError();
}

int nbf_k2_membership(const void* words, int wstride, const void* h1,
                      const void* h2, const void* act_hi, const void* act_lo,
                      const void* m, const void* thi, const void* tlo,
                      const void* fk, const void* flags, void* passes,
                      void* wcnt, int nf, int nb, int k_lanes, int nw,
                      void* stream) {
    k2_membership<<<dim3(nb, nf), IPB, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, wstride, (const int32_t*)h1,
        (const int32_t*)h2, (const int32_t*)act_hi, (const int32_t*)act_lo,
        (const int32_t*)m, (const int32_t*)thi, (const int32_t*)tlo,
        (const int32_t*)fk, (const int32_t*)flags, (uint8_t*)passes,
        (int32_t*)wcnt, nb, k_lanes, nw);
    return (int)cudaGetLastError();
}

int nbf_k3_expand_chain(const void* passes, const void* wit, const void* raw,
                        const void* flags, const void* vseg, const void* base,
                        void* out, int nf, int nb, int vslots,
                        void* stream) {
    k3_expand_chain<<<dim3(nb), IPB, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)passes, (const uint8_t*)wit, (const uint8_t*)raw,
        (const int32_t*)flags, (const int32_t*)vseg, (const int32_t*)base,
        (int32_t*)out, nf, nb, vslots);
    return (int)cudaGetLastError();
}

int nbf_k4_expand(const void* passes, const void* wit, const void* raw,
                  const void* flags, const void* vseg, void* mask_out,
                  void* vals_out, int nf, int nb, int vslots, void* stream) {
    k4_expand<<<dim3(nb, nf), IPB, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)passes, (const uint8_t*)wit, (const uint8_t*)raw,
        (const int32_t*)flags, (const int32_t*)vseg, (uint8_t*)mask_out,
        (int32_t*)vals_out, nb, vslots);
    return (int)cudaGetLastError();
}

int nbf_k5a_encode(const void* bits, const void* a, const void* b,
                   const void* act, const void* vals, const void* m,
                   const void* fk, void* words, void* wit, void* wcnt,
                   void* vseg, void* vcnt, int nf, int nb, int k_lanes,
                   int nw, int vslots, void* stream) {
    k5a_encode<<<dim3(nb, nf), IPB, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bits, (const int32_t*)a, (const int32_t*)b,
        (const uint8_t*)act, (const int32_t*)vals, (const int32_t*)m,
        (const int32_t*)fk, (int32_t*)words, (uint8_t*)wit, (int32_t*)wcnt,
        (int32_t*)vseg, (int32_t*)vcnt, nb, k_lanes, nw, vslots);
    return (int)cudaGetLastError();
}

int nbf_k5b_membership(const void* words, int wstride, const void* a,
                       const void* b, const void* act, const void* m,
                       const void* fk, const void* flags, void* passes,
                       void* wcnt, int nf, int nb, int k_lanes, int nw,
                       void* stream) {
    k5b_membership<<<dim3(nb, nf), IPB, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, wstride, (const int32_t*)a,
        (const int32_t*)b, (const uint8_t*)act, (const int32_t*)m,
        (const int32_t*)fk, (const int32_t*)flags, (uint8_t*)passes,
        (int32_t*)wcnt, nb, k_lanes, nw);
    return (int)cudaGetLastError();
}

}  // extern "C"
