// What the transit (transit_rt.cu) and emission (emission_rt.cu) kernels
// share: the block layout, the staging of the chain-invariant tables and
// the assembly of the extinction (the Assembler below is the emission
// kernel's; the transit kernel assembles its own, transit_rt.cu says how).
//
// Layout.  A block owns one tile of TW = 64 wave columns and a group of
// chains.  A team of two warps takes one chain at a time over the whole
// tile, one column a lane (lane t of the team's warp m owns column
// 32 m + t), so every global or shared access of a warp is one contiguous
// 128-byte row and needs no alignment beyond 4 bytes (the flagship's 3209
// columns are odd).  The teams of a block work on different chains of the
// group; a team synchronises on its own named barrier, and the block only
// once, after its tables are staged.
//
// Why teams, and one column a lane.  These kernels are bound by latency,
// not by any pipe: with the slab below a block fills its SM alone, a warp
// runs its instructions in order, and a chain's pass is a long chain of
// dependent steps.
// Their time falls with the warps a block may hold (NVIDIA H100 80GB HBM3,
// 700 W, builds with MAX_WARPS lowered: transit 2.48, 1.28, 0.97, 0.86 ms
// at 4, 8, 12, 16 warps; emission 1.89, 1.01, 0.82, 0.76 ms at 6, 12, 18,
// 24).
// What counts is the chains in flight, which the shared memory bounds
// (8 of the transit kernel's regions fit beside the flagship's slab, 15
// of the emission kernel's, of which its 24 warps use 12), and the
// registers bound the warps: two columns a lane halve the
// shared-memory reads of an FMA but need twice the registers.  A version
// with one warp a chain and two columns a lane took 0.90 ms (transit, 8
// warps) and 0.75 ms (emission, 14 warps) in chip_smoke.py; this one
// 0.84 ms and 0.74 ms.
//
// Chain-invariant operands, staged once per block:
//   * the line-sample slab ls_tab[K2, l, tile] in shared memory
//     (K2 * l * 64 floats: 130,560 bytes at K2 = 10, l = 51);
//   * the tile's CIA table rows: in the emission kernel KP (16 or 32,
//     zero padded) in each thread's registers, in the transit kernel in
//     shared memory (n_cia * 64 floats).
// (The transit kernel's tall function, above 64 layers, keeps no slab:
// it streams the live line-sample rows through its ring; transit_rt.cu
// says why.)
// Per chain, a team copies its weights into its own shared-memory region:
// CIA [rows, KP], line sample [rows, K2P] and the layer columns (rank-1
// columns among them), which the wrapper has already padded and laid out
// this way, so the copy is linear, 16 bytes at a time, all in flight at
// once (cp.async); the rank-1 rows of a thread's column stay in registers.
// (The transit kernel up to 64 layers stages, in place of the weights,
// each layer's first two non-zero CIA and line-sample weights and their
// offsets in the tables.)
// Dense [B, l, W] parts stream through a per-team ring of RING rows filled
// with cp.async, each lane copying and reading back only its own column.
//
// The extinction of a layer, in the order of the Pallas kernels
// (ensemble_pallas.py _ensemble_kernel): dense parts, rank-1 terms, the
// CIA product (summed on its own, then added), the line-sample terms in
// ascending k.  The line-sample weights are two-hot along temperature, so
// only the non-zero weights of a layer are visited: after the copy the
// team scans the weights of each layer into a bit mask, and the assembly
// walks the set bits (tests on a broadcast word, uniform over the warp).
// It adds exactly the terms that are non-zero, and a NaN weight counts as
// non-zero.  (Testing each weight in the layer loop costs a branch a
// weight: with that, a serial staging and an unrolled epilogue the
// transit kernel took 1.63 ms in chip_smoke.py where this scheme, a
// linear staging and a looped epilogue took 0.98 ms.)
// The assembly works on four layers at a time, whose CIA sums and table
// reads are independent of each other, because a warp runs in order and
// one layer's CIA sum alone is a chain of dependent FMAs.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace pbt {

constexpr int TW = 64;          // wave columns per block
constexpr int TEAM = 2;         // warps that share a chain
constexpr int MAX_PARTS = 4;    // dense extinction parts
constexpr int MAX_R1 = 4;       // rank-1 (column, row) pairs
constexpr int RING = 8;         // rows of a dense part in flight per team
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Pointers of the dense parts, separate members: none is indexed at run
// time, so the struct stays in the constant bank.
struct Parts {
    const float* p0;
    const float* p1;
    const float* p2;
    const float* p3;
    int n;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The team's own barrier (0 is the block's):
__device__ __forceinline__ void team_sync(int team) {
    asm volatile("bar.sync %0, %1;\n"
                 :: "r"(team + 1), "n"(32 * TEAM) : "memory");
}

// A 16-byte aligned block of n floats (a multiple of 4) by one team;
// tlane is the thread's index in the team.
__device__ __forceinline__ void copy_block(
        float* dst, const float* __restrict__ src, int n, int tlane) {
    for (int i = 4 * tlane; i < n; i += 4 * 32 * TEAM)
        cp_async16(dst + i, src + i);
}

// The block's line-sample slab: s_tab[(k * L + j) * TW + col], zero in
// the columns past nwave.  Every copy is in flight at once (cp.async);
// the caller waits for them and synchronises the block.
__device__ __forceinline__ void load_slab(
        float* s_tab, const float* __restrict__ ls_tab, int rows,
        int tile0, int nwave) {
    const int total = rows * TW;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int w = tile0 + (idx & (TW - 1));
        if (w < nwave)
            cp_async4(s_tab + idx, ls_tab + (size_t)(idx / TW) * nwave + w);
        else
            s_tab[idx] = 0.f;
    }
}

// Row `row` of the chain's dense parts into the ring, each thread its own
// column (col in the tile, w in the spectrum, copied if valid): one
// commit group per row, empty past the last layer or without dense parts.
__device__ __forceinline__ void ring_fetch(
        float* ring, const Parts& parts, size_t chain_off, int row, int L,
        int nwave, int col, int w, bool valid) {
    if (row < L && parts.n > 0 && valid) {
        const size_t at = chain_off + (size_t)row * nwave + w;
        float* dst = ring + (row & (RING - 1)) * TW + col;
        if (parts.n > 0) cp_async4(dst, parts.p0 + at);
        if (parts.n > 1) cp_async4(dst + RING * TW, parts.p1 + at);
        if (parts.n > 2) cp_async4(dst + 2 * RING * TW, parts.p2 + at);
        if (parts.n > 3) cp_async4(dst + 3 * RING * TW, parts.p3 + at);
    }
    cp_async_commit();
}

// The first two set bits of a mask word (k0, k1; one, two say whether
// they exist), and the word without them.
__device__ __forceinline__ unsigned first_two(
        unsigned live, bool& one, bool& two, int& k0, int& k1) {
    one = live != 0;
    k0 = one ? __ffs(live) - 1 : 0;
    live &= live - 1;
    two = live != 0;
    k1 = two ? __ffs(live) - 1 : k0;
    return live & (live - 1);
}

// Chain b's rank-1 rows of column w, zero past n_r1 or an invalid column.
__device__ __forceinline__ void load_r1_rows(
        float (&r1r)[MAX_R1], const float* __restrict__ r1_rows, int n_r1,
        int b, int nwave, int w, bool valid) {
#pragma unroll
    for (int r = 0; r < MAX_R1; ++r)
        r1r[r] = r < n_r1 && valid
            ? r1_rows[((size_t)b * n_r1 + r) * nwave + w] : 0.f;
}

// e[t] += the rank-1 terms of layer j0 + t (j0 a multiple of 4; s_r1c the
// rank-1 columns [n_r1][rows], r1r the column's rank-1 rows).
__device__ __forceinline__ void add_rank1(
        float (&e)[4], const float* s_r1c, int rows, int j0,
        const float (&r1r)[MAX_R1], int n_r1) {
#pragma unroll
    for (int r = 0; r < MAX_R1; ++r) {
        if (r < n_r1) {
            const float4 c =
                *reinterpret_cast<const float4*>(s_r1c + r * rows + j0);
            e[0] += c.x * r1r[r];
            e[1] += c.y * r1r[r];
            e[2] += c.z * r1r[r];
            e[3] += c.w * r1r[r];
        }
    }
}

// What a thread needs to assemble the extinction of its column.
template <int KP>
struct Assembler {
    // Registers:
    float ct[KP];               // CIA table rows of the column
    float r1r[MAX_R1];          // rank-1 rows of the column
    // Shared memory (the team's own region, and the block's slab):
    const float* s_ciaw;        // [rows][KP]
    const float* s_lsw;         // [rows][K2P]
    const unsigned* s_mask;     // [rows][words]: the non-zero weights
    const float* s_r1c;         // [n_r1][rows]
    const float* s_tab;         // [K2][L][TW]
    const float* ring;          // [n_parts][RING][TW]
    int n_parts, n_r1, n_cia, K2P, L, rows, col;

    __device__ __forceinline__ void load_cia_table(
            const float* __restrict__ cia_tab, int nwave, int w,
            bool valid) {
#pragma unroll
        for (int k = 0; k < KP; ++k)
            ct[k] = k < n_cia && valid ? cia_tab[(size_t)k * nwave + w]
                : 0.f;
    }

    __device__ __forceinline__ void load_r1_rows(
            const float* __restrict__ r1_rows, int b, int nwave, int w,
            bool valid) {
        pbt::load_r1_rows(r1r, r1_rows, n_r1, b, nwave, w, valid);
    }

    // Extinction of the layers j0 .. j0 + 3 (j0 a multiple of 4) in the
    // thread's column.  The dense parts' rows must have landed in the
    // ring (cp_async_wait); the weights of the padded layers past L are
    // zero.
    __device__ __forceinline__ void rows4(int j0, float (&e)[4]) const {
#pragma unroll
        for (int t = 0; t < 4; ++t) e[t] = 0.f;
        if (n_parts > 0) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                if (j0 + t < L) {
                    const float* slot =
                        ring + ((j0 + t) & (RING - 1)) * TW + col;
                    e[t] = slot[0];
#pragma unroll
                    for (int p = 1; p < MAX_PARTS; ++p)
                        if (p < n_parts) e[t] += slot[p * RING * TW];
                }
            }
        }
        add_rank1(e, s_r1c, rows, j0, r1r, n_r1);
        if (n_cia > 0) {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int k4 = 0; k4 < KP / 4; ++k4) {
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    const float4 wv = *reinterpret_cast<const float4*>(
                        s_ciaw + (j0 + t) * KP + 4 * k4);
                    c[t] = fmaf(wv.x, ct[4 * k4], c[t]);
                    c[t] = fmaf(wv.y, ct[4 * k4 + 1], c[t]);
                    c[t] = fmaf(wv.z, ct[4 * k4 + 2], c[t]);
                    c[t] = fmaf(wv.w, ct[4 * k4 + 3], c[t]);
                }
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) e[t] += c[t];
        }
        if (K2P > 0) {
            const int words = (K2P + 31) >> 5;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int j = j0 + t;
                const float* wrow = s_lsw + j * K2P;
                const float* tab = s_tab + j * TW + col;
                // The first two non-zero weights without a branch (the
                // two-hot case is over after them):
                bool one, two;
                int k0, k1;
                unsigned live = first_two(s_mask[j * words], one, two, k0, k1);
                const float wa = one ? wrow[k0] : 0.f;
                const float wb = two ? wrow[k1] : 0.f;
                const float ta = one ? tab[k0 * L * TW] : 0.f;
                const float tb = two ? tab[k1 * L * TW] : 0.f;
                if (one) e[t] = fmaf(wa, ta, e[t]);
                if (two) e[t] = fmaf(wb, tb, e[t]);
                // Any further ones (several species, or several words):
                if (live != 0 || words > 1) {
                    for (int word = 0; word < words; ++word) {
                        if (word > 0) live = s_mask[j * words + word];
                        while (live) {
                            const int k = 32 * word + __ffs(live) - 1;
                            live &= live - 1;
                            e[t] = fmaf(wrow[k], tab[k * L * TW], e[t]);
                        }
                    }
                }
            }
        }
    }
};

// Floats of a team's assembly region (multiples of 4): CIA weights,
// line-sample weights and their masks, the layer columns, the parts ring.
__host__ __device__ inline int assembly_floats(
        int rows, int KP, int n_cia, int K2P, int ncols, int n_parts) {
    return (n_cia ? rows * KP : 0) + rows * K2P + rows * ((K2P + 31) >> 5)
        + ncols * rows + n_parts * RING * TW;
}

// One chain's weights and layer columns into the team's region, as
// asynchronous copies (the caller commits, waits and synchronises the
// team, then calls build_mask).
__device__ __forceinline__ void stage_chain(
        float* s_ciaw, float* s_lsw, float* s_cols,
        const float* __restrict__ cia_w, const float* __restrict__ ls_w,
        const float* __restrict__ cols, int b, int rows, int KP, int n_cia,
        int K2P, int ncols, int tlane) {
    if (n_cia)
        copy_block(s_ciaw, cia_w + (size_t)b * rows * KP, rows * KP, tlane);
    if (K2P)
        copy_block(s_lsw, ls_w + (size_t)b * rows * K2P, rows * K2P, tlane);
    copy_block(s_cols, cols + (size_t)b * ncols * rows, ncols * rows, tlane);
}

// Bit k of word (j, k / 32) says that the line-sample weight k of layer j
// is not zero.  The team's threads take layers; synchronises the team.
__device__ __forceinline__ void build_mask(
        unsigned* s_mask, const float* s_lsw, int rows, int K2P, int tlane,
        int team) {
    const int words = (K2P + 31) >> 5;
    for (int j = tlane; j < rows; j += 32 * TEAM) {
        for (int word = 0; word < words; ++word) {
            unsigned live = 0;
            for (int k = 32 * word; k < min(K2P, 32 * word + 32); ++k)
                if (s_lsw[j * K2P + k] != 0.f) live |= 1u << (k & 31);
            s_mask[j * words + word] = live;
        }
    }
    team_sync(team);
}

}  // namespace pbt
