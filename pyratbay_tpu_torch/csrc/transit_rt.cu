// Ensemble transit radiative transfer for Hopper (sm_90a), float32.
//
// Replaces two Pallas TPU kernels of pyratbay_tpu:
//   * spectrum/ensemble_pallas.py  _ensemble_kernel (transit_spectrum_ensemble)
//   * spectrum/rt_pallas.py        _transit_kernel  (transit_spectrum_fused),
//     which is the same computation for one chain (B = 1);
// with the per-chain epilogue of rt_pallas.py chain_rt_epilogue.
//
// Per chain b and wavenumber column w:
//   ec[j]   = sum of dense parts[b, j, w]
//           + sum_r r1_cols[b, r, j] * r1_rows[b, r, w]
//           + sum_k cia_w[b, j, k] * cia_tab[k, w]
//           + sum_k ls_w[b, k, j] * ls_tab[k, j, w]     (line sample)
//   depth[i] = sum_j path2[b, i, j] * ec[j]      (chord matrix, pair-sum fold)
//   ideep   = first row i in [itop, ibottom) with depth > maxdepth,
//             else ibottom - 1
//   integ[i] = exp(-depth[i]) * r[i], row deck_itop spliced with the deck
//             surface when deck_itop > itop
//   out[b, w] = (r_itop^2 + 2 * sum_i integ[i] * coef[i]) / rstar^2, with
//             coef = 0.5 (h[i] m[i] + h[i-1] mp[i]),
//             m = in_range & i < ideep, mp = i >= itop+1 & i <= ideep.
//
// Design (the block layout, the teams, the staging and the assembly of
// the extinction are in rt_common.cuh).  The chord product is the bulk of
// the arithmetic, and it runs from registers: a thread keeps the depth
// column of its wave column, d[LP] with LP the layer count padded to a
// multiple of 4 (a template parameter: 32, 52 or 64), and walks the layers
// j in ascending order as an outer product.  It assembles ec[j], four
// layers at a time and never stored, then adds path2[i, j] * ec[j] to the
// d[i] below.  The chord matrix is zero above its diagonal
// (transit_path_matrix), so rows i < j would add zeros: a layer adds only
// to the rows from the first of its chunk of four on, which drops 44% of
// the FMAs at 51 layers, and a layer j < itop, whose whole column is
// zero, skips its FMAs too.  The registers want static indices, so every
// chunk's row range is its own unrolled code, reached through a switch;
// the loops around it stay loops (with the whole layer loop and the
// epilogue unrolled, 96 KB of code, the kernel waited for its
// instructions: 2.7 ms).  Each d[i] receives its non-zero terms in the
// order j = 0, 1, ... of the earlier row-by-row kernel.  The matrix comes
// packed from the wrapper (transit_kernel.py chord_layout: layer j's row
// holds path2[i, j] for the rows from its chunk's first on), so a warp
// reads it as 16-byte broadcast loads, one for four independent FMAs.
// The epilogue (ideep, exp, deck splice, masked trapezoid) then runs down
// d, exact as before: the ideep known so far (first exceed, else
// ibottom - 1) gives every row the coefficient of the final ideep.  The
// rows leave the registers through the team's dead chord matrix, so that
// one loop with a run-time row serves them all.  Every row's integ * coef
// is added, zero coefficients included, so NaN/inf propagate as in the
// Pallas kernel; the skipped zero terms would have turned a non-finite
// ec[j] into NaN in every row, which a sum of ec[j] * 0 added to the
// result restores.  No index is taken from data: itop, ibottom and the
// deck row are only compared, so a rejected chain computes garbage but
// cannot fault.  No fast-math, no TF32: the result needs full float32.
//
// Bound on the H100 at the flagship shape (B = 512, l = 51, W = 3209,
// K = 15, K2 = 10, line sample in the kernel): 4.4 GFLOP for the
// triangular chord product (l (l + 1) / 2 FMAs a column), 2.5 GFLOP for
// CIA, 0.3 GFLOP for the two live line-sample terms a layer, all fp32 FMAs
// outside the tensor cores, so ~0.12 ms at the card's 67 TFLOP/s; the
// bytes are 6.5 MB of table, 5.3 MB of chord matrices, 3 MB of weights
// and a 6.6 MB result, ~0.01 ms at 3.35 TB/s.  With the line sample as a
// dense part the 335 MB part is read once, ~0.10 ms.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: 0.84 ms of device time (0.79 ms on a
// dense part), against 1.99 ms for the kernel this replaces (one thread a
// column, the extinction column and the chord matrix read from shared
// memory for every FMA, the whole square matrix).  What is left is
// latency: a chain takes a warp ~58,000 cycles (a build with clock64()
// around the phases, not kept: the assembly 36%, the chord product 38%,
// the epilogue 16%, staging 8%; ~39,000 with the SM to itself), and the
// 130 KB slab leaves room for eight chains in flight on an SM.
// PERF.md has the runs and the designs that were tried.
//
// Tall atmospheres (more than 64 layers: reference users run 81 and 100)
// take a second function, transit_rt_tall_kernel, because a depth column
// of that height no longer fits the registers.  It is the simple design of
// the first version of this file: the team assembles its chain's
// extinction (the same Assembler: dense parts, rank-1 terms, CIA; no line
// sample, which the forward then hands over as a dense part) into a
// [rows][64] column block in shared memory, each lane its own column, and
// then walks the rows once: row i's depth is a dot product of the
// broadcast row of the chord matrix, packed as its lower triangle
// (j <= i, from itop on), with the lane's extinction column, followed by
// the same epilogue step as above.  Two shared-memory loads an FMA bound
// it, as they bounded the first version (4.8 TFLOP/s); its shared memory,
// the triangle (l (l + 1) / 2 floats) and the column block of one chain a
// team, sets the largest layer count, about 250 with the usual operands
// (pbt_transit_rt_tall_warps returns 0 above it, and the wrapper raises).
#include "rt_common.cuh"

namespace {

using namespace pbt;

constexpr int MAX_WARPS = 16;    // warps of a block, at most

// Offset of chunk q (four layers) in the packed chord matrix, and its
// whole size (q = NL4), in floats: the layers of chunk q hold the rows
// from 4 q to the padded last.
__host__ __device__ constexpr int chunk_base(int NL4, int q) {
    return 16 * (q * NL4 - q * (q - 1) / 2);
}

// Floats of a team's region (all multiples of 4): the packed chord
// matrix, then the assembly region of rt_common.cuh, with room for the
// CIA weights whether or not there are any (the epilogue parks rows there).
__host__ __device__ inline int team_floats(
        int NL4, int KP, int K2P, int ncols, int n_parts) {
    return chunk_base(NL4, NL4)
        + assembly_floats(4 * NL4, KP, 1, K2P, ncols, n_parts);
}

// d[i] += path2[i, j] * ec[j] for layer j of chunk Q and the rows from
// 4 Q on:
template <int NL4, int Q>
__device__ __forceinline__ void add_layer(
        float (&d)[4 * NL4], const float* s_pt, int j, float e) {
    if constexpr (Q < NL4) {
        const float4* prow = reinterpret_cast<const float4*>(
            s_pt + chunk_base(NL4, Q) + (j - 4 * Q) * 4 * (NL4 - Q));
#pragma unroll
        for (int i4 = Q; i4 < NL4; ++i4) {
            const float4 p = prow[i4 - Q];
            d[4 * i4] = fmaf(p.x, e, d[4 * i4]);
            d[4 * i4 + 1] = fmaf(p.y, e, d[4 * i4 + 1]);
            d[4 * i4 + 2] = fmaf(p.z, e, d[4 * i4 + 2]);
            d[4 * i4 + 3] = fmaf(p.w, e, d[4 * i4 + 3]);
        }
    }
}

// The layer's chunk decides which rows it adds to: every chunk is its own
// unrolled code, because the registers of d want static indices.
template <int NL4>
__device__ __forceinline__ void add_to_rows(
        float (&d)[4 * NL4], const float* s_pt, int j, int chunk, float e) {
    switch (chunk) {
#define PBT_CHUNK(Q) \
    case Q: add_layer<NL4, Q>(d, s_pt, j, e); break;
        PBT_CHUNK(0) PBT_CHUNK(1) PBT_CHUNK(2) PBT_CHUNK(3)
        PBT_CHUNK(4) PBT_CHUNK(5) PBT_CHUNK(6) PBT_CHUNK(7)
        PBT_CHUNK(8) PBT_CHUNK(9) PBT_CHUNK(10) PBT_CHUNK(11)
        PBT_CHUNK(12) PBT_CHUNK(13) PBT_CHUNK(14) PBT_CHUNK(15)
#undef PBT_CHUNK
    }
}

template <int NL4, int KP>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1) transit_rt_kernel(
        Parts parts, const float* __restrict__ r1_rows, int n_r1,
        const float* __restrict__ cia_w, const float* __restrict__ cia_tab,
        int n_cia,
        const float* __restrict__ ls_w, const float* __restrict__ ls_tab,
        int n_ls,
        const float* __restrict__ packed, const float* __restrict__ cols,
        const float* __restrict__ scal, float* __restrict__ out,
        int nchains, int group, int nlayers, int nwave, float maxdepth) {
    constexpr int LP = 4 * NL4;
    constexpr int PK = chunk_base(NL4, NL4);
    // Rows of d that the epilogue can park in the dead chord matrix and
    // CIA weights at a time:
    constexpr int PARK = (PK + LP * KP) / TW < LP ? (PK + LP * KP) / TW : LP;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int L = nlayers;
    const int K2P = round4(n_ls);
    const int ncols = 3 + n_r1;
    const int lane = threadIdx.x & 31;
    const int team = threadIdx.x / (32 * TEAM);
    const int nteams = blockDim.x / (32 * TEAM);
    const int tlane = threadIdx.x % (32 * TEAM);   // the column in the tile
    const int w = blockIdx.x * TW + tlane;
    const bool valid = w < nwave;

    float* s_tab = smem;                                   // [n_ls][L][TW]
    const int region = team_floats(NL4, KP, K2P, ncols, parts.n);
    float* s_pt = smem + n_ls * L * TW + team * region;    // packed path2T
    float* s_ciaw = s_pt + PK;                             // [LP][KP]
    float* s_lsw = s_ciaw + LP * KP;                       // [LP][K2P]
    unsigned* s_mask = reinterpret_cast<unsigned*>(s_lsw + LP * K2P);
    float* s_cols = s_lsw + LP * K2P + LP * ((K2P + 31) >> 5);
    const float* s_rad = s_cols;                           // [LP]
    const float* s_h = s_cols + LP;                        // [LP]
    const float* s_hprev = s_cols + 2 * LP;                // [LP]
    float* ring = s_cols + ncols * LP;                     // parts ring

    load_slab(s_tab, ls_tab, n_ls * L, blockIdx.x * TW, nwave);
    for (int i = tlane; i < region; i += 32 * TEAM) s_pt[i] = 0.f;

    Assembler<KP> as;
    as.s_ciaw = s_ciaw;
    as.s_lsw = s_lsw;
    as.s_mask = s_mask;
    as.s_r1c = s_cols + 3 * LP;
    as.s_tab = s_tab;
    as.ring = ring;
    as.n_parts = parts.n;
    as.n_r1 = n_r1;
    as.n_cia = n_cia;
    as.K2P = K2P;
    as.L = L;
    as.rows = LP;
    as.col = tlane;
    as.load_cia_table(cia_tab, nwave, w, valid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int c = team; c < group; c += nteams) {
        const int b = blockIdx.y * group + c;
        if (b >= nchains) break;
        team_sync(team);

        // The chain's operands into the team's region, all copies in
        // flight together, and the first rows of the dense parts:
        copy_block(s_pt, packed + (size_t)b * PK, PK, tlane);
        stage_chain(s_ciaw, s_lsw, s_cols, cia_w, ls_w, cols, b, LP, KP,
                    n_cia, K2P, ncols, tlane);
        cp_async_commit();
        const size_t chain_off = (size_t)b * L * nwave;
        for (int r = 0; r < RING; ++r)
            ring_fetch(ring, parts, chain_off, r, L, nwave, tlane, w, valid);
        as.load_r1_rows(r1_rows, b, nwave, w, valid);
        const float* sc = scal + (size_t)b * 8;
        const int itop = (int)sc[0];
        const int ibottom = (int)sc[1];
        const int deck_row = (int)sc[2];
        const bool apply_deck = sc[3] > 0.5f;
        const float w_surf = sc[4];
        const float inv_rstar2 = sc[5];
        const float r_itop2 = sc[6];
        cp_async_wait<RING>();
        team_sync(team);
        build_mask(s_mask, s_lsw, LP, K2P, tlane, team);

        // Outer product down the layers, four at a time:
        float d[LP];
#pragma unroll
        for (int i = 0; i < LP; ++i) d[i] = 0.f;
        float poison = 0.f;
#pragma unroll 1
        for (int chunk = 0; 4 * chunk < L; ++chunk) {
            const int j0 = 4 * chunk;
            // The ring holds the layers j0 .. j0 + 7; the first four must
            // have landed, and their slots take the next four after use.
            if (parts.n > 0) cp_async_wait<4>();
            float e[4];
            as.rows4(j0, e);
            if (parts.n > 0) {
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    ring_fetch(ring, parts, chain_off, j0 + RING + t, L,
                               nwave, tlane, w, valid);
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) poison = fmaf(e[t], 0.f, poison);
#pragma unroll 1
            for (int t = 0; t < 4; ++t) {
                const int j = j0 + t;
                const float ej =
                    t == 0 ? e[0] : t == 1 ? e[1] : t == 2 ? e[2] : e[3];
                if (j >= itop && j < L)
                    add_to_rows<NL4>(d, s_pt, j, chunk, ej);
            }
        }
        cp_async_wait<0>();
        // The other warp of the team may still read the chord matrix:
        team_sync(team);

        // Epilogue down the rows, PARK rows at a time through the team's
        // dead chord matrix and CIA weights (each lane reads back only
        // what it parked).
        int ideep = ibottom - 1;
        bool found = false;
        float integral = 0.f;
        float prev = 0.f;
#pragma unroll
        for (int first = 0; first < LP; first += PARK) {
#pragma unroll
            for (int i = first; i < first + PARK && i < LP; ++i)
                s_pt[(i - first) * TW + tlane] = d[i];
            const int last = min(L, first + PARK);
#pragma unroll 4
            for (int i = first; i < last; ++i) {
                const float di = s_pt[(i - first) * TW + tlane];
                const bool in_range = i >= itop && i < ibottom;
                if (!found && in_range && di > maxdepth) {
                    found = true;
                    ideep = i;
                }
                const float raw = expf(-di) * s_rad[i];
                float integ = raw;
                if (apply_deck && i == deck_row)
                    integ = prev * (1.f - w_surf) + raw * w_surf;
                const float m = (in_range && i < ideep) ? 1.f : 0.f;
                const float mp = (i >= itop + 1 && i <= ideep) ? 1.f : 0.f;
                integral += integ * (0.5f * (s_h[i] * m + s_hprev[i] * mp));
                prev = raw;
            }
        }
        if (valid)
            out[(size_t)b * nwave + w] =
                (r_itop2 + 2.f * integral) * inv_rstar2 + poison;
    }
}

// Floats of the packed lower triangle of an l-layer chord matrix (row i
// holds columns 0 .. i from offset i (i + 1) / 2), and of a team's region
// in the tall function: the triangle, the extinction columns [rows][TW],
// then the assembly region without a line sample.
__host__ __device__ inline int tri_floats(int L) {
    return round4(L * (L + 1) / 2);
}

__host__ __device__ inline int tall_team_floats(
        int L, int KP, int ncols, int n_parts) {
    const int rows = round4(L);
    return tri_floats(L) + rows * TW
        + assembly_floats(rows, KP, 1, 0, ncols, n_parts);
}

template <int KP>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1) transit_rt_tall_kernel(
        Parts parts, const float* __restrict__ r1_rows, int n_r1,
        const float* __restrict__ cia_w, const float* __restrict__ cia_tab,
        int n_cia, const float* __restrict__ tri,
        const float* __restrict__ cols, const float* __restrict__ scal,
        float* __restrict__ out, int nchains, int group, int nlayers,
        int nwave, float maxdepth) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int L = nlayers;
    const int rows = round4(L);
    const int PT = tri_floats(L);
    const int ncols = 3 + n_r1;
    const int team = threadIdx.x / (32 * TEAM);
    const int nteams = blockDim.x / (32 * TEAM);
    const int tlane = threadIdx.x % (32 * TEAM);   // the column in the tile
    const int w = blockIdx.x * TW + tlane;
    const bool valid = w < nwave;

    const int region = tall_team_floats(L, KP, ncols, parts.n);
    float* s_tri = smem + team * region;                   // packed path2
    float* s_ec = s_tri + PT;                              // [rows][TW]
    float* s_ciaw = s_ec + rows * TW;                      // [rows][KP]
    float* s_cols = s_ciaw + rows * KP;                    // [ncols][rows]
    const float* s_rad = s_cols;
    const float* s_h = s_cols + rows;
    const float* s_hprev = s_cols + 2 * rows;
    float* ring = s_cols + ncols * rows;                   // parts ring
    for (int i = tlane; i < region; i += 32 * TEAM) s_tri[i] = 0.f;

    Assembler<KP> as;
    as.s_ciaw = s_ciaw;
    as.s_lsw = nullptr;
    as.s_mask = nullptr;
    as.s_r1c = s_cols + 3 * rows;
    as.s_tab = nullptr;
    as.ring = ring;
    as.n_parts = parts.n;
    as.n_r1 = n_r1;
    as.n_cia = n_cia;
    as.K2P = 0;
    as.L = L;
    as.rows = rows;
    as.col = tlane;
    as.load_cia_table(cia_tab, nwave, w, valid);
    __syncthreads();

    for (int c = team; c < group; c += nteams) {
        const int b = blockIdx.y * group + c;
        if (b >= nchains) break;
        team_sync(team);

        copy_block(s_tri, tri + (size_t)b * PT, PT, tlane);
        stage_chain(s_ciaw, nullptr, s_cols, cia_w, nullptr, cols, b, rows,
                    KP, n_cia, 0, ncols, tlane);
        cp_async_commit();
        const size_t chain_off = (size_t)b * L * nwave;
        for (int r = 0; r < RING; ++r)
            ring_fetch(ring, parts, chain_off, r, L, nwave, tlane, w, valid);
        as.load_r1_rows(r1_rows, b, nwave, w, valid);
        const float* sc = scal + (size_t)b * 8;
        const int itop = (int)sc[0];
        const int ibottom = (int)sc[1];
        const int deck_row = (int)sc[2];
        const bool apply_deck = sc[3] > 0.5f;
        const float w_surf = sc[4];
        const float inv_rstar2 = sc[5];
        const float r_itop2 = sc[6];
        cp_async_wait<RING>();
        team_sync(team);

        // The extinction column, four layers at a time (each lane writes
        // and later reads only its own column):
        float poison = 0.f;
#pragma unroll 1
        for (int j0 = 0; j0 < L; j0 += 4) {
            if (parts.n > 0) cp_async_wait<4>();
            float e[4];
            as.rows4(j0, e);
            if (parts.n > 0) {
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    ring_fetch(ring, parts, chain_off, j0 + RING + t, L,
                               nwave, tlane, w, valid);
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                poison = fmaf(e[t], 0.f, poison);
                s_ec[(j0 + t) * TW + tlane] = e[t];
            }
        }
        cp_async_wait<0>();

        // Down the rows: the depth of row i from the columns j in
        // [itop, i] (the rest of the row is zero), then the epilogue step.
        // itop is clamped before it bounds a loop, so that a rejected
        // chain's garbage cannot address memory.
        const int jlo = max(0, min(itop, L));
        int ideep = ibottom - 1;
        bool found = false;
        float integral = 0.f;
        float prev = 0.f;
#pragma unroll 1
        for (int i = 0; i < L; ++i) {
            const float* prow = s_tri + i * (i + 1) / 2;
            float di = 0.f;
#pragma unroll 4
            for (int j = jlo; j <= i; ++j)
                di = fmaf(prow[j], s_ec[j * TW + tlane], di);
            const bool in_range = i >= itop && i < ibottom;
            if (!found && in_range && di > maxdepth) {
                found = true;
                ideep = i;
            }
            const float raw = expf(-di) * s_rad[i];
            float integ = raw;
            if (apply_deck && i == deck_row)
                integ = prev * (1.f - w_surf) + raw * w_surf;
            const float m = (in_range && i < ideep) ? 1.f : 0.f;
            const float mp = (i >= itop + 1 && i <= ideep) ? 1.f : 0.f;
            integral += integ * (0.5f * (s_h[i] * m + s_hprev[i] * mp));
            prev = raw;
        }
        if (valid)
            out[(size_t)b * nwave + w] =
                (r_itop2 + 2.f * integral) * inv_rstar2 + poison;
    }
}

typedef void (*Kernel)(
    Parts, const float*, int, const float*, const float*, int, const float*,
    const float*, int, const float*, const float*, const float*, float*,
    int, int, int, int, float);

typedef void (*TallKernel)(
    Parts, const float*, int, const float*, const float*, int, const float*,
    const float*, const float*, float*, int, int, int, int, float);

int tall_smem_bytes(int KP, int nlayers, int n_r1, int n_parts, int nwarps) {
    const long floats = (long)(nwarps / TEAM)
        * tall_team_floats(nlayers, KP, 3 + n_r1, n_parts);
    return floats * 4 > (1L << 30) ? (1 << 30) : (int)(floats * 4);
}

// The instantiation for a padded layer count and CIA depth; null above the
// largest.
Kernel pick_kernel(int nlayers, int n_cia, int* NL4, int* KP) {
    *KP = n_cia <= 16 ? 16 : 32;
    *NL4 = nlayers <= 32 ? 8 : nlayers <= 52 ? 13 : 16;
    if (nlayers < 2 || nlayers > 64 || n_cia > 32) return nullptr;
    if (*KP == 16) {
        if (*NL4 == 8) return transit_rt_kernel<8, 16>;
        if (*NL4 == 13) return transit_rt_kernel<13, 16>;
        return transit_rt_kernel<16, 16>;
    }
    if (*NL4 == 8) return transit_rt_kernel<8, 32>;
    if (*NL4 == 13) return transit_rt_kernel<13, 32>;
    return transit_rt_kernel<16, 32>;
}

int smem_bytes(int NL4, int KP, int nlayers, int n_r1, int n_ls, int n_parts,
               int nwarps) {
    const long floats = (long)n_ls * nlayers * TW + (long)(nwarps / TEAM)
        * team_floats(NL4, KP, round4(n_ls), 3 + n_r1, n_parts);
    return floats * 4 > (1L << 30) ? (1 << 30) : (int)(floats * 4);
}

}  // namespace

// Warps of a block for these operand sizes: the most, up to 16 and in
// teams of 2, whose regions fit the shared memory beside the line-sample
// slab; 0 if the shapes have no instantiation or not even one team fits.
extern "C" int pbt_transit_rt_warps(int nlayers, int n_r1, int n_cia,
                                    int n_ls, int n_parts) {
    int NL4, KP;
    if (pick_kernel(nlayers, n_cia, &NL4, &KP) == nullptr) return 0;
    if (n_r1 > pbt::MAX_R1 || n_parts > pbt::MAX_PARTS) return 0;
    for (int nwarps = MAX_WARPS; nwarps >= TEAM; nwarps -= TEAM)
        if (smem_bytes(NL4, KP, nlayers, n_r1, n_ls, n_parts, nwarps)
                <= pbt::SMEM_MAX)
            return nwarps;
    return 0;
}

// packed [B, packed_floats], cia_w [B, 4 nl4, KP], ls_w [B, 4 nl4, K2P]
// and cols [B, ncols, 4 nl4] come laid out by the wrapper
// (transit_kernel.py); nl4, packed_floats and ncols are checked against
// this file's own layout.
extern "C" int pbt_transit_rt(
        const float* part0, const float* part1, const float* part2,
        const float* part3, int n_parts, const float* r1_rows, int n_r1,
        const float* cia_w, const float* cia_tab, int n_cia,
        const float* ls_w, const float* ls_tab, int n_ls,
        const float* packed, const float* cols, const float* scal,
        float* out, int nchains, int nlayers, int nwave, int nl4,
        int packed_floats, int ncols, float maxdepth, void* stream) {
    if (n_parts < 0 || n_parts > pbt::MAX_PARTS)
        return (int)cudaErrorInvalidValue;
    const int nwarps =
        pbt_transit_rt_warps(nlayers, n_r1, n_cia, n_ls, n_parts);
    if (nwarps < 1) return (int)cudaErrorInvalidValue;
    int NL4, KP;
    Kernel kernel = pick_kernel(nlayers, n_cia, &NL4, &KP);
    if (nl4 != NL4 || packed_floats != chunk_base(NL4, NL4)
            || ncols != 3 + n_r1)
        return (int)cudaErrorInvalidValue;
    const int smem =
        smem_bytes(NL4, KP, nlayers, n_r1, n_ls, n_parts, nwarps);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    // Two chains a team: the slab is staged once for the group.
    const int group = 2 * (nwarps / pbt::TEAM);
    Parts parts = {part0, part1, part2, part3, n_parts};
    dim3 grid((nwave + pbt::TW - 1) / pbt::TW, (nchains + group - 1) / group);
    kernel<<<grid, 32 * nwarps, smem, (cudaStream_t)stream>>>(
        parts, r1_rows, n_r1, cia_w, cia_tab, n_cia, ls_w, ls_tab, n_ls,
        packed, cols, scal, out, nchains, group, nlayers, nwave, maxdepth);
    return (int)cudaGetLastError();
}

// The tall function (any layer count from 2; the wrapper takes it above
// 64): warps of a block, the most up to 16 in teams of 2 whose regions fit
// the shared memory; 0 if not even one team fits or an operand count
// exceeds its limit.
extern "C" int pbt_transit_rt_tall_warps(int nlayers, int n_r1, int n_cia,
                                         int n_parts) {
    if (nlayers < 2 || n_cia > 32 || n_r1 > pbt::MAX_R1
            || n_parts > pbt::MAX_PARTS)
        return 0;
    const int KP = n_cia <= 16 ? 16 : 32;
    for (int nwarps = MAX_WARPS; nwarps >= TEAM; nwarps -= TEAM)
        if (tall_smem_bytes(KP, nlayers, n_r1, n_parts, nwarps)
                <= pbt::SMEM_MAX)
            return nwarps;
    return 0;
}

// tri [B, tri_floats] (path2's lower triangles), cia_w [B, rows, KP] and
// cols [B, ncols, rows] with rows = round4(nlayers) come laid out by the
// wrapper (transit_kernel.py); tri_floats and ncols are checked against
// this file's own layout.
extern "C" int pbt_transit_rt_tall(
        const float* part0, const float* part1, const float* part2,
        const float* part3, int n_parts, const float* r1_rows, int n_r1,
        const float* cia_w, const float* cia_tab, int n_cia,
        const float* tri, const float* cols, const float* scal, float* out,
        int nchains, int nlayers, int nwave, int tri_count, int ncols,
        float maxdepth, void* stream) {
    const int nwarps = pbt_transit_rt_tall_warps(nlayers, n_r1, n_cia,
                                                 n_parts);
    if (nwarps < 1 || n_parts < 0 || tri_count != tri_floats(nlayers)
            || ncols != 3 + n_r1)
        return (int)cudaErrorInvalidValue;
    const int KP = n_cia <= 16 ? 16 : 32;
    TallKernel kernel = KP == 16 ? transit_rt_tall_kernel<16>
                                 : transit_rt_tall_kernel<32>;
    const int smem = tall_smem_bytes(KP, nlayers, n_r1, n_parts, nwarps);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int group = 2 * (nwarps / pbt::TEAM);
    Parts parts = {part0, part1, part2, part3, n_parts};
    dim3 grid((nwave + pbt::TW - 1) / pbt::TW, (nchains + group - 1) / group);
    kernel<<<grid, 32 * nwarps, smem, (cudaStream_t)stream>>>(
        parts, r1_rows, n_r1, cia_w, cia_tab, n_cia, tri, cols, scal, out,
        nchains, group, nlayers, nwave, maxdepth);
    return (int)cudaGetLastError();
}
