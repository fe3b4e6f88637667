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
// triangular chord product (l (l + 1) / 2 FMAs a column), 1.0 GFLOP for
// the rank-1 term and the epilogue, 0.3 GFLOP each for the two live CIA
// and line-sample terms a layer, all fp32 outside the tensor cores, so
// ~0.09 ms at the card's 67 TFLOP/s (chip_smoke.py kernel_bound); the
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
// of that height no longer fits the registers one column a lane.  It takes
// the same operands, the line sample included.  A team of two warps takes
// one chain over a 64-column tile.  Each lane assembles its column's
// extinction eight layers at a time: the dense parts and the two live
// line-sample table rows come through a ring in shared memory, the CIA
// product from its two live weights against the tile's CIA table in shared
// memory.  The chord product then runs on the tensor cores: each warp
// holds the depths of its 32 columns and of a pass of 96 rows (six 16-row
// m-tiles, 96 registers a lane) in the mma.sync m16n8k8 accumulator
// layout, B the eight layers' extinction (through a small buffer, into the
// fragment layout), A the pass's chord rows, streamed through the ring.
// TF32 alone would keep about three digits, so each step is three TF32
// products of the split operands (lo x hi, hi x lo, hi x hi).  They sum
// from zero, and the step's sum joins the depths by a float32 add outside
// the tensor cores, so that a depth is a float32 sum over the steps
// whatever its layer count, not one kept in the mma's accumulator, whose
// rounding is the tensor cores' own.  PERF.md has the error against the
// plain version on operands whose extinction grows e^7 down the layers
// (tests/test_torch_cuda.py), with the sums in the mma and outside it, and
// what the adds cost.  An m-tile whose last row lies above the step is
// skipped: the matrix is zero above its diagonal.
// A pass covers 96 rows, so up to 96 layers every layer's extinction is
// assembled once.  The fragments then leave through the ring, an m-tile
// at a time, for the same one-pass epilogue as above, down each lane's
// column.  The line-sample rows are 16-byte copies from the table, whose
// rows the wrapper pads to a multiple of four floats.  The table (10.4 MB
// at 81 layers) stays in the card's 50 MB L2; a slab of it in shared
// memory (207 KB for one wave tile at 81 layers) would leave room for no
// warp.  Kept from the first design: no index taken from data (itop clamped
// before it bounds a loop), the poison sum, no fast-math; the extinction
// of the layers above itop goes in as zero, so that a non-finite one
// reaches the output only through the poison sum, as the skipped FMAs did.
// Shared memory sets the largest layer count (one team's weights, layer
// columns and ring): ~1,500 with the retrieval's operands, ~2,500
// without a line sample (pbt_transit_rt_tall_warps returns 0 above it,
// and the wrapper raises).  Two designs came before this one (PERF.md):
// the depths of a pass of 44 rows in registers as an outer product of
// broadcast chord rows, one column a lane and then two; on an NVIDIA H100
// both ran little faster than the function they replaced.  Builds with
// parts removed put the cost in the broadcast 16-byte shared loads of the
// chord rows and in the 4-byte copies of the table rows, not in the
// arithmetic: hence the tensor cores and the 16-byte copies.  A version
// that also copied the dense parts' rows as 16-byte windows and assembled
// the eight layers of a step in a rolled loop was slower on every operand
// set measured.
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

// One column's epilogue step at row `row`, rows in ascending order (the
// ideep known so far, first exceed else ibottom - 1, gives every row the
// coefficient of the final ideep), for both functions.
struct Epilogue {
    int ideep;
    bool found;
    float integral, prev;

    __device__ __forceinline__ void step(
            int row, float di, bool in_range, int itop, bool deck,
            float w_surf, float rad, float h, float hprev, float maxdepth) {
        if (!found && in_range && di > maxdepth) {
            found = true;
            ideep = row;
        }
        const float raw = expf(-di) * rad;
        const float integ = deck ? prev * (1.f - w_surf) + raw * w_surf : raw;
        const float m = (in_range && row < ideep) ? 1.f : 0.f;
        const float mp = (row >= itop + 1 && row <= ideep) ? 1.f : 0.f;
        integral += integ * (0.5f * (h * m + hprev * mp));
        prev = raw;
    }
};

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
        Epilogue ep = {ibottom - 1, false, 0.f, 0.f};
#pragma unroll
        for (int first = 0; first < LP; first += PARK) {
#pragma unroll
            for (int i = first; i < first + PARK && i < LP; ++i)
                s_pt[(i - first) * TW + tlane] = d[i];
            const int last = min(L, first + PARK);
#pragma unroll 4
            for (int i = first; i < last; ++i)
                ep.step(i, s_pt[(i - first) * TW + tlane],
                        i >= itop && i < ibottom, itop,
                        apply_deck && i == deck_row, w_surf, s_rad[i],
                        s_h[i], s_hprev[i], maxdepth);
        }
        if (valid)
            out[(size_t)b * nwave + w] =
                (r_itop2 + 2.f * ep.integral) * inv_rstar2 + poison;
    }
}

// The tall function.  A team of two warps takes one chain over a 64-column
// tile, one column a lane for the extinction, which goes through a small
// shared-memory buffer into the tensor cores: the chord product of a pass
// of 96 rows (six 16-row m-tiles) by eight layers at a time is mma.sync
// m16n8k8 in TF32, three products a step (lo x hi, hi x lo, hi x hi) from
// zero, added to the depths in float32, so that the sum keeps the float32
// result; the depths of the pass's rows stay in the warps' registers.  A
// team's ring holds two steps of eight layers: the chord rows of the pass,
// the lanes' columns of the dense parts (4-byte copies) and the two live
// line-sample table rows (16-byte copies from a table whose rows the
// wrapper pads to a multiple of four).
constexpr int TALL_WARPS = 4;     // warps of a block, at most
constexpr int TALL_MT = 6;        // m-tiles of 16 rows in a pass
constexpr int TALL_ROWS = 16 * TALL_MT;
constexpr int TALL_RING = 16;     // layers in a team's ring: two steps
constexpr int CHORD_STRIDE = 104; // floats a layer's chord rows take
constexpr int E_STRIDE = 72;      // floats a layer's extinction row takes
constexpr int PARK_STRIDE = 40;   // floats a parked row of 32 columns takes

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }

// Floats of a chain's packed chord matrix: pass p (rows 96 p .. 96 p + 95)
// holds, for each layer j below min(round8(L), 96 (p + 1)), the 96 values
// path2[96 p + r, j].
__host__ __device__ inline long tall_packed_floats(int L) {
    long n = 0;
    for (int r0 = 0; r0 < L; r0 += TALL_ROWS)
        n += (long)TALL_ROWS * (round8(L) < r0 + TALL_ROWS
                                ? round8(L) : r0 + TALL_ROWS);
    return n;
}

// Floats of a team's region (all multiples of 4): the CIA weights
// [rows][KP] and their masks [rows], the line-sample weights [rows][K2P]
// and their masks, the layer columns [ncols][rows] (rows = round8(L)),
// the ring's column slots [n_parts + 2 line-sample rows][TALL_RING][TW],
// its chord slots [TALL_RING][CHORD_STRIDE] (the epilogue parks rows
// there) and the extinction buffer [8][E_STRIDE].
__host__ __device__ inline int tall_team_floats(
        int L, int KP, int n_cia, int K2P, int ncols, int n_parts) {
    const int rows = round8(L);
    return (n_cia ? rows * (KP + 1) : 0) + rows * K2P
        + rows * ((K2P + 31) >> 5) + ncols * rows
        + (n_parts + (K2P ? 2 : 0)) * TALL_RING * TW
        + TALL_RING * CHORD_STRIDE + 8 * E_STRIDE;
}

// Floats of a block: the tile's CIA table [n_cia][TW], then the teams.
__host__ __device__ inline long tall_block_floats(
        int L, int KP, int n_cia, int K2P, int ncols, int n_parts,
        int nteams) {
    return (long)n_cia * TW
        + (long)nteams * tall_team_floats(L, KP, n_cia, K2P, ncols, n_parts);
}

__device__ __forceinline__ unsigned to_tf32(float x) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// d += a b for one warp's m16n8k8 TF32 fragments (PTX ISA layouts: with
// g = lane / 4 and t = lane % 4, a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]).
__device__ __forceinline__ void mma_tf32(
        float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x as the sum of two TF32 values:
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

__global__ void __launch_bounds__(32 * TALL_WARPS, 3) transit_rt_tall_kernel(
        Parts parts, const float* __restrict__ r1_rows, int n_r1,
        const float* __restrict__ cia_w, const float* __restrict__ cia_tab,
        int n_cia,
        const float* __restrict__ ls_w, const float* __restrict__ ls_tab,
        int n_ls, int ls_stride,
        const float* __restrict__ packed, const float* __restrict__ cols,
        const float* __restrict__ scal, float* __restrict__ out,
        int nchains, int group, int nlayers, int nwave, float maxdepth) {
    constexpr int SLOT = TALL_RING * TW;             // floats of a column slot
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int L = nlayers;
    const int rows = round8(L);
    const size_t PK = (size_t)tall_packed_floats(L);
    const int KP = n_cia <= 16 ? 16 : 32;   // the wrapper pads cia_w so
    const int K2P = round4(n_ls);
    const int words = (K2P + 31) >> 5;
    const int ncols = 3 + n_r1;
    const int n_slots = parts.n + (n_ls ? 2 : 0);
    const int team = threadIdx.x / (32 * TEAM);
    const int nteams = blockDim.x / (32 * TEAM);
    const int tlane = threadIdx.x % (32 * TEAM);     // the column in the tile
    const int lane = threadIdx.x & 31;
    const int half = tlane >> 5;        // the warp's 32 columns of the tile
    const int gid = lane >> 2, tig = lane & 3;        // fragment coordinates
    const int tile0 = blockIdx.x * TW;
    const int w = tile0 + tlane;
    const bool valid = w < nwave;

    float* s_ctab = smem;                                  // [n_cia][TW]
    const int region =
        tall_team_floats(L, KP, n_cia, K2P, ncols, parts.n);
    float* s_ciaw = smem + n_cia * TW + team * region;     // [rows][KP]
    unsigned* s_cmask = reinterpret_cast<unsigned*>(
        s_ciaw + (n_cia ? rows * KP : 0));                 // [rows]
    float* s_lsw = s_ciaw + (n_cia ? rows * (KP + 1) : 0); // [rows][K2P]
    unsigned* s_mask = reinterpret_cast<unsigned*>(s_lsw + rows * K2P);
    float* s_cols = s_lsw + rows * K2P + rows * words;     // [ncols][rows]
    const float* s_rad = s_cols;
    const float* s_h = s_cols + rows;
    const float* s_hprev = s_cols + 2 * rows;
    const float* s_r1c = s_cols + 3 * rows;
    float* ring = s_cols + ncols * rows;        // [n_slots][TALL_RING][TW]
    float* s_lsr = ring + parts.n * SLOT;       // the two line-sample slots
    float* s_chord = ring + n_slots * SLOT;     // [TALL_RING][CHORD_STRIDE]
    float* s_e = s_chord + TALL_RING * CHORD_STRIDE;   // [8][E_STRIDE]
    float* s_park = s_chord + half * 16 * PARK_STRIDE; // [16][PARK_STRIDE]

    for (int i = threadIdx.x; i < n_cia * TW; i += blockDim.x) {
        const int k = i / TW, wk = tile0 + (i - k * TW);
        s_ctab[i] = wk < nwave ? cia_tab[(size_t)k * nwave + wk] : 0.f;
    }
    for (int i = tlane; i < region; i += 32 * TEAM) s_ciaw[i] = 0.f;
    __syncthreads();

    for (int c = team; c < group; c += nteams) {
        const int b = blockIdx.y * group + c;
        if (b >= nchains) break;
        team_sync(team);

        // The chain's weights and layer columns into the team's region:
        stage_chain(s_ciaw, s_lsw, s_cols, cia_w, ls_w, cols, b, rows, KP,
                    n_cia, K2P, ncols, tlane);
        cp_async_commit();
        float r1r[MAX_R1];
        load_r1_rows(r1r, r1_rows, n_r1, b, nwave, w, valid);
        const float* sc = scal + (size_t)b * 8;
        const int itop = (int)sc[0];
        const int ibottom = (int)sc[1];
        const int deck_row = (int)sc[2];
        const bool apply_deck = sc[3] > 0.5f;
        const float w_surf = sc[4];
        const float inv_rstar2 = sc[5];
        const float r_itop2 = sc[6];
        cp_async_wait<0>();
        team_sync(team);
        if (n_cia) build_mask(s_cmask, s_ciaw, rows, KP, tlane, team);
        if (n_ls) build_mask(s_mask, s_lsw, rows, K2P, tlane, team);
        const size_t chain_off = (size_t)b * L * nwave;
        // itop is clamped before it bounds a loop, so that a rejected
        // chain's garbage cannot address memory.
        const int jlo = max(0, min(itop, L));

        float poison = 0.f;
        Epilogue ep = {ibottom - 1, false, 0.f, 0.f};
#pragma unroll 1
        for (int r0 = 0; r0 < L; r0 += TALL_ROWS) {
            const bool last = r0 + TALL_ROWS >= L;
            const float* pk = packed + b * PK + (size_t)TALL_ROWS * (
                r0 / TALL_ROWS * TALL_ROWS * (r0 / TALL_ROWS + 1) / 2);
            // The steps of eight layers the pass walks: from the one that
            // holds itop (the last pass from 0, so that every layer's
            // extinction reaches the poison sum) to the pass's last row.
            const int s0 = last ? 0 : jlo >> 3;
            const int s1 = min(rows, r0 + TALL_ROWS) >> 3;

            // Step s into its ring slots; one commit group, empty past s1.
            auto fetch = [&](int s) {
                if (s < s1) {
                    const int slot = 8 * (s & 1);
                    const int j0 = 8 * s;
                    // The chord rows of the eight layers, 24 16-byte
                    // copies each:
                    for (int i = tlane; i < 8 * 24; i += 32 * TEAM) {
                        const int t = i / 24, q = i - 24 * t;
                        cp_async16(s_chord + (slot + t) * CHORD_STRIDE + 4 * q,
                                   pk + (size_t)(j0 + t) * TALL_ROWS + 4 * q);
                    }
                    // The live line-sample table rows (the first two
                    // non-zero weights of each layer), 16 columns a copy:
                    if (n_ls) {
                        for (int i = tlane; i < 8 * 2 * 16; i += 32 * TEAM) {
                            const int t = i >> 5, r = (i >> 4) & 1;
                            const int q = i & 15;
                            const int j = j0 + t;
                            if (j >= L || tile0 + 4 * q >= ls_stride) continue;
                            bool one, two;
                            int k0, k1;
                            first_two(s_mask[j * words], one, two, k0, k1);
                            if (!(r ? two : one)) continue;
                            cp_async16(
                                s_lsr + r * SLOT + (slot + t) * TW + 4 * q,
                                ls_tab + ((size_t)(r ? k1 : k0) * L + j)
                                    * ls_stride + tile0 + 4 * q);
                        }
                    }
                    // The thread's own column of the dense parts:
                    if (parts.n > 0 && valid) {
                        for (int t = 0; t < 8; ++t) {
                            const int j = j0 + t;
                            if (j >= L) break;
                            const size_t at = chain_off + (size_t)j * nwave + w;
                            float* d = ring + (slot + t) * TW + tlane;
                            cp_async4(d, parts.p0 + at);
                            if (parts.n > 1) cp_async4(d + SLOT, parts.p1 + at);
                            if (parts.n > 2)
                                cp_async4(d + 2 * SLOT, parts.p2 + at);
                            if (parts.n > 3)
                                cp_async4(d + 3 * SLOT, parts.p3 + at);
                        }
                    }
                }
                cp_async_commit();
            };

            float acc[TALL_MT][4][4];
#pragma unroll
            for (int m = 0; m < TALL_MT; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
            fetch(s0);
#pragma unroll 1
            for (int s = s0; s < s1; ++s) {
                // Step s has landed for every thread of the team, and every
                // thread is done with step s - 1, whose slots take s + 1:
                cp_async_wait<0>();
                team_sync(team);
                fetch(s + 1);
                const int slot = 8 * (s & 1);
                const int j0 = 8 * s;
                // The extinction of the eight layers in the lane's column,
                // in the order of the Pallas kernel: dense parts, rank-1
                // terms, the CIA product (its non-zero weights in
                // ascending k, summed on its own), the line sample.
#pragma unroll
                for (int t4 = 0; t4 < 8; t4 += 4) {
                    float e[4];
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        e[t] = 0.f;
                        const float* row = ring + (slot + t4 + t) * TW + tlane;
                        if (parts.n > 0 && j0 + t4 + t < L) {
                            e[t] = row[0];
#pragma unroll
                            for (int p = 1; p < MAX_PARTS; ++p)
                                if (p < parts.n) e[t] += row[p * SLOT];
                        }
                    }
                    add_rank1(e, s_r1c, rows, j0 + t4, r1r, n_r1);
                    if (n_cia) {
#pragma unroll
                        for (int t = 0; t < 4; ++t) {
                            const int j = j0 + t4 + t;
                            const float* wrow = s_ciaw + j * KP;
                            bool one, two;
                            int k0, k1;
                            unsigned more =
                                first_two(s_cmask[j], one, two, k0, k1);
                            float cs = one ? wrow[k0] * s_ctab[k0 * TW + tlane]
                                           : 0.f;
                            if (two)
                                cs = fmaf(wrow[k1], s_ctab[k1 * TW + tlane], cs);
                            while (more) {
                                const int k = __ffs(more) - 1;
                                more &= more - 1;
                                cs = fmaf(wrow[k], s_ctab[k * TW + tlane], cs);
                            }
                            e[t] += cs;
                        }
                    }
                    if (n_ls) {
#pragma unroll
                        for (int t = 0; t < 4; ++t) {
                            const int j = j0 + t4 + t;
                            const float* wrow = s_lsw + j * K2P;
                            const float* lsr = s_lsr + (slot + t4 + t) * TW + tlane;
                            bool one, two;
                            int k0, k1;
                            unsigned more =
                                first_two(s_mask[j * words], one, two, k0, k1);
                            if (one) e[t] = fmaf(wrow[k0], lsr[0], e[t]);
                            if (two) e[t] = fmaf(wrow[k1], lsr[SLOT], e[t]);
                            // Any further ones (several species, or several
                            // words), read from the table directly:
                            if (more != 0 || words > 1) {
                                for (int word = 0; word < words; ++word) {
                                    if (word > 0) more = s_mask[j * words + word];
                                    while (more) {
                                        const int k = 32 * word + __ffs(more) - 1;
                                        more &= more - 1;
                                        const float tk = valid ? __ldg(
                                            ls_tab + ((size_t)k * L + j)
                                            * ls_stride + w) : 0.f;
                                        e[t] = fmaf(wrow[k], tk, e[t]);
                                    }
                                }
                            }
                        }
                    }
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        poison = fmaf(e[t], 0.f, poison);
                        // Layers above itop add nothing (their chord
                        // column is zero): zero them here, so that a
                        // non-finite one reaches only the poison sum.
                        s_e[(t4 + t) * E_STRIDE + tlane] =
                            j0 + t4 + t >= jlo ? e[t] : 0.f;
                    }
                }
                __syncwarp();
                // The chord product of the step: B is the extinction of
                // the warp's 32 columns (four n-tiles), A the pass's chord
                // rows, for the m-tiles whose last row reaches the step.
                unsigned bh[4][2], bl[4][2];
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    const float* eb = s_e + 32 * half + 8 * n + gid;
                    split_tf32(eb[tig * E_STRIDE], bh[n][0], bl[n][0]);
                    split_tf32(eb[(tig + 4) * E_STRIDE], bh[n][1], bl[n][1]);
                }
#pragma unroll
                for (int m = 0; m < TALL_MT; ++m) {
                    if (r0 + 16 * m + 15 < j0 || r0 + 16 * m >= L) continue;
                    const float* ca = s_chord + (slot + tig) * CHORD_STRIDE
                        + 16 * m + gid;
                    unsigned ah[4], al[4];
                    split_tf32(ca[0], ah[0], al[0]);
                    split_tf32(ca[8], ah[1], al[1]);
                    split_tf32(ca[4 * CHORD_STRIDE], ah[2], al[2]);
                    split_tf32(ca[4 * CHORD_STRIDE + 8], ah[3], al[3]);
#pragma unroll
                    for (int n = 0; n < 4; ++n) {
                        // The step's product from zero, then into the
                        // depths by a float32 add outside the tensor cores:
                        float c[4] = {0.f, 0.f, 0.f, 0.f};
                        mma_tf32(c, al, bh[n]);
                        mma_tf32(c, ah, bl[n]);
                        mma_tf32(c, ah, bh[n]);
#pragma unroll
                        for (int i = 0; i < 4; ++i) acc[m][n][i] += c[i];
                    }
                }
                __syncwarp();
            }
            cp_async_wait<0>();
            // The other warp of the team may still read the chord slots:
            team_sync(team);

            // Epilogue down the pass's rows, an m-tile at a time through
            // the warp's part of the chord slots: the fragments go in as
            // rows of 32 columns, each lane reads back its own column.
#pragma unroll
            for (int m = 0; m < TALL_MT; ++m) {
                if (r0 + 16 * m >= L) break;
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    float* p = s_park + 8 * n + 2 * tig;
                    p[gid * PARK_STRIDE] = acc[m][n][0];
                    p[gid * PARK_STRIDE + 1] = acc[m][n][1];
                    p[(gid + 8) * PARK_STRIDE] = acc[m][n][2];
                    p[(gid + 8) * PARK_STRIDE + 1] = acc[m][n][3];
                }
                __syncwarp();
#pragma unroll 1
                for (int r = 0; r < 16; ++r) {
                    const int row = r0 + 16 * m + r;
                    if (row >= L) break;
                    ep.step(row, s_park[r * PARK_STRIDE + lane],
                            row >= itop && row < ibottom, itop,
                            apply_deck && row == deck_row, w_surf,
                            s_rad[row], s_h[row], s_hprev[row], maxdepth);
                }
                __syncwarp();
            }
            // Before the next pass's copies overwrite the parked rows:
            team_sync(team);
        }
        if (valid)
            out[(size_t)b * nwave + w] =
                (r_itop2 + 2.f * ep.integral) * inv_rstar2 + poison;
    }
}

typedef void (*Kernel)(
    Parts, const float*, int, const float*, const float*, int, const float*,
    const float*, int, const float*, const float*, const float*, float*,
    int, int, int, int, float);

int tall_smem_bytes(int nlayers, int n_r1, int n_cia, int n_ls, int n_parts,
                    int nwarps) {
    const long floats = tall_block_floats(
        nlayers, n_cia <= 16 ? 16 : 32, n_cia, round4(n_ls), 3 + n_r1,
        n_parts, nwarps / TEAM);
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
// 64): warps of a block, the most up to TALL_WARPS in teams of 2 whose
// regions fit the shared memory; 0 if not even one team fits or an
// operand count exceeds its limit.
extern "C" int pbt_transit_rt_tall_warps(int nlayers, int n_r1, int n_cia,
                                         int n_ls, int n_parts) {
    if (nlayers < 2 || n_cia < 0 || n_cia > 32 || n_r1 < 0
            || n_r1 > pbt::MAX_R1 || n_ls < 0 || n_parts < 0
            || n_parts > pbt::MAX_PARTS)
        return 0;
    for (int nwarps = TALL_WARPS; nwarps >= TEAM; nwarps -= TEAM)
        if (tall_smem_bytes(nlayers, n_r1, n_cia, n_ls, n_parts, nwarps)
                <= pbt::SMEM_MAX)
            return nwarps;
    return 0;
}

// Chains in flight on one SM for these operand sizes (blocks an SM, by
// the runtime's occupancy rule, times teams a block); 0 if no block fits,
// a negative CUDA error if the query fails.
extern "C" int pbt_transit_rt_tall_chains_per_sm(
        int nlayers, int n_r1, int n_cia, int n_ls, int n_parts) {
    const int nwarps = pbt_transit_rt_tall_warps(nlayers, n_r1, n_cia, n_ls,
                                                 n_parts);
    if (nwarps < 1) return 0;
    const int smem = tall_smem_bytes(nlayers, n_r1, n_cia, n_ls, n_parts,
                                     nwarps);
    cudaError_t err = cudaFuncSetAttribute(
        transit_rt_tall_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, transit_rt_tall_kernel, 32 * nwarps, smem);
    return err == cudaSuccess ? blocks * (nwarps / TEAM) : -(int)err;
}

// packed [B, packed_floats] (the passes' chord rows), cia_w [B, rows, KP],
// ls_w [B, rows, K2P] and cols [B, ncols, rows] with rows = round8(nlayers)
// come laid out by the wrapper (transit_kernel.py tall_layout), and ls_tab
// [K2, nlayers, ls_stride] with its rows padded to a multiple of four
// floats; packed_floats, ls_stride and ncols are checked against this
// file's own layout.
extern "C" int pbt_transit_rt_tall(
        const float* part0, const float* part1, const float* part2,
        const float* part3, int n_parts, const float* r1_rows, int n_r1,
        const float* cia_w, const float* cia_tab, int n_cia,
        const float* ls_w, const float* ls_tab, int n_ls,
        const float* packed, const float* cols, const float* scal,
        float* out, int nchains, int nlayers, int nwave, int ls_stride,
        int packed_floats, int ncols, float maxdepth, void* stream) {
    const int nwarps = pbt_transit_rt_tall_warps(nlayers, n_r1, n_cia, n_ls,
                                                 n_parts);
    if (nwarps < 1 || packed_floats != tall_packed_floats(nlayers)
            || ncols != 3 + n_r1
            || (n_ls && (ls_stride < nwave || ls_stride % 4 != 0)))
        return (int)cudaErrorInvalidValue;
    const int smem = tall_smem_bytes(nlayers, n_r1, n_cia, n_ls, n_parts,
                                     nwarps);
    cudaError_t err = cudaFuncSetAttribute(
        transit_rt_tall_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    // Two chains a team: the CIA table tile is staged once a block.
    const int group = 2 * (nwarps / pbt::TEAM);
    Parts parts = {part0, part1, part2, part3, n_parts};
    dim3 grid((nwave + pbt::TW - 1) / pbt::TW, (nchains + group - 1) / group);
    transit_rt_tall_kernel<<<grid, 32 * nwarps, smem, (cudaStream_t)stream>>>(
        parts, r1_rows, n_r1, cia_w, cia_tab, n_cia, ls_w, ls_tab, n_ls,
        ls_stride, packed, cols, scal, out, nchains, group, nlayers, nwave,
        maxdepth);
    return (int)cudaGetLastError();
}
