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
// Design (the block layout and the teams are in rt_common.cuh).  A team of
// two warps takes one chain over a 64-column wave tile, one column a lane;
// a block holds the tile's line-sample slab and CIA table rows in shared
// memory, staged once for its chains.  Per chain the team stages the chord
// matrix, packed by the wrapper as the fragments of its product
// (transit_kernel.py chord_layout), the rank-1 columns, and for each layer
// (a thread a layer) its first two non-zero CIA and line-sample weights
// with their offsets in the tables, a bit if it has more, and its
// epilogue's chain-uniform part: radius, coefficients, threshold.
//
// The layers go in steps of eight.  Each lane assembles its column's
// extinction of the step's layers, in the order of the Pallas kernel:
// dense parts (a ring of rows), rank-1 terms, the CIA product over its two
// live weights, the line sample the same way, all without a branch; then,
// in the rare layers with more live weights (several species or CIA
// tables), the others, read from device memory.  The chord product runs on
// the tensor cores, mma.sync m16n8k8: A the extinction of the warp's 32
// columns (two m-tiles of 16) by the step's 8 layers, through a swizzled
// buffer of the warp into the fragment layout; B an n-tile of 8 depth rows
// by those layers, the packed matrix as one 8-byte shared load a lane; C
// the depths of the warp's columns by an n-tile's rows, 2 x NT x 4
// registers a lane (NT = 4, 7 or 8 for up to 32, 56 or 64 layers: 7 at
// 51).  The matrix is zero above its diagonal, so a step adds only to the
// n-tiles from its own on: nt (nt + 1) / 2 pairs of step and n-tile, 28 at
// 51 layers, 168 mma a warp and chain.  TF32 alone keeps about three
// digits, so each product is three TF32 products of the split operands
// (lo x hi, hi x lo, hi x hi; each split by integer rounding to nearest,
// ties away, two instructions where cvt.rna.tf32 takes four), summed from
// zero, and the step's sum joins the depths by a float32 add outside the
// tensor cores: a depth is a float32 sum over the steps (the tall
// function's arithmetic).  After step s, n-tile s is done: its rows leave
// the accumulators through the warp's buffer for the epilogue (ideep, exp,
// deck splice, masked trapezoid) down each lane's column, and the others
// move down a position, so that every step's body has static indices and
// each count of live n-tiles its own unrolled product.  The epilogue is
// exact as before: the ideep known so far (first exceed, else
// ibottom - 1) gives every row the coefficient of the final ideep.  Every
// row's integ * coef is added, zero coefficients included, so NaN/inf
// propagate as in the Pallas kernel; the extinction of the layers above
// itop goes into the product as zero and reaches the output only through a
// sum of ec[j] * 0 added to it (the poison sum), as does a rejected
// chain's non-finite weight (its layer's extinction is made NaN).  No
// index is taken from data: itop is clamped before it bounds a loop,
// ibottom and the deck row are only compared, so a rejected chain computes
// garbage but cannot fault.  No fast-math: the result keeps float32.
//
// Bound on the H100 at the flagship shape (B = 512, l = 51, W = 3209,
// K = 15, K2 = 10, line sample in the kernel): the triangular chord product
// (l (l + 1) / 2 FMAs a column, 4.4 GFLOP) three times at the tensor
// cores' 495 TFLOP/s, 0.026 ms, beside 1.6 GFLOP of float32 (the rank-1
// term, the epilogue, the two live CIA and line-sample terms a layer) at
// 67 TFLOP/s, 0.024 ms (chip_smoke.py kernel_bound); the bytes (table,
// chord matrices, weights, result) ~0.01 ms at 3.35 TB/s.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: 0.62 ms of device time at 3,209 columns
// and 8.9 ms at R = 115,000 (50,062 columns), where the FMA design before
// it (the depth column in registers, an outer product down the layers
// from 16-byte broadcast loads of the chord rows, the CIA sum over all KP
// weights from registers) took 0.84 ms and 12.2-12.6 ms.  What is left is
// latency and instruction count: a chain takes a warp ~39,000 cycles (a
// build with clock64() around the phases, not kept: staging 5,700,
// assembly 10,700, chord product 11,000, epilogue 8,800; the FMA design's
// ~58,200: 4,500, 21,100, 22,000, 9,200).  128 registers a thread and no
// spill at 16 warps (NT = 4 and 7; the NT = 8 blocks take 12 warps, whose
// registers hold its 64 accumulators); the 130 KB slab, the 3.8 KB CIA
// table tile and eight teams' 11.9 KB regions fill the block's shared
// memory: eight chains in flight on an SM.  PERF.md has the runs and the
// designs that were tried.
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
constexpr int E_FLOATS = 256;    // a warp's extinction buffer: 8 x 32

// Floats of a chain's chord fragments with nt n-tiles of 8 rows: 64 for
// each pair of a step s of 8 layers and an n-tile n >= s.
__host__ __device__ constexpr int chord_floats(int nt) {
    return 32 * nt * (nt + 1);
}

// Floats of a team's region (all multiples of 4): the chord fragments,
// each layer's live weights [rows] (float4), their table offsets [rows]
// (int4) and its epilogue constants [rows] (float4), the rank-1 columns
// [n_r1][rows], the two warps' extinction buffers, the parts ring, and
// the warps' words of layers with more live weights (rows = 8 nt).
__host__ __device__ inline int team_floats(int nt, int n_r1, int n_parts) {
    const int rows = 8 * nt;
    return chord_floats(nt) + 12 * rows + n_r1 * rows + TEAM * E_FLOATS
        + n_parts * RING * TW + 4;
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

// x as the sum of two TF32 values, each rounded to nearest with ties away
// from zero by integer operations (for finite x what cvt.rna.tf32.f32
// gives, in two instructions where it takes four).
__device__ __forceinline__ void split_tf32_rna(float x, unsigned& hi,
                                               unsigned& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// The first two non-zero weights among the first 32 of a row of n in
// device memory (n a multiple of 4, 16-byte aligned): w0, w1 (zero where
// there are fewer) at k0, k1 (0 where absent); true if any other weight
// is not zero.  Where it took fewer than two, the row has no other
// non-zero weight among its first 32, so those it took are the first of
// the row.  A row with a non-finite weight (a rejected chain's) gives
// w0 = NaN and nothing more: its layer's extinction is then NaN, as is
// every sum that takes it (the plain version's product too), and the
// chain's result is NaN through the poison sum.
__device__ __forceinline__ bool live_pair(
        const float* __restrict__ row, int n, float& w0, float& w1,
        int& k0, int& k1) {
    unsigned live = 0;
    bool rest = false, finite = true;
#pragma unroll 4
    for (int k = 0; k < n; k += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + k));
        const unsigned nz = (unsigned)(v.x != 0.f)
            | (unsigned)(v.y != 0.f) << 1 | (unsigned)(v.z != 0.f) << 2
            | (unsigned)(v.w != 0.f) << 3;
        finite = finite && isfinite(v.x) && isfinite(v.y) && isfinite(v.z)
            && isfinite(v.w);
        if (k < 32)
            live |= nz << k;
        else
            rest = rest || nz != 0;
    }
    bool one, two;
    const unsigned more = first_two(live, one, two, k0, k1);
    w0 = !finite ? NAN : one ? __ldg(row + k0) : 0.f;
    w1 = finite && two ? __ldg(row + k1) : 0.f;
    k0 = finite ? k0 : 0;
    k1 = finite && two ? k1 : 0;
    return finite && (more != 0 || rest);
}

// acc + w[k] tab[k stride] over the non-zero weights of a row of n in
// device memory (n a multiple of 4, 16-byte aligned) after its first
// `taken`, in ascending k (the layers with more than two live weights).
__device__ __forceinline__ float rest_sum(
        const float* __restrict__ row, int n, int taken, const float* tab,
        int stride, float acc) {
    int seen = 0;
#pragma unroll 1
    for (int k = 0; k < n; k += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + k));
        const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (x[i] != 0.f && ++seen > taken)
                acc = fmaf(x[i], tab[(k + i) * stride], acc);
    }
    return acc;
}

// Row r (0-7) and column c (0-31) of a warp's extinction buffer: rows of
// 32 floats, the columns XOR-swizzled so that the A fragments are read
// and the accumulators parked without bank conflicts.
__device__ __forceinline__ int swz(int r, int c) {
    return 32 * r + (c ^ (((r + (r >> 2)) & 3) << 3));
}

// One column's epilogue step at row `row`, rows in ascending order (the
// ideep known so far, first exceed else ibottom - 1, gives every row the
// coefficient of the final ideep), for the tall function.
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

// The epilogue of Epilogue::step with its chain-uniform part computed once
// a row (the staging's q = radius, the coefficient while no row above
// exceeded maxdepth, the coefficient at the first that does, and the
// row's threshold: maxdepth in [itop, ibottom), else infinite): the same
// sums in the same order.
struct RowEpilogue {
    bool found;
    float integral, prev;

    __device__ __forceinline__ void step(float di, const float4& q,
                                         bool deck, float w_surf) {
        const bool exceed = di > q.w;
        const float raw = expf(-di) * q.x;
        const float integ = deck ? prev * (1.f - w_surf) + raw * w_surf : raw;
        integral += integ * (found ? 0.f : exceed ? q.z : q.y);
        found = found || exceed;
        prev = raw;
    }
};

// The step's chord product into the first k positions of the
// accumulators (k = K if it matches, else fewer: one unrolled body for
// each count, so that the positions' products interleave): position p
// takes the B fragment pb[32 p].
template <int K, int NT>
__device__ __forceinline__ void step_product(
        int k, float (&acc)[NT][2][4], const float2* pb,
        const unsigned (&ah)[2][4], const unsigned (&al)[2][4]) {
    if constexpr (K > 0) {
        if (k != K) {
            step_product<K - 1, NT>(k, acc, pb, ah, al);
            return;
        }
#pragma unroll
        for (int p = 0; p < K; ++p) {
            const float2 bv = pb[32 * p];
            unsigned bh[2], bl[2];
            split_tf32_rna(bv.x, bh[0], bl[0]);
            split_tf32_rna(bv.y, bh[1], bl[1]);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                mma_tf32(d, al[m], bh);
                mma_tf32(d, ah[m], bl);
                mma_tf32(d, ah[m], bh);
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[p][m][i] += d[i];
            }
        }
    }
}

// Warps of a block, at most, for the instantiation of NT n-tiles: with 8
// the 64 accumulators want more than 128 registers a thread (16 warps
// leave no more), so its blocks take 12.
__host__ __device__ constexpr int k1_max_warps(int NT) {
    return NT == 8 ? 12 : MAX_WARPS;
}

// NT: the n-tiles of 8 rows the accumulators hold (4, 7 or 8: up to 32,
// 56 or 64 layers).
template <int NT>
__global__ void __launch_bounds__(32 * k1_max_warps(NT), 1) transit_rt_kernel(
        Parts parts, const float* __restrict__ r1_rows, int n_r1,
        const float* __restrict__ cia_w, const float* __restrict__ cia_tab,
        int n_cia,
        const float* __restrict__ ls_w, const float* __restrict__ ls_tab,
        int n_ls,
        const float* __restrict__ packed, const float* __restrict__ cols,
        const float* __restrict__ scal, float* __restrict__ out,
        int nchains, int group, int nlayers, int nwave, float maxdepth) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int L = nlayers;
    const int nt = (L + 7) >> 3;        // n-tiles, and steps of 8 layers
    const int rows = 8 * nt;
    const int PK = chord_floats(nt);
    const int KP = n_cia <= 16 ? 16 : 32;   // the wrapper pads cia_w so
    const int K2P = round4(n_ls);
    const int ncols = 3 + n_r1;
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;        // fragment coordinates
    const int team = threadIdx.x / (32 * TEAM);
    const int nteams = blockDim.x / (32 * TEAM);
    const int tlane = threadIdx.x % (32 * TEAM);     // the column in the tile
    const int w = blockIdx.x * TW + tlane;
    const bool valid = w < nwave;

    float* s_tab = smem;                                   // [n_ls][L][TW]
    float* s_ctab = s_tab + n_ls * L * TW;                 // [n_cia][TW]
    const int region = team_floats(nt, n_r1, parts.n);
    float* s_chord = s_ctab + n_cia * TW + team * region;  // [PK]
    float4* s_w4 = reinterpret_cast<float4*>(s_chord + PK);       // [rows]
    int4* s_o4 = reinterpret_cast<int4*>(s_chord + PK + 4 * rows); // [rows]
    float4* s_ep = reinterpret_cast<float4*>(s_chord + PK + 8 * rows);
    float* s_r1c = s_chord + PK + 12 * rows;               // [n_r1][rows]
    float* s_e = s_r1c + n_r1 * rows + (tlane >> 5) * E_FLOATS;
    float* ring = s_r1c + n_r1 * rows + TEAM * E_FLOATS;
    unsigned* s_more =
        reinterpret_cast<unsigned*>(ring + parts.n * RING * TW);  // [2]
    const float* ctab = s_ctab + tlane;     // the lane's column of the tables
    const float* ltab = s_tab + tlane;
    // A layer's CIA (2 j) and line-sample (2 j + 1) live weights and offsets:
    const float2* s_w2 = reinterpret_cast<const float2*>(s_w4);
    const int2* s_o2 = reinterpret_cast<const int2*>(s_o4);

    load_slab(s_tab, ls_tab, n_ls * L, blockIdx.x * TW, nwave);
    for (int i = threadIdx.x; i < n_cia * TW; i += blockDim.x) {
        const int wk = blockIdx.x * TW + (i & (TW - 1));
        if (wk < nwave)
            cp_async4(s_ctab + i, cia_tab + (size_t)(i / TW) * nwave + wk);
        else
            s_ctab[i] = 0.f;
    }
    for (int i = tlane; i < region; i += 32 * TEAM) s_chord[i] = 0.f;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int c = team; c < group; c += nteams) {
        const int b = blockIdx.y * group + c;
        if (b >= nchains) break;
        team_sync(team);

        // The chain's chord fragments and rank-1 columns, all copies in
        // flight together, and the first rows of the dense parts:
        const float* cols_b = cols + (size_t)b * ncols * rows;
        copy_block(s_chord, packed + (size_t)b * PK, PK, tlane);
        copy_block(s_r1c, cols_b + 3 * rows, n_r1 * rows, tlane);
        cp_async_commit();
        for (int r = 0; r < RING; ++r)
            ring_fetch(ring, parts, (size_t)b * L * nwave, r, L, nwave,
                       tlane, w, valid);
        const float* sc = scal + (size_t)b * 8;
        const int itop = (int)sc[0];
        const int ibottom = (int)sc[1];
        // The deck row, or -1 (no row) without a deck splice:
        const int deck_row = sc[3] > 0.5f ? (int)sc[2] : -1;
        const float w_surf = sc[4];
        // Each layer's first two live CIA and line-sample weights and
        // their offsets in the tables, a thread a layer (rows <= 64), a
        // bit for each layer with more, and the layer's epilogue
        // constants (RowEpilogue; the coefficients as Epilogue::step makes
        // them, before and at the first row that exceeds maxdepth):
        const size_t row_b = (size_t)b * rows;   // the chain's first row
        bool more = false;
        if (tlane < rows) {
            float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
            int4 ov = make_int4(0, 0, 0, 0);
            if (n_cia) {
                more = live_pair(cia_w + (row_b + tlane) * KP, KP, wv.x,
                                 wv.y, ov.x, ov.y);
                ov.x *= TW;
                ov.y *= TW;
            }
            if (n_ls) {
                more |= live_pair(ls_w + (row_b + tlane) * K2P, K2P, wv.z,
                                  wv.w, ov.z, ov.w);
                // (A padded layer's absent weights point into the slab.)
                const int j = min(tlane, L - 1);
                ov.z = (ov.z * L + j) * TW;
                ov.w = (ov.w * L + j) * TW;
            }
            s_w4[tlane] = wv;
            s_o4[tlane] = ov;
            const int j = tlane;
            const float h = __ldg(cols_b + rows + j);
            const float hprev = __ldg(cols_b + 2 * rows + j);
            const float m = (j >= itop && j < ibottom - 1) ? 1.f : 0.f;
            const float mp = (j >= itop + 1 && j <= ibottom - 1) ? 1.f : 0.f;
            s_ep[j] = make_float4(
                __ldg(cols_b + j), 0.5f * (h * m + hprev * mp),
                0.5f * (h * 0.f + hprev * mp),
                j >= itop && j < ibottom ? maxdepth : INFINITY);
        }
        const unsigned more_bits = __ballot_sync(0xffffffffu, more);
        if (lane == 0) s_more[tlane >> 5] = more_bits;
        float r1r[MAX_R1];
        load_r1_rows(r1r, r1_rows, n_r1, b, nwave, w, valid);
        cp_async_wait<RING>();
        team_sync(team);
        // itop is clamped before it bounds a loop, so that a rejected
        // chain's garbage cannot address memory.
        const int jlo = max(0, min(itop, L));

        // The depths of the warp's columns by the rows of the n-tiles not
        // yet done: at step s, position p holds n-tile s + p.
        float acc[NT][2][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[n][m][i] = 0.f;
        float poison = 0.f;
        RowEpilogue ep = {false, 0.f, 0.f};
#pragma unroll 1
        for (int s = 0; s < nt; ++s) {
            const int j0 = 8 * s;
            // The extinction of the step's eight layers in the lane's
            // column, in the order of the Pallas kernel: dense parts (the
            // ring holds the step's rows, fetched during the step before),
            // rank-1 terms, the CIA product (its two live weights, from the
            // staged offsets, without a branch), the line sample (the
            // same); then, in the rare layers with more live weights, the
            // others, read from device memory.
            float e[2][4];
#pragma unroll
            for (int t = 0; t < 8; ++t) e[t >> 2][t & 3] = 0.f;
            if (parts.n > 0) {
                cp_async_wait<0>();
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    if (j0 + t < L) {
                        const float* slot = ring + t * TW + tlane;
                        float v = slot[0];
#pragma unroll
                        for (int p = 1; p < MAX_PARTS; ++p)
                            if (p < parts.n) v += slot[p * RING * TW];
                        e[t >> 2][t & 3] = v;
                    }
                }
#pragma unroll
                for (int t = 0; t < 8; ++t)
                    ring_fetch(ring, parts, (size_t)b * L * nwave,
                               j0 + RING + t, L, nwave, tlane, w, valid);
            }
            add_rank1(e[0], s_r1c, rows, j0, r1r, n_r1);
            add_rank1(e[1], s_r1c, rows, j0 + 4, r1r, n_r1);
            if (n_cia) {
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    const int2 o = s_o2[2 * (j0 + t)];
                    const float2 wv = s_w2[2 * (j0 + t)];
                    e[t >> 2][t & 3] += fmaf(wv.y, ctab[o.y], wv.x * ctab[o.x]);
                }
            }
            if (n_ls) {
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    const int2 o = s_o2[2 * (j0 + t) + 1];
                    const float2 wv = s_w2[2 * (j0 + t) + 1];
                    float& et = e[t >> 2][t & 3];
                    et = fmaf(wv.y, ltab[o.y], fmaf(wv.x, ltab[o.x], et));
                }
            }
            const unsigned more8 = (s_more[j0 >> 5] >> (j0 & 31)) & 0xffu;
            if (more8) {
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    if (!(more8 >> t & 1u)) continue;
                    const int j = j0 + t;
                    const float4 wv = s_w4[j];
                    float& et = e[t >> 2][t & 3];
                    if (n_cia)
                        et += rest_sum(cia_w + (row_b + j) * KP, KP,
                                       (wv.x != 0.f) + (wv.y != 0.f), ctab, TW,
                                       0.f);
                    if (n_ls)
                        et = rest_sum(ls_w + (row_b + j) * K2P, K2P,
                                      (wv.z != 0.f) + (wv.w != 0.f),
                                      ltab + j * TW, L * TW, et);
                }
            }
#pragma unroll
            for (int t = 0; t < 8; ++t) {
                const float et = e[t >> 2][t & 3];
                poison = fmaf(et, 0.f, poison);
                // Layers above itop add nothing (their chord column is
                // zero): zero them here, so that a non-finite one reaches
                // only the poison sum.
                s_e[swz(t, lane)] = j0 + t >= jlo ? et : 0.f;
            }
            __syncwarp();
            // The step's chord product on the tensor cores, for the
            // n-tiles from the step's own on (the matrix is zero above its
            // diagonal): A the extinction of the warp's 32 columns (two
            // m-tiles of 16) by the step's 8 layers, B an n-tile's chord
            // rows by those layers.  Three TF32 products of the split
            // operands from zero, then a float32 add to the depths.
            if (j0 + 8 > jlo) {
                unsigned ah[2][4], al[2][4];
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const int col = 16 * m + gid;
                    split_tf32_rna(s_e[swz(tig, col)], ah[m][0], al[m][0]);
                    split_tf32_rna(s_e[swz(tig, col + 8)], ah[m][1], al[m][1]);
                    split_tf32_rna(s_e[swz(tig + 4, col)], ah[m][2], al[m][2]);
                    split_tf32_rna(s_e[swz(tig + 4, col + 8)], ah[m][3],
                                   al[m][3]);
                }
                const float2* pb = reinterpret_cast<const float2*>(
                    s_chord + 64 * (s * nt - s * (s - 1) / 2)) + lane;
                step_product<NT, NT>(nt - s, acc, pb, ah, al);
            }
            __syncwarp();
            // n-tile s is done: its rows' epilogue, through the warp's
            // extinction buffer (the accumulators go in as rows of 32
            // columns, each lane reads back its own column; rows past the
            // last, to the padded 8 nt, add nothing: their depths, radii
            // and coefficients are zero), and the others move down.
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const int col = 16 * m + gid;
                s_e[swz(2 * tig, col)] = acc[0][m][0];
                s_e[swz(2 * tig + 1, col)] = acc[0][m][1];
                s_e[swz(2 * tig, col + 8)] = acc[0][m][2];
                s_e[swz(2 * tig + 1, col + 8)] = acc[0][m][3];
            }
#pragma unroll
            for (int p = 0; p + 1 < NT; ++p)
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[p][m][i] = acc[p + 1][m][i];
            __syncwarp();
#pragma unroll
            for (int r = 0; r < 8; ++r)
                ep.step(s_e[swz(r, lane)], s_ep[j0 + r], j0 + r == deck_row,
                        w_surf);
            __syncwarp();
        }
        cp_async_wait<0>();
        if (valid)
            out[(size_t)b * nwave + w] =
                (sc[6] + 2.f * ep.integral) * sc[5] + poison;
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

// The instantiation for a layer count (the n-tiles its accumulators
// hold); null outside 2-64 layers or above 32 CIA rows.
Kernel pick_kernel(int nlayers, int n_cia) {
    if (nlayers < 2 || nlayers > 64 || n_cia > 32) return nullptr;
    if (nlayers <= 32) return transit_rt_kernel<4>;
    if (nlayers <= 56) return transit_rt_kernel<7>;
    return transit_rt_kernel<8>;
}

int smem_bytes(int nlayers, int n_r1, int n_cia, int n_ls, int n_parts,
               int nwarps) {
    const long floats = (long)n_ls * nlayers * TW + (long)n_cia * TW
        + (long)(nwarps / TEAM)
        * team_floats((nlayers + 7) / 8, n_r1, n_parts);
    return floats * 4 > (1L << 30) ? (1 << 30) : (int)(floats * 4);
}

}  // namespace

// Warps of a block for these operand sizes: the most, up to 16 (12 above
// 56 layers) and in teams of 2, whose regions fit the shared memory
// beside the line-sample slab and the CIA table tile; 0 if the shapes
// have no instantiation or not even one team fits.
extern "C" int pbt_transit_rt_warps(int nlayers, int n_r1, int n_cia,
                                    int n_ls, int n_parts) {
    if (pick_kernel(nlayers, n_cia) == nullptr || n_cia < 0 || n_r1 < 0
            || n_r1 > pbt::MAX_R1 || n_ls < 0 || n_parts < 0
            || n_parts > pbt::MAX_PARTS)
        return 0;
    for (int nwarps = k1_max_warps(nlayers <= 56 ? 7 : 8); nwarps >= TEAM;
            nwarps -= TEAM)
        if (smem_bytes(nlayers, n_r1, n_cia, n_ls, n_parts, nwarps)
                <= pbt::SMEM_MAX)
            return nwarps;
    return 0;
}

// packed [B, chord_floats(nt)] (the chord fragments), cia_w [B, 8 nt, KP],
// ls_w [B, 8 nt, K2P] and cols [B, ncols, 8 nt] come laid out by the
// wrapper (transit_kernel.py chord_layout, assembly_operands); nt,
// packed_floats and ncols are checked against this file's own layout.
extern "C" int pbt_transit_rt(
        const float* part0, const float* part1, const float* part2,
        const float* part3, int n_parts, const float* r1_rows, int n_r1,
        const float* cia_w, const float* cia_tab, int n_cia,
        const float* ls_w, const float* ls_tab, int n_ls,
        const float* packed, const float* cols, const float* scal,
        float* out, int nchains, int nlayers, int nwave, int nt,
        int packed_floats, int ncols, float maxdepth, void* stream) {
    const int nwarps =
        pbt_transit_rt_warps(nlayers, n_r1, n_cia, n_ls, n_parts);
    if (nwarps < 1 || nt != (nlayers + 7) / 8
            || packed_floats != chord_floats(nt) || ncols != 3 + n_r1)
        return (int)cudaErrorInvalidValue;
    Kernel kernel = pick_kernel(nlayers, n_cia);
    const int smem =
        smem_bytes(nlayers, n_r1, n_cia, n_ls, n_parts, nwarps);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    // Two chains a team: the slab and the CIA table tile are staged once
    // for the group.
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
// the runtime's occupancy rule, times teams a block) in the function the
// wrapper takes at this layer count (the tall one above 64); 0 if no
// block fits, a negative CUDA error if the query fails.
extern "C" int pbt_transit_rt_chains_per_sm(
        int nlayers, int n_r1, int n_cia, int n_ls, int n_parts) {
    const bool tall = nlayers > 64;
    const int nwarps = tall
        ? pbt_transit_rt_tall_warps(nlayers, n_r1, n_cia, n_ls, n_parts)
        : pbt_transit_rt_warps(nlayers, n_r1, n_cia, n_ls, n_parts);
    if (nwarps < 1) return 0;
    const int smem = tall
        ? tall_smem_bytes(nlayers, n_r1, n_cia, n_ls, n_parts, nwarps)
        : smem_bytes(nlayers, n_r1, n_cia, n_ls, n_parts, nwarps);
    const void* fn = tall ? (const void*)transit_rt_tall_kernel
                          : (const void*)pick_kernel(nlayers, n_cia);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, fn, 32 * nwarps, smem);
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
