// Plane-parallel emission radiative transfer for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel of pyratbay_tpu
//   spectrum/emission_pallas.py  _emission_kernel (emission_flux_ensemble).
//
// Per chain b and wavenumber column w:
//   ec[j]    = sum of dense parts[b, j, w]
//            + sum_r r1_cols[b, r, j] * r1_rows[b, r, w]
//            + sum_k cia_w[b, j, k] * cia_tab[k, w]
//            + sum_k ls_w[b, k, j] * ls_tab[k, j, w]    (the transit order)
//   depth[k] = 0 for k <= itop, else
//              depth[k-1] + 0.5 * dr[k-1] * (ec[k-1] + ec[k])
//   ideep    = first row k > itop with depth[k] >= maxdepth, clipped to
//              bottom, else bottom  (bottom = min(ibottom, l-1), clipped to
//              the deck row with a deck: prep_emission_chains)
//   B[j]     = c1 wn^3 / expm1(c2 wn / T[j]), T with the deck row at tsurf
//   I(mu)    = B[ideep] e^{-depth[ideep]/mu}
//            - 1/2 sum_{itop <= j < ideep} (B[j] + B[j+1])
//                  (e^{-depth[j+1]/mu} - e^{-depth[j]/mu}),
//              and I = B[ideep] when ideep - itop == 1
//   out[b,w] = sum_m weight[m] I(mu[m])
// which is spectrum/rt.py plane_parallel_depth + plane_parallel_intensity
// + the weighted sum over angles.  Planck uses expm1f: the Pallas kernel's
// exp - 1 exists only because Mosaic has no expm1.
//
// Design (the block layout, the teams, the staging and the assembly of
// the extinction are in rt_common.cuh).  A thread walks its column of one
// chain once from the top: the depth is a running sum (l FMAs where the
// Pallas kernel's two [l, l] x [l, wt] products cost 2 l^2, and no
// [B, l, l] operand exists), it carries B and e^{-depth/mu} of the
// previous row, so each row costs one Planck and nmu exponentials.  The
// extinction and the Planck function of four layers are made together
// (they do not depend on each other, and a warp runs in order); the
// depth, the exponentials and the stop are then taken layer by layer.  A
// column's result is final at its ideep; the warp goes on, all lanes
// together and without divergence, until its last column has stopped, and
// what a stopped column computes after that is discarded.  So rows past a
// column's ideep cannot reach its result, NaN or inf there included: this
// follows rt.py's masked (where) semantics, not the Pallas kernel's
// multiply-by-zero.  itop, bottom and the layer index are only compared,
// never used to address memory, so a rejected chain (T_irr = 1e6, T <= 0)
// computes garbage but cannot fault.  e^{-depth / mu} is one exp2f of the
// depth times -log2(e) / mu (2 ulp), a column's intensities are put
// together only at the row where it stops, and 1 / T[j] is taken once a
// chain, as it is staged, so a row's Planck costs one division.  The angle
// count is a template parameter (5, the default ray grid; 8 and 16 take
// the other counts under a predicate) and the angles sit in the constant
// bank.
//
// Bound on the H100 at the flagship shape (B = 512, l = 51, W = 3209,
// nmu = 5, line sample in the kernel): (1 + nmu) B l W = 5.0e8
// transcendentals are ~0.13 ms at the SFUs' ~4e12/s if every row is
// walked (the stop at ideep walks fewer); CIA is 2.5 GFLOP of fp32 FMAs,
// ~0.04 ms, the line sample 0.3 GFLOP; the bytes (6.5 MB of table, 3 MB
// of weights, a 6.6 MB result) are ~0.005 ms at 3.35 TB/s, and with the
// line sample as a dense part its 335 MB are ~0.10 ms.  So the bound is
// ~0.15-0.2 ms.  Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.74 ms
// of device time (0.76 ms on a dense part), against 1.03 ms for the
// kernel this replaces (one thread a column, one block a chain and 128
// columns).  Of that kernel's unattributed ~0.5 ms, 0.27 ms was the angle
// loop unrolled to 16 under predicates (that kernel rebuilt with 5 slots:
// 1.06 ms as it was, 0.79 ms, on the same operands), and its `Parts`
// pointers did sit in local memory (a 32-byte stack frame).  Past that,
// both designs are bound the same way: by the latency of one chain's walk
// and the chains an SM holds in flight (builds with MAX_WARPS lowered:
// 1.89, 1.01, 0.82, 0.76 ms at 6, 12, 18, 24 warps a block).
// PERF.md has the runs and the designs that were tried.
#include "rt_common.cuh"

namespace {

using namespace pbt;

constexpr int MAX_WARPS = 24;    // warps of a block, at most
constexpr int MAX_MU = 16;

// scale[m] = -log2(e) / mu[m]: e^{-depth / mu} = 2^{depth * scale}.
struct Angles {
    float scale[MAX_MU];
    float weight[MAX_MU];
};

template <int NMU, int KP>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1) emission_rt_kernel(
        Parts parts, const float* __restrict__ r1_rows, int n_r1,
        const float* __restrict__ cia_w, const float* __restrict__ cia_tab,
        int n_cia,
        const float* __restrict__ ls_w, const float* __restrict__ ls_tab,
        int n_ls,
        const float* __restrict__ cols, const int* __restrict__ scal,
        const float* __restrict__ wn, Angles angles, int nmu, float c1,
        float c2, float* __restrict__ out, int nchains, int group,
        int nlayers, int nwave, float maxdepth) {
    // The default ray grid's count runs without the predicate on nmu:
    constexpr bool EXACT = NMU == 5;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int L = nlayers;
    const int rows = round4(L);
    const int K2P = round4(n_ls);
    const int ncols = 2 + n_r1;
    const int team = threadIdx.x / (32 * TEAM);
    const int nteams = blockDim.x / (32 * TEAM);
    const int tlane = threadIdx.x % (32 * TEAM);   // the column in the tile
    const int w = blockIdx.x * TW + tlane;
    const bool valid = w < nwave;

    float* s_tab = smem;                                   // [n_ls][L][TW]
    const int region = assembly_floats(rows, KP, n_cia, K2P, ncols, parts.n);
    float* s_ciaw = smem + n_ls * L * TW + team * region;  // [rows][KP]
    float* s_lsw = s_ciaw + (n_cia ? rows * KP : 0);       // [rows][K2P]
    unsigned* s_mask = reinterpret_cast<unsigned*>(s_lsw + rows * K2P);
    float* s_cols = s_lsw + rows * K2P + rows * ((K2P + 31) >> 5);
    const float* s_dr = s_cols;                            // [rows]
    float* s_invt = s_cols + rows;             // [rows]: T, staged to 1 / T
    float* ring = s_cols + ncols * rows;                   // parts ring

    load_slab(s_tab, ls_tab, n_ls * L, blockIdx.x * TW, nwave);
    for (int i = tlane; i < region; i += 32 * TEAM) s_ciaw[i] = 0.f;

    Assembler<KP> as;
    as.s_ciaw = s_ciaw;
    as.s_lsw = s_lsw;
    as.s_mask = s_mask;
    as.s_r1c = s_cols + 2 * rows;
    as.s_tab = s_tab;
    as.ring = ring;
    as.n_parts = parts.n;
    as.n_r1 = n_r1;
    as.n_cia = n_cia;
    as.K2P = K2P;
    as.L = L;
    as.rows = rows;
    as.col = tlane;
    as.load_cia_table(cia_tab, nwave, w, valid);

    // Planck numerators of the column (a column past nwave takes wn = 1:
    // finite and discarded).
    const float wnv = valid ? wn[w] : 1.f;
    const float bnum = c1 * wnv * wnv * wnv, xnum = c2 * wnv;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int c = team; c < group; c += nteams) {
        const int b = blockIdx.y * group + c;
        if (b >= nchains) break;
        team_sync(team);

        // The chain's operands into the team's region, all copies in
        // flight together, and the first rows of the dense parts:
        stage_chain(s_ciaw, s_lsw, s_cols, cia_w, ls_w, cols, b, rows, KP,
                    n_cia, K2P, ncols, tlane);
        cp_async_commit();
        const int itop = scal[2 * b];
        const int bottom = scal[2 * b + 1];
        // The walk starts in the chunk of four layers that holds the
        // first layer it needs:
        const int first = max(min(itop, bottom), 0) & ~3;
        const size_t chain_off = (size_t)b * L * nwave;
        for (int r = 0; r < RING; ++r)
            ring_fetch(ring, parts, chain_off, first + r, L, nwave, tlane, w,
                       valid);
        as.load_r1_rows(r1_rows, b, nwave, w, valid);
        cp_async_wait<RING>();
        team_sync(team);
        // One division a layer for the Planck function of the whole tile:
        for (int j = tlane; j < L; j += 32 * TEAM)
            s_invt[j] = 1.f / s_invt[j];
        build_mask(s_mask, s_lsw, rows, K2P, tlane, team);

        float e_prev[NMU], integ[NMU];
#pragma unroll
        for (int m = 0; m < NMU; ++m) {
            e_prev[m] = 1.f;
            integ[m] = 0.f;
        }
        float flux = 0.f, depth = 0.f, ec_prev = 0.f, b_prev = 0.f;
        bool live = valid;
        bool done = false;
#pragma unroll 1
        for (int k0 = first; k0 < L && !done; k0 += 4) {
            // Extinction and Planck function of four layers together
            // (independent of each other: the warp runs in order); the
            // ring holds the layers k0 .. k0 + 7.
            if (parts.n > 0) cp_async_wait<4>();
            float ec[4], bb[4];
            as.rows4(k0, ec);
            if (parts.n > 0) {
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    ring_fetch(ring, parts, chain_off, k0 + RING + t, L,
                               nwave, tlane, w, valid);
            }
#pragma unroll
            for (int t = 0; t < 4; ++t)
                bb[t] = bnum / expm1f(xnum * s_invt[k0 + t]);
#pragma unroll 1
            for (int t = 0; t < 4; ++t) {
                const int k = k0 + t;
                if (k >= L) break;
                if (k < itop && k != bottom) continue;
                const float ec_k =
                    t == 0 ? ec[0] : t == 1 ? ec[1] : t == 2 ? ec[2] : ec[3];
                const float b_k =
                    t == 0 ? bb[0] : t == 1 ? bb[1] : t == 2 ? bb[2] : bb[3];
                if (k <= itop && k == bottom) {
                    // ideep at or above itop: depth is 0 there, and
                    // I = B[ideep].
#pragma unroll
                    for (int m = 0; m < NMU; ++m)
                        if (EXACT || m < nmu) flux += angles.weight[m] * b_k;
                    done = true;
                    break;
                }
                if (k > itop) {
                    depth = fmaf(0.5f * s_dr[k - 1], ec_prev + ec_k, depth);
                    const float b_sum = b_prev + b_k;
#pragma unroll
                    for (int m = 0; m < NMU; ++m) {
                        if (EXACT || m < nmu) {
                            const float x = exp2f(depth * angles.scale[m]);
                            integ[m] = fmaf(b_sum, x - e_prev[m], integ[m]);
                            e_prev[m] = x;
                        }
                    }
                    const bool last = k >= bottom || k == L - 1;
                    // A column's intensities are summed once, at its ideep:
                    if (live && (depth >= maxdepth || last)) {
                        const bool single = k - itop == 1;
#pragma unroll
                        for (int m = 0; m < NMU; ++m) {
                            if (EXACT || m < nmu) {
                                const float inten = single ? b_k :
                                    b_k * e_prev[m] - 0.5f * integ[m];
                                flux += angles.weight[m] * inten;
                            }
                        }
                        live = false;
                    }
                    if (!__any_sync(0xffffffffu, live)) {
                        done = true;
                        break;
                    }
                }
                ec_prev = ec_k;
                b_prev = b_k;
            }
        }
        cp_async_wait<0>();
        if (valid) out[(size_t)b * nwave + w] = flux;
    }
}

typedef void (*Kernel)(
    Parts, const float*, int, const float*, const float*, int, const float*,
    const float*, int, const float*, const int*, const float*, Angles, int,
    float, float, float*, int, int, int, int, float);

template <int NMU>
Kernel pick_depth(int n_cia) {
    if (n_cia <= 16) return emission_rt_kernel<NMU, 16>;
    return emission_rt_kernel<NMU, 32>;
}

Kernel pick_kernel(int nmu, int n_cia, int* KP) {
    *KP = n_cia <= 16 ? 16 : 32;
    if (nmu < 1 || nmu > MAX_MU || n_cia > 32) return nullptr;
    if (nmu == 5) return pick_depth<5>(n_cia);
    if (nmu <= 8) return pick_depth<8>(n_cia);
    return pick_depth<16>(n_cia);
}

int smem_bytes(int KP, int nlayers, int n_r1, int n_cia, int n_ls,
               int n_parts, int nwarps) {
    const long floats = (long)n_ls * nlayers * TW + (long)(nwarps / TEAM)
        * assembly_floats(round4(nlayers), KP, n_cia, round4(n_ls),
                          2 + n_r1, n_parts);
    return floats * 4 > (1L << 30) ? (1 << 30) : (int)(floats * 4);
}

}  // namespace

extern "C" int pbt_emission_rt_max_mu() { return MAX_MU; }

// Warps of a block for these operand sizes: the most, up to 24 and in
// teams of 2, whose regions fit the shared memory beside the line-sample
// slab; 0 if the shapes have no instantiation or not even one team fits.
extern "C" int pbt_emission_rt_warps(int nlayers, int n_r1, int n_cia,
                                     int n_ls, int n_parts) {
    if (nlayers < 2 || n_cia > 32 || n_r1 > pbt::MAX_R1
            || n_parts > pbt::MAX_PARTS)
        return 0;
    const int KP = n_cia <= 16 ? 16 : 32;
    for (int nwarps = MAX_WARPS; nwarps >= TEAM; nwarps -= TEAM)
        if (smem_bytes(KP, nlayers, n_r1, n_cia, n_ls, n_parts, nwarps)
                <= pbt::SMEM_MAX)
            return nwarps;
    return 0;
}

// cia_w [B, rows, KP], ls_w [B, rows, K2P] and cols [B, ncols, rows]
// (layer thicknesses, temperatures, rank-1 columns) come laid out by the
// wrapper (emission_kernel.py); rows and ncols are checked against this
// file's own layout.
extern "C" int pbt_emission_rt(
        const float* part0, const float* part1, const float* part2,
        const float* part3, int n_parts, const float* r1_rows, int n_r1,
        const float* cia_w, const float* cia_tab, int n_cia,
        const float* ls_w, const float* ls_tab, int n_ls,
        const float* cols, const int* scal, const float* wn,
        const float* inv_mu, const float* weights, int nmu, float c1,
        float c2, float* out, int nchains, int nlayers, int nwave, int rows,
        int ncols, float maxdepth, void* stream) {
    if (n_parts < 0 || n_parts > pbt::MAX_PARTS)
        return (int)cudaErrorInvalidValue;
    const int nwarps =
        pbt_emission_rt_warps(nlayers, n_r1, n_cia, n_ls, n_parts);
    int KP;
    Kernel kernel = pick_kernel(nmu, n_cia, &KP);
    if (nwarps < 1 || kernel == nullptr || rows != pbt::round4(nlayers)
            || ncols != 2 + n_r1)
        return (int)cudaErrorInvalidValue;
    Angles angles;
    for (int m = 0; m < MAX_MU; ++m) {
        angles.scale[m] = m < nmu ? -1.4426950408889634f * inv_mu[m] : 0.f;
        angles.weight[m] = m < nmu ? weights[m] : 0.f;
    }
    const int smem =
        smem_bytes(KP, nlayers, n_r1, n_cia, n_ls, n_parts, nwarps);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    // Two chains a team: the slab is staged once for the group.
    const int group = 2 * (nwarps / pbt::TEAM);
    Parts parts = {part0, part1, part2, part3, n_parts};
    dim3 grid((nwave + pbt::TW - 1) / pbt::TW, (nchains + group - 1) / group);
    kernel<<<grid, 32 * nwarps, smem, (cudaStream_t)stream>>>(
        parts, r1_rows, n_r1, cia_w, cia_tab, n_cia, ls_w, ls_tab, n_ls,
        cols, scal, wn, angles, nmu, c1, c2, out, nchains, group, nlayers,
        nwave, maxdepth);
    return (int)cudaGetLastError();
}
