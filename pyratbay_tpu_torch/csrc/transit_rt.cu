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
//   depth[i] = sum_j path2[b, i, j] * ec[j]      (chord matrix, pair-sum fold)
//   ideep   = first row i in [itop, ibottom) with depth > maxdepth,
//             else ibottom - 1
//   integ[i] = exp(-depth[i]) * r[i], row deck_itop spliced with the deck
//             surface when deck_itop > itop
//   out[b, w] = (r_itop^2 + 2 * sum_i integ[i] * coef[i]) / rstar^2, with
//             coef = 0.5 (h[i] m[i] + h[i-1] mp[i]),
//             m = in_range & i < ideep, mp = i >= itop+1 & i <= ideep.
//
// Design: one block per (tile of TILE wave columns, chain), one thread per
// column.  The chain's small operands (path2 [l, l], r/h/h_prev columns,
// CIA weights [l, K], rank-1 columns) and the tile's table rows are staged
// in shared memory; each thread assembles its ec column in shared memory,
// then walks the rows once: the depth row is an FMA dot product against
// the broadcast path2 row, and the epilogue (ideep, exp, deck splice,
// masked trapezoid) is accumulated in the same pass.  This is exact
// because the ideep known so far (first exceed, else ibottom-1) gives
// every row the coefficient of the final ideep: a later exceed changes
// no earlier row's masks.  Every row's integ * coef is added, zero
// coefficients included, so NaN/inf propagate as in the Pallas kernel.
//
// Bound on the H100 at the flagship shape (B = 512, l = 51, W = 3209):
// 2*B*l*l*W = 8.5 GFLOP for the chord product plus 2*B*l*K*W = 2.5 GFLOP
// for CIA (K = 15), all fp32 FMAs outside the tensor cores (no TF32), and
// one read of the 335 MB line-sample part plus a 6.6 MB write.  At the
// card's 67 TFLOP/s fp32 and 3.35 TB/s that is ~0.16 ms of arithmetic and
// ~0.10 ms of HBM traffic; shared-memory reads of the ec column (one per
// FMA of the chord product) are the practical limit of this simple design.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 128;
constexpr int MAX_PARTS = 4;

struct Parts {
    const float* p[MAX_PARTS];
};

__global__ void transit_rt_kernel(
        Parts parts, int n_parts,
        const float* __restrict__ r1_cols, const float* __restrict__ r1_rows,
        int n_r1,
        const float* __restrict__ cia_w, const float* __restrict__ cia_tab,
        int n_cia,
        const float* __restrict__ path2, const float* __restrict__ scal,
        const float* __restrict__ rad, const float* __restrict__ h,
        const float* __restrict__ hprev,
        float* __restrict__ out, int nlayers, int nwave, float maxdepth) {
    extern __shared__ float smem[];
    const int L = nlayers;
    const int K = n_cia;
    const int tid = threadIdx.x;
    float* s_path2 = smem;                     // [L * L]
    float* s_rad = s_path2 + L * L;            // [L]
    float* s_h = s_rad + L;                    // [L]
    float* s_hprev = s_h + L;                  // [L]
    float* s_ciaw = s_hprev + L;               // [L * K]
    float* s_r1c = s_ciaw + L * K;             // [n_r1 * L]
    float* s_ciat = s_r1c + n_r1 * L;          // [K * TILE]
    float* s_r1r = s_ciat + K * TILE;          // [n_r1 * TILE]
    float* s_ec = s_r1r + n_r1 * TILE;         // [L * TILE]

    const int b = blockIdx.y;
    const int w = blockIdx.x * TILE + tid;
    const bool valid = w < nwave;

    const size_t chain_ll = (size_t)b * L * L;
    for (int i = tid; i < L * L; i += TILE) s_path2[i] = path2[chain_ll + i];
    for (int i = tid; i < L; i += TILE) {
        s_rad[i] = rad[(size_t)b * L + i];
        s_h[i] = h[(size_t)b * L + i];
        s_hprev[i] = hprev[(size_t)b * L + i];
    }
    for (int i = tid; i < L * K; i += TILE)
        s_ciaw[i] = cia_w[(size_t)b * L * K + i];
    for (int i = tid; i < n_r1 * L; i += TILE)
        s_r1c[i] = r1_cols[(size_t)b * n_r1 * L + i];
    for (int k = 0; k < K; ++k)
        s_ciat[k * TILE + tid] = valid ? cia_tab[(size_t)k * nwave + w] : 0.f;
    for (int r = 0; r < n_r1; ++r)
        s_r1r[r * TILE + tid] =
            valid ? r1_rows[((size_t)b * n_r1 + r) * nwave + w] : 0.f;
    __syncthreads();

    // Extinction column of this thread (only this thread reads it back):
    const size_t col0 = (size_t)b * L * nwave + (valid ? w : 0);
    for (int j = 0; j < L; ++j) {
        float e = 0.f;
        if (valid) {
            const size_t at = col0 + (size_t)j * nwave;
            if (n_parts > 0) e = parts.p[0][at];
            for (int p = 1; p < n_parts; ++p) e += parts.p[p][at];
        }
        for (int r = 0; r < n_r1; ++r)
            e += s_r1c[r * L + j] * s_r1r[r * TILE + tid];
        if (K > 0) {
            float c = 0.f;
            for (int k = 0; k < K; ++k)
                c = fmaf(s_ciaw[j * K + k], s_ciat[k * TILE + tid], c);
            e += c;
        }
        s_ec[j * TILE + tid] = e;
    }

    const float* sc = scal + (size_t)b * 8;
    const int itop = (int)sc[0];
    const int ibottom = (int)sc[1];
    const int deck_row = (int)sc[2];
    const bool apply_deck = sc[3] > 0.5f;
    const float w_surf = sc[4];
    const float inv_rstar2 = sc[5];
    const float r_itop2 = sc[6];

    int ideep = ibottom - 1;
    bool found = false;
    float integral = 0.f;
    float prev_integ = 0.f;
    for (int i = 0; i < L; ++i) {
        const float* prow = s_path2 + i * L;
        float d = 0.f;
        for (int j = 0; j < L; ++j) d = fmaf(prow[j], s_ec[j * TILE + tid], d);
        const bool in_range = i >= itop && i < ibottom;
        if (!found && in_range && d > maxdepth) {
            found = true;
            ideep = i;
        }
        const float raw = expf(-d) * s_rad[i];
        float integ = raw;
        if (apply_deck && i == deck_row)
            integ = prev_integ * (1.f - w_surf) + raw * w_surf;
        const float m = (in_range && i < ideep) ? 1.f : 0.f;
        const float mp = (i >= itop + 1 && i <= ideep) ? 1.f : 0.f;
        integral += integ * (0.5f * (s_h[i] * m + s_hprev[i] * mp));
        prev_integ = raw;
    }
    if (valid)
        out[(size_t)b * nwave + w] = (r_itop2 + 2.f * integral) * inv_rstar2;
}

}  // namespace

extern "C" int pbt_transit_rt_smem_bytes(int nlayers, int n_r1, int n_cia) {
    const int L = nlayers;
    return (int)sizeof(float) * (L * L + 3 * L + L * n_cia + n_r1 * L
                                 + (n_cia + n_r1 + L) * TILE);
}

extern "C" int pbt_transit_rt(
        const float* part0, const float* part1, const float* part2,
        const float* part3, int n_parts,
        const float* r1_cols, const float* r1_rows, int n_r1,
        const float* cia_w, const float* cia_tab, int n_cia,
        const float* path2, const float* scal, const float* rad,
        const float* h, const float* hprev, float* out,
        int nchains, int nlayers, int nwave, float maxdepth, void* stream) {
    if (n_parts < 0 || n_parts > MAX_PARTS) return (int)cudaErrorInvalidValue;
    Parts parts = {{part0, part1, part2, part3}};
    const int smem = pbt_transit_rt_smem_bytes(nlayers, n_r1, n_cia);
    cudaError_t err = cudaFuncSetAttribute(
        transit_rt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((nwave + TILE - 1) / TILE, nchains);
    transit_rt_kernel<<<grid, TILE, smem, (cudaStream_t)stream>>>(
        parts, n_parts, r1_cols, r1_rows, n_r1, cia_w, cia_tab, n_cia,
        path2, scal, rad, h, hprev, out, nlayers, nwave, maxdepth);
    return (int)cudaGetLastError();
}
