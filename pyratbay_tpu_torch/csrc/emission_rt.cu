// Plane-parallel emission radiative transfer for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel of pyratbay_tpu
//   spectrum/emission_pallas.py  _emission_kernel (emission_flux_ensemble).
//
// Per chain b and wavenumber column w:
//   ec[j]    = sum of dense parts[b, j, w]
//            + sum_r r1_cols[b, r, j] * r1_rows[b, r, w]
//            + sum_k cia_w[b, j, k] * cia_tab[k, w]          (K1's order)
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
// Design: one block per (tile of TILE wave columns, chain), one thread per
// column.  The chain's small operands (dr, the temperature column, CIA
// weights [l, K], rank-1 columns) and the tile's table rows sit in shared
// memory.  Each thread walks its column once from the top: the depth is a
// running sum (l FMAs where the Pallas kernel's two [l, l] x [l, wt]
// products cost 2 l^2, and no [B, l, l] operand exists), it carries B and
// e^{-depth/mu} of the previous row, so each row costs one Planck and nmu
// exponentials, and it stops at ideep, where every term the result needs
// is known.  Rows past ideep are never read, so NaN or inf there cannot
// reach the result: this follows rt.py's masked (where) semantics, not the
// Pallas kernel's multiply-by-zero.  itop, bottom and the layer index are
// only compared, never used to address memory taken from data, so a
// rejected chain (T_irr = 1e6, T <= 0) computes garbage but cannot fault.
//
// Bound on the H100 at the flagship shape (B = 512, l = 51, W = 3209,
// nmu = 5): one read of the 335 MB line-sample part is ~0.10 ms at
// 3.35 TB/s; (1 + nmu) B l W = 5.0e8 transcendentals are ~0.13 ms at the
// SFUs' ~4e12/s; CIA is 2 B l K W = 2.5 GFLOP of fp32 FMAs, ~0.04 ms.  So
// the ideal is ~0.1-0.2 ms.  This simple design issues the part loads one
// row at a time per thread (coalesced across the warp, no prefetch) and
// pays expm1f and an IEEE division per row in software on top of the SFU
// work; the early stop at ideep skips the rows below the photosphere.
// Measured there (H100 80GB HBM3, 700 W): 1.33 ms.  A probe with the same
// grid, part stream and per-row arithmetic but nothing staged in shared
// memory takes 0.43 ms, and prefetching the part rows ahead does not help,
// so HBM bandwidth and load latency do not bound it.  Dropping CIA saves
// 0.23 ms and dropping the rank-1 term 0.13 ms; the other ~0.5 ms is not
// yet attributed (suspects: the serial per-block staging into shared
// memory, the parts pointers read from local memory, the angle loop
// unrolled to MAX_MU with predicates).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 128;
constexpr int MAX_PARTS = 4;
constexpr int MAX_MU = 16;

struct Parts {
    const float* p[MAX_PARTS];
};

struct Angles {
    float inv_mu[MAX_MU];
    float weight[MAX_MU];
};

__global__ void emission_rt_kernel(
        Parts parts, int n_parts,
        const float* __restrict__ r1_cols, const float* __restrict__ r1_rows,
        int n_r1,
        const float* __restrict__ cia_w, const float* __restrict__ cia_tab,
        int n_cia,
        const int* __restrict__ scal, const float* __restrict__ dr,
        const float* __restrict__ temp, const float* __restrict__ wn,
        Angles angles, int nmu, float c1, float c2,
        float* __restrict__ out, int nlayers, int nwave, float maxdepth) {
    extern __shared__ float smem[];
    const int L = nlayers;
    const int K = n_cia;
    const int tid = threadIdx.x;
    float* s_dr = smem;                        // [L] (L - 1 used)
    float* s_temp = s_dr + L;                  // [L]
    float* s_ciaw = s_temp + L;                // [L * K]
    float* s_r1c = s_ciaw + L * K;             // [n_r1 * L]
    float* s_ciat = s_r1c + n_r1 * L;          // [K * TILE]
    float* s_r1r = s_ciat + K * TILE;          // [n_r1 * TILE]

    const int b = blockIdx.y;
    const int w = blockIdx.x * TILE + tid;
    const bool valid = w < nwave;

    for (int i = tid; i < L - 1; i += TILE)
        s_dr[i] = dr[(size_t)b * (L - 1) + i];
    for (int i = tid; i < L; i += TILE) s_temp[i] = temp[(size_t)b * L + i];
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
    if (!valid) return;

    const int itop = scal[2 * b];
    const int bottom = scal[2 * b + 1];
    const float wnv = wn[w];
    const float bnum = c1 * wnv * wnv * wnv;
    const float xnum = c2 * wnv;
    const size_t col0 = (size_t)b * L * nwave + w;

    // Extinction at row j of this thread's column, in K1's order:
    auto ec_at = [&](int j) {
        float e = 0.f;
        const size_t at = col0 + (size_t)j * nwave;
        if (n_parts > 0) e = parts.p[0][at];
        for (int p = 1; p < n_parts; ++p) e += parts.p[p][at];
        for (int r = 0; r < n_r1; ++r)
            e += s_r1c[r * L + j] * s_r1r[r * TILE + tid];
        if (K > 0) {
            float c = 0.f;
            for (int k = 0; k < K; ++k)
                c = fmaf(s_ciaw[j * K + k], s_ciat[k * TILE + tid], c);
            e += c;
        }
        return e;
    };
    auto planck = [&](int j) { return bnum / expm1f(xnum / s_temp[j]); };

    float e_prev[MAX_MU];
    float integ[MAX_MU];
#pragma unroll
    for (int m = 0; m < MAX_MU; ++m) {
        e_prev[m] = 1.f;
        integ[m] = 0.f;
    }
    float flux = 0.f;
    float depth = 0.f;
    float ec_prev = 0.f;
    float b_prev = 0.f;
    for (int k = 0; k < L; ++k) {
        if (k <= itop) {
            if (k == bottom) {
                // ideep at or above itop: depth is 0 there, I = B[ideep].
                const float b_last = planck(k);
#pragma unroll
                for (int m = 0; m < MAX_MU; ++m)
                    if (m < nmu) flux += angles.weight[m] * b_last;
                break;
            }
            if (k == itop) {
                ec_prev = ec_at(k);
                b_prev = planck(k);
            }
            continue;
        }
        const float ec_k = ec_at(k);
        depth = fmaf(0.5f * s_dr[k - 1], ec_prev + ec_k, depth);
        const float b_k = planck(k);
        const float b_sum = b_prev + b_k;
#pragma unroll
        for (int m = 0; m < MAX_MU; ++m) {
            if (m < nmu) {
                const float e = expf(-depth * angles.inv_mu[m]);
                integ[m] = fmaf(b_sum, e - e_prev[m], integ[m]);
                e_prev[m] = e;
            }
        }
        if (depth >= maxdepth || k >= bottom || k == L - 1) {
            const bool single = k - itop == 1;
#pragma unroll
            for (int m = 0; m < MAX_MU; ++m) {
                if (m < nmu) {
                    const float inten =
                        single ? b_k : b_k * e_prev[m] - 0.5f * integ[m];
                    flux += angles.weight[m] * inten;
                }
            }
            break;
        }
        ec_prev = ec_k;
        b_prev = b_k;
    }
    out[(size_t)b * nwave + w] = flux;
}

}  // namespace

extern "C" int pbt_emission_rt_smem_bytes(int nlayers, int n_r1, int n_cia) {
    const int L = nlayers;
    return (int)sizeof(float) * (2 * L + L * n_cia + n_r1 * L
                                 + (n_cia + n_r1) * TILE);
}

extern "C" int pbt_emission_rt_max_mu() { return MAX_MU; }

extern "C" int pbt_emission_rt(
        const float* part0, const float* part1, const float* part2,
        const float* part3, int n_parts,
        const float* r1_cols, const float* r1_rows, int n_r1,
        const float* cia_w, const float* cia_tab, int n_cia,
        const int* scal, const float* dr, const float* temp, const float* wn,
        const float* inv_mu, const float* weights, int nmu, float c1,
        float c2, float* out, int nchains, int nlayers, int nwave,
        float maxdepth, void* stream) {
    if (n_parts < 0 || n_parts > MAX_PARTS || nmu < 1 || nmu > MAX_MU)
        return (int)cudaErrorInvalidValue;
    Parts parts = {{part0, part1, part2, part3}};
    Angles angles;
    for (int m = 0; m < MAX_MU; ++m) {
        angles.inv_mu[m] = m < nmu ? inv_mu[m] : 0.f;
        angles.weight[m] = m < nmu ? weights[m] : 0.f;
    }
    const int smem = pbt_emission_rt_smem_bytes(nlayers, n_r1, n_cia);
    cudaError_t err = cudaFuncSetAttribute(
        emission_rt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((nwave + TILE - 1) / TILE, nchains);
    emission_rt_kernel<<<grid, TILE, smem, (cudaStream_t)stream>>>(
        parts, n_parts, r1_cols, r1_rows, n_r1, cia_w, cia_tab, n_cia, scal,
        dr, temp, wn, angles, nmu, c1, c2, out, nlayers, nwave, maxdepth);
    return (int)cudaGetLastError();
}
