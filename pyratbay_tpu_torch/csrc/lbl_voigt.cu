// Direct line-by-line Voigt cross sections for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of pyratbay_tpu opacity/lbl_pallas.py:
//   K4  wing_sigma_grouped (_wing_grouped_kernel)  -> pbt_lbl_wing, group >= 1
//   K6  wing_sigma         (_wing_kernel)          -> pbt_lbl_wing, group = 1
//   K5  core_sigma         (_core_kernel)          -> pbt_lbl_core
//
// Every output point w of a tile sums over the tile's static window of
// candidate lines l (operands prepared by opacity/lbl_direct.py):
//   dnu  = (wn_hi[w] - lwn_hi[l]) + (wn_lo[w] - lwn_lo[l])   float pairs
//   wing: x2 = (dnu inv_ad)^2, u = 1 / (x2 + y2), a = x2 u,
//         sigma += c1 u S(u, a)        if margin < |dnu| <= cutoff
//         with S the 5-term asymptotic series of Re w (wing_series)
//   core: sigma += Re w(dnu inv_ad, y) scale        if |dnu| <= margin
//         (ops/special.py wofz_real with 16 Weideman terms)
// per species when a species index is given.  The float-pair difference
// keeps ~1e-7 cm-1 of dnu at nu ~ 1e4 cm-1 (a plain float32 difference
// loses ~1e-3 cm-1, a tenth of a Doppler width): the parenthesisation
// matters and the library is built without fast-math.  The reciprocal is
// the IEEE 1.0f / d (the Pallas kernel's approximate reciprocal plus one
// Newton step is later performance work).
//
// Design.  Wing (K4, K6): one block per (cell, group of consecutive
// tiles), one thread per output point; K4's fine sub-tiles of tile_pts
// points come 128 / tile_pts to a block, K6's 128-point tiles one to a
// block.  The block stages its tiles' windows (lwn_hi, lwn_lo, c1, y2,
// inv_ad, species) through shared memory in chunks of STAGE entries with
// coalesced loads; every thread of a tile then reads the same entry (a
// broadcast) and keeps its per-species sums in registers.  Core (K5): one
// thread per output point of the 4-point tiles, 32 tiles to a block; each
// thread loops over its tile's few dozen lines straight from global
// memory (the four threads of a tile read the same addresses) and branches
// to the one region of wofz_real that its pair needs, where the TPU
// computes all three and selects; pairs outside the margin skip it.
//
// Bound on the H100.  Wing pairs cost ~35 float32 operations and one IEEE
// division (~10 instructions) plus 5-6 shared-memory reads; the flagship
// (51 x 3209, 50,000 lines) has 4.7e6 padded wing pairs per cell, so a
// 64-cell block is 3.0e8 pairs: ~1.5e10 instructions, ~0.5 ms of issue
// at the card's ~3e13 lane-instructions/s.  The core pairs inside the
// margin cost ~150-250 operations each (the Weideman rational function
// has three complex divisions), ~1e5 per cell.  Operands are read once
// per block from HBM/L2 (~15 MB per 64-cell block): arithmetic bounds
// both kernels, not memory.  Measured on an H100 80GB HBM3 at 700 W: the
// wing pass runs 3.7-4.1e11 pairs/s on a flagship block and 5.2e11 on a
// 200,000-point block, the core pass 0.22-0.25 ms per flagship block.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_SPEC = 8;
constexpr int STAGE = 1024;      // staged window entries per wing block
constexpr int CORE_THREADS = 128;
constexpr int NW = 16;           // Weideman terms (float32)
constexpr float SQRT_PI = 1.7724538509055159f;

struct Weideman {
    float length;
    float a[NW];
};

__device__ __forceinline__ float wing_series(float u, float a) {
    const float u2 = u * u;
    const float u3 = u2 * u;
    const float u4 = u3 * u;
    return 1.0f
        + u * (2.0f * a - 0.5f)
        + u2 * ((12.0f * a - 9.0f) * a + 0.75f)
        + u3 * (((120.0f * a - 150.0f) * a + 45.0f) * a - 1.875f)
        + u4 * ((((1680.0f * a - 2940.0f) * a + 1575.0f) * a - 262.5f) * a
                + 6.5625f);
}

__device__ __forceinline__ float wing_pair(
        float wh, float wl, float lh, float ll, float c1, float y2,
        float iad, float margin, float cutoff) {
    const float dwn = (wh - lh) + (wl - ll);
    const float xi = dwn * iad;
    const float x2 = xi * xi;
    const float u = 1.0f / (x2 + y2);
    const float a = x2 * u;
    const float s = wing_series(u, a);
    const float adwn = fabsf(dwn);
    return (adwn > margin && adwn <= cutoff) ? c1 * u * s : 0.0f;
}

// Large-|z| asymptotic series of Re w (ops/special.py
// _wofz_real_asymptotic).
__device__ float wofz_asymptotic(float x, float y) {
    const float r2 = fmaxf(x * x + y * y, 1.0f);
    const float r4 = r2 * r2;
    const float re_q = (x * x - y * y) / r4;
    const float im_q = -2.0f * x * y / r4;
    const float coeff[4] = {6.5625f, 1.875f, 0.75f, 0.5f};
    float re_s = 29.53125f, im_s = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float re = re_s * re_q - im_s * im_q + coeff[k];
        im_s = re_s * im_q + im_s * re_q;
        re_s = re;
    }
    const float re = re_s * re_q - im_s * im_q + 1.0f;
    im_s = re_s * im_q + im_s * re_q;
    re_s = re;
    return (y * re_s - x * im_s) / (r2 * SQRT_PI);
}

// Weideman (1994) rational approximation of w(x + i y), y >= 0
// (ops/special.py _weideman).
__device__ void weideman(float x, float y, const Weideman& wd, float* re_w,
                         float* im_w) {
    const float re_num = wd.length - y, im_num = x;
    const float re_den = wd.length + y, im_den = -x;
    const float den2 = re_den * re_den + im_den * im_den;
    const float re_z = (re_num * re_den + im_num * im_den) / den2;
    const float im_z = (im_num * re_den - re_num * im_den) / den2;
    float re_p = wd.a[0], im_p = 0.0f;
#pragma unroll
    for (int k = 1; k < NW; ++k) {
        const float re = re_p * re_z - im_p * im_z + wd.a[k];
        im_p = re_p * im_z + im_p * re_z;
        re_p = re;
    }
    const float re_d2 = re_den * re_den - im_den * im_den;
    const float im_d2 = 2.0f * re_den * im_den;
    const float d4 = re_d2 * re_d2 + im_d2 * im_d2;
    const float re_q = (re_p * re_d2 + im_p * im_d2) / d4;
    const float im_q = (im_p * re_d2 - re_p * im_d2) / d4;
    *re_w = 2.0f * re_q + re_den / den2 / SQRT_PI;
    *im_w = 2.0f * im_q - im_den / den2 / SQRT_PI;
}

// Small-y region: exact Gaussian plus the Dawson-Taylor expansion
// (ops/special.py _wofz_real_small_y).
__device__ float wofz_small_y(float x, float y, const Weideman& wd) {
    float re_w0, im_w0;
    weideman(x, 0.0f, wd, &re_w0, &im_w0);
    const float daw = 0.5f * SQRT_PI * im_w0;
    const float f1 = 1.0f - 2.0f * x * daw;
    const float f2 = -2.0f * daw - 2.0f * x * f1;
    const float f3 = -4.0f * f1 - 2.0f * x * f2;
    const float f4 = -6.0f * f2 - 2.0f * x * f3;
    const float f5 = -8.0f * f3 - 2.0f * x * f4;
    const float gauss = expf(y * y - x * x) * cosf(2.0f * x * y);
    const float y3 = y * y * y;
    const float y5 = y3 * y * y;
    const float im_fc = y * f1 - y3 / 6.0f * f3 + y5 / 120.0f * f5;
    return gauss - 2.0f / SQRT_PI * im_fc;
}

// Re w(x + i y): the one region the pair needs (ops/special.py wofz_real
// selects among all three).
__device__ __forceinline__ float wofz_real(float x, float y,
                                           const Weideman& wd) {
    if (x * x + y * y >= 196.0f) return wofz_asymptotic(x, y);
    if (y < 0.03f) return wofz_small_y(x, y, wd);
    float re_w, im_w;
    weideman(x, y, wd, &re_w, &im_w);
    return re_w;
}

template <int NS>
__global__ void __launch_bounds__(1024) wing_kernel(
        const float* __restrict__ wn_hi, const float* __restrict__ wn_lo,
        const float* __restrict__ lwn_hi, const float* __restrict__ lwn_lo,
        const float* __restrict__ c1, const float* __restrict__ y2,
        const float* __restrict__ inv_ad, const int* __restrict__ spec,
        float* __restrict__ out, int ntiles, int tile, int lmax, int group,
        int nspec, float margin, float cutoff) {
    __shared__ float s_lh[STAGE], s_ll[STAGE], s_c1[STAGE], s_y2[STAGE],
        s_iad[STAGE];
    __shared__ int s_sp[NS > 1 ? STAGE : 1];

    const int cell = blockIdx.y;
    const int tile0 = blockIdx.x * group;
    const int t = threadIdx.x;
    const int sub = t / tile, pt = t - sub * tile;
    const int it = tile0 + sub;
    const bool active = sub < group && it < ntiles;
    const int lch = STAGE / group;        // window entries per tile per chunk
    const size_t cbase = (size_t)cell * ntiles * lmax;

    float wh = 0.0f, wl = 0.0f;
    if (active) {
        wh = wn_hi[(size_t)it * tile + pt];
        wl = wn_lo[(size_t)it * tile + pt];
    }
    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.0f;

    for (int l0 = 0; l0 < lmax; l0 += lch) {
        const int nl = min(lch, lmax - l0);
        __syncthreads();
        for (int i = t; i < group * lch; i += blockDim.x) {
            const int s = i / lch, j = i - s * lch;
            if (tile0 + s < ntiles && j < nl) {
                const size_t e = (size_t)(tile0 + s) * lmax + l0 + j;
                s_lh[i] = lwn_hi[e];
                s_ll[i] = lwn_lo[e];
                s_c1[i] = c1[cbase + e];
                s_y2[i] = y2[cbase + e];
                s_iad[i] = inv_ad[cbase + e];
                if (NS > 1) s_sp[i] = spec[e];
            }
        }
        __syncthreads();
        if (active) {
            const int b = sub * lch;
            for (int j = 0; j < nl; ++j) {
                const float v = wing_pair(wh, wl, s_lh[b + j], s_ll[b + j],
                                          s_c1[b + j], s_y2[b + j],
                                          s_iad[b + j], margin, cutoff);
                if (NS == 1) {
                    acc[0] += v;
                } else {
                    const int sp = s_sp[b + j];
#pragma unroll
                    for (int s = 0; s < NS; ++s) acc[s] += sp == s ? v : 0.0f;
                }
            }
        }
    }
    if (active) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
            if (s < nspec)
                out[(((size_t)cell * nspec + s) * ntiles + it) * tile + pt] =
                    acc[s];
    }
}

template <int NS>
__global__ void __launch_bounds__(CORE_THREADS) core_kernel(
        const float* __restrict__ wn_hi, const float* __restrict__ wn_lo,
        const float* __restrict__ lwn_hi, const float* __restrict__ lwn_lo,
        const float* __restrict__ scale, const float* __restrict__ y,
        const float* __restrict__ inv_ad, const int* __restrict__ spec,
        float* __restrict__ out, int ntiles, int tile, int lmax, int nspec,
        float margin, Weideman wd) {
    const int cell = blockIdx.y;
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= ntiles * tile) return;
    const int it = p / tile;
    const float wh = wn_hi[p], wl = wn_lo[p];
    const size_t wbase = (size_t)it * lmax;
    const size_t cbase = (size_t)cell * ntiles * lmax + wbase;

    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.0f;
    for (int j = 0; j < lmax; ++j) {
        const float dwn = (wh - lwn_hi[wbase + j]) + (wl - lwn_lo[wbase + j]);
        if (fabsf(dwn) <= margin) {
            const float v = wofz_real(dwn * inv_ad[cbase + j], y[cbase + j],
                                      wd) * scale[cbase + j];
            if (NS == 1) {
                acc[0] += v;
            } else {
                const int sp = spec[wbase + j];
#pragma unroll
                for (int s = 0; s < NS; ++s) acc[s] += sp == s ? v : 0.0f;
            }
        }
    }
    const int pt = p - it * tile;
#pragma unroll
    for (int s = 0; s < NS; ++s)
        if (s < nspec)
            out[(((size_t)cell * nspec + s) * ntiles + it) * tile + pt] =
                acc[s];
}

template <int NS>
cudaError_t launch_wing(dim3 grid, int threads, cudaStream_t stream,
                        const float* wn_hi, const float* wn_lo,
                        const float* lwn_hi, const float* lwn_lo,
                        const float* c1, const float* y2, const float* inv_ad,
                        const int* spec, float* out, int ntiles, int tile,
                        int lmax, int group, int nspec, float margin,
                        float cutoff) {
    wing_kernel<NS><<<grid, threads, 0, stream>>>(
        wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad, spec, out, ntiles,
        tile, lmax, group, nspec, margin, cutoff);
    return cudaGetLastError();
}

template <int NS>
cudaError_t launch_core(dim3 grid, cudaStream_t stream, const float* wn_hi,
                        const float* wn_lo, const float* lwn_hi,
                        const float* lwn_lo, const float* scale,
                        const float* y, const float* inv_ad, const int* spec,
                        float* out, int ntiles, int tile, int lmax, int nspec,
                        float margin, const Weideman& wd) {
    core_kernel<NS><<<grid, CORE_THREADS, 0, stream>>>(
        wn_hi, wn_lo, lwn_hi, lwn_lo, scale, y, inv_ad, spec, out, ntiles,
        tile, lmax, nspec, margin, wd);
    return cudaGetLastError();
}

}  // namespace

extern "C" int pbt_lbl_max_spec() { return MAX_SPEC; }

// K4 (group = 128 / tile_pts sub-tiles per block) and K6 (group = 1).
// out: [ncell, nspec, ntiles, tile]; spec may be null when nspec == 1.
extern "C" int pbt_lbl_wing(
        const float* wn_hi, const float* wn_lo, const float* lwn_hi,
        const float* lwn_lo, const float* c1, const float* y2,
        const float* inv_ad, const int* spec, float* out, int ncell,
        int ntiles, int tile, int lmax, int group, int nspec, float margin,
        float cutoff, void* stream) {
    if (ncell < 1 || ncell > 65535 || ntiles < 1 || tile < 1 || lmax < 1
        || group < 1 || group > STAGE || group * tile > 1024 || nspec < 1
        || nspec > MAX_SPEC || (nspec > 1 && spec == nullptr))
        return (int)cudaErrorInvalidValue;
    const int threads = (group * tile + 31) / 32 * 32;
    const dim3 grid((ntiles + group - 1) / group, ncell);
    cudaStream_t s = (cudaStream_t)stream;
    if (nspec == 1)
        return (int)launch_wing<1>(grid, threads, s, wn_hi, wn_lo, lwn_hi,
                                   lwn_lo, c1, y2, inv_ad, spec, out, ntiles,
                                   tile, lmax, group, nspec, margin, cutoff);
    if (nspec <= 2)
        return (int)launch_wing<2>(grid, threads, s, wn_hi, wn_lo, lwn_hi,
                                   lwn_lo, c1, y2, inv_ad, spec, out, ntiles,
                                   tile, lmax, group, nspec, margin, cutoff);
    if (nspec <= 4)
        return (int)launch_wing<4>(grid, threads, s, wn_hi, wn_lo, lwn_hi,
                                   lwn_lo, c1, y2, inv_ad, spec, out, ntiles,
                                   tile, lmax, group, nspec, margin, cutoff);
    return (int)launch_wing<8>(grid, threads, s, wn_hi, wn_lo, lwn_hi,
                               lwn_lo, c1, y2, inv_ad, spec, out, ntiles,
                               tile, lmax, group, nspec, margin, cutoff);
}

// K5.  out: [ncell, nspec, ntiles, tile]; coeffs: the nterms Weideman
// coefficients of ops/special.py _weideman_coeffs, host memory.
extern "C" int pbt_lbl_core(
        const float* wn_hi, const float* wn_lo, const float* lwn_hi,
        const float* lwn_lo, const float* scale, const float* y,
        const float* inv_ad, const int* spec, float* out, int ncell,
        int ntiles, int tile, int lmax, int nspec, float margin,
        float length, const float* coeffs, int nterms, void* stream) {
    if (ncell < 1 || ncell > 65535 || ntiles < 1 || tile < 1 || lmax < 1
        || nspec < 1 || nspec > MAX_SPEC || nterms != NW
        || (nspec > 1 && spec == nullptr))
        return (int)cudaErrorInvalidValue;
    Weideman wd;
    wd.length = length;
    for (int k = 0; k < NW; ++k) wd.a[k] = coeffs[k];
    const long long npts = (long long)ntiles * tile;
    const dim3 grid((unsigned)((npts + CORE_THREADS - 1) / CORE_THREADS),
                    ncell);
    cudaStream_t s = (cudaStream_t)stream;
    if (nspec == 1)
        return (int)launch_core<1>(grid, s, wn_hi, wn_lo, lwn_hi, lwn_lo,
                                   scale, y, inv_ad, spec, out, ntiles, tile,
                                   lmax, nspec, margin, wd);
    if (nspec <= 2)
        return (int)launch_core<2>(grid, s, wn_hi, wn_lo, lwn_hi, lwn_lo,
                                   scale, y, inv_ad, spec, out, ntiles, tile,
                                   lmax, nspec, margin, wd);
    if (nspec <= 4)
        return (int)launch_core<4>(grid, s, wn_hi, wn_lo, lwn_hi, lwn_lo,
                                   scale, y, inv_ad, spec, out, ntiles, tile,
                                   lmax, nspec, margin, wd);
    return (int)launch_core<8>(grid, s, wn_hi, wn_lo, lwn_hi, lwn_lo, scale,
                               y, inv_ad, spec, out, ntiles, tile, lmax,
                               nspec, margin, wd);
}
