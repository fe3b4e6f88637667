// Direct line-by-line Voigt cross sections for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of pyratbay_tpu opacity/lbl_pallas.py:
//   K4  wing_sigma_grouped (_wing_grouped_kernel)
//         -> pbt_lbl_wing_lines    per-line factors by line range: the
//                                  main path
//         -> pbt_lbl_wing, group >= 1   the Pallas wrapper's window layout
//   K5  core_sigma         (_core_kernel)
//         -> pbt_lbl_core_lines    per-line factors by line range: the
//                                  main path
//         -> pbt_lbl_core          the window layout
//   K6  wing_sigma         (_wing_kernel)  -> pbt_lbl_wing, group = 1:
//                                  wing_windows_kernel
//
// Every output point w of a tile sums over the tile's static window of
// candidate lines l, a contiguous range [start, start + lmax) of the
// sorted line array (operands prepared by opacity/lbl_direct.py):
//   dnu  = (wn_hi[w] - lwn_hi[l]) + (wn_lo[w] - lwn_lo[l])   float pairs
//   wing: x2 = (dnu inv_ad)^2, u = 1 / (x2 + y2), a = x2 u,
//         sigma += c1 u S(u, a)        if margin < |dnu| <= cutoff
//         with S the 5-term asymptotic series of Re w (wing_series)
//   core: sigma += Re w(dnu inv_ad, y) scale        if |dnu| <= margin
//         (ops/special.py wofz_real with 16 Weideman terms)
// per species when a species index is given.  The float-pair difference
// keeps ~1e-7 cm-1 of dnu at nu ~ 1e4 cm-1 (a plain float32 difference
// loses ~1e-3 cm-1, a tenth of a Doppler width): the parenthesisation
// matters and the library is built without fast-math.
//
// The window layout [ncell, ntiles, lmax] of the factors is the TPU's: it
// spares that machine per-tile gathers, and it stores a line's factors
// once per window the line falls in (4 times on the flagship grid of
// 3209 points and 47,175 lines, 60 times at 200,000 points).  Here a warp reads a line range with 16-byte copies, so the
// main path keeps the factors once per line, [ncell, nlines], and the
// kernels get the window starts.
//
// What bounds them on the card.  Both passes are bound by the
// instructions they issue, not by memory: a 64-cell block reads ~40 MB
// of operands (12 us at 3.35 TB/s) and a wing pair and cell costs ~23
// instructions (15 of them FMAs: ~30 operations), a core pair and cell
// ~120 in the Weideman region.  Measured times and bounds: PERF.md,
// section 6 (NVIDIA H100 80GB HBM3, 700.00 W).
//
// Design, wing on per-line factors (wing_lines_kernel).  A warp owns 16
// points x 16 cells: 8 point lanes x 4 cell lanes, 2 points x 4 cells a
// thread, so dnu, |dnu|, the mask and the line reads are paid once per
// (point, line) and serve four cells, a line's factors serve two points,
// and eight independent chains a line hide the FMA latency.  The warp
// bisects the run of lines that its points can reach inside the union
// of their windows (lines and points ascend): on a coarse grid that is
// ~3/4 of a 32-point sub-tile's window, whatever tile_wing is.  It walks
// the run four lines a step; a ring of its own in shared memory, filled
// by 16-byte cp.async copies three steps ahead, feeds the pair loop, so
// no thread holds operands of a later step in registers (70 registers).
// The reciprocal is rcp.approx.ftz.f32 (within one ulp), the series is
// in Horner form over u, the mask is a predicate on the last FMA.  A
// step wholly inside every window of the warp skips the per-line index
// test that keeps a pair out of a window it is not in.  A launch with
// fewer than ~12 warps an SM (a flagship block has 804) gives each warp
// a quarter of its run and sums the four parts through shared memory in
// warp order: the result does not depend on the schedule.
//
// Design, core on per-line factors (core_lines_kernel).  A thread owns
// one point x 2 cells.  It bisects its own run of in-margin lines inside
// its tile's window once for both cells, so the lanes of a warp start
// aligned on their own lines (in the window layout the four points of a
// tile walk the whole window and most candidates fail the margin test,
// on lanes that differ), tests the exact mask per pair, and branches to
// the one region of wofz_real that a pair and cell needs (the lanes of a
// warp work on the same cells at the same time, so the region differs
// among them by x only).  Pairs are not grouped by region: walking the
// run in three phases (far above the point, near it, the rest), so that
// lanes on different lines meet the same region together, was measured
// slower (PERF.md, section 6).  The in-margin pairs are found in the
// kernel, not listed at set-up: the search costs ~50 instructions a
// thread against ~2,000 of Faddeeva work, and no list has to live on the
// card.  The divisions of the Weideman
// function share one reciprocal, except in its last term (see weideman).
//
// Design, K6 on its window layout (wing_windows_kernel): the wing design
// above on the Pallas wrapper's operands, points [ntiles, tile] and each
// tile's window [ntiles, lmax] with its factors [ncell, ntiles, lmax].  A
// warp owns 16 points of one tile x 16 cells (a tile of 128 points is 8
// warps), so a window entry's lwn_hi/lo are read once for its 16 cells and
// its factors once for its two points a thread; it bisects the run of the
// tile's window its points reach (the row ascends: lines 1e9 cm-1 away
// pad a short one), and stages the run four entries a step through its
// ring with 16-byte cp.async copies, or 4-byte ones where a row of lmax
// entries is not 16-byte aligned (lmax not a multiple of four); an entry
// past the run is masked, so nothing past a row is read.  The same
// reciprocal, series and predicate, and the same split of a run over a
// block's warps for a launch with few warps an SM.  The old K6 (one
// thread a point, the window staged through shared memory in chunks of
// 1,024 entries with 4-byte loads, an IEEE divide, no sharing of a line's
// reads between points or cells) took 1.253 ms on a 64-cell flagship
// block against a 0.067 ms bound (PERF.md, section 6).
//
// The window-layout kernels of K4 and K5 (the Pallas wrappers' operands,
// kept for the parity tests): wing, one block per (cell, group of
// consecutive tiles), one thread per output point, the windows staged
// through shared memory in chunks of STAGE entries, IEEE 1.0f / d; core,
// one thread per point of the 4-point tiles walking its tile's window
// from global memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_SPEC = 8;
constexpr int STAGE = 1024;      // staged window entries per wing block
constexpr int CORE_THREADS = 128;
constexpr int NW = 16;           // Weideman terms (float32)
constexpr float SQRT_PI = 1.7724538509055159f;
constexpr float INV_SQRT_PI = 0.5641895835477563f;
// The per-line kernels: the line arrays come in multiples of LINE_ALIGN
// entries (16-byte loads).  A wing warp owns WL_WPTS points x WL_WCELLS
// cells: WL_PLANES point lanes x WL_CLANES cell lanes, WL_PT points x
// WL_CT cells a thread.  A core thread owns one point x CL_CT cells.
constexpr int LINE_ALIGN = 4;
constexpr int WL_PT = 2, WL_CT = 4;
constexpr int WL_PLANES = 8, WL_CLANES = 4;
constexpr int WL_WPTS = WL_PLANES * WL_PT, WL_WCELLS = WL_CLANES * WL_CT;
constexpr int WL_WARPS = 4;      // warps a block
// A launch with fewer warps than this for each SM of the card splits each
// warp's line range over the WL_WARPS warps of a block.  One measurement
// fixed the 12 and no other value was tried: a flagship block (804 warps
// on 132 SMs) took 0.589 ms unsplit and 0.346 ms split (NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md, section 6).
constexpr int WL_SPLIT_WARPS_PER_SM = 12;
// A wing warp stages its steps (LINE_ALIGN lines: the two line arrays and
// three factors of its WL_WCELLS cells, 16 bytes each) through a ring of
// its own in shared memory, WL_RING - 1 steps ahead of the pair loop.
constexpr int WL_RING = 4;
constexpr int WL_ITEMS = 2 + 3 * WL_WCELLS;
// K6's steps also carry the species of the four window entries:
constexpr int WW_ITEMS = WL_ITEMS + 1;
constexpr int CL_CT = 2;
constexpr unsigned FULL = 0xffffffffu;

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
// _wofz_real_asymptotic), with one reciprocal.
__device__ float wofz_asymptotic(float x, float y) {
    const float r2 = fmaxf(x * x + y * y, 1.0f);
    const float ir2 = 1.0f / r2;
    const float ir4 = ir2 * ir2;
    const float re_q = (x * x - y * y) * ir4;
    const float im_q = -2.0f * x * y * ir4;
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
    return (y * re_s - x * im_s) * ir2 * INV_SQRT_PI;
}

// Weideman (1994) rational approximation of w(x + i y), y >= 0
// (ops/special.py _weideman).  The divisions of z and of the polynomial
// share one reciprocal (|den^2|^2 = |den|^4).  The last term keeps its
// two divisions: for large |z| it cancels against the polynomial term to
// a few digits, and there a reciprocal's extra rounding moves the result
// away from the plain version's by up to 1e-4 relative.
__device__ __forceinline__ void weideman(float x, float y,
                                         const Weideman& wd, float* re_w,
                                         float* im_w) {
    const float re_num = wd.length - y, im_num = x;
    const float re_den = wd.length + y, im_den = -x;
    const float den2 = re_den * re_den + im_den * im_den;
    const float iden2 = 1.0f / den2;
    const float re_z = (re_num * re_den + im_num * im_den) * iden2;
    const float im_z = (im_num * re_den - re_num * im_den) * iden2;
    float re_p = wd.a[0], im_p = 0.0f;
#pragma unroll
    for (int k = 1; k < NW; ++k) {
        const float re = re_p * re_z - im_p * im_z + wd.a[k];
        im_p = re_p * im_z + im_p * re_z;
        re_p = re;
    }
    const float re_d2 = re_den * re_den - im_den * im_den;
    const float im_d2 = 2.0f * re_den * im_den;
    const float id4 = iden2 * iden2;
    const float re_q = (re_p * re_d2 + im_p * im_d2) * id4;
    const float im_q = (im_p * re_d2 - re_p * im_d2) * id4;
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
    const float im_fc = y * f1 - y3 * (1.0f / 6.0f) * f3
        + y5 * (1.0f / 120.0f) * f5;
    return gauss - 2.0f * INV_SQRT_PI * im_fc;
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

// d -> 1 / d by the hardware's approximate reciprocal alone:
// rcp.approx.ftz.f32 is within one ulp (PTX ISA), so the Newton step
// that the Pallas wing kernels add to the TPU's coarser reciprocal buys
// nothing here and costs two of ~23 instructions a pair and cell.
__device__ __forceinline__ float rcp_approx(float d) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
    return r;
}

// wing_series in Horner form over u: 14 FMAs.
__device__ __forceinline__ float wing_series_horner(float u, float a) {
    const float p1 = fmaf(2.0f, a, -0.5f);
    const float p2 = fmaf(fmaf(12.0f, a, -9.0f), a, 0.75f);
    const float p3 =
        fmaf(fmaf(fmaf(120.0f, a, -150.0f), a, 45.0f), a, -1.875f);
    const float p4 = fmaf(
        fmaf(fmaf(fmaf(1680.0f, a, -2940.0f), a, 1575.0f), a, -262.5f), a,
        6.5625f);
    return fmaf(u, fmaf(u, fmaf(u, fmaf(u, p4, p3), p2), p1), 1.0f);
}

// Asynchronous 16-byte copy from global to shared memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Slack of a bisection on the float32 `hi` parts alone: a wavenumber and
// its hi part differ by half an ulp (6e-8 relative) at most.
__device__ __forceinline__ float hi_slack(float a, float b) {
    return 1e-6f * fmaxf(fabsf(a), fabsf(b)) + 1e-6f;
}

// First j in [a, b) with v[j] >= t (strict = false) or v[j] > t (true);
// v ascending.
__device__ __forceinline__ int first_at_least(const float* __restrict__ v,
                                              int a, int b, float t,
                                              bool strict) {
    while (a < b) {
        const int m = (a + b) >> 1;
        const float x = __ldg(v + m);
        if (strict ? x <= t : x < t) a = m + 1; else b = m;
    }
    return a;
}

// K4 on per-line operands.  c1, y2, inv_ad: [ncell, nlines]; the window
// of tile t is [starts[t], starts[t] + lmax) of the line arrays.
template <int NS>
__global__ void __launch_bounds__(WL_WARPS * 32) wing_lines_kernel(
        const float* __restrict__ wn_hi, const float* __restrict__ wn_lo,
        const int* __restrict__ starts, const float* __restrict__ lwn_hi,
        const float* __restrict__ lwn_lo, const float* __restrict__ c1,
        const float* __restrict__ y2, const float* __restrict__ inv_ad,
        const int* __restrict__ spec, float* __restrict__ out, int ncell,
        int ntiles, int tile, int lmax, int nlines, int nspec, float margin,
        float cutoff, int split) {
    // split = 0: the warps of a block own consecutive point groups.
    // split = 1: they own one point group and a share each of its line
    // range, summed through shared memory in warp order at the end.
    __shared__ float s_part[WL_WARPS - 1][WL_PT * WL_CT * NS][32];
    __shared__ float4 s_ring[WL_WARPS][WL_RING][WL_ITEMS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int pl = lane % WL_PLANES, cl = lane / WL_PLANES;
    const int npts = ntiles * tile;
    const int p0 =
        (split ? blockIdx.x : blockIdx.x * WL_WARPS + warp) * WL_WPTS;
    if (p0 >= npts) return;      // the whole warp, or with split the block
    const int cell0 = blockIdx.y * WL_WCELLS + cl * WL_CT;

    // This thread's points, each with its own tile's window:
    float wh[WL_PT], wl[WL_PT];
    int lo[WL_PT], hi[WL_PT];
#pragma unroll
    for (int s = 0; s < WL_PT; ++s) {
        const int p = min(p0 + s * WL_PLANES + pl, npts - 1);
        wh[s] = wn_hi[p];
        wl[s] = wn_lo[p];
        lo[s] = min(max(starts[p / tile], 0), nlines);
        hi[s] = min(lo[s] + lmax, nlines);
    }
    // The warp's range: the union of its windows, cut to the lines that
    // one of its points can reach (lines and points ascend, so they are
    // one run); `ilo`, `ihi` bound the lines inside every window.
    int wlo = lo[0], whi = hi[0], ilo = lo[0], ihi = hi[0];
    float pmin = wh[0], pmax = wh[0];
#pragma unroll
    for (int s = 1; s < WL_PT; ++s) {
        wlo = min(wlo, lo[s]);
        whi = max(whi, hi[s]);
        ilo = max(ilo, lo[s]);
        ihi = min(ihi, hi[s]);
        pmin = fminf(pmin, wh[s]);
        pmax = fmaxf(pmax, wh[s]);
    }
    wlo = __reduce_min_sync(FULL, wlo);
    whi = __reduce_max_sync(FULL, whi);
    ilo = __reduce_max_sync(FULL, ilo);
    ihi = __reduce_min_sync(FULL, ihi);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        pmin = fminf(pmin, __shfl_xor_sync(FULL, pmin, d));
        pmax = fmaxf(pmax, __shfl_xor_sync(FULL, pmax, d));
    }
    const float reach = cutoff + hi_slack(pmin, pmax);
    int ja = first_at_least(lwn_hi, wlo, whi, pmin - reach, false)
        & ~(LINE_ALIGN - 1);
    int jb = first_at_least(lwn_hi, ja, whi, pmax + reach, true);
    if (split) {
        const int share = ((jb - ja + WL_WARPS - 1) / WL_WARPS
                           + LINE_ALIGN - 1) & ~(LINE_ALIGN - 1);
        ja = min(ja + warp * share, jb);
        jb = min(ja + share, jb);
    }

    float acc[WL_PT][WL_CT][NS];
#pragma unroll
    for (int s = 0; s < WL_PT; ++s)
#pragma unroll
        for (int c = 0; c < WL_CT; ++c)
#pragma unroll
            for (int k = 0; k < NS; ++k) acc[s][c][k] = 0.0f;

    // Staging: item t of a step is lwn_hi, lwn_lo (t = 0, 1), then c1,
    // y2, inv_ad of the warp's 16 cells; lane l copies items l and
    // l + 32.
    float4* ring = &s_ring[warp][0][0];
    const float* src[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int t = lane + 32 * h;
        if (t < 2) {
            src[h] = t == 0 ? lwn_hi : lwn_lo;
        } else if (t < WL_ITEMS) {
            const int f = (t - 2) / WL_WCELLS, slot = (t - 2) % WL_WCELLS;
            const int cell =
                min((int)blockIdx.y * WL_WCELLS + slot, ncell - 1);
            src[h] = (f == 0 ? c1 : f == 1 ? y2 : inv_ad)
                + (size_t)cell * nlines;
        } else {
            src[h] = nullptr;
        }
    }
    const int nsteps = jb > ja ? (jb - ja + LINE_ALIGN - 1) / LINE_ALIGN : 0;
    auto stage = [&](int step) {
        if (step < nsteps) {
            float4* dst = ring + (step % WL_RING) * WL_ITEMS + lane;
            const int j = ja + step * LINE_ALIGN;
            cp_async16(dst, src[0] + j);
            if (src[1] != nullptr) cp_async16(dst + 32, src[1] + j);
        }
        cp_async_commit();
    };
    for (int step = 0; step < WL_RING - 1; ++step) stage(step);

    for (int step = 0; step < nsteps; ++step) {
        const int j = ja + step * LINE_ALIGN;
        stage(step + WL_RING - 1);
        cp_async_wait<WL_RING - 1>();
        __syncwarp();
        const float4* st = ring + (step % WL_RING) * WL_ITEMS;
        const float4 vlh = st[0], vll = st[1];
        const float lh[4] = {vlh.x, vlh.y, vlh.z, vlh.w};
        const float ll[4] = {vll.x, vll.y, vll.z, vll.w};
        // The pairs of this step: depend on (point, line) only.
        const bool inner = j >= ilo && j + LINE_ALIGN <= ihi;
        float dn[WL_PT][4];
        unsigned mask = 0;
#pragma unroll
        for (int s = 0; s < WL_PT; ++s)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float d = (wh[s] - lh[q]) + (wl[s] - ll[q]);
                const float ad = fabsf(d);
                bool m = ad > margin && ad <= cutoff;
                if (!inner) m = m && j + q >= lo[s] && j + q < hi[s];
                dn[s][q] = d;
                mask |= (unsigned)m << (s * 4 + q);
            }
        int sp[4] = {0, 0, 0, 0};
        if (NS > 1) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(spec + j));
            sp[0] = v.x; sp[1] = v.y; sp[2] = v.z; sp[3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < WL_CT; ++c) {
            const float4 v1 = st[2 + cl * WL_CT + c];
            const float4 v2 = st[2 + WL_WCELLS + cl * WL_CT + c];
            const float4 v3 = st[2 + 2 * WL_WCELLS + cl * WL_CT + c];
            const float k1[4] = {v1.x, v1.y, v1.z, v1.w};
            const float k2[4] = {v2.x, v2.y, v2.z, v2.w};
            const float k3[4] = {v3.x, v3.y, v3.z, v3.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int s = 0; s < WL_PT; ++s) {
                    const float xi = dn[s][q] * k3[q];
                    const float x2 = xi * xi;
                    const float u = rcp_approx(x2 + k2[q]);
                    const float sr = wing_series_horner(u, x2 * u);
                    const float v = k1[q] * u;
                    const bool m = (mask >> (s * 4 + q)) & 1u;
                    if (NS == 1) {
                        if (m) acc[s][c][0] = fmaf(v, sr, acc[s][c][0]);
                    } else {
                        const float t = m ? v * sr : 0.0f;
#pragma unroll
                        for (int k = 0; k < NS; ++k)
                            acc[s][c][k] += sp[q] == k ? t : 0.0f;
                    }
                }
        }
        __syncwarp();       // the ring slot is free for step + WL_RING
    }
    if (split) {
        if (warp > 0) {
#pragma unroll
            for (int s = 0; s < WL_PT; ++s)
#pragma unroll
                for (int c = 0; c < WL_CT; ++c)
#pragma unroll
                    for (int k = 0; k < NS; ++k)
                        s_part[warp - 1][(s * WL_CT + c) * NS + k][lane] =
                            acc[s][c][k];
        }
        __syncthreads();
        if (warp > 0) return;
        for (int w = 0; w < WL_WARPS - 1; ++w)
#pragma unroll
            for (int s = 0; s < WL_PT; ++s)
#pragma unroll
                for (int c = 0; c < WL_CT; ++c)
#pragma unroll
                    for (int k = 0; k < NS; ++k)
                        acc[s][c][k] +=
                            s_part[w][(s * WL_CT + c) * NS + k][lane];
    }
#pragma unroll
    for (int s = 0; s < WL_PT; ++s) {
        const int p = p0 + s * WL_PLANES + pl;
        if (p >= npts) continue;
        const int it = p / tile, pt = p - it * tile;
#pragma unroll
        for (int c = 0; c < WL_CT; ++c) {
            if (cell0 + c >= ncell) continue;
#pragma unroll
            for (int k = 0; k < NS; ++k)
                if (k < nspec)
                    out[(((size_t)(cell0 + c) * nspec + k) * ntiles + it)
                        * tile + pt] = acc[s][c][k];
        }
    }
}

// K6 on the window layout.  lwn_hi, lwn_lo, spec: [ntiles, lmax]; c1, y2,
// inv_ad: [ncell, ntiles, lmax]; tile t's window is row t.  A warp owns
// 16 points of one tile x 16 cells as wing_lines_kernel's warps do, and
// walks its run of the tile's window (bisected: the row ascends) four
// entries a step through its ring.  `vec`: every row starts 16-byte
// aligned (lmax a multiple of four, aligned arrays), so an item of a step
// is one 16-byte copy; otherwise four 4-byte copies, none past the row.
template <int NS>
__global__ void __launch_bounds__(WL_WARPS * 32) wing_windows_kernel(
        const float* __restrict__ wn_hi, const float* __restrict__ wn_lo,
        const float* __restrict__ lwn_hi, const float* __restrict__ lwn_lo,
        const float* __restrict__ c1, const float* __restrict__ y2,
        const float* __restrict__ inv_ad, const int* __restrict__ spec,
        float* __restrict__ out, int ncell, int ntiles, int tile, int lmax,
        int nspec, float margin, float cutoff, int split, int vec) {
    __shared__ float s_part[WL_WARPS - 1][WL_PT * WL_CT * NS][32];
    __shared__ float4 s_ring[WL_WARPS][WL_RING][WW_ITEMS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int pl = lane % WL_PLANES, cl = lane / WL_PLANES;
    const int per_tile = (tile + WL_WPTS - 1) / WL_WPTS;   // point groups
    const int group = split ? blockIdx.x : blockIdx.x * WL_WARPS + warp;
    if (group >= ntiles * per_tile) return;   // the warp, or the block
    const int t = group / per_tile;
    const int q0 = (group - t * per_tile) * WL_WPTS;    // in the tile
    const int cell0 = blockIdx.y * WL_WCELLS + cl * WL_CT;
    const size_t row = (size_t)t * lmax;

    float wh[WL_PT], wl[WL_PT];
    float pmin = INFINITY, pmax = -INFINITY;
#pragma unroll
    for (int s = 0; s < WL_PT; ++s) {
        const int pt = min(q0 + s * WL_PLANES + pl, tile - 1);
        wh[s] = wn_hi[(size_t)t * tile + pt];
        wl[s] = wn_lo[(size_t)t * tile + pt];
        pmin = fminf(pmin, wh[s]);
        pmax = fmaxf(pmax, wh[s]);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        pmin = fminf(pmin, __shfl_xor_sync(FULL, pmin, d));
        pmax = fmaxf(pmax, __shfl_xor_sync(FULL, pmax, d));
    }
    // The run of the window that the warp's points can reach:
    const float reach = cutoff + hi_slack(pmin, pmax);
    int ja = first_at_least(lwn_hi + row, 0, lmax, pmin - reach, false)
        & ~(LINE_ALIGN - 1);
    int jb = first_at_least(lwn_hi + row, ja, lmax, pmax + reach, true);
    if (split) {
        const int share = ((jb - ja + WL_WARPS - 1) / WL_WARPS
                           + LINE_ALIGN - 1) & ~(LINE_ALIGN - 1);
        ja = min(ja + warp * share, jb);
        jb = min(ja + share, jb);
    }

    float acc[WL_PT][WL_CT][NS];
#pragma unroll
    for (int s = 0; s < WL_PT; ++s)
#pragma unroll
        for (int c = 0; c < WL_CT; ++c)
#pragma unroll
            for (int k = 0; k < NS; ++k) acc[s][c][k] = 0.0f;

    // Staging: item i of a step is lwn_hi, lwn_lo (i = 0, 1), c1, y2,
    // inv_ad of the warp's 16 cells, then the species (NS > 1); lane l
    // copies items l and l + 32.
    float4* ring = &s_ring[warp][0][0];
    const float* src[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        if (i < 2) {
            src[h] = (i == 0 ? lwn_hi : lwn_lo) + row;
        } else if (i < WL_ITEMS) {
            const int f = (i - 2) / WL_WCELLS, slot = (i - 2) % WL_WCELLS;
            const int cell =
                min((int)blockIdx.y * WL_WCELLS + slot, ncell - 1);
            src[h] = (f == 0 ? c1 : f == 1 ? y2 : inv_ad)
                + ((size_t)cell * ntiles + t) * lmax;
        } else if (NS > 1 && i == WL_ITEMS) {
            src[h] = reinterpret_cast<const float*>(spec) + row;
        } else {
            src[h] = nullptr;
        }
    }
    const int nsteps = jb > ja ? (jb - ja + LINE_ALIGN - 1) / LINE_ALIGN : 0;
    auto stage = [&](int step) {
        if (step < nsteps) {
            float4* dst = ring + (step % WL_RING) * WW_ITEMS + lane;
            const int j = ja + step * LINE_ALIGN;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (src[h] == nullptr) continue;
                if (vec) {
                    cp_async16(dst + 32 * h, src[h] + j);
                } else {
                    float* d4 = reinterpret_cast<float*>(dst + 32 * h);
                    for (int q = 0; q < LINE_ALIGN && j + q < lmax; ++q)
                        cp_async4(d4 + q, src[h] + j + q);
                }
            }
        }
        cp_async_commit();
    };
    for (int step = 0; step < WL_RING - 1; ++step) stage(step);

    for (int step = 0; step < nsteps; ++step) {
        const int j = ja + step * LINE_ALIGN;
        stage(step + WL_RING - 1);
        cp_async_wait<WL_RING - 1>();
        __syncwarp();
        const float4* st = ring + (step % WL_RING) * WW_ITEMS;
        const float4 vlh = st[0], vll = st[1];
        const float lh[4] = {vlh.x, vlh.y, vlh.z, vlh.w};
        const float ll[4] = {vll.x, vll.y, vll.z, vll.w};
        // The pairs of this step: depend on (point, entry) only; an entry
        // past the run (or the row) is no pair.
        float dn[WL_PT][4];
        unsigned mask = 0;
#pragma unroll
        for (int s = 0; s < WL_PT; ++s)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float d = (wh[s] - lh[q]) + (wl[s] - ll[q]);
                const float ad = fabsf(d);
                const bool m = ad > margin && ad <= cutoff && j + q < jb;
                dn[s][q] = d;
                mask |= (unsigned)m << (s * 4 + q);
            }
        int sp[4] = {0, 0, 0, 0};
        if (NS > 1) {
            const float4 v = st[WL_ITEMS];
            sp[0] = __float_as_int(v.x); sp[1] = __float_as_int(v.y);
            sp[2] = __float_as_int(v.z); sp[3] = __float_as_int(v.w);
        }
#pragma unroll
        for (int c = 0; c < WL_CT; ++c) {
            const float4 v1 = st[2 + cl * WL_CT + c];
            const float4 v2 = st[2 + WL_WCELLS + cl * WL_CT + c];
            const float4 v3 = st[2 + 2 * WL_WCELLS + cl * WL_CT + c];
            const float k1[4] = {v1.x, v1.y, v1.z, v1.w};
            const float k2[4] = {v2.x, v2.y, v2.z, v2.w};
            const float k3[4] = {v3.x, v3.y, v3.z, v3.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int s = 0; s < WL_PT; ++s) {
                    const float xi = dn[s][q] * k3[q];
                    const float x2 = xi * xi;
                    const float u = rcp_approx(x2 + k2[q]);
                    const float sr = wing_series_horner(u, x2 * u);
                    const float v = k1[q] * u;
                    const bool m = (mask >> (s * 4 + q)) & 1u;
                    if (NS == 1) {
                        if (m) acc[s][c][0] = fmaf(v, sr, acc[s][c][0]);
                    } else {
                        const float tv = m ? v * sr : 0.0f;
#pragma unroll
                        for (int k = 0; k < NS; ++k)
                            acc[s][c][k] += sp[q] == k ? tv : 0.0f;
                    }
                }
        }
        __syncwarp();       // the ring slot is free for step + WL_RING
    }
    if (split) {
        if (warp > 0) {
#pragma unroll
            for (int s = 0; s < WL_PT; ++s)
#pragma unroll
                for (int c = 0; c < WL_CT; ++c)
#pragma unroll
                    for (int k = 0; k < NS; ++k)
                        s_part[warp - 1][(s * WL_CT + c) * NS + k][lane] =
                            acc[s][c][k];
        }
        __syncthreads();
        if (warp > 0) return;
        for (int w = 0; w < WL_WARPS - 1; ++w)
#pragma unroll
            for (int s = 0; s < WL_PT; ++s)
#pragma unroll
                for (int c = 0; c < WL_CT; ++c)
#pragma unroll
                    for (int k = 0; k < NS; ++k)
                        acc[s][c][k] +=
                            s_part[w][(s * WL_CT + c) * NS + k][lane];
    }
#pragma unroll
    for (int s = 0; s < WL_PT; ++s) {
        const int pt = q0 + s * WL_PLANES + pl;
        if (pt >= tile) continue;
#pragma unroll
        for (int c = 0; c < WL_CT; ++c) {
            if (cell0 + c >= ncell) continue;
#pragma unroll
            for (int k = 0; k < NS; ++k)
                if (k < nspec)
                    out[(((size_t)(cell0 + c) * nspec + k) * ntiles + t)
                        * tile + pt] = acc[s][c][k];
        }
    }
}

// K5 on per-line operands.  scale, y, inv_ad: [ncell, nlines].
template <int NS>
__global__ void __launch_bounds__(CORE_THREADS) core_lines_kernel(
        const float* __restrict__ wn_hi, const float* __restrict__ wn_lo,
        const int* __restrict__ starts, const float* __restrict__ lwn_hi,
        const float* __restrict__ lwn_lo, const float* __restrict__ scale,
        const float* __restrict__ y, const float* __restrict__ inv_ad,
        const int* __restrict__ spec, float* __restrict__ out, int ncell,
        int ntiles, int tile, int lmax, int nlines, int nspec, float margin,
        Weideman wd) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= ntiles * tile) return;
    const int cell0 = blockIdx.y * CL_CT;
    const int it = p / tile;
    const float wh = wn_hi[p], wl = wn_lo[p];
    const int w0 = min(max(starts[it], 0), nlines);
    const int w1 = min(w0 + lmax, nlines);
    // The point's own run of in-margin lines inside its tile's window
    // (found once for all cells; the exact test follows per pair):
    const float reach = margin + hi_slack(wh, wh);
    const float thi = wh + reach;
    const int j0 = first_at_least(lwn_hi, w0, w1, wh - reach, false);

    size_t row[CL_CT];
#pragma unroll
    for (int c = 0; c < CL_CT; ++c)
        row[c] = (size_t)min(cell0 + c, ncell - 1) * nlines;
    float acc[CL_CT][NS];
#pragma unroll
    for (int c = 0; c < CL_CT; ++c)
#pragma unroll
        for (int k = 0; k < NS; ++k) acc[c][k] = 0.0f;

    for (int j = j0; j < w1; ++j) {
        const float lh = __ldg(lwn_hi + j);
        if (lh > thi) break;
        const float dwn = (wh - lh) + (wl - __ldg(lwn_lo + j));
        if (fabsf(dwn) <= margin) {
            const int sp = NS > 1 ? __ldg(spec + j) : 0;
#pragma unroll
            for (int c = 0; c < CL_CT; ++c) {
                const float v = wofz_real(
                    dwn * __ldg(inv_ad + row[c] + j), __ldg(y + row[c] + j),
                    wd) * __ldg(scale + row[c] + j);
                if (NS == 1) {
                    acc[c][0] += v;
                } else {
#pragma unroll
                    for (int k = 0; k < NS; ++k)
                        acc[c][k] += sp == k ? v : 0.0f;
                }
            }
        }
    }
    const int pt = p - it * tile;
#pragma unroll
    for (int c = 0; c < CL_CT; ++c) {
        if (cell0 + c >= ncell) continue;
#pragma unroll
        for (int k = 0; k < NS; ++k)
            if (k < nspec)
                out[(((size_t)(cell0 + c) * nspec + k) * ntiles + it) * tile
                    + pt] = acc[c][k];
    }
}

// The launch of a wing kernel whose warps own WL_WPTS points x WL_WCELLS
// cells: split each warp's run over a block's warps when the launch has
// too few warps for the card (split < 0), or as told.
cudaError_t wing_grid(long long groups, int cell_groups, int split_arg,
                      dim3* grid, int* split) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err != cudaSuccess) return err;
    *split = split_arg >= 0 ? split_arg
        : groups * cell_groups < (long long)sms * WL_SPLIT_WARPS_PER_SM;
    *grid = dim3(
        (unsigned)(*split ? groups : (groups + WL_WARPS - 1) / WL_WARPS),
        cell_groups);
    return cudaSuccess;
}

template <int NS>
cudaError_t launch_wing_lines(
        cudaStream_t stream, const float* wn_hi, const float* wn_lo,
        const int* starts, const float* lwn_hi, const float* lwn_lo,
        const float* c1, const float* y2, const float* inv_ad,
        const int* spec, float* out, int ncell, int ntiles, int tile,
        int lmax, int nlines, int nspec, float margin, float cutoff) {
    const long long groups =
        ((long long)ntiles * tile + WL_WPTS - 1) / WL_WPTS;
    dim3 grid;
    int split;
    cudaError_t err = wing_grid(groups, (ncell + WL_WCELLS - 1) / WL_WCELLS,
                                -1, &grid, &split);
    if (err != cudaSuccess) return err;
    wing_lines_kernel<NS><<<grid, WL_WARPS * 32, 0, stream>>>(
        wn_hi, wn_lo, starts, lwn_hi, lwn_lo, c1, y2, inv_ad, spec, out,
        ncell, ntiles, tile, lmax, nlines, nspec, margin, cutoff, split);
    return cudaGetLastError();
}

template <int NS>
cudaError_t launch_wing_windows(
        cudaStream_t stream, const float* wn_hi, const float* wn_lo,
        const float* lwn_hi, const float* lwn_lo, const float* c1,
        const float* y2, const float* inv_ad, const int* spec, float* out,
        int ncell, int ntiles, int tile, int lmax, int nspec, float margin,
        float cutoff, int split_arg) {
    const long long groups =
        (long long)ntiles * ((tile + WL_WPTS - 1) / WL_WPTS);
    dim3 grid;
    int split;
    cudaError_t err = wing_grid(groups, (ncell + WL_WCELLS - 1) / WL_WCELLS,
                                split_arg, &grid, &split);
    if (err != cudaSuccess) return err;
    const void* rows[] = {lwn_hi, lwn_lo, c1, y2, inv_ad, spec};
    int vec = lmax % LINE_ALIGN == 0;
    for (const void* p : rows)
        if ((size_t)p % (4 * LINE_ALIGN)) vec = 0;
    wing_windows_kernel<NS><<<grid, WL_WARPS * 32, 0, stream>>>(
        wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad, spec, out, ncell,
        ntiles, tile, lmax, nspec, margin, cutoff, split, vec);
    return cudaGetLastError();
}

template <int NS>
cudaError_t launch_core_lines(
        cudaStream_t stream, const float* wn_hi, const float* wn_lo,
        const int* starts, const float* lwn_hi, const float* lwn_lo,
        const float* scale, const float* y, const float* inv_ad,
        const int* spec, float* out, int ncell, int ntiles, int tile,
        int lmax, int nlines, int nspec, float margin, const Weideman& wd) {
    const long long npts = (long long)ntiles * tile;
    const dim3 grid((unsigned)((npts + CORE_THREADS - 1) / CORE_THREADS),
                    (ncell + CL_CT - 1) / CL_CT);
    core_lines_kernel<NS><<<grid, CORE_THREADS, 0, stream>>>(
        wn_hi, wn_lo, starts, lwn_hi, lwn_lo, scale, y, inv_ad, spec, out,
        ncell, ntiles, tile, lmax, nlines, nspec, margin, wd);
    return cudaGetLastError();
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

// K4 on the window layout (group = 128 / tile_pts sub-tiles per block:
// wing_kernel) and K6 (group = 1: wing_windows_kernel, split = -1 for the
// launch's own choice, 0 or 1 to force it).  out: [ncell, nspec, ntiles,
// tile]; spec may be null when nspec == 1.
extern "C" int pbt_lbl_wing(
        const float* wn_hi, const float* wn_lo, const float* lwn_hi,
        const float* lwn_lo, const float* c1, const float* y2,
        const float* inv_ad, const int* spec, float* out, int ncell,
        int ntiles, int tile, int lmax, int group, int nspec, float margin,
        float cutoff, int split, void* stream) {
    if (ncell < 1 || ntiles < 1 || tile < 1 || lmax < 1
        || group < 1 || group > STAGE || group * tile > 1024 || nspec < 1
        || nspec > MAX_SPEC || (nspec > 1 && spec == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (group == 1) {
        if ((ncell + WL_WCELLS - 1) / WL_WCELLS > 65535 || split > 1)
            return (int)cudaErrorInvalidValue;
#define PBT_WING_WINDOWS(NS)                                                \
        return (int)launch_wing_windows<NS>(                                \
            s, wn_hi, wn_lo, lwn_hi, lwn_lo, c1, y2, inv_ad, spec, out,     \
            ncell, ntiles, tile, lmax, nspec, margin, cutoff, split)
        if (nspec == 1) PBT_WING_WINDOWS(1);
        if (nspec <= 2) PBT_WING_WINDOWS(2);
        if (nspec <= 4) PBT_WING_WINDOWS(4);
        PBT_WING_WINDOWS(8);
#undef PBT_WING_WINDOWS
    }
    if (ncell > 65535) return (int)cudaErrorInvalidValue;
    const int threads = (group * tile + 31) / 32 * 32;
    const dim3 grid((ntiles + group - 1) / group, ncell);
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

extern "C" int pbt_lbl_line_align() { return LINE_ALIGN; }

namespace {

bool line_operands_ok(const void* lwn_hi, const void* lwn_lo, const void* f1,
                      const void* f2, const void* f3, const void* spec,
                      int ncell, int ntiles, int tile, int lmax, int nlines,
                      int nspec, int cells_per_block) {
    const void* aligned[] = {lwn_hi, lwn_lo, f1, f2, f3, spec};
    for (const void* p : aligned)
        if ((size_t)p % (4 * LINE_ALIGN)) return false;
    return ncell >= 1 && ntiles >= 1 && tile >= 1 && lmax >= 1
        && nlines >= LINE_ALIGN && nlines % LINE_ALIGN == 0
        && (long long)ntiles * tile < (1ll << 31)
        && (ncell + cells_per_block - 1) / cells_per_block <= 65535
        && nspec >= 1 && nspec <= MAX_SPEC && (nspec == 1 || spec != nullptr);
}

}  // namespace

// K4 on per-line factors.  wn_hi, wn_lo: [ntiles, tile]; starts:
// [ntiles]; lwn_hi, lwn_lo, spec: [nlines]; c1, y2, inv_ad: [ncell,
// nlines], nlines a multiple of LINE_ALIGN and every line array aligned
// to 16 bytes; out: [ncell, nspec, ntiles, tile].
extern "C" int pbt_lbl_wing_lines(
        const float* wn_hi, const float* wn_lo, const int* starts,
        const float* lwn_hi, const float* lwn_lo, const float* c1,
        const float* y2, const float* inv_ad, const int* spec, float* out,
        int ncell, int ntiles, int tile, int lmax, int nlines, int nspec,
        float margin, float cutoff, void* stream) {
    if (!line_operands_ok(lwn_hi, lwn_lo, c1, y2, inv_ad, spec, ncell,
                          ntiles, tile, lmax, nlines, nspec, WL_WCELLS))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define PBT_WING_LINES(NS)                                                  \
    return (int)launch_wing_lines<NS>(                                      \
        s, wn_hi, wn_lo, starts, lwn_hi, lwn_lo, c1, y2, inv_ad, spec, out, \
        ncell, ntiles, tile, lmax, nlines, nspec, margin, cutoff)
    if (nspec == 1) PBT_WING_LINES(1);
    if (nspec <= 2) PBT_WING_LINES(2);
    if (nspec <= 4) PBT_WING_LINES(4);
    PBT_WING_LINES(8);
#undef PBT_WING_LINES
}

// K5 on per-line factors (operands as pbt_lbl_wing_lines, with scale,
// y, inv_ad [ncell, nlines]); coeffs as pbt_lbl_core.
extern "C" int pbt_lbl_core_lines(
        const float* wn_hi, const float* wn_lo, const int* starts,
        const float* lwn_hi, const float* lwn_lo, const float* scale,
        const float* y, const float* inv_ad, const int* spec, float* out,
        int ncell, int ntiles, int tile, int lmax, int nlines, int nspec,
        float margin, float length, const float* coeffs, int nterms,
        void* stream) {
    if (nterms != NW
        || !line_operands_ok(lwn_hi, lwn_lo, scale, y, inv_ad, spec, ncell,
                             ntiles, tile, lmax, nlines, nspec, CL_CT))
        return (int)cudaErrorInvalidValue;
    Weideman wd;
    wd.length = length;
    for (int k = 0; k < NW; ++k) wd.a[k] = coeffs[k];
    cudaStream_t s = (cudaStream_t)stream;
#define PBT_CORE_LINES(NS)                                                  \
    return (int)launch_core_lines<NS>(                                      \
        s, wn_hi, wn_lo, starts, lwn_hi, lwn_lo, scale, y, inv_ad, spec,    \
        out, ncell, ntiles, tile, lmax, nlines, nspec, margin, wd)
    if (nspec == 1) PBT_CORE_LINES(1);
    if (nspec <= 2) PBT_CORE_LINES(2);
    if (nspec <= 4) PBT_CORE_LINES(4);
    PBT_CORE_LINES(8);
#undef PBT_CORE_LINES
}
