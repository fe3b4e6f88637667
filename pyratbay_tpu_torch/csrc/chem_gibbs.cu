// The thermochemical-equilibrium solve for Hopper (sm_90a), float64: every
// [chain, layer] system of a batch in one launch.
//
// Replaces no Pallas kernel: the JAX package solves the network with jitted
// array code (pyratbay_tpu/atmosphere/chem.py equilibrium_vmr).  The plain
// torch version of that solve (atmosphere/chem.py equilibrium_vmr on a CPU
// tensor) runs each Newton step as ~60 launches, so a batched forward of a
// retrieval issued ~9,500 launches for it and the card idled between them.
// This kernel does the whole solve in one.
//
// Per system (a layer of a chain): ns species, nc element columns (the
// network's elements, then a charge column when ions are present), element
// moles b [nc], mu0 = G/RT + ln(p / 1 bar) [ns]; from ln n_i = ln(0.1 btot /
// ns) and ln n = ln(0.6 btot), btot = sum |b| + 1e-30, n_iter damped Newton
// steps of the element-potential (Gibbs) dual, then 32 more whose ln n_i are
// averaged; each step the plain version's:
//   n_i = exp(ln n_i), mu_i = mu0_i + ln n_i - ln n,
//   [ A     bhat      ] [ pi     ]   [ b - bhat + S^T (n mu)      ]
//   [ bhat^T nsum - n ] [ dln n  ] = [ n - nsum + sum_i n_i mu_i  ],
//   A = S^T diag(n) S, bhat = S^T n, plus 1e-12 (trace / (nc + 1) + btot)
//   on the diagonal, scaled by 1 / sqrt(|diagonal| + 1e-30) on both sides;
//   dln n_i = dln n + (S pi)_i - mu_i; lam = min(1, 2 / max(step, 1e-12)),
//   step the largest |dln n_i| or |dln n|; ln n += lam dln n and
//   ln n_i = clip(ln n_i + lam dln n_i, ln n - 70, ln n + 2).
// The VMRs are exp(mean of the averaged ln n_i), normalised to sum 1.
// The linear system is solved by symmetric elimination without pivoting:
// the scaled leading block S^T diag(n) S is positive definite with a unit
// diagonal, so its pivots need no search, and the total-moles row is
// eliminated last, where its pivot is the (negative) Schur complement.  The
// plain version solves the same scaled system by LU with partial pivoting
// (torch.linalg.solve_ex): the two agree to round-off.
//
// Two ways in.  From temperatures (the retrieval's forward,
// equilibrium_fn): G/RT is the lerp of the network's table [ntemp, ns] on
// its uniform grid at the clamped temperature, and b comes from the chain's
// budget (dex = solar + is_metal [M/H] + escale, b = 10^(dex - 12), the
// ratios b[num] = value b[den] in order, the charge column 0).  Or from g0
// [S, ns], ln p [S] and b [S, nc] given per system (equilibrium_vmr).
//
// What bounds it.  At 512 chains x 51 layers of the nine-species network
// (6 elements: 7 x 7 systems) the solve is 26,112 systems x 152 steps x
// ~1,200 float64 operations (portbench/counts_chem.py): 4.8 GFLOP, 0.14 ms
// at the H100's 34 TFLOP/s of float64 outside the tensor cores; its bytes
// (the temperatures in, the VMRs out, the table once) are ~2 MB.  So
// operations bound it, and with one system a thread (~200 threads an SM)
// the latency of the dependent float64 chain in each step does: 1.5 ms a
// launch on an H100 at 700 W, 255 registers and ~1 KB of spill a thread
// at the (10, 7) instantiation.
//
// Design.  A thread owns one system and keeps it in registers for all the
// steps: its ln n_i, the averaged sum, mu0 and b, and the step's upper
// triangle of the bordered matrix.  The sizes are compile-time maxima (NS
// species, NC element columns; three instantiations, the smallest that
// fits is launched) and every loop is unrolled over them, so each array
// index is static; species past ns are skipped by a uniform test, and
// element rows past nc are identity rows of the system (zero right-hand
// side) placed before the total-moles row, which stays last.  The
// stoichiometry [NS, NC] sits in shared memory, read by every thread at the
// same address (a broadcast).  No host sync, no atomics: each system's
// arithmetic does not depend on the others or on the schedule.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// The largest network the kernel takes (the wrapper raises above it):
// species, and element columns (elements plus the charge column).
constexpr int CHEM_MAX_SPECIES = 24;
constexpr int CHEM_MAX_COLS = 15;
constexpr int CHEM_MAX_RATIOS = 4;
constexpr int N_AVG = 32;
constexpr int THREADS = 64;

struct Params {
    int mode;                 // 0: g0, lnp, b per system; 1: from temp
    int nsys, nlayers, ns, nc, ne, n_iter;
    const double* stoich;     // [ns, nc]
    const double* g0;         // mode 0: [nsys, ns]
    const double* b;          // mode 0: [nsys, nc]
    const double* lnp;        // mode 0: [nsys]; mode 1: [nlayers]
    const void* temp;         // mode 1: [nsys] (chain-major), float or double
    int temp_f32;
    const double* g_table;    // mode 1: [ntemp, ns]
    int ntemp;
    double t0, dt;
    const double* solar_dex;  // mode 1: [ne]
    const double* is_metal;   // mode 1: [ne]
    const double* metallicity;  // mode 1: [nchains] or null
    const double* escale;       // mode 1: [nchains, ne] or null
    int n_ratios;
    int ratio_num[CHEM_MAX_RATIOS], ratio_den[CHEM_MAX_RATIOS];
    const double* ratio_val[CHEM_MAX_RATIOS];   // [nchains] each
    double* vmr;              // [nsys, ns]
};

// Index of (r, c), c >= r, in the packed upper triangle of an m x m matrix.
__host__ __device__ constexpr int tri(int m, int r, int c) {
    return r * m - r * (r - 1) / 2 + (c - r);
}

// The system's mu0 [NS] and b [NC] (b past nc zero) and btot.
template <int NS, int NC>
__device__ __forceinline__ void system_inputs(
        const Params& p, int s, double (&mu0)[NS], double (&b)[NC],
        double& btot) {
    const int ns = p.ns, nc = p.nc;
    if (p.mode == 0) {
        const double lnp = p.lnp[s];
#pragma unroll
        for (int i = 0; i < NS; ++i)
            if (i < ns) mu0[i] = p.g0[(long long)s * ns + i] + lnp;
#pragma unroll
        for (int r = 0; r < NC; ++r)
            b[r] = r < nc ? p.b[(long long)s * nc + r] : 0.0;
    } else {
        const int chain = s / p.nlayers;
        const int layer = s - chain * p.nlayers;
        const double temp = p.temp_f32
            ? (double)static_cast<const float*>(p.temp)[s]
            : static_cast<const double*>(p.temp)[s];
        // torch.clamp(temp, t0, thi), NaN passed on; then the lerp of the
        // table at x = (tc - t0) / dt, i0 = clamp(int(x), 0, ntemp - 2).
        const double thi = p.t0 + p.dt * (p.ntemp - 1);
        const double tc = temp < p.t0 ? p.t0 : (temp > thi ? thi : temp);
        const double x = (tc - p.t0) / p.dt;
        long long i0 = (long long)x;
        i0 = i0 < 0 ? 0 : (i0 > p.ntemp - 2 ? p.ntemp - 2 : i0);
        const double w = x - (double)i0;
        const double* g_lo = p.g_table + i0 * ns;
        const double lnp = p.lnp[layer];
#pragma unroll
        for (int i = 0; i < NS; ++i)
            if (i < ns)
                mu0[i] = g_lo[i] * (1.0 - w) + g_lo[ns + i] * w + lnp;
        const int ne = p.ne;
#pragma unroll
        for (int r = 0; r < NC; ++r) {
            b[r] = 0.0;
            if (r < ne) {
                double dex = p.solar_dex[r];
                if (p.metallicity)
                    dex = dex + p.is_metal[r] * p.metallicity[chain];
                if (p.escale)
                    dex = dex + p.escale[(long long)chain * ne + r];
                b[r] = pow(10.0, dex - 12.0);
            }
        }
        // The ratios, in order: b[num] = value * b[den] (static indices
        // by a select over the columns).
        for (int q = 0; q < p.n_ratios; ++q) {
            const int num = p.ratio_num[q], den = p.ratio_den[q];
            double bden = 0.0;
#pragma unroll
            for (int r = 0; r < NC; ++r)
                if (r == den) bden = b[r];
            const double value = p.ratio_val[q][chain] * bden;
#pragma unroll
            for (int r = 0; r < NC; ++r)
                if (r == num) b[r] = value;
        }
    }
    btot = 0.0;
#pragma unroll
    for (int r = 0; r < NC; ++r) btot += fabs(b[r]);
    btot += 1e-30;
}

// One damped Newton step of the system (the plain version's
// _newton_step); sto the stoichiometry [NS, NC] in shared memory.
template <int NS, int NC>
__device__ __forceinline__ void newton_step(
        const double* sto, int ns, int nc, const double (&mu0)[NS],
        const double (&b)[NC], double btot, double (&ln_n)[NS],
        double& ln_ntot) {
    constexpr int M = NC + 1;          // element rows, then total moles
    double n[NS], mu[NS];
    double nsum = 0.0, nmu_sum = 0.0;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        if (i < ns) {
            n[i] = exp(ln_n[i]);
            nsum += n[i];
            mu[i] = mu0[i] + ln_n[i] - ln_ntot;
            nmu_sum += n[i] * mu[i];
        }
    }
    const double ntot = exp(ln_ntot);

    // The upper triangle of the bordered matrix and the right-hand side.
    double a[M * (M + 1) / 2];
    double y[M];
#pragma unroll
    for (int k = 0; k < M * (M + 1) / 2; ++k) a[k] = 0.0;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
        double bhat = 0.0, smu = 0.0;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            if (i < ns) {
                const double sn = sto[i * NC + r] * n[i];
                bhat += sn;
                smu += sn * mu[i];
#pragma unroll
                for (int c = r; c < NC; ++c)
                    a[tri(M, r, c)] += sn * sto[i * NC + c];
            }
        }
        a[tri(M, r, NC)] = bhat;
        y[r] = b[r] - bhat + smu;
    }
    a[tri(M, NC, NC)] = nsum - ntot;
    y[NC] = ntot - nsum + nmu_sum;

    double trace = a[tri(M, NC, NC)];
#pragma unroll
    for (int r = 0; r < NC; ++r) trace += a[tri(M, r, r)];
    const double reg = 1e-12 * (trace / (nc + 1) + btot);
    double scale[M];
#pragma unroll
    for (int r = 0; r < M; ++r) {
        if (r < nc || r == NC) {
            a[tri(M, r, r)] += reg;
            scale[r] = 1.0 / sqrt(fabs(a[tri(M, r, r)]) + 1e-30);
        } else {
            a[tri(M, r, r)] = 1.0;     // an identity row past nc
            scale[r] = 1.0;
        }
    }
#pragma unroll
    for (int r = 0; r < M; ++r) {
        y[r] *= scale[r];
#pragma unroll
        for (int c = r; c < M; ++c) a[tri(M, r, c)] *= scale[r] * scale[c];
    }

    // Symmetric elimination (upper triangle), then back substitution.
#pragma unroll
    for (int k = 0; k < M; ++k) {
        const double inv = 1.0 / a[tri(M, k, k)];
#pragma unroll
        for (int r = k + 1; r < M; ++r) {
            const double f = a[tri(M, k, r)] * inv;
#pragma unroll
            for (int c = r; c < M; ++c)
                a[tri(M, r, c)] -= f * a[tri(M, k, c)];
            y[r] -= f * y[k];
        }
    }
#pragma unroll
    for (int k = M - 1; k >= 0; --k) {
        double acc = y[k];
#pragma unroll
        for (int c = k + 1; c < M; ++c) acc -= a[tri(M, k, c)] * y[c];
        y[k] = acc / a[tri(M, k, k)];
    }
#pragma unroll
    for (int r = 0; r < M; ++r) y[r] *= scale[r];

    // The step, its limit and the clip.
    const double dln_ntot = y[NC];
    double step = fabs(dln_ntot);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        if (i < ns) {
            double d = dln_ntot - mu[i];
#pragma unroll
            for (int r = 0; r < NC; ++r) d += y[r] * sto[i * NC + r];
            mu[i] = d;                 // mu now holds dln n_i
            step = fmax(step, fabs(d));
        }
    }
    const double lam = fmin(2.0 / fmax(step, 1e-12), 1.0);
    ln_ntot = ln_ntot + lam * dln_ntot;
    const double lo = ln_ntot - 70.0, hi = ln_ntot + 2.0;
#pragma unroll
    for (int i = 0; i < NS; ++i)
        if (i < ns)
            ln_n[i] = fmin(fmax(ln_n[i] + lam * mu[i], lo), hi);
}

template <int NS, int NC>
__global__ void __launch_bounds__(THREADS) chem_gibbs_kernel(Params p) {
    __shared__ double sto[NS * NC];
    for (int k = threadIdx.x; k < NS * NC; k += blockDim.x) {
        const int i = k / NC, r = k - (k / NC) * NC;
        sto[k] = (i < p.ns && r < p.nc) ? p.stoich[i * p.nc + r] : 0.0;
    }
    __syncthreads();
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= p.nsys) return;
    const int ns = p.ns, nc = p.nc;
    double mu0[NS], b[NC], btot;
    system_inputs<NS, NC>(p, s, mu0, b, btot);

    double ln_n[NS];
    const double ln_n0 = log(0.1 * btot / ns);
#pragma unroll
    for (int i = 0; i < NS; ++i) ln_n[i] = ln_n0;
    double ln_ntot = log(0.6 * btot);
    for (int it = 0; it < p.n_iter; ++it)
        newton_step<NS, NC>(sto, ns, nc, mu0, b, btot, ln_n, ln_ntot);
    // The averaged tail:
    double acc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) acc[i] = 0.0;
    for (int it = 0; it < N_AVG; ++it) {
        newton_step<NS, NC>(sto, ns, nc, mu0, b, btot, ln_n, ln_ntot);
#pragma unroll
        for (int i = 0; i < NS; ++i) acc[i] = acc[i] + ln_n[i];
    }
    double total = 0.0;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        if (i < ns) {
            acc[i] = exp(acc[i] / N_AVG);
            total += acc[i];
        }
    }
    double* out = p.vmr + (long long)s * ns;
#pragma unroll
    for (int i = 0; i < NS; ++i)
        if (i < ns) out[i] = acc[i] / total;
}

template <int NS, int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const int blocks = (p.nsys + THREADS - 1) / THREADS;
    chem_gibbs_kernel<NS, NC><<<blocks, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// The instantiation that takes ns species and nc element columns (0, 1 or
// 2, smallest first), or -1 above CHEM_MAX_SPECIES / CHEM_MAX_COLS.
extern "C" int pbt_chem_gibbs_fit(int ns, int nc) {
    if (ns < 1 || nc < 1) return -1;
    if (ns <= 10 && nc <= 7) return 0;
    if (ns <= 16 && nc <= 11) return 1;
    if (ns <= CHEM_MAX_SPECIES && nc <= CHEM_MAX_COLS) return 2;
    return -1;
}

// The solve of nsys systems into vmr [nsys, ns] (float64), on `stream`.
// mode 0: g0 [nsys, ns], lnp [nsys], b [nsys, nc]; mode 1: temp [nsys]
// (chain-major [nchains, nlayers], float32 when temp_f32 else float64),
// lnp [nlayers], g_table [ntemp, ns] on the grid t0 + dt k, solar_dex and
// is_metal [ne], metallicity [nchains] and escale [nchains, ne] (either
// null), n_ratios ratios (host arrays of their element columns and device
// pointers of their values [nchains]).  All device arrays contiguous.
extern "C" int pbt_chem_gibbs(
        int mode, int nsys, int nlayers, int ns, int nc, int ne,
        const double* stoich, const double* g0, const double* b,
        const double* lnp, const void* temp, int temp_f32,
        const double* g_table, int ntemp, double t0, double dt,
        const double* solar_dex, const double* is_metal,
        const double* metallicity, const double* escale, int n_ratios,
        const int* ratio_num, const int* ratio_den,
        const double* const* ratio_val, int n_iter, double* vmr,
        void* stream) {
    const int fit = pbt_chem_gibbs_fit(ns, nc);
    if (fit < 0 || nsys < 0 || n_iter < 0 || (mode != 0 && mode != 1)
            || n_ratios < 0 || n_ratios > CHEM_MAX_RATIOS
            || (mode == 1 && (nlayers < 1 || ntemp < 2 || ne > nc)))
        return (int)cudaErrorInvalidValue;
    if (nsys == 0) return 0;
    Params p;
    p.mode = mode;
    p.nsys = nsys;
    p.nlayers = nlayers;
    p.ns = ns;
    p.nc = nc;
    p.ne = ne;
    p.n_iter = n_iter;
    p.stoich = stoich;
    p.g0 = g0;
    p.b = b;
    p.lnp = lnp;
    p.temp = temp;
    p.temp_f32 = temp_f32;
    p.g_table = g_table;
    p.ntemp = ntemp;
    p.t0 = t0;
    p.dt = dt;
    p.solar_dex = solar_dex;
    p.is_metal = is_metal;
    p.metallicity = metallicity;
    p.escale = escale;
    p.n_ratios = n_ratios;
    for (int q = 0; q < CHEM_MAX_RATIOS; ++q) {
        const bool on = q < n_ratios;
        p.ratio_num[q] = on ? ratio_num[q] : 0;
        p.ratio_den[q] = on ? ratio_den[q] : 0;
        p.ratio_val[q] = on ? ratio_val[q] : nullptr;
        if (on && (ratio_num[q] < 0 || ratio_num[q] >= ne
                   || ratio_den[q] < 0 || ratio_den[q] >= ne))
            return (int)cudaErrorInvalidValue;
    }
    p.vmr = vmr;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (fit == 0)
        err = launch<10, 7>(p, st);
    else if (fit == 1)
        err = launch<16, 11>(p, st);
    else
        err = launch<CHEM_MAX_SPECIES, CHEM_MAX_COLS>(p, st);
    return (int)err;
}
