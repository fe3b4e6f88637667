// The Guillot (2010) / Line et al. (2013) temperature profile for Hopper
// (sm_90a): every [chain, layer] temperature of a batch in one launch.
//
// Replaces no Pallas kernel: the JAX package evaluates the profile with
// jitted array code (pyratbay_tpu/atmosphere/profiles.py guillot_tp).  The
// plain torch version (atmosphere/profiles.py on a CPU tensor) runs the
// fixed-length E_1 series and continued fraction of its two channels as
// ~370 elementwise launches, which on the card are ~40% of a batched
// forward's host launches and no measurable device time: the host, not the
// card, then set the pace of a forward.  This kernel does the profile in
// one launch.
//
// Per chain, params = [log10 kappa', log10 gamma1, log10 gamma2, alpha,
// T_irr, T_int]; per layer the scaled pressure pb (barye over gravity):
//   tau = kappa' pb,  xi(g) = 2/3 ((1/g)(1 + (g tau/2 - 1) exp(-g tau))
//                             + g (1 - tau^2/2) E_2(g tau) + 1),
//   T^4 = 3/4 (T_int^4 (2/3 + tau) + T_irr^4 ((1 - alpha) xi(gamma1)
//                                             + alpha xi(gamma2))),
// E_2(x) = exp(-x) - x E_1(x) (1 at x <= 0, and for NaN), E_1 by the plain
// version's 25-term power series at x <= 1 and its 30-deep continued
// fraction above (ops/special.py exp1).
//
// Arithmetic: float64 whatever the tensors' dtype (float32 or float64), the
// result rounded once to it; the plain float64 version agrees to rounding,
// the plain float32 one to its own rounding.  What bounds it: nothing on
// the card (26,112 elements x ~400 float64 operations at 512 x 51 is ~10
// MFLOP, 0.3 us at the FP64 rate); the launch is its cost.  A thread an
// element, no shared memory, no host sync.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr double EULER_GAMMA = 0.5772156649015329;

// E_1(x) for x > 0.
__device__ __forceinline__ double exp1(double x) {
    if (x <= 1.0) {
        double term = 1.0, series = 0.0;
#pragma unroll
        for (int k = 1; k < 26; ++k) {
            term = term * (-x) / k;
            series = series - term / k;
        }
        return -EULER_GAMMA - log(x) + series;
    }
    double cf = 0.0;
#pragma unroll
    for (int k = 30; k > 0; --k)
        cf = k / (1.0 + k / (x + cf));
    return exp(-x) / (x + cf);
}

__device__ __forceinline__ double e2(double x) {
    if (!(x > 0.0)) return 1.0;
    return exp(-x) - x * exp1(x);
}

__device__ __forceinline__ double xi(double gamma, double tau) {
    const double gt = gamma * tau;
    return 2.0 / 3.0 * ((1.0 / gamma) * (1.0 + (0.5 * gt - 1.0) * exp(-gt))
                        + gamma * (1.0 - 0.5 * tau * tau) * e2(gt) + 1.0);
}

template <typename T>
__global__ void guillot_tp_kernel(int nrows, int nlayers, const T* params,
                                  long long row_stride, const T* pb,
                                  T* temp) {
    const long long idx =
        (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)nrows * nlayers) return;
    const long long row = idx / nlayers;
    const int layer = (int)(idx - row * nlayers);
    const T* p = params + row * row_stride;
    const double kappa = pow(10.0, (double)p[0]);
    const double gamma1 = pow(10.0, (double)p[1]);
    const double gamma2 = pow(10.0, (double)p[2]);
    const double alpha = (double)p[3];
    const double t_irr4 = pow((double)p[4], 4.0);
    const double t_int4 = pow((double)p[5], 4.0);
    const double tau = kappa * (double)pb[layer];
    const double t4 = 0.75 * (t_int4 * (2.0 / 3.0 + tau)
                              + t_irr4 * (1.0 - alpha) * xi(gamma1, tau)
                              + t_irr4 * alpha * xi(gamma2, tau));
    temp[idx] = (T)pow(t4, 0.25);
}

template <typename T>
cudaError_t launch(int nrows, int nlayers, const void* params,
                   long long row_stride, const void* pb, void* temp,
                   cudaStream_t stream) {
    const long long n = (long long)nrows * nlayers;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    guillot_tp_kernel<T><<<blocks, THREADS, 0, stream>>>(
        nrows, nlayers, static_cast<const T*>(params), row_stride,
        static_cast<const T*>(pb), static_cast<T*>(temp));
    return cudaGetLastError();
}

}  // namespace

// The profile of nrows chains into temp [nrows, nlayers] on `stream`:
// params row r at params + r * row_stride (its six values contiguous), pb
// [nlayers]; all float64 when f64 else float32.
extern "C" int pbt_guillot_tp(int f64, int nrows, int nlayers,
                              const void* params, long long row_stride,
                              const void* pb, void* temp, void* stream) {
    if (nrows < 0 || nlayers < 1 || row_stride < 0)
        return (int)cudaErrorInvalidValue;
    if (nrows == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(f64 ? launch<double>(nrows, nlayers, params, row_stride,
                                      pb, temp, st)
                     : launch<float>(nrows, nlayers, params, row_stride,
                                     pb, temp, st));
}
