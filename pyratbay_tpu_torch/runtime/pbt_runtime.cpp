// Native host runtime: high-throughput line-list parsing, TLI scanning
// and the parity line-by-line engine's grouping and scatter.
//
// The device compute path is PyTorch/CUDA; this library covers the
// host-side hot paths: multithreaded fixed-record HITRAN .par parsing,
// ranged binary extraction from TLI files, and the sequential loops of
// the parity engine (opacity/lbl.py).  A copy of
// pyratbay_tpu/runtime/pbt_runtime.cpp, exposed through a C ABI
// consumed via ctypes (pyratbay_tpu_torch/runtime/__init__.py).
//
// Build: g++ at first use, into pyratbay_tpu_torch/_build/<hash>/.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

// Parse a fixed-width fortran-style float field (may contain leading
// blanks, embedded exponent, or be all blanks -> 0).
inline double parse_field(const char* p, int width) {
    char buf[32];
    int n = width < 31 ? width : 31;
    std::memcpy(buf, p, n);
    buf[n] = '\0';
    return std::strtod(buf, nullptr);
}

inline int iso_code(char c) {
    // HITRAN isotopologue column: 1-9, 0 -> 10th, A/B -> 11th/12th.
    if (c >= '1' && c <= '9') return c - '1';
    if (c == '0') return 9;
    if (c >= 'A' && c <= 'Z') return 10 + (c - 'A');
    return -1;
}

}  // namespace

extern "C" {

// Parse nrec HITRAN .par records of length recsize from `data`.
// Outputs: wn, a21 (Einstein A), g2 (upper-state weight), elow, iso.
// Column layout per HITRAN 2004+ 160-char format.
// Returns 0 on success.
int parse_hitran_par(
        const char* data, int64_t nrec, int32_t recsize,
        double* wn, double* a21, double* g2, double* elow, int32_t* iso,
        int32_t nthreads) {
    if (nthreads < 1) nthreads = 1;
    int64_t chunk = (nrec + nthreads - 1) / nthreads;
    std::vector<std::thread> workers;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(nrec, lo + chunk);
        if (lo >= hi) break;
        workers.emplace_back([=]() {
            for (int64_t i = lo; i < hi; i++) {
                const char* rec = data + i * recsize;
                iso[i] = iso_code(rec[2]);
                wn[i] = parse_field(rec + 3, 12);
                a21[i] = parse_field(rec + 25, 10);
                elow[i] = parse_field(rec + 45, 10);
                g2[i] = parse_field(rec + 146, 7);
            }
        });
    }
    for (auto& w : workers) w.join();
    return 0;
}

// Binary search over a sorted double array: first index with
// values[i] >= target (lower bound).
int64_t lower_bound_f64(const double* values, int64_t n, double target) {
    return std::lower_bound(values, values + n, target) - values;
}

// Extract the [wn_low, wn_high] slice of a per-isotope-sorted TLI
// transition block.  For each isotope segment (sorted by wavenumber),
// binary-search the range and copy the surviving records.
// seg_counts: [nseg] per-isotope transition counts.
// Returns the number of transitions kept.
int64_t tli_extract_range(
        const double* wn, const int16_t* iso, const double* elow,
        const double* gf,
        const int32_t* seg_counts, int32_t nseg,
        double wn_low, double wn_high,
        double* out_wn, int16_t* out_iso, double* out_elow,
        double* out_gf) {
    int64_t start = 0;
    int64_t kept = 0;
    for (int32_t s = 0; s < nseg; s++) {
        int64_t count = seg_counts[s];
        const double* seg_wn = wn + start;
        int64_t lo = std::lower_bound(seg_wn, seg_wn + count, wn_low)
            - seg_wn;
        int64_t hi = std::upper_bound(seg_wn, seg_wn + count, wn_high)
            - seg_wn;
        int64_t n = hi - lo;
        if (n > 0) {
            std::memcpy(out_wn + kept, wn + start + lo,
                        n * sizeof(double));
            std::memcpy(out_iso + kept, iso + start + lo,
                        n * sizeof(int16_t));
            std::memcpy(out_elow + kept, elow + start + lo,
                        n * sizeof(double));
            std::memcpy(out_gf + kept, gf + start + lo,
                        n * sizeof(double));
            kept += n;
        }
        start += count;
    }
    return kept;
}

// Greedy co-adding segmentation of the (isotope-then-wavenumber
// sorted) active line list: a new group starts when the isotope
// changes or the line falls outside `ownstep` of the current group's
// anchor (the fine-grid wavenumber of the group's first line).
// Mirrors the accumulation loop of the reference LBL kernel
// (src_c/_extcoeff.c:247-262).  Returns the number of groups.
int64_t lbl_group(
        const double* awavn, const int32_t* aiso,
        const double* anchor_cand, int64_t n, double ownstep,
        int32_t* group_id) {
    if (n == 0) return 0;
    int64_t gid = 0;
    double anchor = anchor_cand[0];
    int32_t aniso = aiso[0];
    group_id[0] = 0;
    for (int64_t j = 1; j < n; j++) {
        bool same = (aiso[j] == aniso)
            && (std::fabs(awavn[j] - anchor) < ownstep);
        if (!same) {
            gid++;
            anchor = anchor_cand[j];
            aniso = aiso[j];
        }
        group_id[j] = (int32_t)gid;
    }
    return gid + 1;
}

// Strided profile gather-add: for each strong line group, add
// k_group * profile[pindex - offset + ofactor*j] over the window
// [minj, maxj) of its species' row of ktmp [nspec, dnwn].
// The scatter loop of src_c/_extcoeff.c:270-308 as a gather.
void lbl_scatter(
        int64_t ngroups, const uint8_t* strong, const int32_t* g_spec,
        const int64_t* minj, const int64_t* maxj,
        const int64_t* pindex, const int64_t* offset, int64_t ofactor,
        const double* k_group, const double* profile,
        double* ktmp, int64_t dnwn) {
    for (int64_t g = 0; g < ngroups; g++) {
        if (!strong[g]) continue;
        int64_t j0 = minj[g], j1 = maxj[g];
        if (j1 <= j0) continue;
        double k = k_group[g];
        double* row = ktmp + (int64_t)g_spec[g] * dnwn;
        const double* prof = profile + pindex[g] - offset[g]
            + ofactor * j0;
        for (int64_t j = j0; j < j1; j++) {
            row[j] += k * prof[(j - j0) * ofactor];
        }
    }
}

}  // extern "C"
