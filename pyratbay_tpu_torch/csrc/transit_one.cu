// One chain's transit spectrum in one launch, for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel pyratbay_tpu/spectrum/rt_pallas.py
// _transit_kernel (the pallas_call of transit_spectrum_fused, line 221)
// together with what that function does around it in one jitted call:
// the pair-sum fold of the chord matrix and the per-chain scalars of
// prep_chain, then the kernel's extinction sum, chord product and
// chain_rt_epilogue.  Per wave column w of the chain:
//   ec[j]    = dense parts + rank-1 terms + CIA weights x table
//            + line-sample weights x table            (transit_rt.cu's order)
//   path2[i, j] = path[i, j - 1] + path[i, j]           (zero outside 0..l-2)
//   depth[i] = sum_j path2[i, j] ec[j]
//   ideep    = first row i in [itop, ibottom) with depth > maxdepth,
//              else ibottom - 1
//   integ[i] = exp(-depth[i]) r[i], row deck_itop spliced with the deck
//              surface when deck_itop > itop (h at the row above it too)
//   out[w]   = (r_itop^2 + 2 sum_i integ[i] coef[i]) / rstar^2.
//
// What bounds it.  At the flagship (51 layers, 3209 columns, the line
// sample as 10 table rows of which the two-hot weights keep two a layer)
// the function needs ~2 MB of one chain's operands (the live table rows
// ~1.3 MB of the table's 6.6): under 0.001 ms at 3.35 TB/s; the
// operations (8.5 MFLOP, most of it the chord product) are less.  So
// nothing of the card's rates bounds one chain: latency does, and the
// launches around it.  The ensemble kernel (transit_rt.cu) launched with
// one chain kept 2 of its 16 warps busy on 51 blocks, each lane walking
// its column's layers alone (~39,000 cycles), and its wrapper made ~35
// small launches (gathers, pads, the fold).
//
// Design.  The wrapper hands over the raw operands (no preparation in
// torch: one launch a spectrum).  A block of ONE_WARPS warps owns a tile of
// 32 columns (one a lane) and one chain (blockIdx.y): 101 blocks at the
// flagship width, so the card fills from one chain.  Every copy a block
// needs goes out at once as cp.async (the radius, the weights, the tile's
// CIA table rows and dense parts).  The layers of the assembly are
// split over the warps (warp k takes j = k mod ONE_WARPS), each lane its
// column: a warp finds the live line-sample weights of its layers (a
// ballot over k) and copies their two table rows, and while those are in
// flight the block folds the chord matrix, read from global memory (L2:
// every block reads it), into shared memory by chunks of four rows (chunk
// g holds, for each layer j <= 4 g + 3, path2[4 g .. 4 g + 3][j] as one
// float4) and takes the layer heights and the per-chain scalars; then the
// warp assembles its layers, two at a time, into ec [l][32] in shared
// memory.  A timer probe of the first design (not in the tree) found the
// time spread over its seven phases, each behind a block barrier; this one
// has four barriers and two waits for global memory, the second
// overlapped with the fold.  The chord product splits the chunks over the
// warps by equal shares of the triangle (chunk g has 4 g + 4 terms a row;
// each warp a run of whole chunks), each lane its column with the chunk's
// four rows in registers: one broadcast 16-byte load and one 4-byte load
// for four FMAs, and each depth gets its terms in ascending j from itop to
// its chunk's last row, as the ensemble kernel adds them (the same FMAs in
// the same order).  The epilogue is two block reductions: each warp's
// first row past maxdepth in its run, the block minimum of those (else
// ibottom - 1); then each warp sums integ x coef over an even share of the
// rows (rows warp l / nw to (warp + 1) l / nw), and the partial sums are
// added in warp order, so the result does not depend on the schedule.
//
// Kept from transit_rt.cu: no index is taken from data (itop, ibottom and
// the deck row are clamped, then only compared or used as clamped
// indices); the poison sum (ec x 0 over every layer) keeps NaN and inf
// where the plain version has them; no fast-math, no TF32.
//
// Layer counts.  Staged, a block holds the folded chord chunks, ec, the
// depths and the staged operands in shared memory (one_smem:
// ~39 KB at 51 layers and ~62 KB at 81 with the flagship's operands; 168
// to 272 layers at most, by operand counts).  Above that the same kernel
// runs streamed (STREAM): ec and the depths go to a scratch of the
// wrapper's in device memory ([B, tiles, 2, l, 32]: each block its own,
// read back by the block after a barrier), the weights, table rows and
// dense parts are read where they lie, and the chord product folds each
// chunk's rows of `path` as it walks j (path2[i][j] = path[i][j - 1] +
// path[i][j], the same sum as the staged fold, so both give the same
// FMAs in the same order); shared memory then holds only the radius and
// the heights of each layer, its live line-sample rows if there is a
// line sample, and the warps' partial sums: ~28,000 layers, ~11,000
// with a line sample, beyond what the ensemble kernel's tall function
// takes with the same operands (~18,000 with the fewest, ~1,500 with the
// retrieval's).  The wrapper raises above it.
#include "rt_common.cuh"

namespace {

using namespace pbt;

constexpr int ONE_TW = 32;          // wave columns of a block: one a lane
constexpr int ONE_WARPS = 16;       // warps of a block
constexpr int NSCAL = 5;            // itop, ibottom, deck_itop, deck_rsurf, rstar
constexpr unsigned FULL = 0xffffffffu;

// The per-chain scalars: each a host value or an element a chain in
// device memory (int32 / int64 for the indices, float32 / float64 for the
// deck radius and rstar).
struct OneScalars {
    const void* ptr[NSCAL];
    int bytes[NSCAL];       // 0: `value`; 4 or 8: the element size at ptr
    int stride[NSCAL];      // 0 (one element for every chain) or 1
    double value[NSCAL];
    int has_deck;
};

__device__ __forceinline__ long long scalar_index(const OneScalars& s, int q,
                                                  int b) {
    if (s.bytes[q] == 8)
        return reinterpret_cast<const long long*>(s.ptr[q])[b * s.stride[q]];
    if (s.bytes[q] == 4)
        return reinterpret_cast<const int*>(s.ptr[q])[b * s.stride[q]];
    return (long long)s.value[q];
}

__device__ __forceinline__ float scalar_float(const OneScalars& s, int q,
                                              int b) {
    if (s.bytes[q] == 8)
        return (float)reinterpret_cast<const double*>(s.ptr[q])[b * s.stride[q]];
    if (s.bytes[q] == 4)
        return reinterpret_cast<const float*>(s.ptr[q])[b * s.stride[q]];
    return (float)s.value[q];
}

// An index clamped to [-1, L + 1]: every comparison with a row 0 .. L - 1
// (and with a row + 1) comes out as with the raw value.
__device__ __forceinline__ int clamp_row(long long v, int L) {
    return (int)(v < -1 ? -1 : v > L + 1 ? L + 1 : v);
}

__host__ __device__ inline int one_chunks(int L) { return (L + 3) >> 2; }

// Float4 entries before chunk g of the folded chord matrix (chunk g holds
// 4 g + 4 of them):
__host__ __device__ inline int chunk_at(int g) { return 2 * g * (g + 1); }

// The first chunk of warp k: the triangle's chunks split by equal shares
// of their terms (chunk g has 4 g + 4 a row).
__device__ __forceinline__ int first_chunk(int k, int G) {
    const long long total = (long long)G * (G + 1);
    int g = 0;
    while (g < G && (long long)g * (g + 1) * ONE_WARPS < k * total) ++g;
    return g;
}

__host__ __device__ inline int take(int& at, long long n) {
    const int here = at;
    at += (int)((n + 3) & ~3LL);
    return here;
}

// Offsets (in floats, each 16-byte aligned) of the block's shared memory;
// streamed, ec, the depths and the staged operands are not there.
struct OneLayout {
    int ec, chord, rad, h, ct, ciaw, r1c, lsw, k0, k1, rest, first,
        part, pois, parts, lsv, d, total;
};

__host__ __device__ inline OneLayout one_layout(int L, int n_r1, int n_cia,
                                                int n_ls, int n_parts,
                                                bool stream) {
    const long long staged = stream ? 0 : 1;
    OneLayout o;
    int at = 0;
    o.ec = take(at, staged * L * ONE_TW);
    o.chord = take(at, staged * 4 * chunk_at(one_chunks(L)));
    o.rad = take(at, L);
    o.h = take(at, L);
    o.ct = take(at, staged * n_cia * ONE_TW);
    o.ciaw = take(at, staged * L * n_cia);
    o.r1c = take(at, staged * n_r1 * L);
    o.lsw = take(at, staged * n_ls * L);
    o.k0 = take(at, n_ls ? L : 0);
    o.k1 = take(at, n_ls ? L : 0);
    o.rest = take(at, n_ls ? L : 0);
    o.first = take(at, ONE_WARPS * ONE_TW);
    o.part = take(at, ONE_WARPS * ONE_TW);
    o.pois = take(at, ONE_WARPS * ONE_TW);
    // What the copies fill and the assembly reads, then (dead by then)
    // the depths:
    const int stage = at;
    o.parts = take(at, staged * (n_parts > 1 ? n_parts - 1 : 0) * L * ONE_TW);
    o.lsv = take(at, n_ls ? staged * 2 * L * ONE_TW : 0);
    o.d = stage;
    const long long d_end = (long long)stage + staged * L * ONE_TW;
    o.total = at > d_end ? at : (int)d_end;
    return o;
}

// n floats from global to shared memory as asynchronous copies by the
// whole block, 16 bytes at a time where the source is aligned (dst is).
__device__ __forceinline__ void stage_linear(float* dst,
                                             const float* __restrict__ src,
                                             int n) {
    int head = 0;
    if ((reinterpret_cast<size_t>(src) & 15) == 0) {
        const int n4 = n >> 2;
        for (int i = threadIdx.x; i < n4; i += blockDim.x)
            cp_async16(dst + 4 * i, src + 4 * i);
        head = 4 * n4;
    }
    for (int i = head + threadIdx.x; i < n; i += blockDim.x)
        cp_async4(dst + i, src + i);
}

template <bool STREAM>
__global__ void __launch_bounds__(32 * ONE_WARPS) transit_one_kernel(
        Parts parts, const float* __restrict__ r1_rows,
        const float* __restrict__ r1_cols, int n_r1,
        const float* __restrict__ cia_w, long long cia_chain, int cia_row,
        const float* __restrict__ cia_tab, int n_cia,
        const float* __restrict__ ls_w, const float* __restrict__ ls_tab,
        int n_ls, const float* __restrict__ path,
        const float* __restrict__ radius, OneScalars sc, float* scratch,
        float* __restrict__ out, int nlayers, int nwave, float maxdepth) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    constexpr int nw = ONE_WARPS;
    const int L = nlayers;
    const int G = one_chunks(L);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.y;
    const int tile0 = blockIdx.x * ONE_TW;
    const int w = tile0 + lane;
    const bool valid = w < nwave;
    const OneLayout o = one_layout(L, n_r1, n_cia, n_ls, parts.n, STREAM);
    const size_t chain_off = (size_t)b * L * nwave;
    // ec [l][32] and the depths [l][32]: in shared memory, or streamed in
    // the block's own scratch (written and read back across barriers, so
    // by plain loads).
    float* blk = STREAM ? scratch + ((size_t)b * gridDim.x + blockIdx.x)
                                        * 2 * L * ONE_TW
                        : nullptr;
    float* s_ec = STREAM ? blk : smem + o.ec;
    float* s_d = STREAM ? blk + (size_t)L * ONE_TW : smem + o.d;
    const float4* s_chord = reinterpret_cast<const float4*>(smem + o.chord);
    float* s_rad = smem + o.rad;
    float* s_h = smem + o.h;
    int* s_k0 = reinterpret_cast<int*>(smem + o.k0);
    int* s_k1 = reinterpret_cast<int*>(smem + o.k1);
    int* s_rest = reinterpret_cast<int*>(smem + o.rest);
    int* s_first = reinterpret_cast<int*>(smem + o.first);
    float* s_part = smem + o.part;
    float* s_pois = smem + o.pois;
    float* s_parts = smem + o.parts;
    float* s_lsv = smem + o.lsv;
    // The weights and the CIA table: staged, or where they lie.
    const float* ciaw = STREAM ? cia_w + b * cia_chain : smem + o.ciaw;
    const int ciaw_row = STREAM ? cia_row : n_cia;
    const float* ct = STREAM ? cia_tab + tile0 : smem + o.ct;
    const int ct_row = STREAM ? nwave : ONE_TW;
    const float* r1c = STREAM ? r1_cols + (size_t)b * n_r1 * L : smem + o.r1c;
    const float* lsw = STREAM ? ls_w + (size_t)b * n_ls * L : smem + o.lsw;

    // 1. Every copy of the chain's operands in flight at once.
    stage_linear(s_rad, radius + (size_t)b * L, L);
    if constexpr (!STREAM) {
        float* s_ciaw = smem + o.ciaw;
        if (n_cia == cia_row) {
            stage_linear(s_ciaw, cia_w + b * cia_chain, L * n_cia);
        } else {
            // A view of the first n_cia weights of longer rows (the size
            // rule's): its rows one by one.
            const float* src = cia_w + b * cia_chain;
            for (int i = threadIdx.x; i < L * n_cia; i += blockDim.x) {
                const int j = i / n_cia;
                cp_async4(s_ciaw + i, src + (size_t)j * cia_row + i - j * n_cia);
            }
        }
        if (n_r1)
            stage_linear(smem + o.r1c, r1_cols + (size_t)b * n_r1 * L,
                         n_r1 * L);
        if (n_ls)
            stage_linear(smem + o.lsw, ls_w + (size_t)b * n_ls * L, n_ls * L);
        float* s_ct = smem + o.ct;
        for (int i = threadIdx.x; i < n_cia * ONE_TW; i += blockDim.x) {
            const int k = i / ONE_TW, wk = tile0 + (i - k * ONE_TW);
            if (wk < nwave)
                cp_async4(s_ct + i, cia_tab + (size_t)k * nwave + wk);
            else
                s_ct[i] = 0.f;
        }
        for (int i = threadIdx.x; i < parts.n * L * ONE_TW; i += blockDim.x) {
            const int p = i / (L * ONE_TW), r = i - p * (L * ONE_TW);
            const int j = r / ONE_TW, c = r - j * ONE_TW;
            if (tile0 + c >= nwave) continue;
            const float* src = p == 0 ? parts.p0 : p == 1 ? parts.p1
                : p == 2 ? parts.p2 : parts.p3;
            float* dst = p == 0 ? s_ec + r
                : s_parts + (size_t)(p - 1) * L * ONE_TW + r;
            cp_async4(dst, src + chain_off + (size_t)j * nwave + tile0 + c);
        }
    }
    cp_async_commit();
    float r1r[MAX_R1];
    load_r1_rows(r1r, r1_rows, n_r1, b, nwave, w, valid);
    // The scalars (every thread its own copy):
    const int itop = clamp_row(scalar_index(sc, 0, b), L);
    const int ibottom = clamp_row(scalar_index(sc, 1, b), L);
    const float inv_rstar2 = [&] {
        const float rs = scalar_float(sc, 4, b);
        return 1.f / (rs * rs);
    }();
    int deck_row = -1;
    bool apply_deck = false;
    float rsurf = 0.f;
    if (sc.has_deck) {
        deck_row = clamp_row(scalar_index(sc, 2, b), L);
        rsurf = scalar_float(sc, 3, b);
        apply_deck = deck_row > itop;
    }
    cp_async_wait<0>();
    __syncthreads();

    // 2. What follows from the staged operands, while each warp's
    // line-sample rows are in flight: each warp finds the live weights of
    // its layers (j = warp, warp + nw, ...; lanes on k) and copies their
    // table rows (lane c its column c, which it alone reads back); the
    // block folds the chord matrix and takes the layer heights; then each
    // warp assembles its layers.  (Streamed, the rows are read where they
    // lie and nothing is folded.)
    if (n_ls) {
        for (int j = warp; j < L; j += nw) {
            int k0 = -1, k1 = -1, rest = n_ls;
            for (int base = 0; base < n_ls && rest == n_ls; base += 32) {
                unsigned live = __ballot_sync(
                    FULL, base + lane < n_ls
                    && lsw[(base + lane) * L + j] != 0.f);
                while (live) {
                    const int k = base + __ffs(live) - 1;
                    live &= live - 1;
                    if (k0 < 0) {
                        k0 = k;
                    } else if (k1 < 0) {
                        k1 = k;
                    } else {
                        rest = k;
                        break;
                    }
                }
            }
            if (lane == 0) {
                s_k0[j] = k0;
                s_k1[j] = k1;
                s_rest[j] = rest;
            }
            if (!STREAM && valid) {
                if (k0 >= 0)
                    cp_async4(s_lsv + j * ONE_TW + lane,
                              ls_tab + ((size_t)k0 * L + j) * nwave + w);
                if (k1 >= 0)
                    cp_async4(s_lsv + (L + j) * ONE_TW + lane,
                              ls_tab + ((size_t)k1 * L + j) * nwave + w);
            }
        }
        cp_async_commit();
    }
    const int jd = deck_row - 1;
    float w_surf = 0.f;
    if (sc.has_deck) {
        const float r_j = s_rad[min(max(jd, 0), L - 1)];
        const float r_j1 = s_rad[min(max(jd + 1, 0), L - 1)];
        w_surf = (r_j - rsurf) / (r_j - r_j1);
    }
    const float r_top = s_rad[min(max(itop, 0), L - 1)];
    const float r_itop2 = r_top * r_top;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
        // h[j] = r[j + 1] - r[j] (negative), the deck surface's at the
        // row above the deck:
        s_h[j] = j < L - 1
            ? (apply_deck && j == jd ? rsurf - s_rad[j]
                                     : s_rad[j + 1] - s_rad[j])
            : 0.f;
    }
    // The chord matrix is read by every block: it comes from L2.
    const float* chain_path = path + (size_t)b * L * (L - 1);
    if constexpr (!STREAM) {
        float4* fold = reinterpret_cast<float4*>(smem + o.chord);
        for (int at = threadIdx.x; at < chunk_at(G); at += blockDim.x) {
            // The chunk g and layer j of entry `at`:
            int g = (int)((sqrtf(1.f + 2.f * at) - 1.f) * 0.5f);
            while (chunk_at(g + 1) <= at) ++g;
            while (chunk_at(g) > at) --g;
            const int j = at - chunk_at(g);
            float v[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = 4 * g + r;
                const float* row = chain_path + (size_t)i * (L - 1);
                v[r] = i < L && j < L
                    ? (j >= 1 ? __ldg(row + j - 1) : 0.f)
                        + (j < L - 1 ? __ldg(row + j) : 0.f)
                    : 0.f;
            }
            fold[at] = make_float4(v[0], v[1], v[2], v[3]);
        }
    }
    cp_async_wait<0>();
    __syncwarp();

    // 3. The extinction, warp k on its layers k, k + nw, ..., two at a
    // time (their CIA sums are independent chains of FMAs): dense parts,
    // rank-1 terms, the CIA product (summed on its own), the line sample
    // in ascending k.
    float poison = 0.f;
    for (int j0 = warp; j0 < L; j0 += 2 * nw) {
        // (Past the last layer the second is the first again, dropped.)
        const int jj[2] = {j0, j0 + nw < L ? j0 + nw : j0};
        float e[2] = {0.f, 0.f};
        if (valid) {
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                const int j = jj[t];
                if (parts.n > 0) {
                    if constexpr (STREAM) {
                        const size_t at = chain_off + (size_t)j * nwave + w;
                        e[t] = __ldg(parts.p0 + at);
                        if (parts.n > 1) e[t] += __ldg(parts.p1 + at);
                        if (parts.n > 2) e[t] += __ldg(parts.p2 + at);
                        if (parts.n > 3) e[t] += __ldg(parts.p3 + at);
                    } else {
                        e[t] = s_ec[j * ONE_TW + lane];
                        for (int p = 1; p < parts.n; ++p)
                            e[t] += s_parts[((size_t)(p - 1) * L + j)
                                            * ONE_TW + lane];
                    }
                }
#pragma unroll
                for (int r = 0; r < MAX_R1; ++r)
                    if (r < n_r1) e[t] = fmaf(r1c[r * L + j], r1r[r], e[t]);
            }
            if (n_cia) {
                float c0 = 0.f, c1 = 0.f;
#pragma unroll 4
                for (int k = 0; k < n_cia; ++k) {
                    const float tab = ct[k * ct_row + lane];
                    c0 = fmaf(ciaw[jj[0] * ciaw_row + k], tab, c0);
                    c1 = fmaf(ciaw[jj[1] * ciaw_row + k], tab, c1);
                }
                e[0] += c0;
                e[1] += c1;
            }
            if (n_ls) {
#pragma unroll
                for (int t = 0; t < 2; ++t) {
                    const int j = jj[t];
                    const int k0 = s_k0[j], k1 = s_k1[j];
                    const float* row = ls_tab + (size_t)j * nwave + w;
                    const size_t krow = (size_t)L * nwave;
                    if (k0 >= 0)
                        e[t] = fmaf(lsw[k0 * L + j],
                                    STREAM ? __ldg(row + k0 * krow)
                                           : s_lsv[j * ONE_TW + lane],
                                    e[t]);
                    if (k1 >= 0)
                        e[t] = fmaf(lsw[k1 * L + j],
                                    STREAM ? __ldg(row + k1 * krow)
                                           : s_lsv[(L + j) * ONE_TW + lane],
                                    e[t]);
                    // Any further ones (several species), from the table:
                    for (int k = s_rest[j]; k < n_ls; ++k) {
                        const float wk = lsw[k * L + j];
                        if (wk != 0.f)
                            e[t] = fmaf(wk, __ldg(row + k * krow), e[t]);
                    }
                }
            }
        }
        poison = fmaf(e[0], 0.f, poison);
        s_ec[j0 * ONE_TW + lane] = e[0];
        if (j0 + nw < L) {
            poison = fmaf(e[1], 0.f, poison);
            s_ec[(j0 + nw) * ONE_TW + lane] = e[1];
        }
    }
    s_pois[warp * ONE_TW + lane] = poison;
    __syncthreads();

    // 4. The chord product, the warp's run of chunks, four rows at a time;
    // the first row of the run past maxdepth.  Streamed, the chunk's four
    // rows of path are folded as j walks (each step reads path[i][j] and
    // keeps it for the next).
    const int g0 = first_chunk(warp, G), g1 = first_chunk(warp + 1, G);
    const int jlo = max(itop, 0);
    int first = L;
    for (int g = g0; g < g1; ++g) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        const int jend = min(4 * g + 4, L);
        if constexpr (STREAM) {
            const float* row[4];
            float prev[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = min(4 * g + r, L - 1);
                row[r] = 4 * g + r < L ? chain_path + (size_t)i * (L - 1)
                                       : nullptr;
                prev[r] = row[r] && jlo >= 1 && jlo < jend
                    ? __ldg(row[r] + jlo - 1) : 0.f;
            }
            for (int j = jlo; j < jend; ++j) {
                const float e = s_ec[j * ONE_TW + lane];
                float p[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float cur =
                        row[r] && j < L - 1 ? __ldg(row[r] + j) : 0.f;
                    p[r] = prev[r] + cur;
                    prev[r] = cur;
                }
                a0 = fmaf(p[0], e, a0);
                a1 = fmaf(p[1], e, a1);
                a2 = fmaf(p[2], e, a2);
                a3 = fmaf(p[3], e, a3);
            }
        } else {
            const float4* pk = s_chord + chunk_at(g);
#pragma unroll 4
            for (int j = jlo; j < jend; ++j) {
                const float e = s_ec[j * ONE_TW + lane];
                const float4 p = pk[j];
                a0 = fmaf(p.x, e, a0);
                a1 = fmaf(p.y, e, a1);
                a2 = fmaf(p.z, e, a2);
                a3 = fmaf(p.w, e, a3);
            }
        }
        const float a[4] = {a0, a1, a2, a3};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = 4 * g + r;
            if (i >= L) break;
            s_d[i * ONE_TW + lane] = a[r];
            if (first == L && i >= itop && i < ibottom && a[r] > maxdepth)
                first = i;
        }
    }
    s_first[warp * ONE_TW + lane] = first;
    __syncthreads();

    // 5. ideep from the block minimum; the masked trapezoid over rows
    // split evenly among the warps (the row above a warp's first comes
    // from the depths).
    int m = L;
    for (int k = 0; k < nw; ++k) m = min(m, s_first[k * ONE_TW + lane]);
    const int ideep = m < L ? m : ibottom - 1;
    const int i0 = warp * L / nw, i1 = (warp + 1) * L / nw;
    float prev = i0 > 0 && i0 < i1
        ? expf(-s_d[(i0 - 1) * ONE_TW + lane]) * s_rad[i0 - 1] : 0.f;
    float integral = 0.f;
    for (int i = i0; i < i1; ++i) {
        const float raw = expf(-s_d[i * ONE_TW + lane]) * s_rad[i];
        const float integ = apply_deck && i == deck_row
            ? prev * (1.f - w_surf) + raw * w_surf : raw;
        const float mi = (i >= itop && i < ibottom && i < ideep) ? 1.f : 0.f;
        const float mp = (i >= itop + 1 && i <= ideep) ? 1.f : 0.f;
        const float hp = i > 0 ? s_h[i - 1] : 0.f;
        integral += integ * (0.5f * (s_h[i] * mi + hp * mp));
        prev = raw;
    }
    s_part[warp * ONE_TW + lane] = integral;
    __syncthreads();

    // 6. The partial sums in warp order.
    if (warp == 0 && valid) {
        float total = 0.f, pois = 0.f;
        for (int k = 0; k < nw; ++k) {
            total += s_part[k * ONE_TW + lane];
            pois += s_pois[k * ONE_TW + lane];
        }
        out[(size_t)b * nwave + w] =
            (r_itop2 + 2.f * total) * inv_rstar2 + pois;
    }
}

// Bytes of shared memory a block takes for these sizes, staged or
// streamed; 0 for counts the kernel does not take.
int one_smem(int nlayers, int n_r1, int n_cia, int n_ls, int n_parts,
             bool stream) {
    if (nlayers < 2 || n_r1 < 0 || n_r1 > MAX_R1 || n_cia < 0 || n_ls < 0
            || n_parts < 0 || n_parts > MAX_PARTS || nlayers > 32768
            || n_cia > 4096 || n_ls > 4096)
        return 0;
    return 4 * one_layout(nlayers, n_r1, n_cia, n_ls, n_parts, stream).total;
}

}  // namespace

// How K2 runs with these sizes: 0 staged (everything in shared memory),
// 1 streamed (ec and the depths in the caller's scratch of
// pbt_transit_one_scratch floats), -1 not at all (the wrapper raises).
extern "C" int pbt_transit_one_mode(int nlayers, int n_r1, int n_cia,
                                    int n_ls, int n_parts) {
    for (int stream = 0; stream < 2; ++stream) {
        const int smem =
            one_smem(nlayers, n_r1, n_cia, n_ls, n_parts, stream);
        if (smem > 0 && smem <= SMEM_MAX) return stream;
    }
    return -1;
}

// Floats of the scratch a streamed launch takes: [B, tiles, 2, l, 32].
extern "C" long long pbt_transit_one_scratch(int nchains, int nlayers,
                                             int nwave) {
    return (long long)nchains * ((nwave + ONE_TW - 1) / ONE_TW) * 2
        * nlayers * ONE_TW;
}

// K2.  parts [B, l, W], r1_rows [B, n_r1, W], r1_cols [B, n_r1, l], cia_w
// [B, l, n_cia] (chain b, layer j at cia_w + b cia_chain + j cia_row: the
// size rule hands over a view of its first 32 weights), cia_tab [n_cia,
// W], ls_w [B, n_ls, l], ls_tab [n_ls, l, W], path [B, l, l - 1], radius
// [B, l], all float32 and contiguous but cia_w, as the wrappers of
// transit_kernel.py hand them over; the scalars as OneScalars, from host
// arrays; scratch of pbt_transit_one_scratch floats when the mode is
// streamed (else unused).  out [B, W].
extern "C" int pbt_transit_one(
        const float* part0, const float* part1, const float* part2,
        const float* part3, int n_parts, const float* r1_rows,
        const float* r1_cols, int n_r1, const float* cia_w,
        long long cia_chain, int cia_row, const float* cia_tab, int n_cia,
        const float* ls_w,
        const float* ls_tab, int n_ls, const float* path,
        const float* radius, const void* const* scalar_ptr,
        const int* scalar_bytes, const int* scalar_stride,
        const double* scalar_value, int has_deck, float* scratch,
        float* out, int nchains, int nlayers, int nwave, float maxdepth,
        void* stream) {
    const int mode =
        pbt_transit_one_mode(nlayers, n_r1, n_cia, n_ls, n_parts);
    if (mode < 0 || (mode == 1 && scratch == nullptr) || nchains < 1
            || nchains > 65535 || nwave < 1 || (n_cia && cia_row < n_cia))
        return (int)cudaErrorInvalidValue;
    OneScalars sc;
    for (int q = 0; q < NSCAL; ++q) {
        sc.ptr[q] = scalar_ptr[q];
        sc.bytes[q] = scalar_ptr[q] ? scalar_bytes[q] : 0;
        sc.stride[q] = scalar_stride[q];
        sc.value[q] = scalar_value[q];
        if (sc.bytes[q] != 0 && sc.bytes[q] != 4 && sc.bytes[q] != 8)
            return (int)cudaErrorInvalidValue;
    }
    sc.has_deck = has_deck;
    const int smem = one_smem(nlayers, n_r1, n_cia, n_ls, n_parts, mode);
    decltype(&transit_one_kernel<false>) kernel =
        mode ? &transit_one_kernel<true> : &transit_one_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    Parts parts = {part0, part1, part2, part3, n_parts};
    const dim3 grid((nwave + ONE_TW - 1) / ONE_TW, nchains);
    kernel<<<grid, 32 * ONE_WARPS, smem, (cudaStream_t)stream>>>(
        parts, r1_rows, r1_cols, n_r1, cia_w, cia_chain, cia_row, cia_tab,
        n_cia, ls_w, ls_tab, n_ls, path, radius, sc, scratch, out, nlayers,
        nwave, maxdepth);
    return (int)cudaGetLastError();
}
