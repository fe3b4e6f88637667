"""The plain reference of the thermochemical-equilibrium solve, in plain
PyTorch on the CPU (float64, or float32 for the controls; TF32 off): the
minimum of the Gibbs energy of an ideal-gas mixture at fixed temperature
and pressure, in the element-potential form of Gordon & McBride (1994,
NASA RP-1311, §2-3), iterated to convergence.

Per system (a layer of a chain), with mu_j = g_j + ln p + ln(n_j / n) the
chemical potential over RT (RP-1311 eq 2.11; g_j = G/RT at 1 bar, p in
bar), the Newton iteration of eqs 2.24 and 2.26 solves for the element
potentials pi_i and dln n

    sum_k (sum_j a_kj a_ij n_j) pi_k + b_i dln n = b0_i - b_i + sum_j a_ij n_j mu_j
    sum_k b_k pi_k + (sum_j n_j - n) dln n      = n - sum_j n_j + sum_j n_j mu_j

(b_i = sum_j a_ij n_j), and dln n_j = -mu_j + sum_i a_ij pi_i + dln n
(eq 2.18); the control factor lambda of eqs 3.1-3.2 (SIZE = 18.420681)
damps the step.  The composition's data: G/RT of each species tabulated on
a temperature grid and lerped at the layer's temperature clamped to the
grid, and the element moles b0 = 10^(dex - 12) with dex the solar
abundances plus [M/H] for every element but H and He, then b0_C =
C/O b0_O (Pyrat Bay's convention).

Departures from RP-1311:
1. Gases only, and no ions: the network holds neither condensates nor
   charged species.
2. Every species stays in the iteration however rare.  RP-1311 §3.2
   takes a species below ln(n_j / n) = -SIZE out of the matrix and tests
   it at the end; here the unknowns are ln n_j, which hold a trace species
   without underflow, and its n_j (which may underflow to 0) weighs
   nothing in the sums.
3. Convergence is tighter: RP-1311 §3.5 stops at n_j |dln n_j| / sum n_j
   <= 0.5e-5 and n |dln n| / sum n_j <= 0.5e-5; here at |dln n_j| (every
   species, trace ones too) and |dln n| at most 1e-10 in float64,
   because the program is compared with it to ~1e-9 of each VMR; a
   system that has not converged after MAX_ITER iterations raises.  In
   float32 (the controls), whose steps rattle at ~1e-4 of ln n_j, the
   iteration stops at 1e-3 or after MAX_ITER iterations and keeps what
   it has.
4. The linear system is solved by LU with partial pivoting after its
   element rows and columns are scaled by their diagonal (the same
   solution; the element moles span ten decades); a singular system (in
   float32, two elements carried by one species alone once the others
   underflow) takes the least-squares solution of least norm.
5. The initial estimates of §3.4 (n_j = 0.1 / N, n = 0.1 per kg of
   mixture) scaled by the element budget: n = 0.1 sum b0, n_j = n / N.
"""
import re

import numpy as np
import torch

__all__ = ['Network', 'parse_formula', 'SIZE', 'MAX_ITER']

SIZE = 18.420681
MAX_ITER = 500
_TOL = {torch.float64: 1e-10, torch.float32: 1e-3}
_FORMULA = re.compile(r'([A-Z][a-z]?)(\d*)')


def parse_formula(name):
    """{element: count} of a neutral species' formula (H2O, CO2, Na)."""
    if not re.fullmatch(r'([A-Z][a-z]?\d*)+', name):
        raise ValueError(f'Not a neutral formula: {name!r}')
    counts = {}
    for element, n in _FORMULA.findall(name):
        counts[element] = counts.get(element, 0) + (int(n) if n else 1)
    return counts


class Network:
    """The equilibrium of a network of species, from the frozen data of a
    file written by portbench/write_gibbs_table.py: species, temperature
    [nT], gibbs_over_rt [nT, ns], elements, solar_dex."""

    def __init__(self, path):
        with np.load(path) as f:
            self.species = [str(s) for s in f['species']]
            self.temps = np.array(f['temperature'], float)
            self.gibbs = np.array(f['gibbs_over_rt'], float)
            self.elements = [str(e) for e in f['elements']]
            self.solar_dex = np.array(f['solar_dex'], float)
        self.stoich = np.zeros((len(self.species), len(self.elements)))
        for j, name in enumerate(self.species):
            for element, n in parse_formula(name).items():
                self.stoich[j, self.elements.index(element)] = n
        self.is_metal = np.array([e not in ('H', 'He')
                                  for e in self.elements])

    def budget(self, metallicity, c_to_o):
        """Element moles b0 [B, ne] (per H atom) of B chains."""
        dex = self.solar_dex[None] + self.is_metal[None] \
            * np.asarray(metallicity, float)[:, None]
        b0 = 10.0 ** (dex - 12.0)
        ic, io = self.elements.index('C'), self.elements.index('O')
        b0[:, ic] = np.asarray(c_to_o, float) * b0[:, io]
        return b0

    def gibbs_at(self, temp):
        """G/RT [..., ns]: the table's lerp at temp clamped to its grid."""
        tc = np.clip(temp, self.temps[0], self.temps[-1])
        i = np.clip(np.searchsorted(self.temps, tc, side='right') - 1,
                    0, len(self.temps) - 2)
        w = ((tc - self.temps[i]) / (self.temps[i + 1] - self.temps[i]))
        return self.gibbs[i] * (1.0 - w[..., None]) \
            + self.gibbs[i + 1] * w[..., None]

    def vmr(self, temp, press, metallicity, c_to_o, dtype=torch.float64):
        """VMRs [B, l, ns] (numpy float64) of B chains at temp [B, l] (K),
        press [l] (bar), [M/H] [B] and C/O [B], solved in `dtype`; NaN
        for a layer whose temperature is not finite."""
        temp = np.asarray(temp, float)
        nb, nl = temp.shape
        b0 = np.broadcast_to(self.budget(metallicity, c_to_o)[:, None],
                             (nb, nl, len(self.elements)))
        lnp = np.broadcast_to(np.log(press)[None], (nb, nl))
        ok = np.isfinite(temp)
        out = np.full((nb, nl, len(self.species)), np.nan)
        if np.any(ok):
            out[ok] = solve(self.gibbs_at(temp[ok]), lnp[ok], b0[ok],
                            self.stoich, dtype)
        return out


def solve(g0, lnp, b0, stoich, dtype=torch.float64):
    """Mole fractions [S, ns] (numpy float64) of S systems: g0 [S, ns]
    G/RT at 1 bar, lnp [S] ln(p / bar), b0 [S, ne] element moles, stoich
    [ns, ne] (atoms of element i in species j), in `dtype` on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = lambda a: torch.as_tensor(np.asarray(a, float)).to(dtype)
    g0, lnp, b0, a = t(g0), t(lnp), t(b0), t(stoich)
    nsys, ns = g0.shape
    ne = a.shape[1]
    tol = _TOL[dtype]
    ntot0 = 0.1 * b0.sum(dim=1)
    ln_n = torch.log(ntot0 / ns)[:, None].expand(nsys, ns).clone()
    ln_ntot = torch.log(ntot0)
    for _ in range(MAX_ITER):
        n = torch.exp(ln_n)
        nsum = n.sum(dim=1)
        mu = g0 + lnp[:, None] + ln_n - ln_ntot[:, None]
        # RP-1311 eqs 2.24 and 2.26, the element rows then the total row:
        mat = torch.zeros((nsys, ne + 1, ne + 1), dtype=dtype)
        mat[:, :ne, :ne] = torch.einsum('ji,sj,jk->sik', a, n, a)
        bj = n @ a
        mat[:, :ne, ne] = bj
        mat[:, ne, :ne] = bj
        mat[:, ne, ne] = nsum - torch.exp(ln_ntot)
        rhs = torch.cat([b0 - bj + (n * mu) @ a,
                         (torch.exp(ln_ntot) - nsum
                          + (n * mu).sum(dim=1))[:, None]], dim=1)
        d = torch.ones((nsys, ne + 1), dtype=dtype)
        d[:, :ne] = 1.0 / torch.sqrt(torch.diagonal(
            mat[:, :ne, :ne], dim1=1, dim2=2))
        mat, rhs = mat * d[:, :, None] * d[:, None, :], rhs * d
        x, info = torch.linalg.solve_ex(mat, rhs)
        singular = info != 0
        if bool(torch.any(singular)):
            x[singular] = torch.linalg.lstsq(
                mat[singular], rhs[singular][:, :, None],
                driver='gelsd').solution[:, :, 0]
        x = x * d
        pi, dln_ntot = x[:, :ne], x[:, ne]
        dln_n = -mu + pi @ a.T + dln_ntot[:, None]           # eq 2.18
        # The control factor (eqs 3.1-3.2):
        ln_x = ln_n - ln_ntot[:, None]
        major = (ln_x > -SIZE) & (dln_n > 0)
        big = torch.maximum(5.0 * torch.abs(dln_ntot), torch.amax(
            torch.where(major, dln_n, torch.zeros_like(dln_n)), dim=1))
        lam1 = 2.0 / big.clamp_min(torch.finfo(dtype).tiny)
        minor = (ln_x <= -SIZE) & (dln_n >= 0)
        ratio = torch.abs((-ln_x - 9.2103404)
                          / (dln_n - dln_ntot[:, None]))
        lam2 = torch.amin(torch.where(minor, ratio,
                                      torch.full_like(ratio, np.inf)), dim=1)
        lam = torch.clamp(torch.minimum(lam1, lam2), max=1.0)
        ln_n = ln_n + lam[:, None] * dln_n
        ln_ntot = ln_ntot + lam * dln_ntot
        done = (torch.amax(torch.abs(dln_n), dim=1) <= tol) \
            & (torch.abs(dln_ntot) <= tol) & (lam == 1.0)
        if bool(torch.all(done)):
            break
    bad = int((~done).sum())
    if bad and dtype == torch.float64:
        raise RuntimeError(f'{bad} of {nsys} equilibrium systems did not '
                           f'converge in {MAX_ITER} iterations')
    x = torch.exp(ln_n - torch.logsumexp(ln_n, dim=1, keepdim=True))
    return x.double().numpy()
