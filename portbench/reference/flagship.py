"""The plain reference of the flagship transit retrieval: numpy, float64.

From the parameters of B chains to their temperature profiles, radii,
transit spectra, band fluxes and log-posteriors, in the order the
program's configuration states them (a Guillot T(p), the free log_H2O
with the bulk H2-He balance, ideal-gas densities, hydro_m radii, the
line-sampled H2O table lerped in temperature, the H2-H2 CIA, the
Lecavelier haze, the opaque deck, the chord optical depths, the transit
integral down to maxdepth, the photon-counting tophat bands and the
Gaussian likelihood inside the prior box).  It reads the input files
the program reads and nothing the program makes.

`precision='tf32'` is the control: the same arithmetic in float32 with
every contraction (the table lerps, the CIA product, the chord product,
the transit integral, the band product) taken on operands rounded to
TF32, the precision below the configuration's float32 with TF32 off.
"""
import numpy as np
import scipy.special as ss

from . import inputs

__all__ = ['Flagship', 'tf32']

# The Lecavelier haze: H2's Rayleigh cross section at 0.35 um and that
# wavelength (opacity/clouds.py):
_S0 = 5.31e-27
_L0 = 3.5e-5
# Sodium D lines (cm-1) and the alkali model's detuning cutoff:
_NA_LINES = (16960.87, 16978.07)
_ALKALI_CUTOFF = 4500.0


def tf32(x):
    """float32 values rounded to nearest (ties to even) at TF32's 10
    mantissa bits."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    out = u.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(x), out, x)


def _wn_mask_tol(wn, wn_min, wn_max, tol=1.0e-8):
    mask = (wn >= wn_min) & (wn <= wn_max)
    if np.sum(mask) < 2:
        min_dwn = max_dwn = 0.0
    else:
        min_dwn = np.abs(np.ediff1d(wn[mask][0:2]))
        max_dwn = np.abs(np.ediff1d(wn[mask][-2:]))
    return (wn >= wn_min - min_dwn * tol) & (wn <= wn_max + max_dwn * tol)


def _spline_second_deriv(y, x):
    """Pyrat Bay's natural-spline second derivatives, with its tension
    term divided by x[i+1] - y[i-1] (src_c/_spline.c), which the
    published spectra carry."""
    n = len(y) - 1
    y2 = np.zeros(n + 1)
    u = np.zeros(n)
    for i in range(1, n):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - y[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        ui = ((y[i + 1] - y[i]) / (x[i + 1] - x[i])
              - (y[i] - y[i - 1]) / (x[i] - x[i - 1]))
        u[i] = (6.0 * ui / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    for i in range(n - 1, -1, -1):
        y2[i] = y2[i] * y2[i + 1] + u[i]
    y2[n] = 0.0
    return y2


def _spline(y, x, y2, xout):
    """Cubic-spline values at xout, 0 outside [x[0], x[-1]]."""
    yout = np.zeros(len(xout))
    inside = (xout >= x[0]) & (xout <= x[-1])
    idx = np.clip(np.searchsorted(x, xout[inside], side='right') - 1,
                  0, len(x) - 2)
    dx = x[idx + 1] - x[idx]
    a = (x[idx + 1] - xout[inside]) / dx
    b = (xout[inside] - x[idx]) / dx
    yout[inside] = (a * y[idx] + b * y[idx + 1]
                    + ((a**3 - a) * y2[idx] + (b**3 - b) * y2[idx + 1])
                    * dx * dx / 6.0)
    return yout


def _tophat_weights(wn, wl0, half_width):
    """A photon-counting tophat's weight row on the grid wn (increasing):
    the in-band points and one point of margin on each side, the
    trapezoid rule in wavenumber times the wavelength, normalized so that
    a flat spectrum integrates to one (spectrum/passbands.py Tophat)."""
    wn_low = 1.0 / ((wl0 + half_width) * inputs.UM)
    wn_high = 1.0 / ((wl0 - half_width) * inputs.UM)
    in_band = (wn >= wn_low) & (wn <= wn_high)
    where = np.where(in_band)[0]
    idx = np.arange(max(where[0] - 1, 0), min(where[-1] + 2, len(wn)))
    bwn = wn[idx]
    bwl = 1.0 / (bwn * inputs.UM)
    resp = in_band[idx].astype(float)
    trapz = np.zeros(len(bwn))
    trapz[:-1] += 0.5 * np.diff(bwn)
    trapz[1:] += 0.5 * np.diff(bwn)
    height = 1.0 / np.sum(trapz * resp * bwl)
    row = np.zeros(len(wn))
    row[idx] = trapz * bwl * resp * height
    return row


class Flagship:
    """The reference forward of one configuration file, on the inputs
    written at `paths` (inputs.write_inputs)."""

    def __init__(self, config, paths, precision='float64'):
        if precision not in ('float64', 'tf32'):
            raise ValueError(f'Unknown precision {precision!r}')
        self.precision = precision
        self.dt = np.float64 if precision == 'float64' else np.float32
        self.config = config
        species, press, _, vmr0 = inputs.read_atm(paths['atm'])
        self.species = species
        self.press = press
        self.nlayers = len(press)
        self.vmr0 = vmr0
        self.mass = np.array([inputs.MASSES[s] for s in species])
        ttemps, tpress, twn, opacity = inputs.read_table(paths['table'])
        if len(tpress) != len(press) or np.any(
                np.abs(1.0 - tpress / press) > 0.01):
            raise ValueError('The table is not on the layers of the model')
        wnlow = 1.0 / (config['wl_high_um'] * inputs.UM)
        wnhigh = 1.0 / (config['wl_low_um'] * inputs.UM)
        mask = _wn_mask_tol(twn, wnlow, wnhigh)
        self.wn = twn[mask]
        self.nwave = len(self.wn)
        self.ls_temps = ttemps
        self.ls_tab = opacity[:, :, mask]
        self.i_h2o = species.index('H2O')
        cspec, ctemps, cwn, cs = inputs.read_cia(paths['cia'])
        order = np.argsort(ctemps)
        self.cia_temps = ctemps[order]
        self.cia_tab = np.array([
            _spline(row, cwn, _spline_second_deriv(row, cwn), self.wn)
            for row in cs[order]])
        self.i_cia = [species.index(s) for s in cspec]
        for line in _NA_LINES:
            if (line - _ALKALI_CUTOFF <= self.wn[-1]
                    and line + _ALKALI_CUTOFF >= self.wn[0]):
                raise ValueError('An alkali line reaches the grid: the '
                                 'reference leaves the alkali model out')
        self.i_bulk = [species.index('H2'), species.index('He')]
        self.bratio = vmr0[:, self.i_bulk] / vmr0[:, self.i_bulk[:1]]
        self.bratio[:, 0] = 1.0
        self.invsrat = 1.0 / np.sum(self.bratio, axis=1)
        self.i_trace = [i for i in range(len(species))
                        if i not in self.i_bulk]
        bands = config['bands']
        centers = np.linspace(config['wl_low_um'] + bands['margin_um'],
                              config['wl_high_um'] - bands['margin_um'],
                              bands['n'])
        self.bands = np.array([
            _tophat_weights(self.wn, float(f'{wl0:.4f}'),
                            bands['half_width_um']) for wl0 in centers])
        planet = config['planet']
        self.rstar = planet['rstar_rsun'] * inputs.RSUN
        self.rplanet = planet['rplanet_rjup'] * inputs.RJUP
        self.mplanet = planet['mplanet_mjup'] * inputs.MJUP
        self.refpress = planet['refpressure_bar']
        self.maxdepth = config['maxdepth']
        self.tpars = np.array(config['tpars'], float)
        rows = config['retrieval_params']
        self.pnames = [r[0] for r in rows]
        self.params0 = np.array([r[1] for r in rows], float)
        self.pmin = np.array([r[2] for r in rows], float)
        self.pmax = np.array([r[3] for r in rows], float)
        self.tmin_bound = max(ttemps.min(), ctemps.min(), config['tlow'])
        self.tmax_bound = min(ttemps.max(), ctemps.max(), config['thigh'])

    # ------------------------------------------------------------------
    def _c(self, x):
        """x in the reference's precision."""
        return np.asarray(x, self.dt)

    def _op(self, x):
        """An operand of a contraction: TF32-rounded in the control."""
        x = self._c(x)
        return tf32(x) if self.precision == 'tf32' else x

    def _param(self, params, name, default):
        if name in self.pnames:
            return params[:, self.pnames.index(name)]
        return np.full(params.shape[0], default)

    def state(self, params):
        """Temperature, VMRs, densities and radius of B chains: params
        [B, npars] in the order of the configuration's retrieval_params."""
        c = self._c
        params = c(params)
        nb = params.shape[0]
        tpars = np.tile(c(self.tpars), (nb, 1))
        tpars[:, 0] = self._param(params, "log_kappa'", self.tpars[0])
        tpars[:, 4] = self._param(params, 'T_irr', self.tpars[4])
        temp = self.guillot(tpars)
        vmr = np.tile(c(self.vmr0), (nb, 1, 1))
        vmr[:, :, self.i_h2o] = 10.0 ** self._param(
            params, 'log_H2O', self.config['log_H2O'])[:, None]
        remainder = 1.0 - np.sum(vmr[:, :, self.i_trace], axis=2)
        vmr[:, :, self.i_bulk] = c(self.bratio) * (
            remainder * c(self.invsrat))[:, :, None]
        press = c(self.press)
        dens = vmr * (press / temp)[:, :, None] * (inputs.BAR
                                                   / inputs.K_BOLTZ)
        mu = np.sum(vmr * c(self.mass), axis=2)
        rplanet = self._param(params, 'R_planet',
                              self.config['planet']['rplanet_rjup']) \
            * inputs.RJUP
        radius = self.hydro_m(temp, mu, rplanet)
        return dict(temp=temp, vmr=vmr, dens=dens, radius=radius,
                    params=params)

    def guillot(self, tpars):
        """Guillot (2010) T(p), tau = kappa' p (p in barye)."""
        c = self._c
        pb = c(self.press * inputs.BAR)
        col = lambda i: tpars[:, i:i + 1]
        tau = 10.0 ** col(0) * pb

        def xi(gamma):
            gt = gamma * tau
            return 2.0 / 3.0 * (
                (1.0 / gamma) * (1.0 + (0.5 * gt - 1.0) * np.exp(-gt))
                + gamma * (1.0 - 0.5 * tau**2) * c(ss.expn(2, gt)) + 1.0)

        t4 = 0.75 * (col(5)**4 * (2.0 / 3.0 + tau)
                     + col(4)**4 * (1.0 - col(3)) * xi(10.0 ** col(1))
                     + col(4)**4 * col(3) * xi(10.0 ** col(2)))
        return c(t4 ** 0.25)

    def hydro_m(self, temp, mu, rplanet):
        """Hydrostatic radii with g = G M / r^2, normalized at the
        reference pressure; layers above a non-monotonic step are inf."""
        c = self._c
        logp = c(np.log(self.press))
        r0 = c(rplanet)[:, None]
        f = r0 * inputs.K_BOLTZ * inputs.N_AVOGADRO * temp / (
            inputs.G_GRAV * mu * self.mplanet)
        steps = 0.5 * np.diff(logp) * (f[:, 1:] + f[:, :-1])
        integ = np.concatenate([np.zeros((len(f), 1), self.dt),
                                np.cumsum(steps, axis=1)], axis=1)
        i0 = np.array([np.interp(self.refpress, self.press, row)
                       for row in integ], self.dt)
        radius = r0 / (integ - i0[:, None] + 1.0)
        nl = radius.shape[1]
        bad = radius[:, :-1] <= radius[:, 1:]
        last_bad = np.max(np.where(bad, np.arange(nl - 1), -1), axis=1)
        return np.where(np.arange(nl)[None] <= last_bad[:, None], np.inf,
                        radius)

    def extinction(self, st):
        """Extinction [B, l, W] (cm-1) of the gas and the haze, and the
        deck (itop [B], rsurf [B])."""
        c, op = self._c, self._op
        temp, dens = st['temp'], st['dens']
        nb, nl = temp.shape
        nt = len(self.ls_temps)
        lt = c(self.ls_temps)
        tlo = np.clip(np.searchsorted(lt, temp.ravel(), side='right')
                      .reshape(temp.shape) - 1, 0, nt - 2)
        w_hi = (temp - lt[tlo]) / (lt[tlo + 1] - lt[tlo])
        d_h2o = dens[:, :, self.i_h2o]
        w_lo = op((1.0 - w_hi) * d_h2o)[:, :, None]
        w_up = op(w_hi * d_h2o)[:, :, None]
        tab = op(self.ls_tab)
        layers = np.arange(nl)[None, :]
        ec = w_lo * tab[tlo, layers] + w_up * tab[tlo + 1, layers]
        # CIA: the temperature lerp of the table, clamped to its range,
        # times the amagat-normalized density product:
        ct = c(self.cia_temps)
        tcl = np.clip(temp, ct[0], ct[-1])
        clo = np.clip(np.searchsorted(ct, tcl.ravel(), side='right')
                      .reshape(temp.shape) - 1, 0, len(ct) - 2)
        cw = (tcl - ct[clo]) / (ct[clo + 1] - ct[clo])
        dprod = np.prod(dens[:, :, self.i_cia] / inputs.AMAGAT, axis=2)
        weights = np.zeros((nb, nl, len(ct)), self.dt)
        np.put_along_axis(weights, clo[..., None],
                          ((1.0 - cw) * dprod)[..., None], axis=2)
        np.put_along_axis(weights, clo[..., None] + 1,
                          (cw * dprod)[..., None], axis=2)
        ec = ec + op(weights) @ op(self.cia_tab)
        # The haze: the total gas density times a power-law cross section.
        log_k = self._param(st['params'], 'log_k_ray',
                            self.config['log_k_ray'])
        alpha = self._param(st['params'], 'alpha_ray',
                            self.config['alpha_ray'])
        cs = 10.0 ** log_k[:, None] * _S0 * (c(self.wn)[None] * _L0) \
            ** (-alpha[:, None])
        density = c(self.press) * inputs.BAR / temp / inputs.K_BOLTZ
        ec = ec + density[:, :, None] * cs[:, None, :]
        # The deck: its layer and radius at 10**log_p_cl bar.
        ptop = 10.0 ** self._param(st['params'], 'log_p_cl',
                                   self.config['log_p_cl'])
        itop = np.searchsorted(self.press, ptop, side='left')
        itop = np.where(ptop >= self.press[-1], nl - 1, itop)
        itop = np.clip(itop, 1, nl - 1)
        rsurf = np.array([np.interp(p, self.press, r)
                          for p, r in zip(ptop, st['radius'])], self.dt)
        return ec, itop, rsurf

    def transit(self, ec, radius, deck_itop, deck_rsurf):
        """(Rp/Rs)^2 spectra [B, W]: chord optical depths on the radius
        normalized by rplanet, each column integrated down to the first
        layer past maxdepth or to the deck, with the deck's splice."""
        c, op = self._c, self._op
        nb, nl, nw = ec.shape
        rscale = self.rplanet
        rr = radius / rscale
        r2 = rr**2
        s = np.sqrt(np.maximum(r2[:, None, :] - r2[:, :, None], 0.0))
        seg = s[..., :-1] - s[..., 1:]
        rows = np.arange(nl)[:, None]
        cols = np.arange(nl - 1)[None, :]
        path = np.where((cols < rows)[None], seg, 0.0) * rscale
        path2 = np.zeros((nb, nl, nl), self.dt)
        path2[:, :, 1:] += path
        path2[:, :, :-1] += path
        depth = op(path2) @ op(ec)
        ibottom = deck_itop + 1
        in_range = np.arange(nl)[None, :, None] < ibottom[:, None, None]
        depth = np.where(in_range, depth, 0.0)
        exceeded = (depth > self.maxdepth) & in_range
        first = np.argmax(exceeded, axis=1)
        ideep = np.where(np.any(exceeded, axis=1), first,
                         (ibottom - 1)[:, None])
        integ = np.exp(-depth) * rr[:, :, None]
        h = np.diff(rr, axis=1)
        b = np.arange(nb)
        j = deck_itop - 1
        rsurf = deck_rsurf / rscale
        w = (rr[b, j] - rsurf) / (rr[b, j] - rr[b, j + 1])
        integ[b, j + 1] = integ[b, j] * (1.0 - w)[:, None] \
            + integ[b, j + 1] * w[:, None]
        h[b, j] = rsurf - rr[b, j]
        # The trapezoid as one contraction over the layers: coefficient
        # 0.5 h_k of layers k and k+1 of each segment k above ideep.
        seg_ok = np.arange(nl - 1)[None, :, None] < ideep[:, None, :]
        half = 0.5 * h[:, :, None] * seg_ok
        coef = np.zeros((nb, nl, nw), self.dt)
        coef[:, :-1] += half
        coef[:, 1:] += half
        integral = np.einsum('blw,blw->bw', op(integ), op(coef))
        rstar = c(self.rstar / rscale)
        return c((rr[:, :1]**2 + 2.0 * integral) / rstar**2)

    @np.errstate(invalid='ignore', over='ignore', divide='ignore')
    def forward(self, params):
        """dict(spectrum [B, W], bandflux [B, nbands], temp, radius,
        good [B]) of B chains (non-finite where a radius diverges)."""
        st = self.state(params)
        ec, itop, rsurf = self.extinction(st)
        spec = self.transit(ec, st['radius'], itop, rsurf)
        temp = st['temp']
        good = ((temp.min(axis=1) >= self.tmin_bound)
                & (temp.max(axis=1) <= self.tmax_bound)
                & (temp.min(axis=1) > 0))
        spec = np.where(good[:, None], spec, 0.0)
        band = self._c(self._op(spec) @ self._op(self.bands).T)
        return dict(spectrum=spec, bandflux=band, temp=temp,
                    radius=st['radius'], good=good)

    @np.errstate(invalid='ignore', over='ignore')
    def log_post(self, params, data, uncert, block=16):
        """Log-posterior [B] of B chains, in blocks of `block` chains:
        -chi^2 / 2 of the band fluxes, -inf outside the prior box, for a
        rejected profile or a non-finite likelihood."""
        params = np.atleast_2d(np.asarray(params, float))
        out = np.empty(len(params))
        for lo in range(0, len(params), block):
            p = params[lo:lo + block]
            fwd = self.forward(p)
            resid = (fwd['bandflux'] - data[None]) / uncert[None]
            like = -0.5 * np.sum(resid**2, axis=1)
            inside = np.all((p >= self.pmin) & (p <= self.pmax), axis=1)
            bad = ~inside | ~fwd['good'] | ~np.isfinite(like)
            out[lo:lo + block] = np.where(bad, -np.inf, like)
        return out
