"""Plotting: spectra, contribution functions, temperature profiles,
abundances, and posterior distributions.

Copy of pyratbay_tpu/plots.py (host matplotlib, imported when a figure
is made; the retrieval's post-processing logs a warning where it is
missing).
"""
import numpy as np

__all__ = [
    'Theme',
    'THEMES',
    'get_theme',
    'spectrum',
    'temperature',
    'abundance',
    'contribution',
    'posteriors',
    'alphatize',
]


def _mpl():
    import matplotlib
    matplotlib.use('Agg', force=False)
    import matplotlib.pyplot as plt
    return plt


class Theme:
    """Color theme for posterior/temperature figures (the capability
    of mc3's plot themes, which the reference passes around as
    `theme`; reference plots.py:92-718 + mc3.plots)."""

    def __init__(self, color, light=None, dark=None):
        import matplotlib.colors as mc
        self.color = color
        rgb = np.array(mc.to_rgb(color))
        self.light_color = light if light is not None else tuple(
            0.35 * rgb + 0.65)
        self.dark_color = dark if dark is not None else tuple(0.6 * rgb)
        self.colormap = self._make_cmap(rgb)

    def _make_cmap(self, rgb):
        from matplotlib.colors import LinearSegmentedColormap
        return LinearSegmentedColormap.from_list(
            'theme', [(1.0, 1.0, 1.0), tuple(rgb), self.dark_color],
        )


THEMES = {
    name: Theme(color) for name, color in [
        ('blue', 'xkcd:blue'),
        ('green', 'xkcd:green'),
        ('orange', 'darkorange'),
        ('purple', 'xkcd:violet'),
        ('red', 'xkcd:red'),
        ('black', '0.3'),
        ('indigo', 'xkcd:indigo'),
    ]
}


def get_theme(theme):
    """Resolve a theme name / color string / Theme instance."""
    if isinstance(theme, Theme):
        return theme
    if theme is None:
        return THEMES['blue']
    if theme in THEMES:
        return THEMES[theme]
    return Theme(theme)


def alphatize(colors, alpha, background='white'):
    """Blend colors toward a background as if drawn with given alpha."""
    import matplotlib.colors as mc
    single = isinstance(colors, str)
    if single:
        colors = [colors]
    bg = np.array(mc.to_rgb(background))
    out = [
        tuple(alpha * np.array(mc.to_rgb(c)) + (1 - alpha) * bg)
        for c in colors
    ]
    return out[0] if single else out


_DEPTH_UNITS = {'none': 1.0, 'percent': 100.0, 'ppt': 1e3, 'ppm': 1e6}


def spectrum(
        spectrum, wl, rt_path='transit',
        data=None, uncert=None, band_wl=None, bandflux=None,
        bands=None, units=None, theme=None,
        logxticks=None, gaussbin=2.0, yran=None, filename=None, ax=None,
    ):
    """Plot a transmission/emission/eclipse spectrum (+ data points).

    bands: optional list of (wl, response) passband curves, drawn as
        shaded profiles along the bottom axis (reference
        plots.py:92-298 band-depth overlay).
    units: depth units 'none'/'percent'/'ppt'/'ppm' (defaults:
        percent for transit, ppm for eclipse).
    theme: Theme/name/color for the model curve.
    """
    from scipy.ndimage import gaussian_filter1d
    plt = _mpl()
    thm = get_theme(theme)
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4.5), constrained_layout=True)
    if rt_path == 'transit':
        units = units or 'percent'
        scale = _DEPTH_UNITS[units]
        label = f'Transit depth (Rp/Rs)$^2$ ({units})'
    elif rt_path == 'eclipse':
        units = units or 'ppm'
        scale = _DEPTH_UNITS[units]
        label = f'Eclipse depth Fp/Fs ({units})'
    else:
        scale, label = 1.0, r'Flux (erg s$^{-1}$ cm$^{-2}$ cm)'
    smooth = gaussian_filter1d(spectrum, gaussbin) if gaussbin else spectrum
    ax.plot(wl, scale * np.asarray(smooth), color=thm.color, lw=1.0,
            label='model')
    if bandflux is not None and band_wl is not None:
        ax.plot(band_wl, scale * np.asarray(bandflux), 'o', ms=4,
                color='orange', mec='k', mew=0.5, label='band-integrated')
    if data is not None and band_wl is not None:
        ax.errorbar(
            band_wl, scale * np.asarray(data),
            yerr=None if uncert is None else scale * np.asarray(uncert),
            fmt='o', ms=4, color='0.2', ecolor='0.4', label='data',
        )
    ax.set_xscale('log')
    if logxticks is not None:
        ax.set_xticks(logxticks)
        ax.get_xaxis().set_major_formatter(
            __import__('matplotlib').ticker.ScalarFormatter())
    if yran is not None:
        ax.set_ylim(yran)
    ax.set_xlabel('Wavelength (um)')
    ax.set_ylabel(label)
    if bands is not None:
        # Filter response profiles along the bottom (reference-style
        # band overlay): scaled to 12% of the axis height.
        ylim = ax.get_ylim()
        height = 0.12 * (ylim[1] - ylim[0])
        for band in bands:
            bwl, resp = np.asarray(band[0]), np.asarray(band[1])
            resp = resp / resp.max() if resp.max() > 0 else resp
            ax.fill_between(
                bwl, ylim[0], ylim[0] + height * resp,
                color=thm.light_color, alpha=0.7, lw=0.0, zorder=0,
            )
        ax.set_ylim(ylim)
    ax.legend(loc='best', fontsize=9)
    if filename is not None:
        ax.figure.savefig(filename, dpi=150)
    return ax


def temperature(
        pressure, profiles=None, labels=None, bounds=None,
        theme=None, filename=None, ax=None,
    ):
    """Plot temperature profiles (with optional credible-region bounds).

    pressure in bar; profiles: array or list of [nlayers] arrays;
    bounds: (low1, high1[, low2, high2]) interquantile envelopes.
    """
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 5.5), constrained_layout=True)
    if profiles is not None:
        profiles = np.atleast_2d(np.asarray(profiles))
        for i, prof in enumerate(profiles):
            label = labels[i] if labels is not None else None
            ax.plot(prof, pressure, lw=1.5, label=label)
    if bounds is not None and len(bounds) >= 2:
        thm = get_theme(theme)
        ax.fill_betweenx(
            pressure, bounds[0], bounds[1], alpha=0.45,
            color=thm.light_color, lw=0,
        )
        if len(bounds) == 4:
            ax.fill_betweenx(
                pressure, bounds[2], bounds[3], alpha=0.3,
                color=thm.light_color, lw=0,
            )
    ax.set_yscale('log')
    ax.invert_yaxis()
    ax.set_xlabel('Temperature (K)')
    ax.set_ylabel('Pressure (bar)')
    if labels is not None:
        ax.legend(loc='best', fontsize=9)
    if filename is not None:
        ax.figure.savefig(filename, dpi=150)
    return ax


def abundance(
        vmr, pressure, species, colors=None, xlim=None,
        filename=None, ax=None,
    ):
    """Plot VMR profiles [nlayers, nspecies] vs pressure (bar)."""
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 5.5), constrained_layout=True)
    vmr = np.asarray(vmr)
    for i, spec in enumerate(species):
        color = None if colors is None else colors[i % len(colors)]
        ax.plot(vmr[:, i], pressure, lw=1.5, label=spec, color=color)
    ax.set_xscale('log')
    ax.set_yscale('log')
    ax.invert_yaxis()
    if xlim is not None:
        ax.set_xlim(xlim)
    ax.set_xlabel('Volume mixing ratio')
    ax.set_ylabel('Pressure (bar)')
    ax.legend(loc='best', fontsize=8, ncol=2)
    if filename is not None:
        ax.figure.savefig(filename, dpi=150)
    return ax


def contribution(
        cf, wl, pressure, filename=None, ax=None,
    ):
    """Plot a contribution-function (or transmittance) map
    [nlayers, nwave] vs wavelength and pressure."""
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4.5), constrained_layout=True)
    mesh = ax.pcolormesh(
        wl, pressure, np.asarray(cf), cmap='viridis', shading='auto',
    )
    ax.set_yscale('log')
    ax.invert_yaxis()
    ax.set_xscale('log')
    ax.set_xlabel('Wavelength (um)')
    ax.set_ylabel('Pressure (bar)')
    ax.figure.colorbar(mesh, ax=ax, label='Contribution')
    if filename is not None:
        ax.figure.savefig(filename, dpi=150)
    return ax


def posteriors(
        posterior, pnames=None, bestp=None, nbins=30,
        theme=None, quantiles=(0.159, 0.841), smooth=1.2,
        filename=None,
    ):
    """Corner-style posterior pair grid (reference plots.py:719-960 +
    mc3 pairwise styling): themed marginal histograms with
    credible-interval markers on the diagonal, smoothed filled-contour
    density maps below it.

    quantiles: marginal interval edges drawn as dashed lines (defaults
        to the central 68.3%); None disables.
    smooth: gaussian smoothing (in bins) of the 2D histograms before
        contouring; 0 falls back to raw hist2d cells.
    """
    from scipy.ndimage import gaussian_filter
    plt = _mpl()
    thm = get_theme(theme)
    posterior = np.asarray(posterior)
    npars = posterior.shape[1]
    fig, axes = plt.subplots(
        npars, npars, figsize=(2.2 * npars, 2.2 * npars),
        constrained_layout=True, squeeze=False,
    )
    for i in range(npars):
        for j in range(npars):
            ax = axes[i][j]
            if j > i:
                ax.axis('off')
                continue
            if i == j:
                ax.hist(
                    posterior[:, i], bins=nbins, color=thm.light_color,
                    edgecolor=thm.color, density=True,
                )
                if quantiles is not None:
                    for q in quantiles:
                        ax.axvline(
                            np.quantile(posterior[:, i], q),
                            color=thm.dark_color, lw=0.9, ls='--',
                        )
                    ax.axvline(
                        np.median(posterior[:, i]),
                        color=thm.dark_color, lw=1.1,
                    )
                if bestp is not None:
                    ax.axvline(bestp[i], color='crimson', lw=1.2)
            else:
                hist, xe, ye = np.histogram2d(
                    posterior[:, j], posterior[:, i], bins=nbins,
                )
                if smooth:
                    hist = gaussian_filter(hist, smooth)
                xc = 0.5 * (xe[:-1] + xe[1:])
                yc = 0.5 * (ye[:-1] + ye[1:])
                levels = np.linspace(0.0, hist.max() or 1.0, 9)[1:]
                ax.contourf(
                    xc, yc, hist.T, levels=levels, cmap=thm.colormap,
                    extend='min',
                )
                if bestp is not None:
                    ax.plot(bestp[j], bestp[i], '+', color='crimson')
            if i == npars - 1 and pnames is not None:
                ax.set_xlabel(pnames[j], fontsize=8)
            if j == 0 and i > 0 and pnames is not None:
                ax.set_ylabel(pnames[i], fontsize=8)
            ax.tick_params(labelsize=7)
    if filename is not None:
        fig.savefig(filename, dpi=120)
    return axes
