"""The readings of the equilibrium cells' per-layer metrics, from what a
run records: the program's pbt.state.chem spans and pbt.chem.systems
counter (program_spans.record), the profiled chunk's trace reduced by
chem_trace.py, and the work of counts_chem.py.  Each portbench/metrics/
<metric>.py names the function here that reads it; a reading returns None
where the run recorded nothing for it (a program without the span, the
counter or the solve kernel)."""
import statistics

from . import chem_trace, counts, counts_chem, program_spans, trace

__all__ = ['chem_spans', 'chem_device_ms', 'chem_launches_per_forward',
           'chem_roofline_share', 'demc_step_mfu_eq']


def chem_spans(spans=None):
    """The pbt.state.chem spans of the program's last pbt.demc.run (the
    profiled chunk's forwards)."""
    found = program_spans.last_run(spans)
    if found is None:
        return []
    return [s for s in found[1] if s.name == chem_trace.SPAN]


def chem_device_ms(ctx, spans=None):
    """The median ms between the device's arrival at a pbt.state.chem
    span's start mark and at its end mark."""
    ms = [(s.d1 - s.d0) * 1e-6 for s in chem_spans(spans)
          if s.d0 is not None]
    return statistics.median(ms) if ms else None


def chem_launches_per_forward(ctx):
    """Device kernels, copies and sets launched inside the profiled
    chunk's pbt.state.chem spans, over its annotated forwards."""
    prof = ctx.get('profile')
    if not prof or not prof['annotations'] \
            or not prof.get(chem_trace.SPAN, {}).get('spans'):
        return None
    return prof[chem_trace.SPAN]['launches'] / prof['annotations']


def chem_roofline_share(ctx, spans=None):
    """The solve kernel's share of its roofline (%): counts_chem.py's
    least time for the systems a pbt.state.chem span solves (its
    pbt.chem.systems, the median over the last run) at the float64 peak
    the configuration's work names, over the device ms a launch of the
    kernels it lists under kernels.chem."""
    prof = ctx.get('profile')
    kernels = ctx['config'].get('kernels', {}).get('chem')
    timed = trace.kernel_ms(prof, kernels) if prof and kernels else None
    systems = [s.counts['pbt.chem.systems'] for s in chem_spans(spans)
               if 'pbt.chem.systems' in s.counts]
    if timed is None or timed[0] <= 0 or not systems:
        return None
    work = ctx['config']['work']
    nlayers = ctx['shape']['nlayers']
    flops, nbytes = counts_chem.solve_work(
        work, statistics.median(systems) // nlayers, nlayers)
    bound, _ = counts_chem.bound_ms(flops, nbytes, work['chem_peak'],
                                    counts.peaks()['bytes_per_s'])
    return 100.0 * bound / timed[0]


def demc_step_mfu_eq(ctx):
    """The whole DEMC step's share of the card's peaks (%): the window's
    forwards (each chunk's initial one included) x (counts.py's float32
    operations of a forward at the float32 peak the configuration's work
    names + counts_chem.py's float64 operations of its solve at the
    float64 peak it names), over the window's seconds x the cards."""
    window = ctx.get('window')
    if not window or not window.get('forwards'):
        return None
    shape, work = ctx['shape'], ctx['config']['work']
    t32 = counts.forward_flops(shape) / counts.peaks()[shape['peak']]
    f64, _ = counts_chem.solve_work(work, shape['nchains'], shape['nlayers'])
    t64 = f64 / counts_chem.peaks()[work['chem_peak']]
    return 100.0 * window['forwards'] * (t32 + t64) / (
        window['seconds'] * ctx['chips'])
