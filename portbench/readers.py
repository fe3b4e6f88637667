"""The readings of the per-layer metrics from what a run records (its
ctx): each portbench/metrics/<metric>.py names the function here that
reads it.  A reading returns None when the run recorded nothing for it."""
from . import counts, trace

__all__ = ['sampler_ms_per_gen', 'forward_ms', 'launches_per_call',
           'k1_roofline_share', 'demc_step_mfu', 'device_idle_share']


def sampler_ms_per_gen(ctx):
    """The sampler's own ms a generation: the spans phase's wall time less
    the time inside the log-posterior calls (each span ends in a
    synchronize of the card), over its generations."""
    s = ctx.get('sampler')
    if not s or not s['generations']:
        return None
    return (s['wall_s'] - s['log_post_s']) / s['generations'] * 1e3


def forward_ms(ctx):
    """The mean of the CUDA-event ms around the spans phase's
    log-posterior calls, at the ensemble's batch."""
    ms = ctx.get('forward_event_ms')
    return sum(ms) / len(ms) if ms else None


def launches_per_call(ctx):
    """Device kernels and copies launched inside the profiled calls'
    annotations, over the calls recorded."""
    prof = ctx.get('profile')
    if not prof or not prof['annotations']:
        return None
    return prof['annotated_launches'] / prof['annotations']


def k1_roofline_share(ctx):
    """K1's share of its roofline (%): counts.py's bound of the ensemble
    at the cell's shapes over the device ms a launch of the kernels the
    configuration names under kernels.ensemble."""
    return trace.roofline_share(ctx, 'ensemble', 'transit_work')


def demc_step_mfu(ctx):
    """The whole DEMC step's share of the cards' peak (%), the peak the
    configuration's work names:
    counts.py's operations of a forward at the cell's shapes times the
    window's forwards (each chunk's initial one included) over the
    window's seconds x the peak x the cards."""
    window = ctx.get('window')
    if not window or not window.get('forwards'):
        return None
    flops = counts.forward_flops(ctx['shape']) * window['forwards']
    peak = counts.peaks()[ctx['shape']['peak']]
    return 100.0 * flops / (window['seconds'] * peak * ctx['chips'])


def device_idle_share(ctx):
    """1 less the union of the device's intervals over the profiled
    phase's window (%)."""
    prof = ctx.get('profile')
    if not prof or not prof['window_s']:
        return None
    return 100.0 * (1.0 - prof['busy_s'] / prof['window_s'])
