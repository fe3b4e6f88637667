"""GPU smoke run of pyratbay_tpu_torch: the flagship transit and eclipse
retrievals end to end on one CUDA device, through the hand-written
transit and emission kernels.

    python3 chip_smoke.py              # one GPU; exits non-zero on any failure
    python3 chip_smoke.py --profile    # also print torch.profiler breakdowns

Phases, one JSON line each: device, kernel build, then for each path
(transit, then eclipse): the path's kernel against its plain PyTorch
version at the flagship's shapes (51 layers x 3209 wavenumbers, B = 512
with and without the deck, and B = 1), the main path (python -m
pyratbay_tpu_torch's driver on a flagship retrieval config with 512
chains, checked for finite results and kernel launches), float32-GPU
against float64-CPU agreement, and timings.  The line before the last
is the kernel table; the last line is the result.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NLAYERS, NWAVE = 51, 3209   # the flagship's full width
NCHAINS = 512
NGEN = 20
NOISE = 30e-6          # transit: 30 ppm, as bench.py's synthetic data
ECLIPSE_NOISE = 0.03   # eclipse: 3% of each band, as bench.py's eclipse rate
FORWARD_TOL = 1e-4     # flagship batched bound of tests/test_tpu_hw.py
# Kernel against plain, relative to the row maximum: the transit and
# emission bounds of tests/test_tpu_hw.py.
KERNELS = {
    'transit': dict(
        name='transit_rt', tol=2e-5,
        source='pyratbay_tpu_torch/csrc/transit_rt.cu',
        replaces='pyratbay_tpu/spectrum/ensemble_pallas.py:299',
        also_replaces='pyratbay_tpu/spectrum/rt_pallas.py:221'),
    'eclipse': dict(
        name='emission_rt', tol=1e-4,
        source='pyratbay_tpu_torch/csrc/emission_rt.cu',
        replaces='pyratbay_tpu/spectrum/emission_pallas.py:433'),
}


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def fail(message):
    print(f'chip_smoke: FAILED: {message}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_times(fn, repeats=10, warmup=3):
    """Milliseconds of each of `repeats` calls of fn() on the current
    stream (CUDA events), after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def paired_ms(fns, repeats=10):
    """Median milliseconds of each named function, timed in turns
    (a, b, b, a) so that a drift of the card's clock hits both."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name] += cuda_times(fns[name], repeats)
    return {name: float(np.median(t)) for name, t in times.items()}


def rel_err(got, want):
    """(max |got - want| / row max |want|, max |got - want|) over the
    rows where `want` is finite and not all zero; inf when the
    non-finite entries of the two differ (a rejected chain may carry
    NaN in both) or when a row of zeros (a rejected chain of the
    forward) is not zero in both."""
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        return np.inf, np.inf
    rows = np.all(np.isfinite(want), axis=-1)
    scale = np.abs(np.where(np.isfinite(want), want, 0)).max(axis=-1)
    zero = rows & (scale == 0)
    if np.any(got[zero] != 0):
        return np.inf, np.inf
    rows &= scale > 0
    if not rows.any():
        return np.inf, np.inf
    diff = np.abs(got[rows] - want[rows])
    return float(np.max(diff / scale[rows, None])), float(np.max(diff))


def write_retrieval_cfg(src_cfg, dst_cfg, data, uncert, filters, logfile):
    """The flagship config as a retrieval run with data and sampler
    settings."""
    with open(src_cfg) as f:
        lines = f.read().splitlines()
    out = []
    for line in lines:
        if line.startswith('runmode'):
            line = 'runmode = retrieval'
        elif line.startswith('logfile'):
            line = f'logfile = {logfile}'
        out.append(line)
    out += [
        'data = ' + ' '.join(f'{d:.10e}' for d in data),
        'uncert = ' + ' '.join(f'{u:.10e}' for u in uncert),
        'filters =',
        *[f'    {entry}' for entry in filters],
        f'nchains = {NCHAINS}',
        f'nsamples = {NCHAINS * NGEN}',
        'burnin = 2',
    ]
    with open(dst_cfg, 'w') as f:
        f.write('\n'.join(out) + '\n')


def record_call(module, name, fn):
    """Run fn() with module.<name> wrapped; return the (args, kwargs)
    of its last call."""
    recorded = {}
    real = getattr(module, name)

    def recorder(*a, **kw):
        recorded['call'] = (a, kw)
        return real(*a, **kw)

    setattr(module, name, recorder)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return recorded['call']


def transit_cases(tk, model, call):
    """Kernel operands of the transit main path at B = 512 (with and
    without the deck) and B = 1: name -> (args, kwargs)."""
    import torch
    (parts, path, rr, rstar, itop, ibottom), kw = call
    common = dict(cia_w=kw['cia_w'], cia_tab=kw['cia_tab'],
                  r1_cols=kw['r1_cols'], r1_rows=kw['r1_rows'],
                  maxdepth=kw['maxdepth'])
    nolayers = torch.full_like(ibottom, model.nlayers)
    return {
        'B512_deck': ((parts, *tk.prep_chains(
            path, rr, rstar, itop, ibottom, kw['deck_itop'],
            kw['deck_rsurf'])), common),
        'B512_nodeck': ((parts, *tk.prep_chains(
            path, rr, rstar, itop, nolayers)), common),
        'B1_deck': (([p[:1] for p in parts], *tk.prep_chains(
            path[:1], rr[:1], rstar, itop[:1], ibottom[:1],
            kw['deck_itop'][:1], kw['deck_rsurf'][:1])), first_chain(common)),
    }


def emission_cases(ek, model, call):
    """Kernel operands of the eclipse main path at B = 512 (with and
    without the deck) and B = 1: name -> (args, kwargs)."""
    (parts, radius, temp, wn, mu, weights, itop, ibottom), kw = call
    common = dict(cia_w=kw['cia_w'], cia_tab=kw['cia_tab'],
                  r1_cols=kw['r1_cols'], r1_rows=kw['r1_rows'],
                  maxdepth=kw['maxdepth'])
    angles = (wn, mu, weights)
    return {
        'B512_deck': ((parts, *ek.prep_emission_chains(
            radius, temp, itop, ibottom, kw['deck_itop'],
            kw['deck_tsurf']), *angles), common),
        'B512_nodeck': ((parts, *ek.prep_emission_chains(
            radius, temp, itop, model.nlayers), *angles), common),
        'B1_deck': (([p[:1] for p in parts], *ek.prep_emission_chains(
            radius[:1], temp[:1], itop[:1], ibottom[:1],
            kw['deck_itop'][:1], kw['deck_tsurf'][:1]), *angles),
            first_chain(common)),
    }


def first_chain(common):
    return {k: (v[:1] if k in ('cia_w', 'r1_cols', 'r1_rows') else v)
            for k, v in common.items()}


def check_kernel(name, kernel, plain, cases, tol):
    """Each case through the kernel and its plain version; returns the
    largest absolute difference.  Fails beyond `tol` of the row max."""
    import torch
    max_abs = 0.0
    for case, (args, kw) in cases.items():
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        rel, absolute = rel_err(got, want)
        max_abs = max(max_abs, absolute)
        emit('kernel_check', kernel=name, case=case, shape=list(got.shape),
             finite_rows=int(torch.isfinite(got).all(dim=1).sum()),
             max_rel_err=rel, max_abs_err=absolute, tol=tol)
        if not rel < tol:
            fail(f'{name} {case}: kernel disagrees with plain ({rel})')
    return max_abs


def run_path(label, rt_path, workdir, dev, args, card):
    """One path end to end: kernel checks, the main path through the
    driver, GPU against CPU, and timings.  Returns the kernel entry."""
    import torch
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.retrieval.batched import (
        build_forward_batched, build_log_posterior_batched,
    )
    from pyratbay_tpu_torch.retrieval.samplers import sample_demc
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    spec = KERNELS[label]
    suffix = '' if label == 'transit' else f'_{label}'
    if label == 'transit':
        wrapper, make_cases = 'transit_spectrum_ensemble', transit_cases
        kernel, plain, mod = tk.transit_rt_cuda, tk.transit_rt_plain, tk
    else:
        wrapper, make_cases = 'emission_flux_ensemble', emission_cases
        kernel, plain, mod = ek.emission_rt_cuda, ek.emission_rt_plain, ek
    counters = (tk.transit_rt_cuda, ek.emission_rt_cuda)

    # Flagship at full width on the GPU:
    model, obs, ret, forward, p0 = make_flagship(
        workdir, device=dev, rt_path=rt_path)
    if (model.nlayers, model.nwave) != (NLAYERS, NWAVE):
        fail(f'{label} flagship shape {(model.nlayers, model.nwave)}')
    rng = np.random.default_rng(0)
    pb = p0 + ret.pstep * rng.standard_normal((NCHAINS, len(p0)))
    pb = np.clip(pb, ret.pmin, ret.pmax)
    forward_b = build_forward_batched(model, obs, ret)

    # The kernel against its plain version on the operands the main
    # path hands it (recorded from one B = 512 forward):
    call = record_call(model_mod, wrapper, lambda: forward_b(pb))
    cases = make_cases(mod, model, call)
    max_abs = check_kernel(spec['name'], kernel, plain, cases, spec['tol'])

    # The main path, through the driver:
    band0 = forward(p0)['bandflux'].cpu().numpy()
    if label == 'transit':
        uncert = np.full(len(band0), NOISE)
    else:
        uncert = np.maximum(np.abs(band0) * ECLIPSE_NOISE, 1e-12)
    data = band0 + np.random.default_rng(1).normal(0, uncert)
    filters = [f'tophat {band.wl0:.4f} {band.half_width}'
               for band in obs.filters]
    cfg_file = os.path.join(workdir, 'retrieval.cfg')
    write_retrieval_cfg(
        os.path.join(workdir, 'flagship.cfg'), cfg_file, data, uncert,
        filters, os.path.join(workdir, 'retrieval.log'))
    for counter in counters:
        counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rmodel = run(cfg_file, device=dev, seed=0)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = kernel.launches
    all_launches = {c.__name__: c.launches for c in counters}
    out = np.load(os.path.join(workdir, 'retrieval.npz'))
    finite = {k: bool(np.all(np.isfinite(out[k])))
              for k in ('posterior', 'bestp', 'spec_best', 'bandflux_best')}
    emit('main_path' + suffix, rt_path=rt_path, seconds=main_s,
         nchains=NCHAINS, generations=NGEN, nlayers=rmodel.nlayers,
         nwave=rmodel.nwave, acceptance_rate=float(out['acceptance_rate']),
         best_log_post=float(out['best_log_post']),
         posterior_shape=list(out['posterior'].shape),
         launches=all_launches, finite=finite)
    if not all(finite.values()):
        fail(f'{label}: non-finite retrieval output {finite}')
    if not float(out['acceptance_rate']) > 0:
        fail(f'{label}: acceptance rate is 0')
    if out['spec_best'].shape != (NWAVE,):
        fail(f'{label}: spec_best shape {out["spec_best"].shape}')
    if launches < NGEN + 2:
        fail(f'{label}: {launches} {spec["name"]} launches < {NGEN + 2}')

    # GPU float32 forward against the CPU float64 plain forward:
    cpu_model = model_mod.Model(os.path.join(workdir, 'flagship.cfg'))
    cpu_obs = Observation(obs_cfg(obs), cpu_model.wn)
    cpu_ret = RetrievalParams(cpu_model, cpu_obs)
    p8 = pb[:8]
    spec_gpu = forward_b(p8)['spectrum']
    spec_cpu = build_forward_batched(cpu_model, cpu_obs, cpu_ret)(
        p8)['spectrum']
    fwd_rel, fwd_abs = rel_err(spec_gpu, spec_cpu)
    emit('gpu_vs_cpu' + suffix, chains=8, max_rel_err=fwd_rel,
         max_abs_err=fwd_abs, tol=FORWARD_TOL)
    if not fwd_rel < FORWARD_TOL:
        fail(f'{label}: GPU f32 forward disagrees with CPU f64 ({fwd_rel})')

    # Times (CUDA events, medians after warm-up):
    c_args, c_kw = cases['B512_deck']
    ms = paired_ms({
        'plain': lambda: plain(*c_args, **c_kw),
        'kernel': lambda: kernel(*c_args, **c_kw),
    })
    pb_t = torch.as_tensor(pb, dtype=torch.float32, device=dev)
    with torch.no_grad():
        ms_forward = float(np.median(cuda_times(lambda: forward_b(pb_t))))
    log_post_b = build_log_posterior_batched(rmodel, rmodel.obs, rmodel.ret)
    gens = 10
    gen_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_demc(log_post_b, rmodel.ret.params,
                    nsamples=NCHAINS * gens, nchains=NCHAINS,
                    pstep=rmodel.ret.pstep, pmin=rmodel.ret.pmin,
                    pmax=rmodel.ret.pmax, device=dev, dtype=rmodel.dtype)
        torch.cuda.synchronize()
        gen_times.append(time.perf_counter() - t0)
    emit('times', path=label, card=card, kernel=spec['name'],
         kernel_ms=ms['kernel'], plain_ms=ms['plain'],
         forward_ms=ms_forward,
         forward_spectra_per_s=NCHAINS / (ms_forward * 1e-3),
         demc_generations_per_s=gens / float(np.median(gen_times)),
         demc_note='includes the initial ensemble evaluation and the '
                   'history copy to the host')

    if args.profile:
        profile(label, forward_b, pb_t, ms_forward)

    entry = {'name': spec['name'], 'route': 'cuda', 'source': spec['source'],
             'replaces': spec['replaces']}
    if 'also_replaces' in spec:
        entry['also_replaces'] = spec['also_replaces']
    entry.update(launches=launches, max_abs_err=max_abs, ms=ms['kernel'],
                 plain_ms=ms['plain'])
    return entry


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--profile', action='store_true',
                        help='also print torch.profiler kernel breakdowns')
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(HERE, 'pyratbay_tpu_torch')):
        fail('pyratbay_tpu_torch/ is not beside this script: run it from '
             'the root of a checkout')
    sys.path.insert(0, HERE)

    import torch
    # Device:
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else 'nvidia-smi unavailable'
    print(card, flush=True)
    dev = torch.device('cuda')
    emit('device', name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False

    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    # Build the kernels from the sources in this checkout (one nvcc per
    # source, in parallel, then one link):
    t0 = time.perf_counter()
    lib_path = tk.build_library()
    tk._library()
    build_s = time.perf_counter() - t0
    with open(os.path.join(os.path.dirname(lib_path), 'build.log')) as f:
        ptxas = [ln.strip() for ln in f
                 if 'registers' in ln or 'spill' in ln or 'smem' in ln]
    emit('build', seconds=build_s, library=os.path.relpath(lib_path),
         ptxas=ptxas)

    workdir = tempfile.mkdtemp(prefix='pbt_chip_smoke_')
    try:
        kernels = []
        for label, rt_path in (('transit', 'transit'), ('eclipse', 'eclipse')):
            path_dir = os.path.join(workdir, label)
            os.makedirs(path_dir)
            kernels.append(run_path(label, rt_path, path_dir, dev, args, card))
        print(json.dumps({'kernels': kernels}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def obs_cfg(obs):
    """A config-like object carrying an Observation's tophat filters."""
    class _Cfg:
        data = uncert = obsfile = dunits = None
        offset_inst = uncert_scaling = None
        filters = [f'tophat {band.wl0:.4f} {band.half_width}'
                   for band in obs.filters]
    return _Cfg


def profile(label, forward_b, pb_t, ms_forward, reps=3):
    """Device-time breakdown of one B = 512 forward (torch.profiler):
    the device kernels by self time, their launches, and the device's
    busy share of the forward's CUDA-event time `ms_forward`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    with torch.no_grad(), tprofile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward_b(pb_t)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        # Device-side events only (the host ops that launched them carry
        # the same time again):
        if evt.device_type != DeviceType.CPU:
            rows.append((evt.device_time_total / reps, evt.key,
                         evt.count / reps))
    rows.sort(reverse=True)
    busy_us = sum(us for us, _, _ in rows)
    emit('profile', path=label, device_busy_us=busy_us,
         device_kernels=sum(calls for _, _, calls in rows),
         forward_us=ms_forward * 1e3,
         device_idle_share=1.0 - busy_us / (ms_forward * 1e3),
         per_forward_device_us=[
             {'name': name[:80], 'us': us, 'calls': calls}
             for us, name, calls in rows[:15]])


if __name__ == '__main__':
    main()
