"""GPU smoke run of pyratbay_tpu_torch: the flagship transit and eclipse
retrievals end to end on one CUDA device, through the hand-written
transit and emission kernels, then the transit retrieval on 81 layers
through the transit kernel's tall function, then forward spectra from
configs (runmode = spectrum and atmosphere) through the one-chain
transit kernel (K2) and the emission kernel, then retrievals as users
run them (passbands from filter files and the bundled library, checkpoints and resume, the post-processing
and --post), then the flagship opacity workflow (line list -> TLI file
-> cross-section table) through the hand-written line-by-line wing and
core kernels, then a high-resolution eclipse retrieval with a
stellar-model star on a 39,200-point table.

    python3 chip_smoke.py              # one GPU; exits non-zero on any failure
    python3 chip_smoke.py --profile    # also print torch.profiler breakdowns
    python3 chip_smoke.py --seed 2     # another noise draw of hires_eclipse

Phases, one JSON line each: device, kernel build, then for each path
(transit, then eclipse): the path's kernel against its plain PyTorch
version at the flagship's shapes (51 layers x 3209 wavenumbers): with
the line sample contracted in the kernel (B = 512 with and without the
deck, with a dense part beside it, with the top of the atmosphere
lowered by three layers, B = 500, B = 1, and eight chains of which one
is rejected) and with the line sample as a dense part (B = 512 with and
without the deck, B = 1); the main path (the entry point of python -m
pyratbay_tpu_torch on a flagship retrieval config with 512 chains,
checked for finite results and kernel launches); float32-GPU against float64-CPU
agreement; and timings: the kernel, its plain version and its roofline
bound at B = 512 and B = 1, its recorded time before it was redesigned
(a constant, labelled so), and the two line-sample routes in turns
(einsum + contiguous copy + kernel on a dense part, against the kernel
on weights and table).  On the transit paths also K2, the one-chain
kernel that Model.run (the best fit) launches, against its plain version
on chain 0's raw operands (deck, no deck, no maxdepth, the line sample
made a dense part, a second chain with +inf top radii), and its times
(times_one_chain: the whole wrapper, its device ms and device launches a
call, what the wrapper did before (K1 after prep_chains), the device ms
at 4, 8, 16 and 32 warps a block, and K2 beside K1 at the nested walk's
12 and 25 chains).
Then the same for the transit retrieval on the
flagship written on 81 layers (81 x 3209, 512 chains x 20 generations), whose forwards launch the tall function with the line
sample inside it; its `times` line adds the chains the function keeps
in flight on an SM.  Then the transit_r115k path: the flagship at
constant R = 115,000 (make_flagship(resolution=), 51 x 50,062), 512
chains x 20 generations through the driver; K1 against its plain
version on the line-sample cases (no dense part: one would take 5.2
GB), K2 on chain 0, GPU float32 against CPU float64 on 4 chains; K1's
events, device and plain ms and bound, K2's, the forward's ms,
generations/s and the card's peak memory (its `times` and
`times_one_chain` lines; the kernel table carries them under
`at_transit_r115k`).  Then the spectrum path: the flagship (51 x 3209) as runmode = spectrum configs
with the bundled H2-H2 and H2-He CIA tables by basename (40 rows),
Rayleigh, the haze and a gray cloud (5 rank-1 terms), the deck, and the
specfile, through the CLI's driver on the default device: transit (one
launch of K2, the counterpart of the per-chain transit_spectrum_fused),
eclipse (one emission launch), patchy transit
(two launches), H- with Rayleigh of e- (6 rank-1 terms) on an
atmosphere the script writes, and that atmosphere on 81 layers (K2
too); each spectrum read back from its file
and held against a CPU float64 Model.run; runmode = atmosphere on the
flagship; the kernels against their plain versions at B = 512 and B = 1
(K2 on chain 0 of the B = 512 call) on each of those operand sets, and
at B = 512 on five dense parts (the
kernel on what the size rule fitted, the plain version on every
operand), the tall function also on the line sample made a dense part
(3 dense parts, the operands of its earlier version); and timings:
Model.run (and its spectrum stamp), the kernels at B = 1, the tall
function (on both operand
sets, with its profiler device time) and the emission kernel at B = 512
on 81 layers.  Then the model_io phase (run_model_io): the transit
retrieval's Model and the eclipse spectrum's saved with io.save_model,
reopened with io.load_model on the default device and run (K2, the
one-chain kernel, and K3); the spectra against the originals', the
result arrays exactly, K2
and K3 on the reopened models' operands against their plain versions,
the printed summary against a CPU float64 Model's, the ops helpers in
float32 on the card against the CPU in float64, and the seconds of the
save, the load and the reopened run (by the host clock and by
Model.timestamps).  Then the retrieval_post phase: the transit flagship's
data in 12 bands whose passbands are filter files the script writes,
run through the driver with a checkpoint after every chunk for 10
generations of 512 chains and resumed to 20 (the checkpoint's
generation and history checked), every numeric post-processing file
(temperature and spectrum envelopes, median atmosphere, band
contributions) held against the CPU in float64, the envelope's K1
launch at B = 128 against its plain version, `python -m
pyratbay_tpu_torch --post` in a process of its own, history_thin = 3
against an unthinned run, and generations/s with and without the
checkpoint in turns; then the eclipse flagship over 3.0-5.3 um with the
bundled Spitzer IRAC 1 and 2 passbands by name and two filter files,
10 generations and its post-processing (the emission band contributions)
against the CPU.  Then the opacity path:
a synthetic 50,000-line HITRAN H2O list through runmode = tli (the
driver), Model(cfg, device='cuda').compute_opacity(engine='direct') on
the flagship grid (10 T x 51 layers x 3209 points), the table read back
through io and LineSample, with K4 and K5 reading per-line factors by
line range (no factor tensor in the window layout is made); the wing
(K4, K6) and core (K5) kernels against their plain versions on one
main-path block, a production-width block (200,000 points), a
two-species case and a ragged cell count (K6 also at nspec = 2 on the
main-path block), the window-layout kernels of K4 and K5 too; K6's own
run (no user path launches it: its entry point lk.wing_sigma on that
block at nspec 1 and 2, whose launches its entry counts); the table
against a CPU float64 tabulation of 3 T x 4 layers; and timings: K4, K5
and K6 with their plain versions and bounds on a flagship block (K6 also
split over a block's warps and not, and at nspec = 2), K4 and K5 on a
production block, the per-line route against the
window-layout route in turns, three wing sub-tile widths, and one
species at the production width of the JAX bench's _production_table.
The spectrum phase also runs eclipse spectra with a Kurucz star (a
four-model .pck grid it writes) and a starspec SED, and transit and
eclipse spectra from the flagship's TLI file through the parity
line-by-line engine (host float64, one dense part to the kernels); the
opacity phase also runs the CLI's runmode = opacity (the parity engine,
3 of the 10 temperatures) in a process of its own and prints its
difference from the direct table.  Then the hires_eclipse phase (see
HIRES_WL): the direct table over 1.5-1.7 um at 0.02 cm-1 (K4, K5), the
eclipse flagship on it with a 7-temperature SED star and T_eff
retrieved, 6 bands and a 16,650-point high-res channel with rv_shift,
512 chains x 20 generations through the driver and its
post-processing; GPU float32 against CPU float64 at B = 512 (spectrum,
high-res fluxes, log-posterior), K3 against its plain version on 16
chains, and timings (forward, the high-res stage, K3, DEMC).  Then the
equilibrium phase (run_equilibrium): the transit flagship with
thermochemical equilibrium, [M/H] and C/O retrieved, 512 chains x 20
generations through the driver (K1 on every generation, the network
solved in float64 for every chain by one launch of the solve kernel,
csrc/chem_gibbs.cu, on every forward), K1 and K3 against their plain
versions on its operands, the solve kernel against the CPU float64
solve on the B = 512 forward's operands (its `kernels` entry: launches
by path, the bound of portbench/counts_chem.py, its largest
difference), GPU against CPU float64 at B = 512 (VMRs,
spectrum, log-posterior; the eclipse variant's forward through K3),
Model.run and runmode = atmosphere with the network, and timings (the
solve, the forward, the device's idle share, DEMC).  Then the radeq
phase (run_radeq): runmode = radeq through the driver, configured and
with equilibrium chemistry, each's first 10 iterations against a CPU
float64 run, a warm restart, the two-stream Model.run and a convective
run.  Then the nested phase (run_nested): the transit flagship with
sampler = multinest and nlive = 400 through the driver, its dead points
cut to 4,000 of the default 20,000 by wrapping the driver's
sample_nested (--nested-max-iter; 0 runs the default), K1 at every walk
step (B = 25) and at the live set's start (B = 400); finite logz,
logz_err and posterior inside the prior box; the best fit's and a first
scan step's float32 log-likelihoods against CPU float64; K1 against its
plain version at B = 25; a scan step that reads nothing back to the
host (torch.profiler); an analytic Gaussian's evidence on the card; and
timings (walk forwards/s, dead points/s, the run's seconds, launches a
walk step).  Then the lbl_retrieval phase (run_lbl_retrieval): the
transit flagship with H2O from make_lbl_flagship's 50,000-line TLI file
(the opacity phase's list) in place of the line sample, 512 chains x 10 generations through the
driver and its post-processing, every forward through the direct engine
(K4 and K5 on each budget-sized block of cells, then K1); K4 and K5
against their plain versions on one of the forward's blocks; GPU float32
against CPU float64 on 2 chains x 51 layers (extinction, spectrum,
log-posterior); and timings (the forward at B = 512, K4, K5 and the line
factors' device ms, peak memory, DEMC generations/s, K4 and K5 at the
retrieval's block).  Then the line_lists phase (run_line_lists): line
lists in every format the readers take (1,000,000 synthetic H2O lines as
HITRAN, ExoMol and repack files, 200,000 as P&S, Schwenke TiO and Plez
VO, 20,000 VALD Fe records) through runmode = tli and read back, the
native HITRAN parse and TLI range read against their numpy versions, the
ExoMol TLI into the direct table on the card (K4, K5: a block against
the plain versions, 4 cells against CPU float64) and through the parity
engine on the native grouping and scatter (each native function's call
count checked), the CLI's -cs hitran and -pf tips in processes of their
own, and a spectrum on the card (K2) from that table and the
CLI's CIA table against CPU float64.  Then the parallel phase
(run_parallel): the wave-sharded flagship retrieval (51 x 3209, 512
chains) on torch.distributed process groups whose ranks are new
interpreters sharing the card: a world-1 group (mesh (1, 1), NCCL), two
ranks on (1, 2) (gloo; K1 on 1,605 columns, the eclipse flagship's K3,
a few TLI forwards' K4 and K5 on each window) and on (2, 1) (K1 at 256
chains, the nested sampler with the mesh); each rank's kernels against
their plain versions on its own operands, the gathered log-posterior
against the unsharded one, generations/s and the collectives' ms; then
python -m pyratbay_tpu_torch.parallel.mp_probe.  The whole script's
seconds close the phases.
The line before the last is the kernel table; the last line is the
result.
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
        replaces='pyratbay_tpu/spectrum/ensemble_pallas.py:299'),
    'eclipse': dict(
        name='emission_rt', tol=1e-4,
        source='pyratbay_tpu_torch/csrc/emission_rt.cu',
        replaces='pyratbay_tpu/spectrum/emission_pallas.py:433'),
    # The flagship at constant R = 115,000 (51 x 50,062), through K1:
    'transit_r115k': dict(
        name='transit_rt', tol=2e-5,
        source='pyratbay_tpu_torch/csrc/transit_rt.cu',
        replaces='pyratbay_tpu/spectrum/ensemble_pallas.py:299'),
    # The transit kernel's function for more than 64 layers:
    'transit_81': dict(
        name='transit_rt_tall', tol=2e-5,
        source='pyratbay_tpu_torch/csrc/transit_rt.cu',
        replaces='pyratbay_tpu/spectrum/ensemble_pallas.py:299'),
}
# Constants, not measurements of a run of this script: the times of the
# one-thread-a-column kernels that the present ones replaced, B = 512 on a
# dense part, CUDA events around single calls, NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md, section 6); and of the tall function before its
# redesign, on the spectrum phase's 81-layer operands (3 dense parts, 4
# rank-1 terms, 32 CIA rows), CUDA events in turns.  Only the `times`
# and `times_spectrum` phases repeat them.
EARLIER_MS = {'transit': 2.286, 'eclipse': 1.341}
EARLIER_TALL_MS = 4.057
# The per-chain interface (transit_spectrum_fused, and the ensemble's
# wrapper at B = 1) is K2, the one-chain kernel, on the raw operands.
# Its EARLIER_* are constants, not measurements of a run of this script:
# K1 launched with one chain after the wrapper's preparation (~35 small
# launches), CUDA events around runs of 4 calls of the wrapper and
# torch.profiler device ms, NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
# section 6).
# The thermochemical-equilibrium solve (one launch for every [chain,
# layer] system; the plain version is equilibrium_vmr's torch steps,
# float64 on the CPU), its Newton steps (120 damped and 32 averaged):
CHEM = dict(
    name='chem_gibbs', tol=1e-10, steps=152,
    source='pyratbay_tpu_torch/csrc/chem_gibbs.cu',
    replaces='pyratbay_tpu/atmosphere/chem.py equilibrium_vmr')
ONE_CHAIN = dict(
    name='transit_one', tol=2e-5,
    source='pyratbay_tpu_torch/csrc/transit_one.cu',
    replaces='pyratbay_tpu/spectrum/rt_pallas.py:221')
EARLIER_ONE_MS = 0.160
EARLIER_ONE_DEVICE_MS = [0.025, 0.047]
# The nested walk's batches, at which K2 is timed beside K1 (a finding;
# the wrappers send B > 1 to K1):
ONE_BATCHES = (12, 25)
# The spectrum phase: the bundled H2-H2 and H2-He CIA tables by basename
# (20 + 20 rows, more than the kernels' 32), Rayleigh of H2, He and H
# with the haze and a gray cloud (5 rank-1 terms, more than their 4),
# and the deck; variants with patchy clouds, with H- and Rayleigh of e-
# (6 rank-1 terms) on an atmosphere with free electrons, and with that
# atmosphere on 81 layers (the tall function).
BUNDLED_CIA = ('CIA_Borysow_H2H2_0060-7000K_0.6-500um.npz',
               'CIA_Borysow_H2He_0050-3000K_0.3-030um.npz')
SPECTRUM_CLOUDS = ('deck 2.0', 'lecavelier 0.0 -4.0', 'ccsgray 0.0 -4.0 2.0')
TALL_LAYERS = 81
# Layers of the spectrum phase's deep transit run: above the most whose
# block K2 holds in shared memory with any operand counts (168 to 272),
# so Model.run takes its streamed layout.
DEEP_LAYERS = 300
# The constant-R flagship (make_flagship(resolution=)): the JAX bench's
# high-resolution transit setting, R = 115,000 over 1.1-1.7 um.
R115K = 115_000.0
ELECTRONS = ['H2', 'He', 'H', 'Na', 'K', 'H2O', 'CH4', 'CO', 'CO2', 'e-']
ELECTRON_VMR = [8.5e-1, 1.49e-1, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7,
                1e-6]
MODEL_RUN_REPEATS = 5
# Peaks of one NVIDIA H100 SXM (data sheet, dense): HBM3 bytes/s, float32
# operations/s outside the tensor cores and TF32 operations/s on them (an
# FMA counts two).
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
# Float32 operations of one line-window pair, from the kernels' formulas:
# a wing pair is the hi/lo difference, u, a, the 5-term series and the
# sum (~30); a core pair is 16 Weideman terms of a complex multiply-add
# plus the set-up (~160).
WING_PAIR_FLOPS = 30
CORE_PAIR_FLOPS = 160
# Instructions a lane issues for one pair and cell, counted from
# csrc/lbl_voigt.cu (an FMA is one instruction but two operations): the
# wing pair ~23; the core pair ~120 in the Weideman region.  A lane
# issues at most one instruction a clock, PEAK_FP32 / 2 a second.
WING_PAIR_INSTR = 23
CORE_PAIR_INSTR = 120


# The kernels of the table: K4 and K5 as the main path launches them
# (per-line factors read by line range), K6 on its window layout.
# earlier_ms are constants, not measurements of a run of this script:
# the window-layout kernels that the main path launched before, one
# 64-cell flagship block, NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md,
# section 6); earlier_production_ms the same for a production block
# (torch.profiler device time).
LBL = {
    'wing_lines': dict(
        name='lbl_wing_grouped', fn='wing_sigma_lines',
        replaces='pyratbay_tpu/opacity/lbl_pallas.py:462',
        earlier_ms=0.639, earlier_production_ms=21.5),
    'core_lines': dict(
        name='lbl_core', fn='core_sigma_lines',
        replaces='pyratbay_tpu/opacity/lbl_pallas.py:648',
        earlier_ms=0.203, earlier_production_ms=2.75),
    'wing': dict(
        name='lbl_wing', fn='wing_sigma',
        replaces='pyratbay_tpu/opacity/lbl_pallas.py:239',
        earlier_ms=1.253),
}
# The window-layout kernels of K4 and K5 (the JAX wrappers' operands):
# off the main path, held against their plain versions all the same.
LBL_WINDOWS = {
    'wing_grouped': dict(name='lbl_wing_grouped_windows',
                         fn='wing_sigma_grouped'),
    'core': dict(name='lbl_core_windows', fn='core_sigma'),
}
WINDOWS_OF = {'wing_lines': 'wing_grouped', 'core_lines': 'core'}
EARLIER_NOTE = ('constants from PERF.md, not measured in this run: the '
                'window-layout kernels before the per-line route, NVIDIA '
                'H100 80GB HBM3, 700.00 W')
LBL_SOURCE = 'pyratbay_tpu_torch/csrc/lbl_voigt.cu'
LBL_TOL = 2e-4          # lbl_pallas against XLA, tests/test_tpu_hw.py
TABLE_TOL = 1e-4        # strong-line bound of tests/test_lbl_tpu.py
NLINES = 50_000
PROD_NWAVE = 200_000    # bench.py::_production_table's width
PROD_NTEMP = 24
PROD_BUDGET_S = 60.0
PARITY_TEMPS = (300, 2700, 1200)   # tmin, tmax, tstep of the parity table


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def fail(message):
    print(f'chip_smoke: FAILED: {message}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_times(fn, repeats=10, warmup=3, inner=4):
    """`repeats` timings in milliseconds of one call of fn() on the
    current stream, each the mean over a run of `inner` calls between two
    CUDA events, after `warmup` calls.  (Around a single call the events
    would also count the host's time between the call's launches.)"""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return times


def paired_ms(fns, repeats=10):
    """Median milliseconds of each named function, timed in turns
    (a, b, b, a) so that a drift of the card's clock hits both."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name] += cuda_times(fns[name], repeats)
    return {name: float(np.median(t)) for name, t in times.items()}


def _profile(fn, reps):
    """torch.profiler's device records of `reps` calls of fn(), after a
    warm-up step of the profiler (one call, its records dropped):
    {key: (count, device us)} over every device kernel and copy (not the
    step's own annotation on the device's timeline, nor any other
    annotation).  Profiles late in this script missed records (6 of 10
    launches of K2 at 300 layers in the spectrum phase, 7 or 8 of 10 of
    K2 at 51 there, also with 50 ms of host time around each step's
    calls; every one with the spectrum phase in a process of its own):
    the callers count what the profile recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule
    fn()
    torch.cuda.synchronize()
    with torch.no_grad(), tprofile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1,
                              repeat=1)) as prof:
        for calls in (1, reps):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return {evt.key: (evt.count, evt.device_time_total)
            for evt in prof.key_averages()
            if evt.device_type != DeviceType.CPU
            and not getattr(evt, 'is_user_annotation', False)
            and not evt.key.startswith('ProfilerStep')}


def device_ms(fn, kernel_name, reps=10):
    """Device milliseconds of one call fn() by torch.profiler: (the
    kernels whose names contain `kernel_name`, every device kernel and
    copy the call launches, the number of those launches), each over
    `reps` calls.  CUDA events around a single call also count the
    host's time between its launches; this does not."""
    records = _profile(fn, reps)
    main = sum(us for key, (_, us) in records.items() if kernel_name in key)
    total = sum(us for _, us in records.values())
    launches = sum(count for count, _ in records.values())
    return main / reps * 1e-3, total / reps * 1e-3, launches / reps


def kernel_device_ms(fn, kernel_name, reps=10, tries=3):
    """Device ms of a call fn() that launches the kernel `kernel_name`
    once, by torch.profiler over `reps` calls: (the kernel's ms a launch,
    over the launches the profile recorded of it; the call's device ms;
    its device launches a call; the share of the kernel's launches the
    profile recorded).  Of up to `tries` profiles the first that recorded
    all `reps` launches, else the one that recorded the most; fails if
    none recorded any."""
    best = None
    for _ in range(tries):
        records = _profile(fn, reps)
        count = sum(n for key, (n, _) in records.items()
                    if kernel_name in key)
        if best is None or count > best[0]:
            best = count, records
        if count == reps:
            break
    count, records = best
    if count == 0:
        fail(f'torch.profiler recorded no launch of {kernel_name} in '
             f'{tries} profiles of {reps} calls: {sorted(records)}')
    main = sum(us for key, (_, us) in records.items() if kernel_name in key)
    total = sum(us for _, us in records.values())
    launches = sum(n for n, _ in records.values())
    return (main / count * 1e-3, total / reps * 1e-3, launches / reps,
            count / reps)


def call_launches(fn, kernel_name):
    """Device launches of a call fn() for each launch of the kernel
    `kernel_name` it makes, by kernel_device_ms' profile: every device
    launch recorded over the kernel's launches recorded (a profile late
    in this script misses records, `_profile`; a call of one launch reads
    1 whatever it misses)."""
    _, _, launches, recorded = kernel_device_ms(fn, kernel_name)
    return launches / recorded


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


def write_retrieval_cfg(src_cfg, dst_cfg, data, uncert, filters, logfile,
                        ngen=NGEN, extra=()):
    """The flagship config as a retrieval run with data and sampler
    settings (`ngen` generations of NCHAINS chains, `extra` lines)."""
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
        f'nsamples = {NCHAINS * ngen}',
        'burnin = 2',
        *extra,
    ]
    with open(dst_cfg, 'w') as f:
        f.write('\n'.join(out) + '\n')


def record_calls(pairs, fn):
    """Run fn() with each (module or class, name) of `pairs` wrapped;
    return the (args, kwargs) of each one's last call."""
    recorded, reals = {}, {}
    for module, name in pairs:
        reals[name] = real = getattr(module, name)

        def recorder(*a, _name=name, _real=real, **kw):
            recorded[_name] = (a, kw)
            return _real(*a, **kw)

        setattr(module, name, recorder)
    try:
        fn()
    finally:
        for module, name in pairs:
            setattr(module, name, reals[name])
    return [recorded[name] for _, name in pairs]


def roofline(nbytes, flops, tf32_flops=0):
    """(bound in ms, 'bytes' or 'operations'): the larger of the bytes
    over the card's memory rate, the float32 operations over the CUDA
    cores' peak rate and the TF32 operations over the tensor cores'
    (the two pipes run side by side)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(flops / PEAK_FP32, tf32_flops / PEAK_TF32)
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def tensor_bytes(*tensors):
    import torch
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


_PER_CHAIN = ('cia_w', 'r1_cols', 'r1_rows', 'ls_w')


def _common(kw, sl, **over):
    """The keyword operands of a recorded wrapper call for the chains
    `sl`, with `over` in place."""
    out = {k: kw[k] for k in (*_PER_CHAIN, 'cia_tab', 'ls_tab', 'maxdepth')}
    out = {k: (v[sl] if k in _PER_CHAIN and v is not None else v)
           for k, v in out.items()}
    out.update(over)
    return out


def _prep(label, model, args, kw, sl, deck=True, lower_top=0):
    """The kernel's positional operands after the dense parts, from a
    recorded call of the wrapper of `label`'s RT path, for the chains
    `sl` (with the deck, or without it; the top lowered by
    `lower_top` layers)."""
    import torch
    from pyratbay_tpu_torch.atmosphere import geometry
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    if label == 'transit':
        _, path, rr, rstar, itop, ibottom = args
        itop, path = itop[sl], path[sl]
        if lower_top:
            itop = itop + lower_top
            path = geometry.transit_path_matrix(
                rr[sl], itop) * model._radius_scale
        if deck:
            return tk.prep_chains(
                path, rr[sl], rstar, itop, ibottom[sl], kw['deck_itop'][sl],
                kw['deck_rsurf'][sl])
        return tk.prep_chains(path, rr[sl], rstar, itop,
                              torch.full_like(ibottom[sl], model.nlayers))
    _, radius, temp, wn, mu, weights, itop, ibottom = args
    itop = itop[sl] + lower_top
    if deck:
        operands = ek.prep_emission_chains(
            radius[sl], temp[sl], itop, ibottom[sl], kw['deck_itop'][sl],
            kw['deck_tsurf'][sl])
    else:
        operands = ek.prep_emission_chains(
            radius[sl], temp[sl], itop, model.nlayers)
    return (*operands, wn, mu, weights)


def wrapper_case(label, model, call):
    """The kernel's (args, kwargs) for every chain of one recorded
    wrapper call, as the wrapper hands them to the kernel."""
    args, kw = call
    every = slice(None)
    return ((list(args[0]), *_prep(label, model, args, kw, every)),
            _common(kw, every))


def kernel_cases(label, model, call, rejected, dense_cases=True):
    """Kernel operands at the flagship's width from a recorded B = 512
    call of the main path's wrapper and a recorded call with a rejected
    chain: name -> (args, kwargs) of the kernel and its plain version.
    Cases named *_ls_* carry the line sample as ls_w / ls_tab, cases
    named *_dense_* as a dense part (left out without `dense_cases`: at
    50,062 columns a [512, 51, W] part takes 5.2 GB)."""
    import torch
    common = _common

    def prep(args, kw, sl, deck=True, lower_top=0):
        return _prep(label, model, args, kw, sl, deck, lower_top)

    args, kw = call
    if args[0] or kw['ls_w'] is None:
        fail(f'{label}: the main path did not hand the kernel the line '
             'sample as ls_w / ls_tab alone')
    every, some, one = slice(None), slice(0, 500), slice(0, 1)
    cases = {
        'B512_ls_deck': (([], *prep(args, kw, every)), common(kw, every)),
        'B512_ls_nodeck': (
            ([], *prep(args, kw, every, deck=False)), common(kw, every)),
        'B512_ls_lowered_top': (
            ([], *prep(args, kw, every, lower_top=3)), common(kw, every)),
        'B500_ls_deck': (([], *prep(args, kw, some)), common(kw, some)),
        'B1_ls_deck': (([], *prep(args, kw, one)), common(kw, one)),
        'B8_ls_rejected_chain': (
            ([], *prep(*rejected, every)), common(rejected[1], every)),
    }
    if not dense_cases:
        return cases
    dense = torch.einsum(
        'bkl,klw->blw', kw['ls_w'], kw['ls_tab']).contiguous()
    no_ls = dict(ls_w=None, ls_tab=None)
    cases.update({
        'B512_ls_beside_dense_part': (
            ([0.25 * dense], *prep(args, kw, every)),
            common(kw, every, ls_w=0.75 * kw['ls_w'])),
        'B512_dense_deck': (
            ([dense], *prep(args, kw, every)), common(kw, every, **no_ls)),
        'B512_dense_nodeck': (
            ([dense], *prep(args, kw, every, deck=False)),
            common(kw, every, **no_ls)),
        'B1_dense_deck': (
            ([dense[:1]], *prep(args, kw, one)), common(kw, one, **no_ls)),
    })
    return cases


def kernel_bound(label, args, kw):
    """Roofline bound of one kernel call from its operands: every input
    read once, the [B, W] result written once, and the operations this
    data needs at the peak rate of the pipe that runs them (an FMA counts
    two, a transcendental or a division one).  Transit: the triangular
    chord product, the rank-1 terms, the non-zero CIA and line-sample
    weights, ~10 operations a row of the epilogue; the chord product
    runs on the tensor cores as three TF32 products (both functions: up
    to 64 layers and the tall one above), counted at their rate, the rest
    in float32 on the CUDA cores.
    Emission: the same assembly, the depth step, one Planck and an
    exponential with its FMA for each angle, for the rows from the top to
    each column's ideep only (the walk stops there)."""
    import torch
    from pyratbay_tpu_torch.spectrum import rt
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    parts = args[0]
    like = args[3]      # the radius or the temperature column [B, l]
    nb, nlayers = like.shape
    nwave = tk._nwave(parts, kw['r1_rows'], kw['cia_tab'], kw['ls_tab'])
    n_r1 = 0 if kw['r1_cols'] is None else kw['r1_cols'].shape[1]
    # The weights' non-zero terms (line sample and CIA are two-hot in
    # temperature):
    terms = sum(int(torch.count_nonzero(kw[k])) for k in ('ls_w', 'cia_w')
                if kw[k] is not None)
    nbytes = tensor_bytes(*parts, *args[1:], *kw.values()) + 4 * nb * nwave
    assembly_row = 2 * n_r1 + max(len(parts) - 1, 0)
    tf32 = 0
    if label == 'transit':
        tf32 = 3 * nb * nwave * nlayers * (nlayers + 1)
        flops = nb * nwave * nlayers * (assembly_row + 10) \
            + 2 * terms * nwave
    else:
        scal, dr = args[1], args[2]
        ec = tk.extinction_plain(
            parts, kw['cia_w'], kw['cia_tab'], kw['r1_cols'], kw['r1_rows'],
            kw['ls_w'], kw['ls_tab'], like)
        itop, bottom = scal[:, 0].long(), scal[:, 1].long()
        _, ideep = rt.cumulative_depth(ec, dr, kw['maxdepth'], itop, bottom)
        rows = int(torch.clamp(ideep - itop[:, None] + 1, min=1).sum())
        nmu = len(args[5])
        flops = rows * (
            assembly_row + 2 * terms / (nb * nlayers) + 8 + 5 * nmu)
    return roofline(nbytes, flops, tf32)


_ONE_PER_CHAIN = ('deck_itop', 'deck_rsurf', 'cia_w', 'r1_cols', 'r1_rows',
                  'ls_w')


def one_case(call, sl=slice(0, 1)):
    """K2's (args, kwargs) for the chains `sl` of a recorded call of
    transit_spectrum_ensemble: the raw operands, as the wrapper hands
    one chain to K2."""
    import torch
    args, kw = call
    parts, path, radius, rstar, itop, ibottom = args
    cut = lambda v: v[sl] if torch.is_tensor(v) and v.dim() > 0 else v
    kw = {k: cut(v) if k in _ONE_PER_CHAIN else v for k, v in kw.items()}
    return ([p[sl] for p in parts], path[sl], radius[sl], rstar, cut(itop),
            cut(ibottom)), kw


def one_chain_cases(model, call, tag=''):
    """K2's cases from a recorded call of the transit wrapper (chain 0 of
    it): as the main path has it (deck, the flagship's maxdepth of 10),
    without the deck, with no maxdepth, the line sample made a dense part,
    and two chains of which the second has +inf top radii (NaN in its row
    alone)."""
    import torch
    from pyratbay_tpu_torch.atmosphere import geometry
    base = one_case(call)
    (parts, path, rr, rstar, itop, ibottom), kw = base
    cases = {
        f'B1_{tag}deck': base,
        f'B1_{tag}no_maxdepth': (base[0], dict(kw, maxdepth=np.inf)),
    }
    if kw.get('deck_itop') is not None:
        cases[f'B1_{tag}nodeck'] = (
            (parts, path, rr, rstar, itop,
             torch.full_like(ibottom, model.nlayers)),
            dict(kw, deck_itop=None, deck_rsurf=None))
    if kw.get('ls_w') is not None:
        dense = torch.einsum('bkl,klw->blw', kw['ls_w'],
                             kw['ls_tab']).contiguous()
        cases[f'B1_{tag}dense'] = ((parts + [dense], *base[0][1:]),
                                   dict(kw, ls_w=None, ls_tab=None))
    (parts2, _, rr2, _, itop2, ibot2), kw2 = one_case(call, slice(0, 2))
    rr2 = rr2.clone()
    rr2[1, :3] = np.inf
    path2 = geometry.transit_path_matrix(rr2, itop2) * model._radius_scale
    cases[f'B2_{tag}inf_top_radii'] = (
        (parts2, path2, rr2, rstar, itop2, ibot2), kw2)
    return cases


def one_bound(args, kw):
    """Roofline bound of one K2 call from its raw operands: every input
    read once (of the line-sample table only the rows [k, j] whose
    weight is not zero, which is what the function needs and what K2
    reads), the [B, W] result written once, and the operations
    kernel_bound counts for K1, with K2's chord product in float32 on
    the CUDA cores at any layer count."""
    import torch
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    parts, radius = args[0], args[2]
    nb, nlayers = radius.shape
    nwave = tk._nwave(parts, kw['r1_rows'], kw['cia_tab'], kw['ls_tab'])
    n_r1 = 0 if kw['r1_cols'] is None else kw['r1_cols'].shape[1]
    nonzero = {k: int(torch.count_nonzero(kw[k])) for k in ('ls_w', 'cia_w')
               if kw.get(k) is not None}
    live_rows = 0 if kw.get('ls_w') is None else int(
        torch.count_nonzero(kw['ls_w'].ne(0).any(dim=0)))
    nbytes = tensor_bytes(*parts, *args[1:], *[
        v for k, v in kw.items() if k != 'ls_tab']) \
        + 4 * live_rows * nwave + 4 * nb * nwave
    flops = nb * nwave * nlayers * (nlayers + 1) \
        + nb * nwave * nlayers * (2 * n_r1 + max(len(parts) - 1, 0) + 10) \
        + 2 * sum(nonzero.values()) * nwave
    return roofline(nbytes, flops)


def one_chain_times(case, call, card, label, batches=ONE_BATCHES):
    """K2's numbers on one chain's operands: CUDA events around runs of
    the whole wrapper (transit_one_cuda) in turns with its plain version
    and with what the wrapper did before (prep_chains, then K1 with one
    chain), each's profiler device ms and device launches a call; and
    K2 beside K1 at the nested walk's batches (from the recorded B = 512
    call; `batches`, none to leave them out).  Emits `times_one_chain`;
    returns K2's kernel-entry numbers."""
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    args, kw = case

    def before():
        ops = tk.prep_chains(*args[1:], kw.get('deck_itop'),
                             kw.get('deck_rsurf'))
        return tk.transit_rt_cuda(list(args[0]), *ops, **{
            k: v for k, v in kw.items()
            if k not in ('deck_itop', 'deck_rsurf')})

    ms = paired_ms({
        'plain': lambda: tk.transit_one_plain(*args, **kw),
        'kernel': lambda: tk.transit_one_cuda(*args, **kw),
        'before': before})
    dev = {name: kernel_device_ms(fn, kernel) for name, (fn, kernel) in {
        'kernel': (lambda: tk.transit_one_cuda(*args, **kw),
                   'transit_one_kernel'),
        'before': (before, 'transit_rt_kernel')}.items()}
    bound_ms, bound_by = one_bound(args, kw)
    sizes, batches = batches, {}
    for nb in sizes:
        b_args, b_kw = one_case(call, slice(0, nb))
        pair = paired_ms({
            'k2': lambda: tk.transit_one_cuda(*b_args, **b_kw),
            'k1': lambda: tk.transit_spectrum_ensemble(*b_args, **b_kw)})
        k2 = kernel_device_ms(lambda: tk.transit_one_cuda(*b_args, **b_kw),
                              'transit_one_kernel')
        k1 = kernel_device_ms(
            lambda: tk.transit_spectrum_ensemble(*b_args, **b_kw),
            'transit_rt_kernel')
        batches[f'B{nb}'] = dict(
            k2_ms=pair['k2'], k1_with_prep_ms=pair['k1'],
            k2_device_ms=k2[0], k2_recorded=k2[3], k1_device_ms=k1[0],
            k1_recorded=k1[3], k2_bound_ms=one_bound(b_args, b_kw)[0])
    launches = {name: call_launches(fn, kernel) for name, fn, kernel in (
        ('kernel', lambda: tk.transit_one_cuda(*args, **kw),
         'transit_one_kernel'),
        ('before', before, 'transit_rt_kernel'))}
    emit('times_one_chain', path=label, card=card, kernel=ONE_CHAIN['name'],
         nlayers=int(args[2].shape[1]), ms=ms['kernel'],
         plain_ms=ms['plain'], bound_ms=bound_ms, bound_by=bound_by,
         device_ms=dev['kernel'][0], device_recorded=dev['kernel'][3],
         device_launches=launches['kernel'],
         before_ms=ms['before'], before_device_ms=dev['before'][1],
         before_device_launches=launches['before'],
         earlier_ms=EARLIER_ONE_MS, earlier_device_ms=EARLIER_ONE_DEVICE_MS,
         earlier_note='constants from PERF.md, not measured in this run: '
                      'K1 with one chain after the wrapper\'s preparation',
         batches=batches,
         times_note='*_ms: CUDA events around runs of 4 calls of the '
                    'whole wrapper, in turns; device_ms: torch.profiler, '
                    'the kernel alone a launch over the launches its '
                    'profile of 10 calls recorded (*_recorded: their '
                    'share; before_device_ms: every device kernel and '
                    'copy of the call); *_launches: device launches of a '
                    'call for each launch of its kernel, by torch.profiler '
                    'over 10 calls (call_launches); '
                    'batches: K2 with B chains beside '
                    'transit_spectrum_ensemble (prep_chains and K1), a '
                    'finding, the wrappers send B > 1 to K1')
    if launches['kernel'] != 1:
        fail(f'{label}: a one-chain transit call made '
             f'{launches["kernel"]} device launches, not 1')
    return dict(ms=ms['kernel'], plain_ms=ms['plain'], bound_ms=bound_ms,
                bound_by=bound_by, device_ms=dev['kernel'][0],
                earlier_ms=EARLIER_ONE_MS,
                earlier_device_ms=EARLIER_ONE_DEVICE_MS)


def check_kernel(name, kernel, plain, cases, tol, path=None):
    """Each case through the kernel and its plain version; returns each
    case's largest absolute difference.  Fails beyond `tol` of the row
    max.  `path` names the phase in each line (None: not a retrieval
    path's own)."""
    import torch
    max_abs = {}
    for case, (args, kw) in cases.items():
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        rel, absolute = rel_err(got, want)
        max_abs[case] = absolute
        emit('kernel_check', kernel=name, case=case, path=path,
             shape=list(got.shape),
             finite_rows=int(torch.isfinite(got).all(dim=1).sum()),
             max_rel_err=rel, max_abs_err=absolute, tol=tol)
        if not rel < tol:
            fail(f'{name} {case}: kernel disagrees with plain ({rel})')
    return max_abs


def flagship_width(resolution):
    """Wavenumbers of the flagship's 1.1-1.7 um range: NWAVE at its
    wnstep of 1 cm-1, else the constant-R grid of ops/grids.py."""
    if resolution is None:
        return NWAVE
    from pyratbay_tpu_torch.ops.grids import wavenumber_grid
    return len(wavenumber_grid(wnlow=1.0 / 1.7e-4, wnhigh=1.0 / 1.1e-4,
                               resolution=resolution).wn)


def run_path(label, rt_path, workdir, dev, args, card, nlayers=NLAYERS,
             keep=None, resolution=None):
    """One path end to end on the flagship with `nlayers` layers (at the
    constant R `resolution`, when given): kernel checks, the main path
    through pyratbay_tpu_torch's run(), GPU against CPU, and timings.
    Returns the kernel entries; the dict `keep`, when given, receives the
    retrieval's Model as 'model'.  On the constant-R grid the dense-part
    cases and routes are left out (a [512, 51, W] part is 5.2 GB at R =
    115,000), and the entries are marked partial: their figures at this
    width go under `at_<label>` of the entries of the transit path."""
    import torch
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    spec = KERNELS[label]
    suffix = '' if label == 'transit' else f'_{label}'
    kind = 'transit' if rt_path == 'transit' else 'eclipse'
    tall = kind == 'transit' and nlayers > tk.MAX_LAYERS
    if kind == 'transit':
        wrapper = 'transit_spectrum_ensemble'
        kernel, plain = tk.transit_rt_cuda, tk.transit_rt_plain
    else:
        wrapper = 'emission_flux_ensemble'
        kernel, plain = ek.emission_rt_cuda, ek.emission_rt_plain
    counters = (tk.transit_rt_cuda, ek.emission_rt_cuda)

    # Flagship at full width on the GPU:
    wide = resolution is not None
    nwave = flagship_width(resolution)
    phase_t0 = time.perf_counter()
    model, obs, ret, forward, p0 = make_flagship(
        workdir, nlayers=nlayers, resolution=resolution, device=dev,
        rt_path=rt_path)
    setup_s = time.perf_counter() - phase_t0
    if (model.nlayers, model.nwave) != (nlayers, nwave):
        fail(f'{label} flagship shape {(model.nlayers, model.nwave)}, not '
             f'{(nlayers, nwave)}')
    rng = np.random.default_rng(0)
    pb = p0 + ret.pstep * rng.standard_normal((NCHAINS, len(p0)))
    pb = np.clip(pb, ret.pmin, ret.pmax)
    forward_b = build_forward_batched(model, obs, ret)

    # The kernel against its plain version on the operands the main
    # path hands it (recorded from one B = 512 forward, and from eight
    # chains of which the last is rejected: T_irr = 1e6):
    call, = record_calls(((model_mod, wrapper),), lambda: forward_b(pb))
    pb_rejected = pb[:8].copy()
    pb_rejected[-1, 1] = 1.0e6
    rejected, = record_calls(((model_mod, wrapper),),
                             lambda: forward_b(pb_rejected))
    cases = kernel_cases(kind, model, call, rejected, dense_cases=not wide)
    if wide:
        # Which route the line sample took at this width (the recorded
        # call handed it to the kernel as weights and table, or
        # kernel_cases failed):
        n_k, _, _ = call[1]['ls_tab'].shape
        emit('ls_route', path=label, nlayers=nlayers, nwave=nwave,
             ls_rows=n_k, in_kernel=tk.ls_in_kernel(n_k, nlayers, rt_path),
             route='ls_w / ls_tab inside the kernel',
             setup_seconds=setup_s)
    case_abs = check_kernel(spec['name'], kernel, plain, cases, spec['tol'],
                            path=label)
    max_abs = max(case_abs.values())
    # K2 on one chain's raw operands from the same call:
    one_abs = {}
    if kind == 'transit':
        one_cases = one_chain_cases(
            model, call, tag='layers81_' if tall else 'ls_')
        one_abs = check_kernel(ONE_CHAIN['name'], tk.transit_one_cuda,
                               tk.transit_one_plain, one_cases,
                               ONE_CHAIN['tol'], path=label)

    # The main path, through the driver:
    band0 = forward(p0)['bandflux'].cpu().numpy()
    if kind == 'transit':
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
    for counter in (*counters, tk.transit_one_cuda):
        counter.launches = 0
    tk.transit_rt_cuda.tall_launches = 0
    tk.transit_rt_cuda.mma_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rmodel = run(cfg_file, seed=0)       # the default device: the card
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    if keep is not None:
        keep['model'] = rmodel
    tall_launches = tk.transit_rt_cuda.tall_launches
    mma_launches = tk.transit_rt_cuda.mma_launches
    launches = tall_launches if tall else kernel.launches - tall_launches
    one_launches = tk.transit_one_cuda.launches
    all_launches = {c.__name__: c.launches
                    for c in (*counters, tk.transit_one_cuda)}
    all_launches['transit_rt_tall'] = tall_launches
    all_launches['transit_rt_mma'] = mma_launches
    if rmodel.device.type != 'cuda':
        fail(f'{label}: the retrieval ran on {rmodel.device}, not on the '
             'card')
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
    if out['spec_best'].shape != (nwave,):
        fail(f'{label}: spec_best shape {out["spec_best"].shape}')
    if launches < NGEN + 2:
        fail(f'{label}: {launches} {spec["name"]} launches < {NGEN + 2}')
    if tall and tall_launches != kernel.launches:
        fail(f'{label}: the transit kernel for up to 64 layers ran at '
             f'{nlayers} layers')
    if kind == 'transit' and mma_launches != kernel.launches - tall_launches:
        fail(f'{label}: {mma_launches} launches of the tensor-core chord '
             f'product, not the {kernel.launches - tall_launches} of the '
             'transit kernel for up to 64 layers')

    # GPU float32 forward against the CPU float64 plain forward:
    cpu_model = model_mod.Model(
        os.path.join(workdir, 'flagship.cfg'), device='cpu')
    cpu_obs = Observation(obs_cfg(obs), cpu_model.wn)
    cpu_ret = RetrievalParams(cpu_model, cpu_obs)
    # (4 chains by chunks of 2 on the constant-R grid, whose CPU
    # operands are 15.6 times wider):
    p8 = pb[:4] if wide else pb[:8]
    spec_gpu = forward_b(p8)['spectrum']
    spec_cpu = torch.cat([out['spectrum'] for out in chunked_cpu(
        build_forward_batched(cpu_model, cpu_obs, cpu_ret), p8,
        chunk=2 if wide else len(p8))])
    fwd_rel, fwd_abs = rel_err(spec_gpu, spec_cpu)
    emit('gpu_vs_cpu' + suffix, chains=len(p8), max_rel_err=fwd_rel,
         max_abs_err=fwd_abs, tol=FORWARD_TOL)
    if not fwd_rel < FORWARD_TOL:
        fail(f'{label}: GPU f32 forward disagrees with CPU f64 ({fwd_rel})')

    if wide:
        return wide_times(label, spec, kernel, plain, cases, call, one_cases,
                          forward_b, rmodel, pb, dev, args, card, nwave,
                          launches, mma_launches, one_launches, max_abs,
                          one_abs, time.perf_counter() - phase_t0, setup_s)

    # Times (CUDA events, medians after warm-up, in turns).  The two
    # line-sample routes: the einsum and the contiguous copy that make the
    # dense part, then the kernel on it; against the kernel on the
    # weights and the table.
    ls_args, ls_kw = cases['B512_ls_deck']
    dense_args, dense_kw = cases['B512_dense_deck']
    one_args, one_kw = cases['B1_ls_deck']

    def route_dense():
        part = torch.einsum(
            'bkl,klw->blw', ls_kw['ls_w'], ls_kw['ls_tab']).contiguous()
        return kernel([part], *dense_args[1:], **dense_kw)

    ms = paired_ms({
        'plain': lambda: plain(*ls_args, **ls_kw),
        'kernel': lambda: kernel(*ls_args, **ls_kw),
        'kernel_dense': lambda: kernel(*dense_args, **dense_kw),
        'route_dense': route_dense,
        'plain_b1': lambda: plain(*one_args, **one_kw),
        'kernel_b1': lambda: kernel(*one_args, **one_kw),
    })
    kernel_name = spec['name'] + '_kernel'
    dev_ms = {name: kernel_device_ms(fn, kernel_name) for name, fn in {
        'kernel': lambda: kernel(*ls_args, **ls_kw),
        'kernel_dense': lambda: kernel(*dense_args, **dense_kw),
        'route_dense': route_dense,
        'kernel_b1': lambda: kernel(*one_args, **one_kw),
    }.items()}
    bound_ms, bound_by = kernel_bound(kind, ls_args, ls_kw)
    dense_bound_ms, dense_bound_by = kernel_bound(
        kind, dense_args, dense_kw)
    b1_bound_ms, b1_bound_by = kernel_bound(kind, one_args, one_kw)
    pb_t = torch.as_tensor(pb, dtype=torch.float32, device=dev)
    with torch.no_grad():
        ms_forward = float(np.median(cuda_times(lambda: forward_b(pb_t))))
    gens_per_s = demc_rate(rmodel, dev)
    extra = {}
    if tall:
        # Chains in flight on an SM at this phase's operand counts:
        n_cia = ls_kw['cia_w'].shape[2]
        n_r1 = 0 if ls_kw['r1_cols'] is None else ls_kw['r1_cols'].shape[1]
        extra['tall_chains_per_sm'] = tk.chains_per_sm(
            nlayers, n_r1, n_cia, ls_kw['ls_w'].shape[1], 0)
    emit('times', path=label, card=card, kernel=spec['name'],
         nlayers=nlayers,
         kernel_ms=ms['kernel'], plain_ms=ms['plain'], bound_ms=bound_ms,
         bound_by=bound_by, earlier_ms=EARLIER_MS.get(label),
         earlier_note='a constant from PERF.md, not measured in this run: '
                      'the kernel before its redesign, events around '
                      'single calls, which also count host gaps'
                      if label in EARLIER_MS else
                      'none: the function before its redesign took no '
                      'line sample (times_spectrum has its successor)',
         main_path_launches=launches, **extra,
         device_ms={name: {'kernel_alone': alone, 'whole_call': whole,
                           'recorded': recorded}
                    for name, (alone, whole, _, recorded) in dev_ms.items()},
         times_note='*_ms: CUDA events around runs of 4 calls of the '
                    'wrapper (its layout operations included; at B = 1 '
                    'the host between the launches too); device_ms: '
                    'torch.profiler device time of one call',
         routes_ms={'einsum_copy_kernel_on_dense_part': ms['route_dense'],
                    'kernel_on_weights_and_table': ms['kernel']},
         kernel_dense_ms=ms['kernel_dense'], dense_bound_ms=dense_bound_ms,
         dense_bound_by=dense_bound_by,
         b1_kernel_ms=ms['kernel_b1'], b1_plain_ms=ms['plain_b1'],
         b1_bound_ms=b1_bound_ms, b1_bound_by=b1_bound_by,
         forward_ms=ms_forward,
         forward_spectra_per_s=NCHAINS / (ms_forward * 1e-3),
         demc_generations_per_s=gens_per_s,
         demc_note='includes the initial ensemble evaluation and the '
                   'history copy to the host')
    if not ms['kernel'] <= ms['route_dense']:
        fail(f'{label}: the main path takes the line sample in the kernel '
             f'({ms["kernel"]:.3f} ms), but the dense-part route is faster '
             f'({ms["route_dense"]:.3f} ms)')

    if args.profile:
        profile(label, forward_b, pb_t, ms_forward)

    entry = {'name': spec['name'], 'route': 'cuda', 'source': spec['source'],
             'replaces': spec['replaces'], 'launches': launches,
             'launches_by_path': {label: launches},
             'max_abs_err': max_abs, 'ms': ms['kernel'],
             'plain_ms': ms['plain'], 'bound_ms': bound_ms,
             'bound_by': bound_by, 'library_ms': None}
    entries = [entry]
    if kind == 'transit':
        # K2: the main path's best fit (Model.run, B = 1) launches it.
        if one_launches < 1:
            fail(f'{label}: the main path launched the one-chain kernel '
                 'no time')
        one = {'name': ONE_CHAIN['name'], 'launches': one_launches,
               'launches_by_path': {label: one_launches},
               'max_abs_err': max(one_abs.values())}
        if tall:
            one['partial'] = True
        else:
            one.update(route='cuda', source=ONE_CHAIN['source'],
                       replaces=ONE_CHAIN['replaces'], library_ms=None,
                       **one_chain_times(one_cases['B1_ls_deck'], call,
                                         card, label))
        entries.append(one)
    return entries


def demc_rate(rmodel, dev, gens=10, runs=3):
    """DEMC generations/s of the retrieval's Model: `gens` generations of
    NCHAINS chains by the host clock ending in a synchronize, the median
    of `runs` runs (each with its initial ensemble and the history's copy
    to the host)."""
    import torch
    from pyratbay_tpu_torch.retrieval.batched import (
        build_log_posterior_batched)
    from pyratbay_tpu_torch.retrieval.samplers import sample_demc
    log_post_b = build_log_posterior_batched(rmodel, rmodel.obs, rmodel.ret)
    gen_times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_demc(log_post_b, rmodel.ret.params,
                    nsamples=NCHAINS * gens, nchains=NCHAINS,
                    pstep=rmodel.ret.pstep, pmin=rmodel.ret.pmin,
                    pmax=rmodel.ret.pmax, device=dev, dtype=rmodel.dtype)
        torch.cuda.synchronize()
        gen_times.append(time.perf_counter() - t0)
    return gens / float(np.median(gen_times))


def wide_times(label, spec, kernel, plain, cases, call, one_cases,
               forward_b, rmodel, pb, dev, args, card, nwave, launches,
               mma_launches, one_launches, max_abs, one_abs, checks_s,
               setup_s):
    """The constant-R path's timings: K1 at B = 512 by CUDA events in
    turns with its plain version, its device ms (kernel_device_ms, which
    checks the launches the profile recorded), its bound at this width;
    K2 on chain 0 (one_chain_times, without the nested-walk batches);
    the forward at B = 512, DEMC generations/s, the card's peak memory of
    those two; with --profile the forward's device busy and idle share.
    Emits `times`; returns K1's and K2's entries, marked partial."""
    import torch
    ls_args, ls_kw = cases['B512_ls_deck']
    t0 = time.perf_counter()
    ms = paired_ms({
        'plain': lambda: plain(*ls_args, **ls_kw),
        'kernel': lambda: kernel(*ls_args, **ls_kw)})
    alone, whole, _, recorded = kernel_device_ms(
        lambda: kernel(*ls_args, **ls_kw), spec['name'] + '_kernel')
    bound_ms, bound_by = kernel_bound('transit', ls_args, ls_kw)
    one = one_chain_times(one_cases['B1_ls_deck'], call, card, label,
                          batches=())
    pb_t = torch.as_tensor(pb, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        ms_forward = float(np.median(cuda_times(lambda: forward_b(pb_t))))
    gens_per_s = demc_rate(rmodel, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    fields = dict(
        kernel_ms=ms['kernel'], plain_ms=ms['plain'], bound_ms=bound_ms,
        bound_by=bound_by, device_ms=alone, device_whole_call_ms=whole,
        device_recorded=recorded, main_path_launches=launches,
        main_path_mma_launches=mma_launches, forward_ms=ms_forward,
        forward_spectra_per_s=NCHAINS / (ms_forward * 1e-3),
        demc_generations_per_s=gens_per_s,
        max_memory_allocated_bytes=int(peak))
    emit('times', path=label, card=card, kernel=spec['name'],
         nlayers=int(ls_args[3].shape[1]), nwave=nwave, **fields,
         times_note='kernel_ms, plain_ms: CUDA events around runs of 4 '
                    'calls of the wrapper, in turns; device_ms: '
                    'torch.profiler, the kernel alone a launch over the '
                    'launches recorded (device_recorded: their share); '
                    'forward_ms: CUDA events; demc: 10 generations of 512 '
                    'chains by the host clock, the median of 3, with the '
                    'initial ensemble and the history copy; peak memory: '
                    'the forward and the DEMC runs')
    if args.profile:
        prof = profile(label, forward_b, pb_t, ms_forward)
        fields['device_idle_share'] = prof['device_idle_share']
    emit('phase_seconds', name=label, seconds=checks_s
         + time.perf_counter() - t0, setup_seconds=setup_s)
    k1 = {'name': spec['name'], 'launches': launches,
          'launches_by_path': {label: launches}, 'max_abs_err': max_abs,
          'partial': True, f'at_{label}': dict(nwave=nwave, **fields)}
    if one_launches < 1:
        fail(f'{label}: the main path launched the one-chain kernel no '
             'time')
    k2 = {'name': ONE_CHAIN['name'], 'launches': one_launches,
          'launches_by_path': {label: one_launches},
          'max_abs_err': max(one_abs.values()), 'partial': True,
          f'at_{label}': dict(nwave=nwave, **{
              k: one[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                                  'device_ms')})}
    return [k1, k2]


def write_spectrum_cfg(workdir, name, rt_path, atmfile=None, nlayers=None,
                       rayleigh=('H2', 'He', 'H'), extra=(), tli=None,
                       cia=BUNDLED_CIA, sampled=None):
    """The flagship config (runmode = spectrum) with this phase's
    sources, as <workdir>/<name>.cfg writing <workdir>/<name>.dat; with
    `tli`, H2O from that TLI file (the parity engine) in place of the
    line-sampled table; with `sampled`, that table in its place; the CIA
    files `cia`."""
    with open(os.path.join(workdir, 'flagship.cfg')) as f:
        lines = f.read().splitlines()
    out, in_clouds = [], False
    for line in lines:
        if in_clouds and line.startswith(' '):
            continue
        in_clouds = False
        key = line.split('=')[0].strip()
        if key == 'clouds':
            in_clouds = True
            out += ['clouds =', *[f'    {c}' for c in SPECTRUM_CLOUDS]]
            continue
        line = {
            'continuum_cross_sec':
                'continuum_cross_sec = ' + ' '.join(cia),
            'rt_path': f'rt_path = {rt_path}',
            'logfile': f'logfile = {workdir}/{name}.log',
            'atmfile': f'atmfile = {atmfile}' if atmfile else line,
            'sampled_cross_sec': f'tlifile = {tli}' if tli
            else f'sampled_cross_sec = {sampled}' if sampled else line,
        }.get(key, line)
        out.append(line)
    out += [f'specfile = {workdir}/{name}.dat',
            'rayleigh = ' + ' '.join(f'rayleigh_{m}' for m in rayleigh),
            *extra]
    if nlayers is not None:
        out += ['ptop = 1e-6 bar', 'pbottom = 100 bar', f'nlayers = {nlayers}']
    cfg = os.path.join(workdir, name + '.cfg')
    with open(cfg, 'w') as f:
        f.write('\n'.join(out) + '\n')
    return cfg


def fitted_cases(label, model, pre, post, tag):
    """Kernel cases at B = 512 and B = 1 from one batched forward: the
    kernel on the operands the size rule fitted (`post`, the wrapper's
    call) against the plain version on every operand before the rule
    (`pre`, fit_operands' call), with the wrapper's per-chain
    preparation: name -> (kernel args, kernel kw, plain args, plain
    kw)."""
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    per_chain = ('cia_w', 'r1_cols', 'r1_rows', 'ls_w')
    (pre_parts,), pre_kw = pre
    args, kw = post
    post_parts = args[0]

    def operands(parts, ops, sl):
        ops = {k: (v[sl] if k in per_chain and v is not None else v)
               for k, v in ops.items()
               if k in (*per_chain, 'cia_tab', 'ls_tab')}
        return [p[sl] for p in parts], dict(ops, maxdepth=kw['maxdepth'])

    cases = {}
    for case, sl in ((f'B512_{tag}', slice(None)), (f'B1_{tag}', slice(0, 1))):
        if label == 'transit':
            _, path, rr, rstar, itop, ibottom = args
            prepared = tk.prep_chains(
                path[sl], rr[sl], rstar, itop[sl], ibottom[sl],
                kw['deck_itop'][sl], kw['deck_rsurf'][sl])
        else:
            _, radius, temp, wn, mu, weights, itop, ibottom = args
            prepared = (*ek.prep_emission_chains(
                radius[sl], temp[sl], itop[sl], ibottom[sl],
                kw['deck_itop'][sl], kw['deck_tsurf'][sl]), wn, mu, weights)
        k_parts, k_kw = operands(post_parts, kw, sl)
        p_parts, p_kw = operands(pre_parts, pre_kw, sl)
        cases[case] = ((k_parts, *prepared), k_kw, (p_parts, *prepared), p_kw)
    return cases


def run_spectrum(workdir, dev, args, card):
    """runmode = spectrum and runmode = atmosphere on the flagship at
    full width: Model.run through the RT kernels at B = 1 from the
    CLI's driver, the kernels against their plain versions beyond their
    operand limits (40 CIA rows, 6 rank-1 terms, 5 dense parts, 81
    layers; K2 streamed at 300 layers), GPU against CPU float64,
    timings.  Returns the kernels'
    launches, what the tall function's entry takes from the phase and
    the phase's Models by run name."""
    import torch
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch import runtime
    from pyratbay_tpu_torch.benchmark import make_flagship, make_lbl_flagship
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.io import io as pio
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.retrieval import batched
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    _, obs, _, _, _ = make_flagship(workdir, device=dev)
    # Stars from files, and H2O from the flagship's TLI file:
    pck = write_kurucz_file(os.path.join(workdir, 'stars.pck'),
                            np.linspace(900.0, 1900.0, 1001), KURUCZ_MODELS)
    sed = write_sed_file(os.path.join(workdir, 'star_sed.dat'),
                         np.linspace(1.0, 1.8, SED_POINTS), SED_TEMPS)
    lines_dir = os.path.join(workdir, 'lines')
    _, tli_cfg, _ = make_lbl_flagship(lines_dir, nlines=NLINES)
    run(tli_cfg)
    tli = os.path.join(lines_dir, 'flagship_h2o.tli')
    atm_e = os.path.join(workdir, 'electrons.atm')
    nl = NLAYERS
    pio.write_atm(atm_e, np.logspace(-6, 2, nl), np.full(nl, 1400.0),
                  ELECTRONS, np.tile(ELECTRON_VMR, (nl, 1)), punits='bar')
    with_e = dict(atmfile=atm_e, rayleigh=('H2', 'He', 'H', 'e-'),
                  extra=('h_ion = h_ion_john1988',))
    runs = {
        # name: (rt_path, config options, K1, K2, K1's tall function, K3,
        # K2 streamed)
        'transit': ('transit', {}, 0, 1, 0, 0, 0),
        'eclipse': ('eclipse', {}, 0, 0, 0, 1, 0),
        'transit_patchy': ('transit', dict(extra=('fpatchy = 0.4',)),
                           0, 2, 0, 0, 0),
        'transit_h_ion': ('transit', with_e, 0, 1, 0, 0, 0),
        'eclipse_h_ion': ('eclipse', with_e, 0, 0, 0, 1, 0),
        'transit_tall': ('transit', dict(with_e, nlayers=TALL_LAYERS),
                         0, 1, 0, 0, 0),
        'eclipse_tall': ('eclipse', dict(with_e, nlayers=TALL_LAYERS),
                         0, 0, 0, 1, 0),
        'transit_deep': ('transit', dict(nlayers=DEEP_LAYERS),
                         0, 1, 0, 0, 1),
        'eclipse_kurucz': ('eclipse', dict(extra=(
            f'kurucz = {pck}', 'log_gstar = 4.4')), 0, 0, 0, 1, 0),
        'eclipse_starspec': ('eclipse', dict(extra=(f'starspec = {sed}',)),
                             0, 0, 0, 1, 0),
        'transit_tli': ('transit', dict(tli=tli), 0, 1, 0, 0, 0),
        'eclipse_tli': ('eclipse', dict(tli=tli), 0, 0, 0, 1, 0),
    }
    counters = (tk.transit_rt_cuda, tk.transit_one_cuda, ek.emission_rt_cuda)
    natives = (runtime.lbl_group, runtime.lbl_scatter)
    total = {'transit_rt': 0, 'transit_one': 0, 'transit_rt_tall': 0,
             'emission_rt': 0, 'transit_one_streamed': 0}
    cfgs, models, deep_call = {}, {}, None
    for name, (rt_path, opts, *expect) in runs.items():
        cfgs[name] = cfg = write_spectrum_cfg(workdir, name, rt_path, **opts)
        for counter in counters:
            counter.launches = 0
        for fn in natives:
            fn.calls = 0
        tk.transit_rt_cuda.tall_launches = 0
        tk.transit_one_cuda.streamed_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # (The default device: the card.  The deep run's RT call is kept
        # for K2's check below.)
        calls = record_calls(
            ((model_mod, 'transit_spectrum_ensemble'),)
            if name == 'transit_deep' else (),
            lambda: models.update({name: run(cfg)}))
        model = models[name]
        if calls:
            deep_call, = calls
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {
            'transit_rt': tk.transit_rt_cuda.launches,
            'transit_one': tk.transit_one_cuda.launches,
            'transit_rt_tall': tk.transit_rt_cuda.tall_launches,
            'emission_rt': ek.emission_rt_cuda.launches,
            'transit_one_streamed': tk.transit_one_cuda.streamed_launches}
        # The parity engine's grouping and scatter in the native runtime
        # (a TLI file's H2O): one grouping a model, a scatter a layer.
        native_calls = {fn.__name__: fn.calls for fn in natives}
        for key, value in launches.items():
            total[key] += value
        models[name] = model
        wn, spec = pio.read_spectrum(os.path.join(workdir, name + '.dat'))
        t0 = time.perf_counter()
        cpu = Model(cfg, device='cpu').run()['spectrum']
        cpu_s = time.perf_counter() - t0
        rel, absolute = rel_err(
            torch.as_tensor(model.spectrum)[None], cpu[None])
        checks = {
            'on_the_card': model.device.type == 'cuda',
            'launches': list(launches.values()) == expect,
            'shape': spec.shape == (model.nwave,) == model.spectrum.shape,
            'finite': bool(np.all(np.isfinite(spec))),
            'read_back': bool(np.allclose(spec, model.spectrum, rtol=1e-8,
                                          atol=0)),
            'gpu_vs_cpu': rel < FORWARD_TOL,
            'native_runtime': 'tli' not in opts or all(
                n > 0 for n in native_calls.values()),
        }
        emit('main_path_spectrum', run=name, rt_path=rt_path,
             nlayers=model.nlayers, nwave=model.nwave, seconds=seconds,
             native_calls=native_calls,
             cpu_seconds=cpu_s, star=star_of(model),
             launches=launches, expected=expect, gpu_vs_cpu_max_rel_err=rel,
             gpu_vs_cpu_max_abs_err=absolute, tol=FORWARD_TOL, checks=checks,
             opacity_models=[m.name for _, m, _ in model.opacity_models])
        if not all(checks.values()):
            fail(f'spectrum {name}: {checks}')

    # runmode = atmosphere on the flagship:
    atm_cfg = os.path.join(workdir, 'atmosphere.cfg')
    atm_out = os.path.join(workdir, 'flagship_out.atm')
    with open(cfgs['transit']) as f:
        text = f.read().replace('runmode = spectrum', 'runmode = atmosphere')
    with open(atm_cfg, 'w') as f:
        f.write(text + f'output_atmfile = {atm_out}\n')
    run(atm_cfg)
    _, species, press, temp, vmr, radius = pio.read_atm(atm_out)
    checks = {'layers': len(press) == NLAYERS,
              'radius_finite': radius is not None
              and bool(np.all(np.isfinite(radius))),
              'temperature_finite': bool(np.all(np.isfinite(temp)))}
    emit('main_path_atmosphere', species=list(species), layers=len(press),
         radius_km=[float(radius[0]), float(radius[-1])],
         temperature_k=[float(temp.min()), float(temp.max())],
         checks=checks)
    if not all(checks.values()):
        fail(f'atmosphere: {checks}')

    # The kernels beyond their operand limits, from batched forwards at
    # B = 512 (the last call of each wrapper and of the size rule):
    rng = np.random.default_rng(0)
    case_abs = {}
    all_cases = {}
    one_cases = {}
    for label, wrapper, kernel, plain, tol in (
            ('transit', 'transit_spectrum_ensemble', tk.transit_rt_cuda,
             tk.transit_rt_plain, KERNELS['transit']['tol']),
            ('eclipse', 'emission_flux_ensemble', ek.emission_rt_cuda,
             ek.emission_rt_plain, KERNELS['eclipse']['tol'])):
        for tag, name in (('cia40_r1_5', label),
                          ('r1_6_h_ion', f'{label}_h_ion'),
                          ('layers81', f'{label}_tall')):
            model = models[name]
            mobs = Observation(obs_cfg(obs), model.wn)
            ret = RetrievalParams(model, mobs)
            pb = np.clip(ret.params + ret.pstep * rng.standard_normal(
                (NCHAINS, len(ret.params))), ret.pmin, ret.pmax)
            forward_b = batched.build_forward_batched(model, mobs, ret)
            pre, post = record_calls(
                ((batched, 'fit_operands'), (model_mod, wrapper)),
                lambda: forward_b(pb))
            cases = fitted_cases(label, model, pre, post, tag)
            if tag == 'r1_6_h_ion':
                # Five dense parts (the H- part split in five), through
                # the size rule:
                k_args, k_kw, p_args, p_kw = cases[f'B512_{tag}']
                parts5 = [0.2 * p_args[0][0]] * 5
                fit = tk.fit_operands(parts5, **{
                    k: v for k, v in p_kw.items() if k != 'maxdepth'})
                cases['B512_parts5'] = (
                    (fit.pop('ec_parts'), *k_args[1:]),
                    dict(fit, maxdepth=k_kw['maxdepth']),
                    (parts5, *p_args[1:]), p_kw)
            if (label, tag) == ('transit', 'layers81'):
                # The tall function on the operands it had before it took
                # the line sample: the table as a dense part (3 dense
                # parts in all), as the old 4.057 ms were measured on.
                k_args, k_kw, p_args, p_kw = cases[f'B512_{tag}']
                if k_kw['ls_w'] is None:
                    fail('spectrum: the 81-layer transit forward made the '
                         'line sample a dense part')
                dense = torch.einsum('bkl,klw->blw', k_kw['ls_w'],
                                     k_kw['ls_tab']).contiguous()
                cases[f'B512_{tag}_dense_ls'] = (
                    ([*k_args[0], dense], *k_args[1:]),
                    dict(k_kw, ls_w=None, ls_tab=None), p_args, p_kw)
            for case, (k_args, k_kw, p_args, p_kw) in cases.items():
                got = kernel(*k_args, **k_kw)
                want = plain(*p_args, **p_kw)
                torch.cuda.synchronize()
                rel, absolute = rel_err(got, want)
                sizes = dict(
                    dense_parts=[len(k_args[0]), len(p_args[0])],
                    rank1=[int(k_kw['r1_cols'].shape[1]),
                           int(p_kw['r1_cols'].shape[1])],
                    cia_rows=[int(k_kw['cia_w'].shape[2]),
                              int(p_kw['cia_w'].shape[2])],
                    line_sample_rows=[
                        0 if kw['ls_w'] is None else int(kw['ls_w'].shape[1])
                        for kw in (k_kw, p_kw)])
                emit('kernel_check', kernel=KERNELS[label]['name'],
                     case=case, shape=list(got.shape),
                     nlayers=model.nlayers, kernel_and_plain_operands=sizes,
                     max_rel_err=rel, max_abs_err=absolute, tol=tol)
                if not rel < tol:
                    fail(f'{label} {case}: kernel disagrees with plain '
                         f'({rel})')
                case_abs[(label, case)] = absolute
            all_cases[(label, tag)] = cases
            if label == 'transit':
                # K2 on chain 0 of the wrapper's call (the rule-fitted
                # operands) against the plain version on every operand
                # before the rule (fit_operands' call):
                (pre_parts,), pre_kw = pre
                one_args, one_kw = one_case(post)
                plain_kw = dict(one_kw, **{
                    k: (v[:1] if k in _ONE_PER_CHAIN and v is not None
                        else v) for k, v in pre_kw.items()})
                plain_args = ([p[:1] for p in pre_parts], *one_args[1:])
                one_cases[f'B1_{tag}'] = (one_args, one_kw, plain_args,
                                          plain_kw)

    one_abs = 0.0
    for case, (k_args, k_kw, p_args, p_kw) in one_cases.items():
        got = tk.transit_one_cuda(*k_args, **k_kw)
        want = tk.transit_one_plain(*p_args, **p_kw)
        torch.cuda.synchronize()
        rel, absolute = rel_err(got, want)
        emit('kernel_check', kernel=ONE_CHAIN['name'], case=case,
             shape=list(got.shape), nlayers=int(k_args[2].shape[1]),
             kernel_and_plain_operands=dict(
                 dense_parts=[len(k_args[0]), len(p_args[0])],
                 rank1=[int(kw['r1_cols'].shape[1]) for kw in (k_kw, p_kw)],
                 cia_rows=[int(kw['cia_w'].shape[2]) for kw in (k_kw, p_kw)]),
             max_rel_err=rel, max_abs_err=absolute, tol=ONE_CHAIN['tol'])
        if not rel < ONE_CHAIN['tol']:
            fail(f'spectrum {case}: K2 disagrees with plain ({rel})')
        one_abs = max(one_abs, absolute)
    # K2 streamed (ec and the depths through device memory) on the deep
    # run's operands, against its plain version; its times by events in
    # turns with the plain version and by the profiler:
    one_abs = max(one_abs, *check_kernel(
        ONE_CHAIN['name'], tk.transit_one_cuda, tk.transit_one_plain,
        {'B1_deep_streamed': deep_call}, ONE_CHAIN['tol']).values())
    deep_ms = paired_ms({
        'kernel': lambda: tk.transit_one_cuda(*deep_call[0], **deep_call[1]),
        'plain': lambda: tk.transit_one_plain(*deep_call[0], **deep_call[1])},
        repeats=5)
    deep_dev = kernel_device_ms(
        lambda: tk.transit_one_cuda(*deep_call[0], **deep_call[1]),
        'transit_one_kernel')
    streamed = dict(
        nlayers=DEEP_LAYERS, kernel_ms=deep_ms['kernel'],
        plain_ms=deep_ms['plain'], device_ms=deep_dev[0],
        device_recorded=deep_dev[3],
        staged_max_layers=tk.one_staged_max_layers(*[
            0 if deep_call[1][k] is None else deep_call[1][k].shape[i]
            for k, i in (('r1_cols', 1), ('cia_w', 2), ('ls_w', 1))],
            len(deep_call[0][0])))
    streamed['bound_ms'], streamed['bound_by'] = one_bound(*deep_call)

    # Times (NVIDIA card named in `card`): Model.run by the host clock
    # (ending in a synchronize), K1 and K3 at B = 1 on Model.run's
    # operands and the tall function at B = 512 on 81 layers (the line
    # sample in it, and as a dense part) by events, in turns with their
    # plain versions; the tall function's device time by the profiler.
    run_s, stamp_s = {}, {}
    for name in ('transit', 'eclipse', 'transit_tall'):
        model = models[name]
        times, stamps = [], []
        for _ in range(MODEL_RUN_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            stamps.append(model.timestamps['spectrum'])
        run_s[name] = float(np.median(times))
        stamp_s[name] = float(np.median(stamps))
    # K2 on Model.run's operands (chain 0 of the B = 512 wrapper call:
    # 40 CIA rows and 5 rank-1 terms through the size rule), events around
    # the whole wrapper in turns with its plain version, device ms and
    # launches by the profiler:
    k_args, k_kw, _, _ = one_cases['B1_cia40_r1_5']
    one_ms = paired_ms({
        'kernel': lambda: tk.transit_one_cuda(*k_args, **k_kw),
        'plain': lambda: tk.transit_one_plain(*k_args, **k_kw)}, repeats=5)
    one_dev = kernel_device_ms(
        lambda: tk.transit_one_cuda(*k_args, **k_kw), 'transit_one_kernel')
    one_timed = dict(
        kernel_ms=one_ms['kernel'], plain_ms=one_ms['plain'],
        device_ms=one_dev[0], device_recorded=one_dev[3],
        device_launches=call_launches(
            lambda: tk.transit_one_cuda(*k_args, **k_kw),
            'transit_one_kernel'))
    one_timed['bound_ms'], one_timed['bound_by'] = one_bound(k_args, k_kw)
    if one_timed['device_launches'] != 1:
        fail(f'spectrum: K2 on Model.run\'s operands made '
             f'{one_timed["device_launches"]} device launches a call, not 1')
    timed = {}
    for key, (label, tag, case) in {
            'transit_b1': ('transit', 'cia40_r1_5', 'B1_cia40_r1_5'),
            'emission_b1': ('eclipse', 'cia40_r1_5', 'B1_cia40_r1_5'),
            'tall_b512': ('transit', 'layers81', 'B512_layers81'),
            'tall_b512_dense_ls': ('transit', 'layers81',
                                   'B512_layers81_dense_ls'),
            'tall_b1': ('transit', 'layers81', 'B1_layers81'),
            'emission_81_b512': ('eclipse', 'layers81', 'B512_layers81'),
    }.items():
        k_args, k_kw, p_args, p_kw = all_cases[(label, tag)][case]
        kernel = tk.transit_rt_cuda if label == 'transit' \
            else ek.emission_rt_cuda
        plain = tk.transit_rt_plain if label == 'transit' \
            else ek.emission_rt_plain
        ms = paired_ms({
            'kernel': lambda: kernel(*k_args, **k_kw),
            'plain': lambda: plain(*k_args, **k_kw)}, repeats=5)
        bound_ms, bound_by = kernel_bound(
            'transit' if label == 'transit' else 'eclipse', k_args, k_kw)
        timed[key] = dict(kernel_ms=ms['kernel'], plain_ms=ms['plain'],
                          bound_ms=bound_ms, bound_by=bound_by)
        if key.startswith('tall_b512'):
            timed[key]['device_ms'] = kernel_device_ms(
                lambda: kernel(*k_args, **k_kw), 'transit_rt_tall_kernel')[0]
            timed[key]['dense_parts'] = len(k_args[0])
    earlier = dict(
        timed['tall_b512_dense_ls'], earlier_ms=EARLIER_TALL_MS,
        earlier_note='a constant from PERF.md, not measured in this run: '
                     'the tall function before its redesign on these '
                     'operands')
    emit('times_spectrum', card=card, model_run_seconds=run_s,
         model_run_note=f'host clock around Model.run ending in a '
                        f'synchronize, median of {MODEL_RUN_REPEATS}',
         model_run_spectrum_stamp_seconds=stamp_s,
         one_chain_b1=one_timed, one_chain_streamed=streamed,
         kernels=dict(timed, tall_b512_dense_ls=earlier),
         kernels_note='CUDA events around runs of 4 calls of the kernel '
                      'wrapper on the rule-fitted operands, medians, in '
                      'turns with the plain version on the same operands')
    if args.profile:
        for name in ('transit', 'eclipse'):
            profile(f'model_run_{name}', lambda _: models[name].run(), None,
                    run_s[name] * 1e3)
    tall_abs = max(v for (label, case), v in case_abs.items()
                   if label == 'transit' and 'layers81' in case)
    # What the tall function's and K2's kernel entries take from this
    # phase (Model.run launches K2 at B = 1, and the tall function no
    # time):
    tall = {'max_abs_err': tall_abs, 'one_max_abs_err': one_abs,
            'spectrum_operands': {
                key: timed[key] for key in ('tall_b512',
                                            'tall_b512_dense_ls')}}
    for key in ('transit_one', 'emission_rt'):
        if total[key] < 1:
            fail(f'spectrum: {key} launched no time')
    return total, tall, models


# The model_io phase: the ops helpers on the card in float32 against the
# CPU in float64, relative above this share of the largest value:
OPS_TOL = 1e-4
OPS_FLOOR = 1e-6
RUN_STAMPS = ('atmosphere', 'extinction', 'spectrum')


def ops_on_the_card(dev):
    """The ops helpers (integration, interpolation, widths, profiles) on
    float32 tensors on the card against the CPU in float64 on the same
    float32 inputs: name -> (max relative error above OPS_FLOOR of the
    maximum, max absolute error)."""
    import torch
    from pyratbay_tpu_torch.ops import integrate, interp, special
    gen = torch.Generator().manual_seed(13)
    on_card = lambda a: a.to(torch.float32).to(dev)
    x = on_card(torch.linspace(-30.0, 30.0, 4001, dtype=torch.float64))
    data = on_card(torch.rand(257, 64, generator=gen, dtype=torch.float64))
    steps = on_card(torch.rand(256, generator=gen, dtype=torch.float64)
                    + 0.1)
    grid = torch.cat([steps[:1] * 0, torch.cumsum(steps, 0)])   # 257
    temps = on_card(torch.linspace(300.0, 3000.0, 10, dtype=torch.float64))
    # A positive table within a decade, as a cross-section table's rows
    # near one wavenumber (a float32 lerp's error is a rounding of its
    # larger end, so rows spanning decades fail a relative bound):
    table = on_card(0.5 + torch.rand(10, 3209, generator=gen,
                                     dtype=torch.float64))
    slopes = torch.diff(table, dim=0) / torch.diff(temps)[:, None]
    # A profile inside the table's temperatures, as its callers clamp
    # them (beyond them the lines extrapolate through zero):
    tprof = on_card(torch.linspace(300.0, 3000.0, 51, dtype=torch.float64))
    press = on_card(torch.logspace(-6, 2, 51, dtype=torch.float64))
    masses = [2.016, 4.003, 18.015]
    radii = [1.445e-8, 1.09e-8, 1.6e-8]
    vmr = [0.85, 0.149, 1e-3]
    calls = {
        'trapz_intervals': lambda a: integrate.trapz_intervals(
            a['data'], a['steps'], 0),
        'simpson_nonuniform': lambda a: integrate.simpson_nonuniform(
            a['data'], x=a['grid']),
        'lin_interp_trow': lambda a: interp.lin_interp_trow(
            a['table'], a['temps'], a['slopes'], a['tprof'], 0, 3000),
        'doppler_hwhm': lambda a: special.doppler_hwhm(
            a['tprof'], 18.015, 8000.0),
        'lorentz_hwhm': lambda a: special.lorentz_hwhm(
            a['tprof'][:, None], a['press'][:, None], masses, radii, vmr,
            [0, 2]),
        'Lorentz': lambda a: special.Lorentz(0.3, 0.7, 2.0)(a['x']),
        'Gauss': lambda a: special.Gauss(-0.2, 1.3, 0.5)(a['x']),
        'Voigt_exact': lambda a: special.Voigt(0.1, 0.05, 1.0)(a['x']),
        'Voigt_rational': lambda a: special.Voigt(0.1, 2.0, 1.0)(a['x']),
    }
    gpu = dict(x=x, data=data, steps=steps, grid=grid, temps=temps,
               table=table, slopes=slopes, tprof=tprof, press=press)
    cpu = {k: v.double().cpu() for k, v in gpu.items()}
    errors = {}
    for name, call in calls.items():
        got = call(gpu)
        if got.device.type != 'cuda' or got.dtype != torch.float32:
            fail(f'model_io: {name} gave {got.dtype} on {got.device}')
        errors[name] = masked_rel(got.reshape(-1), call(cpu).reshape(-1),
                                  OPS_FLOOR)
    return errors


def run_model_io(workdir, dev, args, card, transit_model, eclipse_model):
    """save_model / load_model on the card: the transit retrieval's Model
    (posterior, bestp, spec_best) and the eclipse flagship's spectrum
    Model are saved, reopened on the default device and run (K2, K3);
    the spectra against the originals' within the kernels' bounds,
    the result arrays exactly, K2 and K3 on the reopened models' operands
    against their plain versions, the summaries against a CPU float64
    Model's, the ops helpers against the CPU, and timings (save, load,
    the reopened run by the host clock and by Model.timestamps).  Returns
    the main path's launches and the kernels' largest differences."""
    import torch
    from pyratbay_tpu_torch import io as pbio
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.opacity import HydrogenIon
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    counters = (tk.transit_rt_cuda, tk.transit_one_cuda, ek.emission_rt_cuda)
    total = {c.__name__: 0 for c in counters}
    max_abs = {}
    for label, original in (('transit', transit_model),
                            ('eclipse', eclipse_model)):
        # Model.run: K2 (one chain) or K3.
        spec = ONE_CHAIN if label == 'transit' else KERNELS[label]
        want = torch.as_tensor(original.run()['spectrum'])
        path = os.path.join(workdir, f'{label}_model.pickle')
        # The main path: save, reopen on the default device, run.
        for counter in counters:
            counter.launches = 0
        tk.transit_rt_cuda.tall_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pbio.save_model(original, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reopened = pbio.load_model(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        restored = {key: getattr(reopened, key)
                    for key in pbio.io._MODEL_RESULT_ATTRS
                    if getattr(original, key, None) is not None}
        t0 = time.perf_counter()
        got = reopened.run()['spectrum']
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        for key, value in launches.items():
            total[key] += value
        rel, absolute = rel_err(got[None], want[None].to(got.device))

        # K2 or K3 on the reopened model's operands:
        kind = 'transit' if label == 'transit' else 'eclipse'
        wrapper = 'transit_spectrum_ensemble' if kind == 'transit' \
            else 'emission_flux_ensemble'
        kernel, plain = (tk.transit_one_cuda, tk.transit_one_plain) \
            if kind == 'transit' else (ek.emission_rt_cuda,
                                       ek.emission_rt_plain)
        call, = record_calls(((model_mod, wrapper),),
                             lambda: reopened.run())
        case = call if kind == 'transit' \
            else wrapper_case(kind, reopened, call)
        max_abs[spec['name']] = check_kernel(
            spec['name'], kernel, plain, {'model_io_B1': case},
            spec['tol'])['model_io_B1']

        # The summaries on the card against a CPU float64 Model of the
        # same configuration, each run once:
        cpu_model = Model(reopened.cfg, device='cpu')
        cpu_model.run()
        head = lambda m: str(m).split('Last-run timestamps')[0]
        summaries = {f'{mtype} {m.name}': len(str(m))
                     for mtype, m, _ in reopened.opacity_models}
        if label == 'transit':
            summaries.update({
                'observation': len(str(original.obs)),
                'retrieval_params': len(str(original.ret)),
                'passband': len(str(original.obs.filters[0])),
                'h_ion': len(str(HydrogenIon(reopened.wn).to(
                    dev, torch.float32)))})

        equal = {key: bool(np.array_equal(np.asarray(value),
                                          np.asarray(getattr(original, key))))
                 for key, value in restored.items()}
        stamps_s = sum(reopened.timestamps[key] for key in RUN_STAMPS)
        checks = {
            'on_the_card': reopened.device.type == 'cuda',
            'launches': launches == (
                {'transit_rt_cuda': 0, 'transit_one_cuda': 1,
                 'emission_rt_cuda': 0} if kind == 'transit' else
                {'transit_rt_cuda': 0, 'transit_one_cuda': 0,
                 'emission_rt_cuda': 1}),
            'spectrum': rel < spec['tol'],
            'results_restored': all(equal.values()) and (
                label != 'transit' or {'posterior', 'bestp', 'spec_best'}
                <= set(equal)),
            'summary_as_on_the_cpu': head(reopened) == head(cpu_model),
            'timestamps': set(RUN_STAMPS) <= set(reopened.timestamps),
        }
        emit('model_io', model=label, card=card, file_bytes=os.path.getsize(
                 path),
             save_seconds=save_s, load_seconds=load_s,
             load_note='load_model: the set-up from the pickled '
                       'configuration onto the card, ended by a '
                       'synchronize',
             run_seconds=run_s, timestamps_run_seconds=stamps_s,
             timestamps={k: reopened.timestamps[k] for k in RUN_STAMPS},
             run_note='host clock around the reopened Model.run ending in '
                      'a synchronize, beside the sum of its three stamps',
             launches=launches, spectrum_max_rel_err=rel,
             spectrum_max_abs_err=absolute, tol=spec['tol'],
             restored=equal, summary_chars=len(head(reopened)),
             other_summaries_chars=summaries, checks=checks)
        if not all(checks.values()):
            if not checks['summary_as_on_the_cpu']:
                emit('model_io_summaries', card_text=head(reopened),
                     cpu_text=head(cpu_model))
            fail(f'model_io {label}: {checks}')

    errors = ops_on_the_card(dev)
    emit('model_io_ops', card=card, tol=OPS_TOL, floor=OPS_FLOOR,
         errors={name: {'max_rel_err': rel, 'max_abs_err': absolute}
                 for name, (rel, absolute) in errors.items()})
    bad = [name for name, (rel, _) in errors.items() if not rel < OPS_TOL]
    if bad:
        fail(f'model_io: ops helpers off the CPU float64 values: {bad}')
    return total, max_abs


def star_of(model):
    """The kind of a model's star."""
    cfg = model.cfg
    return ('starspec' if cfg.starspec else 'kurucz' if cfg.kurucz
            else 'blackbody' if model.star_is_blackbody else None)


def masked_rel(got, want, floor=1e-6):
    """(max relative difference on the entries of `want` above `floor`
    of its maximum, max absolute difference); inf if not finite."""
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    if not (np.all(np.isfinite(got)) and np.all(np.isfinite(want))):
        return np.inf, np.inf
    mask = np.abs(want) > floor * np.abs(want).max()
    diff = np.abs(got - want)
    return float(np.max(diff[mask] / np.abs(want[mask]))), float(diff.max())


def lbl_operands(direct, cells, nspec, windows=True):
    """Operands of K4 and K5 on per-line factors (the main path's), and
    with `windows` of their window-layout kernels and of K6, for the
    cells (temps, dens, pf) of a DirectLBL engine: kernel -> (args,
    kwargs)."""
    tables = direct.tables()
    line = direct._line_factors(tables, *cells)
    spec = lambda pre: tables[pre + 'spec'] if nspec > 1 else None
    wing_kw = dict(margin=direct.margin, cutoff=direct.cutoff, nspec=nspec)
    core_kw = dict(margin=direct.margin, nspec=nspec)
    lines = (tables['l_lwn_hi'], tables['l_lwn_lo'])
    out = {
        'wing_lines': ((
            tables['wn_wf_hi'], tables['wn_wf_lo'], tables['starts_wf'],
            *lines, line['c1'], line['y2'], line['inv_ad'], spec('l_')),
            dict(lmax=direct.lmax_wf, **wing_kw)),
        'core_lines': ((
            tables['wn_core_hi'], tables['wn_core_lo'],
            tables['starts_core'], *lines, line['scale'], line['y'],
            line['inv_ad'], spec('l_')),
            dict(lmax=direct.lmax_core, **core_kw)),
    }
    if not windows:
        return out
    fac = direct._cell_factors(tables, *cells, 'wf_')
    fac_w = direct._cell_factors(tables, *cells, 'w_')
    out.update({
        'wing_grouped': ((
            tables['wn_wf_hi'], tables['wn_wf_lo'], tables['wf_lwn_hi'],
            tables['wf_lwn_lo'], fac['c1_w'], fac['y2_w'], fac['inv_ad_w'],
            spec('wf_')), wing_kw),
        'core': ((
            tables['wn_core_hi'], tables['wn_core_lo'], tables['c_lwn_hi'],
            tables['c_lwn_lo'], fac['scale_c'], fac['y_c'], fac['inv_ad_c'],
            spec('c_')), core_kw),
        'wing': ((
            tables['wn_tiles_hi'], tables['wn_tiles_lo'], tables['w_lwn_hi'],
            tables['w_lwn_lo'], fac_w['c1_w'], fac_w['y2_w'],
            fac_w['inv_ad_w'], spec('w_')), wing_kw),
    })
    return out


def lbl_bound(key, operands, kw):
    """(roofline bound in ms, 'bytes' or 'operations', issue bound in
    ms) of one line-by-line launch: the pairs this data needs, those
    inside the pass's mask (margin < |dnu| <= cutoff for the wings,
    |dnu| <= margin for the cores) for every cell, whatever the layout
    of the operands; and the fewest bytes the function needs: the tiles,
    the line arrays and each line's three factors per cell read once
    (the window layout holds a line once per window it falls in: those
    copies are not counted), the cross sections written once.  The issue
    bound is the same pairs at the instructions a lane needs for one."""
    import torch
    wn_hi, wn_lo = operands[:2]
    ntiles, tile = wn_hi.shape
    if key.endswith('_lines'):
        starts, lwn_hi, lwn_lo, factor = operands[2:6]
        idx = starts[:, None].long() + torch.arange(
            kw['lmax'], device=starts.device)[None, :]
        lwn_hi, lwn_lo = lwn_hi[idx], lwn_lo[idx]
        ncell, nlines = factor.shape
    else:
        lwn_hi, lwn_lo, factor = operands[2:5]
        ncell = factor.shape[0]
        # The lines under the windows, once each:
        nlines = int(torch.unique(lwn_hi.double() + lwn_lo.double()).numel())
    pairs = 0
    for t0 in range(0, ntiles, 256):      # bounded temporaries
        sl = slice(t0, t0 + 256)
        dnu = torch.abs((wn_hi[sl, :, None] - lwn_hi[sl, None, :])
                        + (wn_lo[sl, :, None] - lwn_lo[sl, None, :]))
        if key.startswith('core'):
            pairs += int((dnu <= kw['margin']).sum())
        else:
            pairs += int(((dnu > kw['margin'])
                          & (dnu <= kw['cutoff'])).sum())
    core = key.startswith('core')
    flops = CORE_PAIR_FLOPS if core else WING_PAIR_FLOPS
    instr = CORE_PAIR_INSTR if core else WING_PAIR_INSTR
    nspec = kw['nspec']
    nbytes = 4 * (2 * ntiles * tile + ntiles + 2 * nlines
                  + 3 * ncell * nlines + (nlines if nspec > 1 else 0)
                  + ncell * nspec * ntiles * tile)
    bound_ms, bound_by = roofline(nbytes, ncell * pairs * flops)
    return bound_ms, bound_by, ncell * pairs * instr / (PEAK_FP32 / 2) * 1e3


def cells_of(direct, temps, press, vmr):
    """Float32 cell inputs (temps, densities, pfs) on the engine's
    device for every (T, p) pair, as DirectLBL.tabulate prepares them."""
    from pyratbay_tpu_torch import constants as pc
    t = np.repeat(temps, len(press))
    p = np.tile(press, len(temps))
    dens = np.tile(vmr, (len(temps), 1)) * (
        p[:, None] * pc.bar / (pc.k * t[:, None]))
    return [direct._f32(a) for a in (t, dens, direct.lbl.iso_pf(t).T)]


def run_opacity(workdir, dev, args, card):
    """The opacity path end to end: main path, kernel checks, GPU against
    CPU, timings.  Returns the three kernel entries."""
    import torch
    from pyratbay_tpu_torch.benchmark import (
        make_lbl_flagship, synthetic_lines)
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.io import io as pio
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.opacity import lbl_kernel as lk
    from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL
    from pyratbay_tpu_torch.opacity.line_sample import LineSample
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    every = {**LBL, **LBL_WINDOWS}
    kernels = {key: getattr(lk, spec['fn'] + '_cuda')
               for key, spec in every.items()}
    plains = {key: getattr(lk, spec['fn'] + '_plain')
              for key, spec in every.items()}
    counters = (*kernels.values(), tk.transit_rt_cuda, ek.emission_rt_cuda)

    # 1. The main path: line list -> TLI -> table -> LineSample.
    t0 = time.perf_counter()
    _, tli_cfg, opacity_cfg = make_lbl_flagship(workdir, nlines=NLINES)
    inputs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = run(tli_cfg)
    tli_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = Model(opacity_cfg, device=dev)
    setup_s = time.perf_counter() - t0
    lbl = model.opacity_models[0][1]
    for counter in counters:
        counter.launches = 0
    # Every factor tensor the main path makes is recorded by shape: none
    # may have the window layout [ncell, ntiles, lmax].
    factor_shapes = set()
    real_line, real_window = DirectLBL._line_factors, DirectLBL._window_factors

    def line_factors(self, *a):
        fac = real_line(self, *a)
        factor_shapes.update(tuple(v.shape) for v in fac.values())
        return fac

    def window_factors(self, *a):
        out = real_window(self, *a)
        factor_shapes.update(tuple(v.shape) for v in out)
        return out

    DirectLBL._line_factors = line_factors
    DirectLBL._window_factors = window_factors
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        call, = record_calls(
            ((DirectLBL, '_cross_section_batch'),),
            lambda: model.compute_opacity(engine='direct'))
    finally:
        DirectLBL._line_factors = real_line
        DirectLBL._window_factors = real_window
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {key: fn.launches for key, fn in kernels.items()}
    all_launches = {c.__name__: c.launches for c in counters}
    table = model.cs_table
    direct = model.direct_lbl(lbl)
    ncells = table.shape[0] * table.shape[1]
    nblocks = -(-ncells // 64)
    _, species, temps, press, wn, read = pio.read_opacity(
        model.cfg.sampled_cs[0])
    ls = LineSample(model.cfg.sampled_cs[0], pressure=model.press)
    ls.to(dev, torch.float32)
    ec = ls.extinction(
        torch.full((1, model.nlayers), 1450.0, device=dev),
        torch.full((1, model.nlayers, 1), 1e15, device=dev))
    checks = {
        'shape': list(table.shape) == [10, NLAYERS, NWAVE],
        'finite': bool(np.all(np.isfinite(table))),
        'non_negative': bool(np.all(table >= 0)),
        'positive_share': float(np.mean(table > 0)),
        'read_back': bool(np.array_equal(read, table)) and species == 'H2O',
        'line_sample': list(ec.shape) == [1, NLAYERS, NWAVE]
        and bool(torch.isfinite(ec).all()) and bool((ec >= 0).all()),
        'factors_per_line_only': bool(factor_shapes) and all(
            len(shape) <= 2 for shape in factor_shapes),
    }
    emit('main_path_opacity', seconds=main_s, inputs_seconds=inputs_s,
         tli_seconds=tli_s, model_setup_seconds=setup_s,
         tli_lines=int(summary[0]['n_lines']),
         lines_on_grid=int(lbl.ntransitions), table_shape=list(table.shape),
         blocks=nblocks, launches=all_launches, checks=checks,
         factor_shapes=sorted(list(shape) for shape in factor_shapes),
         nlines_pad=int(direct.tables()['l_lwn_hi'].shape[0]),
         margin=direct.margin, tile_wing=direct.tile_wing,
         wing_group=direct.wing_group, ntiles_wf=direct.ntiles_wf,
         lmax_wf=direct.lmax_wf, ntiles_core=direct.ntiles_core,
         lmax_core=direct.lmax_core, lmax_w=direct.lmax)
    if not all(v for k, v in checks.items() if k != 'positive_share'):
        fail(f'opacity main path: {checks}')
    for key in ('wing_lines', 'core_lines'):
        if launches[key] < nblocks:
            fail(f'opacity: {launches[key]} {LBL[key]["name"]} launches '
                 f'< {nblocks} blocks')
    if launches['wing_grouped'] or launches['core']:
        fail('opacity: the main path launched a window-layout kernel')

    # 2. The kernels against their plain versions on the card.
    _, tables, t_blk, d_blk, pf_blk = call[0]
    cases = {'flagship_block': lbl_operands(
        direct, (t_blk, d_blk, pf_blk), 1)}
    t0 = time.perf_counter()
    prod_wn = np.linspace(model.wn[0], model.wn[-1], PROD_NWAVE)
    prod = DirectLBL(lbl, wn=prod_wn, device=dev)
    prod_setup_s = time.perf_counter() - t0
    cases['production_block'] = lbl_operands(prod, cells_of(
        prod, np.array([300.0, 3000.0]), model.press[[0, 50]],
        model.base_vmr[[0, 50]]), 1)
    two = DirectLBL(synthetic_lines(model.wn, 20_000, seed=1, nspec=2),
                    device=dev)
    vmr2 = np.tile([0.85, 0.149, 1e-6, 3e-6, 5e-8, 4e-4, 1e-4, 5e-4, 1e-7],
                   (2, 1))
    cases['two_species'] = lbl_operands(two, cells_of(
        two, np.array([800.0, 2400.0]), np.array([1e-4, 10.0]), vmr2), 2)
    # 21 cells: no multiple of the kernels' cell tiles (16 and 2).
    cases['ragged_cells'] = lbl_operands(
        direct, (t_blk[:21], d_blk[:21], pf_blk[:21]), 1)
    # K6 at nspec = 2 on the flagship block (a species index drawn over
    # two for its window entries):
    wing_ops, wing_kw = cases['flagship_block']['wing']
    spec2 = torch.as_tensor(np.random.default_rng(6).integers(
        0, 2, tuple(wing_ops[2].shape)), dtype=torch.int32, device=dev)
    cases['flagship_block_nspec2'] = {
        'wing': ((*wing_ops[:7], spec2), dict(wing_kw, nspec=2))}
    max_abs = {key: 0.0 for key in every}
    for case, ops in cases.items():
        for key, (operands, kw) in ops.items():
            got = kernels[key](*operands, **kw)
            want = plains[key](*operands, **kw)
            torch.cuda.synchronize()
            rel, absolute = masked_rel(got, want)
            max_abs[key] = max(max_abs[key], absolute)
            emit('kernel_check', kernel=every[key]['name'], case=case,
                 shape=list(got.shape), max_rel_err=rel,
                 max_abs_err=absolute, tol=LBL_TOL,
                 tile=int(operands[0].shape[1]),
                 lmax=int(kw.get('lmax', operands[2].shape[-1])))
            if not rel < LBL_TOL:
                fail(f'{every[key]["name"]} {case}: kernel disagrees with '
                     f'plain ({rel})')

    # K6's own run (no user path of either package launches it): its
    # entry point, lk.wing_sigma, on the flagship block at nspec 1 and 2.
    lk.wing_sigma_cuda.launches = 0
    for case in ('flagship_block', 'flagship_block_nspec2'):
        k6_ops, k6_kw = cases[case]['wing']
        lk.wing_sigma(*k6_ops, **k6_kw)
    torch.cuda.synchronize()
    k6_launches = lk.wing_sigma_cuda.launches
    if k6_launches != 2:
        fail(f'opacity: lk.wing_sigma made {k6_launches} K6 launches, not 2')

    # 3. GPU float32 table against a CPU float64 tabulation.
    it, il = [0, 4, 9], [0, 17, 34, 50]
    cpu_model = Model(opacity_cfg, device='cpu')
    cpu_direct = cpu_model.direct_lbl(cpu_model.opacity_models[0][1])
    t0 = time.perf_counter()
    sub = cpu_direct.tabulate(model.cs_temps[it], cpu_model.press[il],
                              cpu_model.base_vmr[il])
    cpu_s = time.perf_counter() - t0
    gpu = table[it][:, il]
    rows = np.abs(sub).max(axis=-1, keepdims=True)
    strong = np.abs(sub) > 1e-4 * rows
    table_rel = float(np.max(np.abs(gpu - sub)[strong] / np.abs(sub[strong])))
    emit('gpu_vs_cpu_opacity', temps=model.cs_temps[it].tolist(), layers=il,
         max_rel_err=table_rel, tol=TABLE_TOL, cpu_seconds=cpu_s,
         strong_entries=int(strong.sum()))
    if not table_rel < TABLE_TOL:
        fail(f'opacity: GPU f32 table disagrees with CPU f64 ({table_rel})')

    # 4. Times (CUDA events, medians, kernel and plain in turns).
    def block_times(ops, repeats, plain_repeats):
        """Kernel and plain ms and the bounds of each kernel in `ops`
        (the plain versions alone take seconds at the production
        width: they are timed `plain_repeats` times, the pairs in
        turns otherwise)."""
        ms, plain_ms, bounds = {}, {}, {}
        for key, (operands, kw) in ops.items():
            run_kernel = lambda: kernels[key](*operands, **kw)
            run_plain = lambda: plains[key](*operands, **kw)
            if plain_repeats:
                ms[key] = float(np.median(cuda_times(run_kernel, repeats)))
                plain_ms[key] = float(np.median(cuda_times(
                    run_plain, plain_repeats, warmup=1, inner=1)))
            else:
                pair = paired_ms({'plain': run_plain, 'kernel': run_kernel},
                                 repeats)
                ms[key], plain_ms[key] = pair['kernel'], pair['plain']
            bounds[key] = lbl_bound(key, operands, kw)
        return ms, plain_ms, bounds

    ops = cases['flagship_block']
    ms, plain_ms, bounds = block_times(ops, 5, 0)
    # K6 with each warp's run split over a block's warps and not (the
    # launch picks by its warps an SM), and at nspec = 2:
    k6_ops, k6_kw = ops['wing']
    k6_ms = paired_ms({
        'own_choice': lambda: kernels['wing'](*k6_ops, **k6_kw),
        'split': lambda: kernels['wing'](*k6_ops, **k6_kw, split=True),
        'unsplit': lambda: kernels['wing'](*k6_ops, **k6_kw, split=False)},
        repeats=5)
    k6_ops2, k6_kw2 = cases['flagship_block_nspec2']['wing']
    k6_ms['nspec2'] = float(np.median(cuda_times(
        lambda: kernels['wing'](*k6_ops2, **k6_kw2), 5)))

    # The two routes of one 64-cell flagship block in turns: factors in
    # the window layout and the window kernels, against factors per line
    # and the kernels that read them by line range (the main path).
    cells_blk = (t_blk, d_blk, pf_blk)

    def route_windows():
        fac = direct._cell_factors(tables, *cells_blk, 'wf_')
        kernels['wing_grouped'](*ops['wing_grouped'][0][:4], fac['c1_w'],
                                fac['y2_w'], fac['inv_ad_w'], None,
                                **ops['wing_grouped'][1])
        kernels['core'](*ops['core'][0][:4], fac['scale_c'], fac['y_c'],
                        fac['inv_ad_c'], None, **ops['core'][1])

    routes = paired_ms({
        'window_layout': route_windows,
        'per_line': lambda: direct._cross_section_batch(tables, *cells_blk),
    }, repeats=5)

    # Wing sub-tile widths through the tile_wing argument (the default
    # is _pick_wing_subtile's, the JAX package's):
    tile_wing_ms = {}
    for pts in (8, 16, 32):
        eng = DirectLBL(lbl, device=dev, tile_wing=pts)
        w_ops, w_kw = lbl_operands(eng, cells_blk, 1)['wing_lines']
        tile_wing_ms[str(pts)] = float(np.median(cuda_times(
            lambda: kernels['wing_lines'](*w_ops, **w_kw), 5)))
        del eng, w_ops

    t0 = time.perf_counter()
    model.compute_opacity(engine='direct')
    torch.cuda.synchronize()
    tab_s = time.perf_counter() - t0
    factor_profile = None
    if args.profile:
        profile('opacity', lambda _: model.compute_opacity(engine='direct'),
                None, tab_s * 1e3)
        # Device time and launches of the factors and of a whole block:
        factor_profile = {}
        for name, fn in {
                'line_factors': lambda: direct._line_factors(
                    tables, *cells_blk),
                'window_factors': lambda: direct._cell_factors(
                    tables, *cells_blk, 'wf_'),
                'block_per_line': lambda: direct._cross_section_batch(
                    tables, *cells_blk),
                'block_window_layout': route_windows}.items():
            _, total, count = device_ms(fn, 'lbl')
            factor_profile[name] = {'device_ms': total, 'launches': count}
    # Pair counts of one 64-cell block, as bench.py::_lbl_rates counts
    # them (padded: the Pallas layout's lanes; effective: pairs inside
    # the cutoff), and the pairs of the window layout:
    up = lambda v, m: -(-v // m) * m
    block = int(t_blk.shape[0])
    padded = block * (
        up(direct.ntiles_wf, direct.wing_group) * direct.tile_wing
        * up(direct.lmax_wf, 128)
        + up(direct.ntiles_core, max(1, 128 // direct.tile_core))
        * direct.tile_core * up(direct.lmax_core, 128))
    window_pairs = block * (
        direct.ntiles_wf * direct.tile_wing * direct.lmax_wf
        + direct.ntiles_core * direct.tile_core * direct.lmax_core)
    density = len(direct.lwn) / (direct.lwn[-1] - direct.lwn[0])
    effective = block * direct.nwave * 2.0 * direct.cutoff * density
    block_s = (ms['wing_lines'] + ms['core_lines']) * 1e-3
    named = lambda values, pick=lambda v: v: {
        every[k]['name']: pick(v) for k, v in values.items()}
    emit('times_opacity', card=card, block_cells=block,
         kernel_ms=named(ms), plain_ms=named(plain_ms),
         bound_ms=named(bounds, lambda v: v[0]),
         bound_by=named(bounds, lambda v: v[1]),
         issue_bound_ms=named(bounds, lambda v: v[2]),
         issue_note=f'in-mask pairs x {WING_PAIR_INSTR} (wing) or '
                    f'{CORE_PAIR_INSTR} (core) instructions a lane, at one '
                    'instruction a lane and clock (half the float32 peak)',
         earlier_ms={LBL[k]['name']: LBL[k]['earlier_ms']
                     for k in ('wing_lines', 'core_lines', 'wing')},
         earlier_note=EARLIER_NOTE + '; lbl_wing: K6 before its redesign '
                      '(one thread a point)',
         k6_ms=k6_ms,
         routes_ms={'window_factors_and_window_kernels':
                    routes['window_layout'],
                    'line_factors_and_line_kernels': routes['per_line']},
         tile_wing_ms=tile_wing_ms, tile_wing_default=direct.tile_wing,
         factor_profile=factor_profile,
         compute_opacity_seconds=tab_s, main_path_seconds=main_s,
         table_points_per_s=table.size / tab_s,
         padded_pairs_per_s=padded / block_s,
         effective_pairs_per_s=effective / block_s,
         window_pairs_per_s=window_pairs / block_s,
         pairs_note='per 64-cell block from the K4 + K5 times; padded '
                    'and effective as bench.py::_lbl_rates defines them, '
                    'window: the pairs of the window layout')
    if not routes['per_line'] <= routes['window_layout']:
        fail('opacity: the main path reads per-line factors by line range '
             f'({routes["per_line"]:.3f} ms a block), but the window-layout '
             f'route is faster ({routes["window_layout"]:.3f} ms)')

    # One species at the production width (bench.py::_production_table):
    prod_press = model.press
    prod_temps = np.linspace(300.0, 3000.0, PROD_NTEMP)
    probe = cells_of(prod, prod_temps[:2], prod_press[:32],
                     model.base_vmr[:32])
    prod_ops = lbl_operands(prod, probe, 1)
    prod_ops = {k: prod_ops[k] for k in ('wing_lines', 'core_lines')}
    prod_ms, prod_plain_ms, prod_bounds = block_times(prod_ops, 3, 1)
    del prod_ops
    run_block = lambda: prod._cross_section_batch(prod.tables(), *probe)
    run_block()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_block()
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    if args.profile:
        profile('opacity_production_block', lambda _: run_block(), None,
                probe_s * 1e3)
    nblk = -(-PROD_NTEMP * NLAYERS // 64)
    ntemp = PROD_NTEMP
    if nblk * probe_s > PROD_BUDGET_S:
        ntemp = max(1, int(PROD_BUDGET_S / probe_s) * 64 // NLAYERS)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prod_table = prod.tabulate(prod_temps[:ntemp], prod_press,
                               model.base_vmr)
    torch.cuda.synchronize()
    prod_s = time.perf_counter() - t0
    prod_ok = bool(np.all(np.isfinite(prod_table))) and bool(
        np.all(prod_table >= 0))
    emit('production_opacity', card=card, ntemp=ntemp, nlayers=NLAYERS,
         nwave=PROD_NWAVE, cut=None if ntemp == PROD_NTEMP else
         f'ntemp {PROD_NTEMP} -> {ntemp}: a 64-cell block took '
         f'{probe_s:.3f} s', seconds=prod_s, setup_seconds=prod_setup_s,
         points_per_s=prod_table.size / prod_s,
         block_probe_seconds=probe_s,
         block_kernel_ms=named(prod_ms), block_plain_ms=named(prod_plain_ms),
         block_bound_ms=named(prod_bounds, lambda v: v[0]),
         block_bound_by=named(prod_bounds, lambda v: v[1]),
         block_issue_bound_ms=named(prod_bounds, lambda v: v[2]),
         block_earlier_ms={LBL[k]['name']: LBL[k]['earlier_production_ms']
                           for k in ('wing_lines', 'core_lines')},
         earlier_note=EARLIER_NOTE,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
         tile_wing=prod.tile_wing, wing_group=prod.wing_group,
         lmax_wf=prod.lmax_wf, lmax_core=prod.lmax_core, finite=prod_ok)
    if not prod_ok:
        fail('opacity: non-finite or negative production-width table')

    # 5. The parity engine, compute_opacity's default, through the CLI in
    # a process of its own at PARITY_TEMPS (3 of the 10 temperatures:
    # ~0.4 s of the host a layer), against the direct table there.
    parity_cfg = os.path.join(workdir, 'parity_opacity.cfg')
    parity_table = os.path.join(workdir, 'flagship_h2o_parity.npz')
    with open(opacity_cfg) as f:
        text = f.read()
    text = text.replace(model.cfg.sampled_cs[0], parity_table)
    for key, value in zip(('tmin', 'tmax', 'tstep'), PARITY_TEMPS):
        text = text.replace(f'{key} = {int(getattr(model.cfg, key))}\n',
                            f'{key} = {value}\n')
    with open(parity_cfg, 'w') as f:
        f.write(text)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'pyratbay_tpu_torch', '-c', parity_cfg],
        cwd=HERE, capture_output=True, text=True, timeout=900)
    parity_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f'opacity: the CLI (parity engine) exited {proc.returncode}: '
             f'{proc.stderr[-2000:]}')
    with np.load(parity_table) as f:
        parity = f['opacity']
        parity_temps = f['temperature']
    it = [int(np.argmin(np.abs(model.cs_temps - t))) for t in parity_temps]
    direct_t = table[it]
    mask = np.abs(direct_t) > 1e-6 * np.abs(direct_t).max()
    diff = np.abs(parity - direct_t)[mask] / np.abs(direct_t[mask])
    parity_ok = (parity.shape == direct_t.shape
                 and np.allclose(model.cs_temps[it], parity_temps)
                 and bool(np.all(np.isfinite(parity)))
                 and bool(np.all(parity >= 0)))
    emit('parity_opacity', card=card, seconds=parity_s,
         temps=parity_temps.tolist(), table_shape=list(parity.shape),
         cut=f'temperatures 10 -> {len(parity_temps)}',
         parity_vs_direct_median_rel=float(np.median(diff)),
         parity_vs_direct_max_rel=float(np.max(diff)),
         parity_vs_direct_note='a finding, not a gate: the parity engine '
                               'samples a grid of binned Voigt profiles '
                               '(its quantization), the direct engine '
                               'exact profiles; entries above 1e-6 of the '
                               'maximum',
         checks=dict(ran=True, table=parity_ok))
    if not parity_ok:
        fail('opacity: the parity table is not a finite table at the '
             'direct table\'s temperatures')

    entries = []
    for key, spec in LBL.items():
        entry = {'name': spec['name'], 'route': 'cuda', 'source': LBL_SOURCE,
                 'replaces': spec['replaces'], 'launches': launches[key],
                 'max_abs_err': max_abs[key], 'ms': ms[key],
                 'plain_ms': plain_ms[key], 'bound_ms': bounds[key][0],
                 'bound_by': bounds[key][1], 'library_ms': None}
        if key == 'wing':
            entry.update(
                launches=k6_launches, issue_bound_ms=bounds[key][2],
                earlier_ms=spec['earlier_ms'],
                note='no user path of either package reaches wing_sigma: '
                     'launches are its own run in the opacity phase '
                     '(lk.wing_sigma on the flagship block at nspec 1 and '
                     '2); earlier_ms a constant from PERF.md, the kernel '
                     'before its redesign')
        else:
            entry['windows_ms'] = ms[WINDOWS_OF[key]]
            entry['windows_note'] = (
                'the window-layout kernel on the same block, off the main '
                'path, timed in this run')
        entries.append(entry)
    return entries


# The retrieval_post phase: a retrieval as users run it.  The transit
# flagship's data in 12 bands whose passbands are filter files the script
# writes (WFC3 G141-like trapezoids); the eclipse flagship written over
# 3.0-5.3 um (K3) with the bundled Spitzer IRAC 1 and 2 passbands by name
# and two filter files.  POST_GENS generations, then a resume to twice
# as many, with a checkpoint after every chunk (dt_retrieval_snapshot =
# 0); the post-processing on the card held against the CPU in float64.
POST_GENS = 10
POST_TOL = FORWARD_TOL
ENVELOPE_DRAWS = 128
POST_FILES = ('_temperature_posterior.npz', '_spectrum_posterior.npz',
              '_band_contribution.npz', '_median.atm')
POST_PLOTS = ('_bestfit_spectrum.png', '_posteriors.png', '_temperature.png',
              '_band_contribution.png', '_abundance.png')
ECLIPSE_WL = (3.0, 5.3)


def write_filter_file(path, wl0, half_width, ramp):
    """A two-column passband file (wavelength in um, response), the
    reference's format: a trapezoid, flat within wl0 +- (half_width -
    ramp)."""
    wl = np.linspace(wl0 - half_width - 0.002, wl0 + half_width + 0.002, 101)
    resp = np.clip((half_width - np.abs(wl - wl0)) / ramp, 0.0, 1.0)
    np.savetxt(path, np.column_stack([wl, resp]), fmt='%.6f',
               header='wavelength (um)   response')
    return path


def _rel_to_max(got, want):
    """max |got - want| over each row's max |want| (a 1-D array is one
    row; a 2-D one's columns are its rows: bands, species)."""
    got = np.atleast_2d(np.asarray(got, float).T)
    want = np.atleast_2d(np.asarray(want, float).T)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return np.inf
    scale = np.abs(want).max(axis=1, keepdims=True)
    return float(np.max(np.abs(got - want)
                        / np.where(scale > 0, scale, 1.0)))


def post_file_errors(got_base, want_base):
    """Each numeric post-processing file of one run against another's:
    file -> the largest _rel_to_max over its arrays."""
    from pyratbay_tpu_torch.io import io as pio
    errs = {}
    for suffix in POST_FILES[:3]:
        with np.load(got_base + suffix) as got, \
                np.load(want_base + suffix) as want:
            errs[suffix] = max(_rel_to_max(got[k], want[k])
                               for k in want.files)
    got = pio.read_atm(got_base + '_median.atm')
    want = pio.read_atm(want_base + '_median.atm')
    errs['_median.atm'] = max(_rel_to_max(g, w)
                              for g, w in zip(got[2:], want[2:])
                              if w is not None)
    return errs


def timed_calls(pairs, fn):
    """Run fn() with each (module or class, name) of `pairs` wrapped in
    a timer that ends in a synchronize; return the seconds spent in
    each."""
    import torch
    seconds, reals = {name: 0.0 for _, name in pairs}, {}
    for owner, name in pairs:
        reals[name] = real = getattr(owner, name)

        def timer(*a, _name=name, _real=real, **kw):
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            torch.cuda.synchronize()
            seconds[_name] += time.perf_counter() - t0
            return out

        setattr(owner, name, timer)
    try:
        fn()
    finally:
        for owner, name in pairs:
            setattr(owner, name, reals[name])
    return seconds


def run_retrieval_post(workdir, dev, args, card):
    """The retrieval_post phase (see POST_GENS).  Returns each kernel's
    launches in the phase's driver runs and the envelope launch's
    largest difference from its plain version."""
    import torch
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.io import io as pio
    phase_t0 = time.perf_counter()
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.retrieval import driver as rdriver
    from pyratbay_tpu_torch.retrieval import posterior as rposterior
    from pyratbay_tpu_torch.retrieval.batched import (
        build_forward_batched, build_log_posterior_batched,
    )
    from pyratbay_tpu_torch.retrieval.forward import build_forward
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.retrieval.samplers import sample_demc
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    def setup(label, rt_path, filters_of, noise, **size):
        """The flagship with `rt_path` in its own directory, data in the
        bands `filters_of(dir)` names, and its retrieval config."""
        pdir = os.path.join(workdir, label)
        os.makedirs(pdir)
        model, _, _, _, p0 = make_flagship(pdir, device=dev, rt_path=rt_path,
                                           **size)
        filters = filters_of(pdir)

        class _Cfg:
            data = uncert = obsfile = dunits = None
            offset_inst = uncert_scaling = None

        _Cfg.filters = filters
        obs = Observation(_Cfg, model.wn)
        ret = RetrievalParams(model, obs)
        band0 = build_forward(model, obs, ret)(p0)['bandflux'].cpu().numpy()
        uncert = noise(band0)
        data = band0 + np.random.default_rng(1).normal(0, uncert)
        cfg_file = os.path.join(pdir, 'retrieval.cfg')
        write_retrieval_cfg(
            os.path.join(pdir, 'flagship.cfg'), cfg_file, data, uncert,
            filters, os.path.join(pdir, 'retrieval.log'), ngen=POST_GENS,
            extra=['dt_retrieval_snapshot = 0'])
        return model, cfg_file, os.path.join(pdir, 'retrieval'), obs

    def zero_counts():
        tk.transit_rt_cuda.launches = 0
        tk.transit_one_cuda.launches = 0
        tk.transit_rt_cuda.tall_launches = 0
        ek.emission_rt_cuda.launches = 0

    def counts():
        return {'transit_rt': (tk.transit_rt_cuda.launches
                               - tk.transit_rt_cuda.tall_launches),
                ONE_CHAIN['name']: tk.transit_one_cuda.launches,
                'emission_rt': ek.emission_rt_cuda.launches}

    post_s = []

    def driven(cfg_file):
        """run() of a retrieval config on the card, timed, with its
        post-processing timed apart."""
        real = rdriver.post_process

        def post(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real(*a, **kw)
            torch.cuda.synchronize()
            post_s.append(time.perf_counter() - t0)

        rdriver.post_process = post
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = run(cfg_file, seed=0)
            torch.cuda.synchronize()
        finally:
            rdriver.post_process = real
        if model.device.type != 'cuda':
            fail(f'retrieval_post: the retrieval ran on {model.device}')
        return model, time.perf_counter() - t0

    def outputs(base, label):
        missing = [s for s in POST_FILES if not os.path.isfile(base + s)]
        if missing:
            fail(f'retrieval_post {label}: no {missing}')
        return all(os.path.isfile(base + s) for s in POST_PLOTS)

    def against_cpu(cfg_file, base, label):
        t0 = time.perf_counter()
        rdriver.posterior_post_processing(cfg_file, suffix='_cpu',
                                          device='cpu')
        cpu_s = time.perf_counter() - t0
        errs = post_file_errors(base, base + '_cpu')
        if not max(errs.values()) < POST_TOL:
            fail(f'retrieval_post {label}: the post-processing on the card '
                 f'disagrees with the CPU in float64: {errs}')
        return errs, cpu_s

    # Transit: 12 filter files, 10 generations, then resumed to 20:
    def transit_filters(pdir):
        return [write_filter_file(os.path.join(pdir, f'g141_bin{i:02d}.dat'),
                                  wl0, 0.02, 0.005)
                for i, wl0 in enumerate(np.linspace(1.13, 1.67, 12))]

    _, cfg_file, base, _ = setup('post_transit', 'transit', transit_filters,
                                 lambda b: np.full(len(b), NOISE))
    ckpt_file = base + '_checkpoint.npz'
    zero_counts()
    _, first_s = driven(cfg_file)
    with np.load(ckpt_file) as f:
        ckpt1 = {k: f[k] for k in f.files}
    with open(cfg_file) as f:
        text = f.read().replace(f'nsamples = {NCHAINS * POST_GENS}',
                                f'nsamples = {NCHAINS * 2 * POST_GENS}')
    with open(cfg_file, 'w') as f:
        f.write(text + 'resume = True\n')
    rmodel, second_s = driven(cfg_file)
    transit_launches = counts()
    with np.load(ckpt_file) as f:
        ckpt2 = {k: f[k] for k in f.files}
    igens = [int(ckpt1['igen']), int(ckpt2['igen'])]
    if igens != [POST_GENS, 2 * POST_GENS]:
        fail(f'retrieval_post: checkpoint generations {igens}')
    if not np.array_equal(ckpt2['hist_chains'][:POST_GENS],
                          ckpt1['hist_chains']):
        fail('retrieval_post: the resumed history does not start with the '
             'first run\'s')
    with np.load(base + '.npz') as out:
        posterior = out['posterior']
        if posterior.shape != ((2 * POST_GENS - 2) * NCHAINS, 7) \
                or not np.all(np.isfinite(posterior)):
            fail(f'retrieval_post: posterior {posterior.shape}')
    transit_plots = outputs(base, 'transit')
    min_launches = 2 * (POST_GENS + 1) + 1
    if transit_launches['transit_rt'] < min_launches \
            or transit_launches[ONE_CHAIN['name']] < 2:
        fail(f'retrieval_post: transit launches {transit_launches}')
    transit_errs, transit_cpu_s = against_cpu(cfg_file, base, 'transit')

    # The envelope's K1 launch at B = 128 against its plain version, and
    # its batched forward by CUDA events:
    forward_b = build_forward_batched(rmodel, rmodel.obs, rmodel.ret)
    thinned = rmodel.posterior[::max(1, len(rmodel.posterior) // 256)]
    call, = record_calls(
        ((model_mod, 'transit_spectrum_ensemble'),),
        lambda: rposterior.spectrum_posterior(
            thinned, lambda p: forward_b(p)['spectrum'],
            max_draws=ENVELOPE_DRAWS))
    case = wrapper_case('transit', rmodel, call)
    if case[0][1].shape[0] != ENVELOPE_DRAWS:
        fail(f'retrieval_post: the envelope launched K1 at B = '
             f'{case[0][1].shape[0]}')
    envelope_abs = check_kernel(
        KERNELS['transit']['name'], tk.transit_rt_cuda, tk.transit_rt_plain,
        {f'envelope_B{ENVELOPE_DRAWS}': case}, KERNELS['transit']['tol'])
    draws = thinned[np.random.default_rng(0).choice(
        len(thinned), ENVELOPE_DRAWS, replace=False)]
    draws_t = torch.as_tensor(draws, dtype=rmodel.dtype, device=dev)
    with torch.no_grad():
        envelope_ms = float(np.median(cuda_times(lambda: forward_b(draws_t))))

    # --post in a process of its own:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'pyratbay_tpu_torch', '--post', cfg_file,
         '--suffix', '_post'], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    post_cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f'retrieval_post: --post exited {proc.returncode}: '
             f'{proc.stderr[-2000:]}')
    outputs(base + '_post', '--post')
    post_cli_errs = post_file_errors(base + '_post', base)
    if not max(post_cli_errs.values()) < KERNELS['transit']['tol']:
        fail(f'retrieval_post: --post wrote other numbers {post_cli_errs}')

    # history_thin = 3 against every third state of an unthinned run from
    # the same generator seed; generations/s with a checkpoint file
    # written after the chunk (checkpoint_dt = 0) and without, in turns:
    log_post_b = build_log_posterior_batched(rmodel, rmodel.obs, rmodel.ret)
    ret = rmodel.ret

    def demc(gens, **kw):
        with torch.no_grad():
            return sample_demc(
                log_post_b, ret.params, nsamples=NCHAINS * gens,
                nchains=NCHAINS,
                generator=torch.Generator(device=dev).manual_seed(5),
                pstep=ret.pstep, pmin=ret.pmin, pmax=ret.pmax, device=dev,
                dtype=rmodel.dtype, **kw)

    full, thin3 = demc(9), demc(9, history_thin=3)
    thin_equal = bool(np.array_equal(thin3['chain_history'],
                                     full['chain_history'][2::3]))
    if not thin_equal:
        fail('retrieval_post: history_thin = 3 differs from every third '
             'state of the unthinned run')
    timing_ckpt = os.path.join(workdir, 'post_transit', 'timing_ckpt.npz')
    gens_per_s = {'no_checkpoint': [], 'checkpoint_dt_0': []}
    for name in ('no_checkpoint', 'checkpoint_dt_0', 'checkpoint_dt_0',
                 'no_checkpoint'):
        kw = {} if name == 'no_checkpoint' else dict(
            checkpoint_file=timing_ckpt, checkpoint_dt=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        demc(POST_GENS, **kw)
        torch.cuda.synchronize()
        gens_per_s[name].append(POST_GENS / (time.perf_counter() - t0))

    steps = None
    if args.profile:
        steps = profile_post(cfg_file, dev, timed=lambda fn: timed_calls((
            (rposterior, 'temperature_posterior'),
            (rposterior, 'spectrum_posterior'), (pio, 'write_atm'),
            (model_mod.Model, 'band_contribution'), (rdriver, '_plots'),
        ), fn))

    # Eclipse: the bundled Spitzer IRAC 1 and 2 passbands by name and two
    # filter files, 51 x 1447 (3.0-5.3 um), K3:
    def eclipse_filters(pdir):
        return ['spitzer_irac1', 'spitzer_irac2',
                write_filter_file(os.path.join(pdir, 'nirspec_3.30.dat'),
                                  3.3, 0.05, 0.01),
                write_filter_file(os.path.join(pdir, 'nirspec_5.05.dat'),
                                  5.05, 0.1, 0.02)]

    emodel, ecfg, ebase, eobs = setup(
        'post_eclipse', 'eclipse', eclipse_filters,
        lambda b: np.maximum(np.abs(b) * ECLIPSE_NOISE, 1e-12),
        wl_low=ECLIPSE_WL[0], wl_high=ECLIPSE_WL[1])
    zero_counts()
    _, eclipse_s = driven(ecfg)
    eclipse_launches = counts()
    if eclipse_launches['emission_rt'] < POST_GENS + 3:
        fail(f'retrieval_post: eclipse launches {eclipse_launches}')
    eclipse_plots = outputs(ebase, 'eclipse')
    eclipse_errs, eclipse_cpu_s = against_cpu(ecfg, ebase, 'eclipse')

    emit('retrieval_post', card=card, nchains=NCHAINS,
         transit=dict(
             nlayers=rmodel.nlayers, nwave=rmodel.nwave,
             bands=len(rmodel.obs.filters), generations=igens,
             run_s=[first_s, second_s], post_process_s=post_s[:2],
             post_cli_s=post_cli_s, cpu_post_process_s=transit_cpu_s,
             envelope_forward_ms=envelope_ms,
             envelope_draws=ENVELOPE_DRAWS,
             demc_generations_per_s=gens_per_s,
             history_thin_3_equal=thin_equal, launches=transit_launches,
             gpu_vs_cpu_rel_err=transit_errs, post_cli_rel_err=post_cli_errs,
             plots_written=transit_plots, post_steps_s=steps),
         eclipse=dict(
             nlayers=emodel.nlayers, nwave=emodel.nwave,
             bands=[band.name for band in eobs.filters],
             run_s=eclipse_s, post_process_s=post_s[2:],
             cpu_post_process_s=eclipse_cpu_s, launches=eclipse_launches,
             gpu_vs_cpu_rel_err=eclipse_errs, plots_written=eclipse_plots),
         tol=POST_TOL, phase_s=time.perf_counter() - phase_t0,
         note='run_s: run() of the retrieval config, host clock ending in '
              'a synchronize (post-processing included); post_process_s: '
              'the same clock around post_process; envelope_forward_ms: '
              'CUDA events, median; generations/s: host clock, in turns; '
              'phase_s: the whole phase, --profile included')
    launches = {k: transit_launches[k] + eclipse_launches[k]
                for k in transit_launches}
    return launches, max(envelope_abs.values())


def profile_post(cfg_file, dev, timed):
    """Where the time of one post-processing goes: torch.profiler over
    posterior_post_processing on the card (device busy time, launches,
    the device kernels by time) and the host seconds of its steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from pyratbay_tpu_torch.retrieval import driver as rdriver
    box = {}

    def once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rdriver.posterior_post_processing(cfg_file, suffix='_prof',
                                          device=dev)
        torch.cuda.synchronize()
        box['s'] = time.perf_counter() - t0

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        steps = timed(once)
    rows = sorted(((evt.device_time_total, evt.key, evt.count)
                   for evt in prof.key_averages()
                   if evt.device_type != DeviceType.CPU), reverse=True)
    busy_us = sum(us for us, _, _ in rows)
    emit('profile_post', seconds=box['s'], steps_s=steps,
         device_busy_us=busy_us, device_launches=sum(c for _, _, c in rows),
         device_idle_share=1.0 - busy_us * 1e-6 / box['s'],
         device_kernels=[{'name': name[:80], 'us': us, 'calls': calls}
                         for us, name, calls in rows[:12]])
    return steps


# The hires_eclipse phase: a high-resolution eclipse retrieval with a
# stellar-model star.  The H2O table comes from make_lbl_flagship's
# 50,000 synthetic lines through compute_opacity(engine='direct') (K4,
# K5) over 1.50-1.70 um at 0.02 cm-1 (~39,200 points, sampling
# R ~ 3e5), 51 layers, 10 temperatures; the eclipse flagship reads it.
# The star is an SED of 7 temperatures (5,000-6,500 K) that the phase
# writes in ascending wavelength over 1.4-1.8 um (blackbodies times one
# line pattern from a seed).  The data: a SPIRou-like H-band channel at
# inst_resolution = 70,000 (points uniform in ln(wavelength) at
# R = 140,000 over 1.505-1.695 um) and 6 tophat bands, made from the
# model at known parameters with rv_shift = 12 km/s and Gaussian noise
# from --seed.  9 parameters (the flagship's 7, T_eff and rv_shift),
# 512 chains x 20 generations (the only cut) through the driver, then
# the post-processing.
HIRES_WL = (1.5, 1.7)
HIRES_WNSTEP = 0.02
HIRES_INST_R = 70_000.0
HIRES_SAMPLING_R = 140_000.0
HIRES_DATA_WL = (1.505, 1.695)
HIRES_RV = 12.0
HIRES_NOISE = 0.02      # of the channel's largest flux ratio
HIRES_BANDS = 6
SED_TEMPS = np.linspace(5000.0, 6500.0, 7)
SED_WL = (1.4, 1.8)
SED_POINTS = 40_000
KURUCZ_MODELS = ((5500.0, 4.0), (5500.0, 4.5), (6000.0, 4.0), (6000.0, 4.5))
HIRES_PARAMS = ('    T_eff      5800.0  5000.0  6500.0  50.0',
                '    rv_shift     10.0   -50.0    50.0   2.0')
HIRES_K3_CHAINS = 16    # the plain version's [B, l, W] grows with W
CPU_CHUNK = 32          # chains a CPU float64 forward
CPU_LP_CHAINS = 64      # of them, the CPU's log-posterior


def write_sed_file(path, wl_um, temps, seed=3):
    """A starspec SED (@TEMPERATURES / @SPECTRA) with rows in the order
    of wl_um: a blackbody for each temperature times one pattern of 300
    absorption lines from `seed`."""
    from pyratbay_tpu_torch.spectrum.starspec import bbflux
    rng = np.random.default_rng(seed)
    wn = 1.0 / (wl_um * 1e-4)
    pattern = np.ones_like(wn)
    for center, depth, width in zip(rng.uniform(wn.min(), wn.max(), 300),
                                    rng.uniform(0.02, 0.5, 300),
                                    rng.uniform(0.2, 2.0, 300)):
        pattern -= depth * np.exp(-0.5 * ((wn - center) / width)**2)
    fluxes = np.array([bbflux(wn, t) * np.clip(pattern, 0.05, None)
                       for t in temps])
    with open(path, 'w') as f:
        f.write('@TEMPERATURES\n' + ' '.join(f'{t:.1f}' for t in temps)
                + '\n@SPECTRA\n')
        np.savetxt(f, np.column_stack([wl_um, fluxes.T]), fmt='%.9e')
    return path


def write_kurucz_file(path, wl_nm, models):
    """A Kurucz .pck grid of `models` (teff, log g): the fixed-column
    TEFF / GRAVITY headers and 8 fields of 10 characters a line, the
    intensities (a blackbody's flux / 4 pi c) then the continua."""
    from pyratbay_tpu_torch import constants as pc
    from pyratbay_tpu_torch.spectrum.starspec import bbflux
    lines = ['Kurucz-format grid written by chip_smoke.py', 'END']
    lines += [''.join(f'{w:10.3f}' for w in wl_nm[i:i + 8])
              for i in range(0, len(wl_nm), 8)]
    wn = 1.0 / (wl_nm * pc.nm)
    for teff, logg in models:
        lines.append(f'TEFF {teff:7.0f}  GRAVITY {logg:7.5f} LTE')
        intensity = bbflux(wn, teff) / (4.0 * np.pi * pc.c)
        for block in (intensity, 0.9 * intensity):
            lines += [''.join(f'{v:10.4E}' for v in block[i:i + 8])
                      for i in range(0, len(block), 8)]
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def chunked_cpu(fn, pb, chunk=CPU_CHUNK):
    """fn(pb) by chunks of `chunk` chains (a CPU forward's [B, l, W]
    operands grow with W): the list of the chunks' outputs."""
    return [fn(pb[i:i + chunk]) for i in range(0, len(pb), chunk)]


def run_hires_eclipse(workdir, dev, args, card):
    """The hires_eclipse phase (see HIRES_WL).  Returns each kernel's
    launches on its main path and K3's largest difference from its
    plain version."""
    import torch
    from pyratbay_tpu_torch import constants as pc
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.benchmark import make_flagship, make_lbl_flagship
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.io import io as pio
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.opacity import lbl_kernel as lk
    from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL
    from pyratbay_tpu_torch.retrieval.batched import (
        build_forward_batched, build_log_posterior_batched)
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.retrieval.samplers import sample_demc
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    phase_t0 = time.perf_counter()
    lbl_counters = {LBL[k]['name']: getattr(lk, LBL[k]['fn'] + '_cuda')
                    for k in ('wing_lines', 'core_lines')}

    # 1. The table: line list -> TLI -> compute_opacity(engine='direct').
    odir = os.path.join(workdir, 'opacity')
    _, tli_cfg, opacity_cfg = make_lbl_flagship(
        odir, nlines=NLINES, nlayers=NLAYERS, wl_low=HIRES_WL[0],
        wl_high=HIRES_WL[1], wnstep=HIRES_WNSTEP)
    run(tli_cfg)
    omodel = Model(opacity_cfg, device=dev)
    for counter in lbl_counters.values():
        counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = omodel.compute_opacity(engine='direct')
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    lbl_launches = {k: c.launches for k, c in lbl_counters.items()}
    nblocks = -(-table.shape[0] * table.shape[1] // 64)
    # The table against the CPU in float64 on 4 cells and a 2,000-point
    # slice of the grid (the direct engine on the slice's wavenumbers):
    cpu_omodel = Model(opacity_cfg, device='cpu')
    mid = cpu_omodel.nwave // 2
    it, il = [1, 8], [NLAYERS // 5, NLAYERS - 6]
    iw = slice(max(mid - 1000, 0), mid + 1000)
    cpu_direct = DirectLBL(cpu_omodel.opacity_models[0][1],
                           wn=cpu_omodel.wn[iw], device='cpu')
    t0 = time.perf_counter()
    sub = cpu_direct.tabulate(omodel.cs_temps[it], cpu_omodel.press[il],
                              cpu_omodel.base_vmr[il])
    cpu_s = time.perf_counter() - t0
    gpu = table[it][:, il][..., iw]
    strong = np.abs(sub) > 1e-4 * np.abs(sub).max(axis=-1, keepdims=True)
    table_rel = float(np.max(np.abs(gpu - sub)[strong] / np.abs(sub[strong])))
    checks = {
        'shape': table.shape[:2] == (10, NLAYERS)
        and abs(table.shape[2] - 39_200) < 100,
        'finite': bool(np.all(np.isfinite(table))),
        'non_negative': bool(np.all(table >= 0)),
        'launches': all(n >= nblocks for n in lbl_launches.values()),
        'gpu_vs_cpu': table_rel < TABLE_TOL,
    }
    emit('hires_opacity', card=card, table_shape=list(table.shape),
         seconds=table_s, blocks=nblocks, launches=lbl_launches,
         lines_on_grid=int(omodel.opacity_models[0][1].ntransitions),
         gpu_vs_cpu_cells=dict(temps=omodel.cs_temps[it].tolist(),
                               layers=il, points=[iw.start, iw.stop]),
         gpu_vs_cpu_max_rel_err=table_rel, tol=TABLE_TOL,
         cpu_seconds=cpu_s, checks=checks)
    if not all(checks.values()):
        fail(f'hires_eclipse opacity: {checks}')
    del omodel, cpu_omodel, cpu_direct

    # 2. The eclipse flagship on that table, the star, the data.
    sed = write_sed_file(
        os.path.join(workdir, 'star_sed.dat'),
        np.linspace(SED_WL[0], SED_WL[1], SED_POINTS), SED_TEMPS)
    model, _, _, _, _ = make_flagship(
        workdir, nlayers=NLAYERS, wl_low=HIRES_WL[0], wl_high=HIRES_WL[1],
        wnstep=HIRES_WNSTEP, device=dev, rt_path='eclipse',
        cs_file=os.path.join(odir, 'flagship_h2o_lbl.npz'))
    with open(os.path.join(workdir, 'flagship.cfg')) as f:
        text = f.read()
    text = text.replace('    alpha_ray ', '\n'.join(HIRES_PARAMS)
                        + '\n    alpha_ray ')
    spec_cfg = os.path.join(workdir, 'hires_flagship.cfg')
    with open(spec_cfg, 'w') as f:
        f.write(text + f'starspec = {sed}\n')
    wl_hires = np.exp(np.arange(np.log(HIRES_DATA_WL[0]),
                                np.log(HIRES_DATA_WL[1]),
                                1.0 / HIRES_SAMPLING_R))
    hires_file = os.path.join(workdir, 'hires.dat')
    entries = [f'{wl:.9f}' for wl in wl_hires]
    pio.write_observations(hires_file, np.zeros(len(wl_hires)),
                           np.ones(len(wl_hires)), entries)
    filters = [f'tophat {wl0:.4f} 0.01' for wl0 in np.linspace(
        HIRES_WL[0] + 0.02, HIRES_WL[1] - 0.02, HIRES_BANDS)]

    class ObsCfg:
        data = uncert = obsfile = dunits = None
        offset_inst = uncert_scaling = None
        obsfile_hires = hires_file
        inst_resolution = HIRES_INST_R

    ObsCfg.filters = filters
    model = Model(spec_cfg, device=dev)
    obs = Observation(ObsCfg, model.wn)
    ret = RetrievalParams(model, obs)
    p_true = np.asarray(ret.params, float).copy()
    p_true[ret.irv] = HIRES_RV
    truth = build_forward_batched(model, obs, ret)(p_true[None])
    band0 = truth['bandflux'][0].double().cpu().numpy()
    hires0 = truth['bandflux_hires'][0].double().cpu().numpy()
    rng = np.random.default_rng(args.seed)
    uncert = np.maximum(np.abs(band0) * ECLIPSE_NOISE, 1e-12)
    uncert_h = np.full(len(hires0), HIRES_NOISE * np.abs(hires0).max())
    pio.write_observations(hires_file, hires0 + rng.normal(0, uncert_h),
                           uncert_h, entries)
    cfg_file = os.path.join(workdir, 'hires_retrieval.cfg')
    write_retrieval_cfg(
        spec_cfg, cfg_file, band0 + rng.normal(0, uncert), uncert, filters,
        os.path.join(workdir, 'hires_retrieval.log'),
        extra=(f'obsfile_hires = {hires_file}',
               f'inst_resolution = {HIRES_INST_R}'))

    # 3. The main path: the retrieval through the driver, on the card.
    ek.emission_rt_cuda.launches = 0
    for counter in lbl_counters.values():
        counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rmodel = run(cfg_file, seed=0)      # the default device: the card
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    k3_launches = ek.emission_rt_cuda.launches
    out = np.load(os.path.join(workdir, 'hires_retrieval.npz'))
    robs, rret = rmodel.obs, rmodel.ret
    finite = {k: bool(np.all(np.isfinite(out[k])))
              for k in ('posterior', 'bestp', 'spec_best', 'bandflux_best')}
    post_files = {s: os.path.isfile(os.path.join(workdir, 'hires_retrieval'
                                                 + s))
                  for s in POST_FILES}
    checks = {
        'on_the_card': rmodel.device.type == 'cuda',
        'nwave': abs(rmodel.nwave - 39_200) < 100,
        'hires_points': len(robs.wn_hires) == len(wl_hires),
        'sed_star': rmodel.sed_temps is not None
        and len(rmodel.sed_temps) == len(SED_TEMPS),
        'parameters': len(rret.params) == 9 and rret.irv is not None
        and rret.itstar is not None,
        'finite': all(finite.values()),
        'acceptance': float(out['acceptance_rate']) > 0,
        'posterior_shape': out['posterior'].shape[1] == 9,
        'post_files': all(post_files.values()),
        'k3_launches': k3_launches >= NGEN + 2,
    }
    emit('main_path_hires_eclipse', seconds=main_s, nchains=NCHAINS,
         generations=NGEN, nlayers=rmodel.nlayers, nwave=rmodel.nwave,
         hires_points=len(wl_hires), bands=HIRES_BANDS,
         inst_resolution=HIRES_INST_R,
         acceptance_rate=float(out['acceptance_rate']),
         best_log_post=float(out['best_log_post']),
         posterior_shape=list(out['posterior'].shape),
         truth=dict(zip(rret.pnames, p_true.tolist())),
         bestp=dict(zip(rret.pnames, out['bestp'].tolist())),
         launches={'emission_rt': k3_launches,
                   **{k: c.launches for k, c in lbl_counters.items()}},
         post_files=post_files, checks=checks)
    if not all(checks.values()):
        fail(f'hires_eclipse main path: {checks}')

    # 4. GPU float32 against CPU float64: the spectrum and the high-res
    # fluxes at B = 512 (~2 minutes of an 8-core host), the log-posterior
    # on the first CPU_LP_CHAINS chains.
    pb = np.clip(p_true + rret.pstep * np.random.default_rng(0)
                 .standard_normal((NCHAINS, len(p_true))),
                 rret.pmin, rret.pmax)
    forward_b = build_forward_batched(rmodel, robs, rret)
    log_post_b = build_log_posterior_batched(rmodel, robs, rret)
    with torch.no_grad():
        gpu_out = forward_b(pb)
        gpu_lp = log_post_b(pb).double().cpu().numpy()
    cpu_model = Model(cfg_file, device='cpu')
    cpu_obs = Observation(cpu_model.cfg, cpu_model.wn,
                          root=os.path.dirname(cfg_file) + '/')
    cpu_ret = RetrievalParams(cpu_model, cpu_obs)
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = chunked_cpu(
            build_forward_batched(cpu_model, cpu_obs, cpu_ret), pb)
        cpu_out = {key: torch.cat([o[key] for o in outs])
                   for key in ('spectrum', 'bandflux_hires')}
        cpu_lp = torch.cat(chunked_cpu(build_log_posterior_batched(
            cpu_model, cpu_obs, cpu_ret), pb[:CPU_LP_CHAINS])).numpy()
    cpu_s = time.perf_counter() - t0
    errs = {key: rel_err(gpu_out[key], cpu_out[key])
            for key in ('spectrum', 'bandflux_hires')}
    lp_diff = np.abs(gpu_lp[:CPU_LP_CHAINS] - cpu_lp)
    fin = np.isfinite(cpu_lp)
    emit('gpu_vs_cpu_hires_eclipse', chains=NCHAINS,
         log_posterior_chains=CPU_LP_CHAINS,
         max_rel_err={k: v[0] for k, v in errs.items()},
         max_abs_err={k: v[1] for k, v in errs.items()}, tol=FORWARD_TOL,
         log_posterior_max_abs_diff=float(lp_diff[fin].max()),
         log_posterior_max_rel_diff=float(
             (lp_diff[fin] / np.abs(cpu_lp[fin])).max()),
         finite_log_posteriors=[
             int(np.isfinite(gpu_lp[:CPU_LP_CHAINS]).sum()), int(fin.sum())],
         cpu_seconds=cpu_s)
    if not all(v[0] < FORWARD_TOL for v in errs.values()):
        fail(f'hires_eclipse: GPU f32 disagrees with CPU f64 {errs}')
    del cpu_model, cpu_out

    # 5. K3 on this phase's operands against its plain version.
    call, = record_calls(((model_mod, 'emission_flux_ensemble'),),
                         lambda: forward_b(pb))
    fargs, fkw = call
    sl = slice(0, HIRES_K3_CHAINS)
    k3_args = ([p[sl] for p in fargs[0]],
               *_prep('eclipse', rmodel, fargs, fkw, sl))
    k3_kw = _common(fkw, sl)
    k3_abs = check_kernel('emission_rt', ek.emission_rt_cuda,
                          ek.emission_rt_plain,
                          {f'B{HIRES_K3_CHAINS}_hires_eclipse':
                           (k3_args, k3_kw)},
                          KERNELS['eclipse']['tol'])
    every = slice(None)
    full_args = ([p[every] for p in fargs[0]],
                 *_prep('eclipse', rmodel, fargs, fkw, every))
    full_kw = _common(fkw, every)

    # 6. Times (CUDA events, medians after warm-up).
    pb_t = torch.as_tensor(pb, dtype=torch.float32, device=dev)
    with torch.no_grad():
        ms_forward = float(np.median(cuda_times(lambda: forward_b(pb_t))))
        spectrum = forward_b(pb_t)['spectrum']
        vel = pb_t[:, rret.irv] * pc.km
        ms_hires = float(np.median(cuda_times(
            lambda: forward_b.hires(spectrum, vel))))
        ms_hires_fixed = float(np.median(cuda_times(
            lambda: forward_b.hires(spectrum))))
    ms = paired_ms({
        'kernel_b512': lambda: ek.emission_rt_cuda(*full_args, **full_kw),
        'kernel_b16': lambda: ek.emission_rt_cuda(*k3_args, **k3_kw),
        'plain_b16': lambda: ek.emission_rt_plain(*k3_args, **k3_kw)},
        repeats=5)
    bound16_ms, bound16_by = kernel_bound('eclipse', k3_args, k3_kw)
    gen_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_demc(log_post_b, rret.params, nsamples=NCHAINS * 10,
                    nchains=NCHAINS, pstep=rret.pstep, pmin=rret.pmin,
                    pmax=rret.pmax, device=dev, dtype=rmodel.dtype)
        torch.cuda.synchronize()
        gen_times.append(time.perf_counter() - t0)
    emit('times_hires_eclipse', card=card, nwave=rmodel.nwave,
         nlayers=rmodel.nlayers, hires_points=len(wl_hires),
         forward_ms=ms_forward,
         forward_spectra_per_s=NCHAINS / (ms_forward * 1e-3),
         hires_stage_ms=ms_hires, hires_stage_fixed_grid_ms=ms_hires_fixed,
         k3_b512_ms=ms['kernel_b512'], k3_b16_ms=ms['kernel_b16'],
         k3_b16_plain_ms=ms['plain_b16'], k3_b16_bound_ms=bound16_ms,
         k3_b16_bound_by=bound16_by,
         demc_generations_per_s=10 / float(np.median(gen_times)),
         table_seconds=table_s, main_path_seconds=main_s,
         phase_seconds=time.perf_counter() - phase_t0,
         times_note='CUDA events around runs of 4 calls, medians; the '
                    'high-res stage on the forward\'s [512, W] spectra '
                    'with the retrieved rv_shift (per-chain lerp) and '
                    'without (the fixed lerp); DEMC: host clock around '
                    '10 generations, median of 3')
    if args.profile:
        profile('hires_eclipse', forward_b, pb_t, ms_forward)
    return ({'emission_rt': k3_launches, **lbl_launches},
            max(k3_abs.values()))


# ----------------------------------------------------------------------
# The equilibrium phase: thermochemical equilibrium in the retrieval

EQ_CPU_CHUNK = 64       # chains a CPU float64 forward of this phase takes
VMR_FLOOR = 1e-20       # VMRs held relatively above this value
VMR_TOL = FORWARD_TOL   # GPU float32 temperatures against CPU float64


def _capture(obj, name, store):
    """Wrap obj.name (an instance's method) so that each call's result
    is appended to `store`."""
    real = getattr(obj, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        store.append(out)
        return out

    setattr(obj, name, wrapped)


def _lp_bound(lp_cpu, band_cpu, uncert, tol):
    """The log-posterior difference that a band-flux error of `tol` of
    each chain's largest band flux allows: with d the error in units of
    sigma, |dlp| <= |r| |d| + |d|^2 / 2, |r| = sqrt(2 |lp|)."""
    d = tol * np.abs(band_cpu).max(axis=1, keepdims=True) / uncert[None]
    dn = np.sqrt(np.sum(d**2, axis=1))
    return np.sqrt(2.0 * np.abs(lp_cpu)) * dn + 0.5 * dn**2


def run_equilibrium(workdir, dev, args, card):
    """The equilibrium phase: the transit flagship (51 x 3209) with
    thermochemical equilibrium (benchmark.equilibrium_flagship_cfg:
    the network of H2 He H H2O CH4 CO CO2 Na K, [M/H] and C/O retrieved
    beside the Guillot parameters) as 512 chains x 20 generations
    through the driver; K1 against its plain version on the operands of
    one B = 512 forward, of a chain and of eight chains with one
    rejected; GPU float32 against CPU float64 at B = 512 (VMRs,
    spectrum, log-posterior); the eclipse variant's forward at B = 512
    through K3, held the same way; Model.run of each and runmode =
    atmosphere with the network against the CPU; the solve kernel against
    the plain float64 solve on the CPU on the B = 512 forward's operands;
    timings (the solve, the forward, the device's busy and idle time,
    DEMC).  Returns each kernel's launches on this path (each run counted
    between zeroed counters), each kernel's largest difference from its
    plain version, and the solve kernel's times and bound."""
    import torch
    from portbench import counts_chem
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.atmosphere import chem
    from pyratbay_tpu_torch.benchmark import (
        equilibrium_flagship_cfg, make_flagship)
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.io import io as pio
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.retrieval.batched import (
        build_forward_batched, build_log_posterior_batched)
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.retrieval.samplers import sample_demc
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    _, flag_obs, _, _, _ = make_flagship(workdir, device=dev)
    cfgs = {'transit': equilibrium_flagship_cfg(
        os.path.join(workdir, 'flagship.cfg'),
        os.path.join(workdir, 'equilibrium_transit.cfg'))}
    with open(cfgs['transit']) as f:
        text = f.read()
    cfgs['eclipse'] = os.path.join(workdir, 'equilibrium_eclipse.cfg')
    with open(cfgs['eclipse'], 'w') as f:
        f.write(text.replace('rt_path = transit', 'rt_path = eclipse'))

    counters = (tk.transit_rt_cuda, tk.transit_one_cuda, ek.emission_rt_cuda,
                chem.equilibrium_cuda)
    launches = {'transit_rt': 0, ONE_CHAIN['name']: 0, 'emission_rt': 0,
                CHEM['name']: 0}

    def counted(fn):
        """fn() between zeroed launch counters; adds its launches to
        the phase's and returns (fn's result, its launches)."""
        for counter in counters:
            counter.launches = 0
        tk.transit_rt_cuda.tall_launches = 0
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        got = {'transit_rt': tk.transit_rt_cuda.launches,
               ONE_CHAIN['name']: tk.transit_one_cuda.launches,
               'emission_rt': ek.emission_rt_cuda.launches,
               CHEM['name']: chem.equilibrium_cuda.launches}
        for key, value in got.items():
            launches[key] += value
        return out, got

    max_abs = {}
    rng = np.random.default_rng(0)
    for kind in ('transit', 'eclipse'):
        spec = KERNELS[kind]
        wrapper = 'transit_spectrum_ensemble' if kind == 'transit' \
            else 'emission_flux_ensemble'
        kernel, plain = ((tk.transit_rt_cuda, tk.transit_rt_plain)
                         if kind == 'transit'
                         else (ek.emission_rt_cuda, ek.emission_rt_plain))
        model = Model(cfgs[kind], device=dev)
        obs = Observation(obs_cfg(flag_obs), model.wn)
        ret = RetrievalParams(model, obs)
        if model.chem_model is None or (model.nlayers, model.nwave) != (
                NLAYERS, NWAVE):
            fail(f'equilibrium {kind}: no network or shape '
                 f'{(model.nlayers, model.nwave)}')
        p0 = np.asarray(ret.params)
        pb = np.clip(p0 + ret.pstep * rng.standard_normal(
            (NCHAINS, len(p0))), ret.pmin, ret.pmax)
        forward_b = build_forward_batched(model, obs, ret)
        pb_t = torch.as_tensor(pb, dtype=model.dtype, device=dev)

        # The kernel against its plain version on this path's operands:
        call, = record_calls(((model_mod, wrapper),),
                             lambda: forward_b(pb_t))
        pb_rejected = pb[:8].copy()
        pb_rejected[-1, 1] = 1.0e6
        rejected, = record_calls(((model_mod, wrapper),),
                                 lambda: forward_b(pb_rejected))
        cases = {
            'B512_equilibrium': wrapper_case(kind, model, call),
            'B8_equilibrium_rejected_chain': wrapper_case(
                kind, model, rejected),
        }
        case_abs = check_kernel(spec['name'], kernel, plain, cases,
                                spec['tol'])
        max_abs[spec['name']] = max(case_abs.values())
        if kind == 'transit':
            max_abs[ONE_CHAIN['name']] = max(check_kernel(
                ONE_CHAIN['name'], tk.transit_one_cuda, tk.transit_one_plain,
                {'B1_equilibrium': one_case(call),
                 'B2_equilibrium_rejected_chain': one_case(
                     rejected, slice(6, 8))}, ONE_CHAIN['tol']).values())

        # The main path: the retrieval through the driver (transit), the
        # B = 512 forward (eclipse):
        band0 = forward_b(p0[None])['bandflux'][0].cpu().numpy()
        if kind == 'transit':
            uncert = np.full(len(band0), NOISE)
            data = band0 + np.random.default_rng(1).normal(0, uncert)
            filters = [f'tophat {band.wl0:.4f} {band.half_width}'
                       for band in obs.filters]
            ret_cfg = os.path.join(workdir, 'equilibrium_retrieval.cfg')
            write_retrieval_cfg(
                cfgs[kind], ret_cfg, data, uncert, filters,
                os.path.join(workdir, 'equilibrium_retrieval.log'))
            t0 = time.perf_counter()
            rmodel, path_launches = counted(lambda: run(ret_cfg, seed=0))
            main_s = time.perf_counter() - t0
            out = np.load(os.path.join(workdir, 'equilibrium_retrieval.npz'))
            finite = {k: bool(np.all(np.isfinite(out[k]))) for k in
                      ('posterior', 'bestp', 'spec_best', 'bandflux_best')}
            checks = {
                'on_the_card': rmodel.device.type == 'cuda',
                'network': rmodel.chem_model is not None,
                'finite': all(finite.values()),
                'accepted': float(out['acceptance_rate']) > 0,
                'k1_every_generation':
                    path_launches['transit_rt'] >= NGEN + 2,
                'k2_at_b1': path_launches[ONE_CHAIN['name']] >= 1,
                # A solve on every forward, K1's and K2's:
                'solve_every_forward': path_launches[CHEM['name']]
                >= path_launches['transit_rt']
                + path_launches[ONE_CHAIN['name']],
            }
            emit('main_path_equilibrium', rt_path='transit', seconds=main_s,
                 nchains=NCHAINS, generations=NGEN,
                 pnames=list(rmodel.ret.pnames),
                 acceptance_rate=float(out['acceptance_rate']),
                 best_log_post=float(out['best_log_post']),
                 bestp=[float(v) for v in out['bestp']],
                 launches=path_launches, checks=checks)
            if not all(checks.values()):
                fail(f'equilibrium main path: {checks}')
        else:
            _, path_launches = counted(lambda: forward_b(pb_t))
            emit('main_path_equilibrium', rt_path='eclipse', nchains=NCHAINS,
                 launches=path_launches)
            if path_launches['emission_rt'] != 1 \
                    or path_launches[CHEM['name']] != 1:
                fail(f'equilibrium eclipse: K3 or solve launches '
                     f'{path_launches}')

        # GPU float32 against CPU float64 at B = 512: the VMRs, the
        # spectrum and (transit) the log-posterior.
        cpu_model = Model(cfgs[kind], device='cpu')
        cpu_obs = Observation(obs_cfg(flag_obs), cpu_model.wn)
        cpu_ret = RetrievalParams(cpu_model, cpu_obs)
        if kind == 'transit':
            for o in (obs, cpu_obs):
                o.data, o.uncert = data, uncert
        gpu_vmrs, cpu_vmrs = [], []
        _capture(model, 'eval_vmr_batched', gpu_vmrs)
        _capture(cpu_model, 'eval_vmr_batched', cpu_vmrs)
        with torch.no_grad():
            gpu_out = build_forward_batched(model, obs, ret)(pb_t)
            if kind == 'transit':
                gpu_lp = build_log_posterior_batched(model, obs, ret)(
                    pb_t).double().cpu().numpy()
            t0 = time.perf_counter()
            cpu_fb = build_forward_batched(cpu_model, cpu_obs, cpu_ret)
            outs = chunked_cpu(cpu_fb, pb, EQ_CPU_CHUNK)
            cpu_vmr = torch.cat(cpu_vmrs)
            cpu_lp = None
            if kind == 'transit':
                cpu_lp = torch.cat(chunked_cpu(build_log_posterior_batched(
                    cpu_model, cpu_obs, cpu_ret), pb, EQ_CPU_CHUNK)).numpy()
            cpu_s = time.perf_counter() - t0
        gpu_vmr = gpu_vmrs[0]
        cpu_spec = torch.cat([o['spectrum'] for o in outs])
        cpu_band = torch.cat([o['bandflux'] for o in outs]).numpy()
        spec_rel, spec_abs = rel_err(gpu_out['spectrum'], cpu_spec)
        live = cpu_vmr.numpy() > VMR_FLOOR
        vmr_diff = np.abs(gpu_vmr.double().cpu().numpy() - cpu_vmr.numpy())
        vmr_rel = float(np.max(vmr_diff[live] / cpu_vmr.numpy()[live]))
        checks = {'spectrum': spec_rel < FORWARD_TOL,
                  'vmr': vmr_rel < VMR_TOL,
                  'vmr_shape': tuple(gpu_vmr.shape) == (
                      NCHAINS, NLAYERS, len(model.species))}
        lp_fields = {}
        if cpu_lp is not None:
            fin = np.isfinite(cpu_lp)
            bound = _lp_bound(cpu_lp, cpu_band, uncert, FORWARD_TOL)
            lp_diff = np.abs(gpu_lp - cpu_lp)
            checks['log_posterior_finite'] = bool(np.array_equal(
                np.isfinite(gpu_lp), fin))
            checks['log_posterior'] = bool(np.all(
                lp_diff[fin] <= bound[fin]))
            lp_fields = dict(
                log_posterior_max_abs_diff=float(lp_diff[fin].max()),
                log_posterior_max_rel_diff=float(
                    (lp_diff[fin] / np.abs(cpu_lp[fin])).max()),
                log_posterior_largest_share_of_bound=float(
                    (lp_diff[fin] / bound[fin]).max()),
                finite_log_posteriors=int(fin.sum()))
        emit('gpu_vs_cpu_equilibrium', rt_path=kind, chains=NCHAINS,
             spectrum_max_rel_err=spec_rel, spectrum_max_abs_err=spec_abs,
             vmr_max_rel_err=vmr_rel, vmr_floor=VMR_FLOOR,
             vmr_max_rel_err_above_1e_30=float(np.max(
                 vmr_diff[cpu_vmr.numpy() > 1e-30]
                 / cpu_vmr.numpy()[cpu_vmr.numpy() > 1e-30])),
             tol=FORWARD_TOL, cpu_seconds=cpu_s, checks=checks, **lp_fields)
        if not all(checks.values()):
            fail(f'equilibrium {kind}: GPU f32 against CPU f64 {checks}')
        del model.eval_vmr_batched      # the class's method again
        del cpu_model, outs, cpu_vmrs, gpu_vmrs

        # Model.run through the driver (runmode = spectrum) against the
        # CPU, and (transit) runmode = atmosphere with the network:
        spec_cfg = os.path.join(workdir, f'equilibrium_{kind}_spec.cfg')
        with open(cfgs[kind]) as f:
            spec_text = f.read().replace(
                'logfile = ', f'specfile = {workdir}/eq_{kind}.dat\nlogfile = ')
        with open(spec_cfg, 'w') as f:
            f.write(spec_text)
        t0 = time.perf_counter()
        smodel, run_launches = counted(lambda: run(spec_cfg))
        run_s = time.perf_counter() - t0
        cpu_spec = Model(spec_cfg, device='cpu').run()['spectrum']
        rel, absolute = rel_err(torch.as_tensor(smodel.spectrum)[None],
                                cpu_spec[None])
        expect = {'transit_rt': 0, ONE_CHAIN['name']: 1,
                  'emission_rt': 0} if kind == 'transit' else {
                  'transit_rt': 0, ONE_CHAIN['name']: 0, 'emission_rt': 1}
        checks = {'on_the_card': smodel.device.type == 'cuda',
                  'launches': {k: run_launches[k] for k in expect}
                  == expect,
                  'gpu_vs_cpu': rel < FORWARD_TOL,
                  'finite': bool(np.all(np.isfinite(smodel.spectrum)))}
        emit('main_path_equilibrium_spectrum', rt_path=kind, seconds=run_s,
             launches=run_launches, gpu_vs_cpu_max_rel_err=rel,
             gpu_vs_cpu_max_abs_err=absolute, tol=FORWARD_TOL,
             checks=checks)
        if not all(checks.values()):
            fail(f'equilibrium spectrum {kind}: {checks}')
        if kind == 'transit':
            atm = {}
            for where in ('cuda', 'cpu'):
                atm_cfg = os.path.join(workdir, f'eq_atm_{where}.cfg')
                atm_out = os.path.join(workdir, f'eq_{where}.atm')
                with open(atm_cfg, 'w') as f:
                    f.write(text.replace(
                        'runmode = spectrum', 'runmode = atmosphere')
                        + f'output_atmfile = {atm_out}\n')
                run(atm_cfg, device=where)
                atm[where] = pio.read_atm(atm_out)
            species_ok = list(atm['cuda'][1]) == list(atm['cpu'][1])
            errs = {name: float(np.max(np.abs(g / w - 1)))
                    for name, g, w in zip(
                        ('pressure', 'temperature', 'vmr', 'radius'),
                        atm['cuda'][2:], atm['cpu'][2:])}
            checks = {'species': species_ok,
                      'network_species': list(atm['cuda'][1])
                      == list(smodel.species),
                      'gpu_vs_cpu': max(errs.values()) < FORWARD_TOL}
            emit('main_path_equilibrium_atmosphere',
                 species=list(atm['cuda'][1]), max_rel_diff=errs,
                 checks=checks)
            if not all(checks.values()):
                fail(f'equilibrium atmosphere: {checks}')

        # Times: the forward, the device's busy and idle time in it;
        # (transit) the solve at B = 512 (CUDA events; its launches and
        # device time by the profiler) and DEMC generations/s.
        with torch.no_grad():
            forward_ms = float(np.median(cuda_times(
                lambda: forward_b(pb_t), repeats=5)))
        prof = profile(f'equilibrium_{kind}', forward_b, pb_t, forward_ms)
        times = dict(path=f'equilibrium_{kind}', card=card,
                     forward_ms=forward_ms,
                     forward_spectra_per_s=NCHAINS / (forward_ms * 1e-3),
                     forward_launches=prof['device_kernels'],
                     device_busy_ms=prof['device_busy_us'] * 1e-3,
                     device_idle_share=prof['device_idle_share'],
                     model_run_seconds=run_s)
        if kind == 'transit':
            st = forward_b.state(pb_t)

            def solve():
                return model.eval_vmr_batched(st['vmr_par_list'], st['temp'])

            with torch.no_grad():
                times['solve_ms'] = float(np.median(cuda_times(
                    solve, repeats=5)))
                times['solve_kernel_ms'], times['solve_device_ms'], \
                    times['solve_launches'] = device_ms(
                        solve, 'chem_gibbs_kernel', reps=3)
            # The solve kernel against the plain float64 solve on the CPU,
            # on this forward's operands (the chains' temperatures, [M/H]
            # and C/O), rtol CHEM['tol'] on VMRs above 1e-30:
            seen = []
            card_fn = model._equil_fn
            model._equil_fn = lambda *a: seen.append(
                (a, card_fn(*a))) or seen[-1][1]
            try:
                with torch.no_grad():
                    solve()
            finally:
                model._equil_fn = card_fn
            (temp_c, metal_c, escale_c, ratios_c), got = seen[0]
            host = lambda t: None if t is None else t.cpu()
            want = chem.equilibrium_fn(model.chem_model, torch.device('cpu'))(
                temp_c.cpu(), host(metal_c), host(escale_c),
                [(i, j, v.cpu()) for i, j, v in ratios_c]).numpy()
            got = got.cpu().numpy()
            live = want > 1e-30
            solve_rel = float(np.max(np.abs(got[live] - want[live])
                                     / want[live]))
            max_abs[CHEM['name']] = float(np.max(np.abs(got - want)))
            ns, ncols = model.chem_model._stoich_full.shape
            work = dict(chem_species=ns, chem_cols=ncols,
                        chem_steps=CHEM['steps'],
                        chem_table_temps=len(chem._T_GRID))
            bound_ms, bound_by = counts_chem.bound_ms(
                *counts_chem.solve_work(work, *temp_c.shape),
                'fp64_flops_per_s', PEAK_BYTES)
            solve_entry = dict(
                ms=times['solve_kernel_ms'], bound_ms=bound_ms,
                bound_by=bound_by, systems=int(temp_c.numel()),
                species=ns, columns=ncols, max_rel_err=solve_rel,
                tol=CHEM['tol'])
            emit('solve_kernel_equilibrium', **solve_entry)
            if not solve_rel <= CHEM['tol']:
                fail(f'equilibrium solve kernel: {solve_rel} against the '
                     f'CPU (tol {CHEM["tol"]})')
            log_post_b = build_log_posterior_batched(
                rmodel, rmodel.obs, rmodel.ret)
            gens = 10
            gen_times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sample_demc(log_post_b, rmodel.ret.params,
                            nsamples=NCHAINS * gens, nchains=NCHAINS,
                            pstep=rmodel.ret.pstep, pmin=rmodel.ret.pmin,
                            pmax=rmodel.ret.pmax, device=dev,
                            dtype=rmodel.dtype)
                torch.cuda.synchronize()
                gen_times.append(time.perf_counter() - t0)
            times['demc_generations_per_s'] = \
                gens / float(np.median(gen_times))
        emit('times_equilibrium', **times,
             times_note='solve_ms, forward_ms: CUDA events, medians of runs '
                        'of 4 calls; solve_kernel_ms (the solve kernel), '
                        'solve_device_ms, solve_launches, '
                        'forward_launches, device_busy_ms: torch.profiler '
                        'of single calls')
    return launches, max_abs, solve_entry


# ----------------------------------------------------------------------
# The radeq phase: radiative equilibrium of a two-stream model

RADEQ_SAMPLES = 100     # the driver's default nsamples
RADEQ_GATE = 10         # iterations held against a CPU float64 run
RADEQ_TOL = 1e-4        # relative, on those iterations' profiles
RADEQ_RESTART = 10      # iterations of the warm restart
CONVECTION_SAMPLES = 20


def _steep_profile(press):
    """A profile super-adiabatic below 1 bar (T ~ p^0.3 against
    grad_ad = 2/7 at cp/R = 3.5): the convective branch acts on it."""
    press = np.asarray(press)
    return np.where(press < 1.0, 1200.0, 1200.0 * press**0.3)[None]


def run_radeq(workdir, dev, args, card):
    """The radeq phase: benchmark.make_radeq's configuration (40 layers,
    0.6-12 um at R = 300, emission_two_stream) as runmode = radeq
    through the driver with nsamples = 100, with the configured
    atmosphere and with chemistry = equilibrium (the network solved at
    each iteration's profile); for each, the first 10 iterations against
    a CPU float64 run (the gate, RADEQ_TOL), the final profiles' largest
    difference in K (a finding: near equilibrium the update follows the
    signs of rounding noise), a warm restart (its shape and its first
    step against the last ones), the two-stream Model.run against the
    CPU; and radiative_equilibrium(..., convection=True) from a
    super-adiabatic profile for 20 iterations, its first 10 against the
    CPU.  Launches no kernel: the JAX package has none on this path."""
    import torch
    from pyratbay_tpu_torch.benchmark import make_radeq
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.io import io as pio
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.spectrum.radeq import radiative_equilibrium

    make_radeq(workdir, device=dev)
    with open(os.path.join(workdir, 'radeq.cfg')) as f:
        text = f.read()
    cfgs = {}
    for name, swap in (
            ('configured', ()),
            ('equilibrium', (('bulk = H2 He', 'chemistry = equilibrium\n'
                              'species = H2 He H H2O CH4 CO CO2 Na K'),))):
        body = text.replace('logfile = ', f'nsamples = {RADEQ_SAMPLES}\n'
                            'logfile = ').replace(
            f'{workdir}/radeq.log', f'{workdir}/radeq_{name}.log')
        for old, new in swap:
            body = body.replace(old, new)
        cfgs[name] = os.path.join(workdir, f'radeq_{name}.cfg')
        with open(cfgs[name], 'w') as f:
            f.write(body)

    def clips(model):
        return dict(tmin=max(model.tmin.values(), default=0.0),
                    tmax=min(model.tmax.values(), default=6000.0))

    def gate(got, want):
        n = RADEQ_GATE + 1
        return float(np.max(np.abs(got[:n] - want[:n]) / want[:n]))

    times = {}
    for name, cfg in cfgs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = run(cfg)                  # the default device: the card
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        base = os.path.join(workdir, f'radeq_{name}')
        temps = np.load(base + '.npz')['temps']
        atm = pio.read_atm(base + '.atm')
        # The same iterations on the CPU in float64:
        cpu_model = Model(cfg, device='cpu')
        t0 = time.perf_counter()
        cpu_temps = radiative_equilibrium(
            cpu_model, nsamples=RADEQ_SAMPLES, **clips(cpu_model))
        cpu_s = time.perf_counter() - t0
        gate_rel = gate(temps, cpu_temps)
        final_k = np.abs(temps[-1] - cpu_temps[-1])
        apart = np.nonzero(np.abs(temps - cpu_temps).max(axis=1) > 1.0)[0]
        # A warm restart from the driver's model:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = radiative_equilibrium(
            model, nsamples=RADEQ_RESTART, radeq_temps=model.radeq_temps,
            dt_scale=model._dt_scale, **clips(model))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        steps = np.abs(np.diff(temps, axis=0)).max(axis=1)
        first_step = float(np.abs(warm[len(temps)] - temps[-1]).max())
        checks = {
            'on_the_card': model.device.type == 'cuda',
            'network': (model.chem_model is not None) == (
                name == 'equilibrium'),
            'shape': temps.shape == (RADEQ_SAMPLES + 1, model.nlayers),
            'finite': bool(np.all(np.isfinite(temps))),
            'atm_is_the_last_profile': bool(np.allclose(
                atm[3], temps[-1], rtol=1e-5, atol=0.01)),
            'first_iterations_vs_cpu': gate_rel < RADEQ_TOL,
            'restart_shape': warm.shape == (
                RADEQ_SAMPLES + RADEQ_RESTART + 1, model.nlayers),
            'restart_keeps_history': bool(np.array_equal(
                warm[:len(temps)], temps)),
            'restart_finite': bool(np.all(np.isfinite(warm))),
            'restart_continuous': bool(
                first_step <= 3.0 * steps[-5:].max() + 1.0),
        }
        emit('main_path_radeq', run=name, seconds=seconds,
             iterations=RADEQ_SAMPLES,
             iterations_per_s=RADEQ_SAMPLES / seconds,
             nlayers=model.nlayers, nwave=model.nwave,
             cpu_seconds=cpu_s, first_iterations=RADEQ_GATE,
             first_iterations_max_rel_diff=gate_rel, tol=RADEQ_TOL,
             final_max_abs_diff_k=float(final_k.max()),
             first_iteration_apart_by_1k=int(apart[0]) if len(apart)
             else None,
             final_profile_k=[float(t) for t in temps[-1]],
             restart_seconds=warm_s,
             restart_iterations_per_s=RADEQ_RESTART / warm_s,
             restart_first_step_k=first_step,
             last_steps_k=[float(v) for v in steps[-5:]], checks=checks)
        if not all(checks.values()):
            fail(f'radeq {name}: {checks}')
        times[f'{name}_iterations_per_s'] = RADEQ_SAMPLES / seconds
        times[f'{name}_restart_iterations_per_s'] = RADEQ_RESTART / warm_s
        if name == 'configured':
            # The two-stream Model.run (no kernel) against the CPU:
            run_s = []
            for _ in range(MODEL_RUN_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = model.run()
                torch.cuda.synchronize()
                run_s.append(time.perf_counter() - t0)
            cpu_spec = cpu_model.run()['spectrum']
            rel, absolute = rel_err(result['spectrum'][None],
                                    cpu_spec[None])
            times['two_stream_model_run_ms'] = float(np.median(run_s)) * 1e3
            emit('main_path_two_stream', rt_path=model.rt_path,
                 model_run_ms=times['two_stream_model_run_ms'],
                 gpu_vs_cpu_max_rel_err=rel, gpu_vs_cpu_max_abs_err=absolute,
                 tol=FORWARD_TOL)
            if not rel < FORWARD_TOL:
                fail(f'two-stream Model.run: GPU f32 against CPU f64 {rel}')
            # Convection from a super-adiabatic profile:
            steep = _steep_profile(model.press)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            conv = radiative_equilibrium(
                model, nsamples=CONVECTION_SAMPLES, convection=True,
                radeq_temps=steep, **clips(model))
            torch.cuda.synchronize()
            conv_s = time.perf_counter() - t0
            cpu_conv = radiative_equilibrium(
                cpu_model, nsamples=CONVECTION_SAMPLES, convection=True,
                radeq_temps=steep, **clips(cpu_model))
            radiative = radiative_equilibrium(
                cpu_model, nsamples=CONVECTION_SAMPLES, radeq_temps=steep,
                **clips(cpu_model))
            conv_rel = gate(conv, cpu_conv)
            checks = {
                'shape': conv.shape == (CONVECTION_SAMPLES + 1,
                                        model.nlayers),
                'finite': bool(np.all(np.isfinite(conv))),
                'first_iterations_vs_cpu': conv_rel < RADEQ_TOL,
                'convection_acted': bool(
                    np.abs(cpu_conv[-1] - radiative[-1]).max() > 1.0),
            }
            times['convection_iterations_per_s'] = CONVECTION_SAMPLES / conv_s
            emit('main_path_radeq_convection', iterations=CONVECTION_SAMPLES,
                 seconds=conv_s,
                 iterations_per_s=times['convection_iterations_per_s'],
                 first_iterations_max_rel_diff=conv_rel, tol=RADEQ_TOL,
                 final_max_abs_diff_k=float(
                     np.abs(conv[-1] - cpu_conv[-1]).max()),
                 convective_minus_radiative_k=float(
                     np.abs(cpu_conv[-1] - radiative[-1]).max()),
                 checks=checks)
            if not all(checks.values()):
                fail(f'radeq convection: {checks}')
        del cpu_model
    emit('times_radeq', card=card, **times,
         times_note='host clock around the driver run (the Model set-up '
                    'and the files included), around radiative_equilibrium '
                    '(restart, convection) and around Model.run, each '
                    'ending in a synchronize')


# ----------------------------------------------------------------------
# The nested phase: sampler = multinest on the transit flagship

NESTED_NLIVE = 400      # the driver's default nlive
NESTED_MAX_ITER = 4000  # dead points of the phase's run (default 50 nlive)
NESTED_WALK = 25        # the sampler's default nsteps_walk
NESTED_INIT_CHECKED = 64   # init chains held against the CPU


def counted_run(counters, fn):
    """fn() between zeroed launch counters (each kernel's `launches`, K2's
    among them whether named or not, and the transit kernel's tall
    count); returns (fn's result, {counter name: launches})."""
    import torch
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    counters = (*counters, tk.transit_one_cuda)
    for counter in counters:
        counter.launches = 0
    tk.transit_rt_cuda.tall_launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {c.__name__: c.launches for c in counters}


def batch_sizes(fn):
    """fn() with the model's transit wrapper wrapped: (fn's result, the
    number of wrapper calls by batch size)."""
    from pyratbay_tpu_torch import model as model_mod
    real = model_mod.transit_spectrum_ensemble
    sizes = {}

    def wrapper(ec_parts, path, radius, *a, **kw):
        nb = int(radius.shape[0])
        sizes[nb] = sizes.get(nb, 0) + 1
        return real(ec_parts, path, radius, *a, **kw)

    model_mod.transit_spectrum_ensemble = wrapper
    try:
        out = fn()
    finally:
        model_mod.transit_spectrum_ensemble = real
    return out, sizes


def synchronising_calls(work):
    """torch.profiler's host calls of work() that read the device back
    (a synchronize, a scalar read, a blocking copy, a nonzero)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    calls = {evt.key: evt.count for evt in prof.key_averages()}
    return {name: count for name, count in calls.items()
            if 'Synchronize' in name or name in (
                'aten::item', 'aten::_local_scalar_dense', 'cudaMemcpy',
                'aten::nonzero')}


def run_nested(workdir, dev, args, card):
    """The nested phase: the transit flagship (51 x 3209, 7 parameters)
    with sampler = multinest and nlive = 400 through the driver on the
    card, its dead points cut to args.nested_max_iter (0: the default
    50 nlive) by wrapping the driver's sample_nested.  Checks: finite
    logz, logz_err and posterior, the posterior inside the prior box, K1
    at every walk step (B = 25) and at the live set's start (B = 400),
    the best fit's log-posterior against a CPU float64 one within what
    the spectrum bound allows, the card's float32 log-likelihoods of a
    first scan step on injected draws against CPU float64 within the
    same allowance, K1 against its plain version at the walk's B = 25,
    a scan step of the flagship that reads nothing back to the host, and
    an analytic Gaussian's evidence on the card within 0.5.  Times: walk
    forwards/s, dead points/s, the run's seconds, launches a walk step.
    Returns each kernel's launches on this path and K1's largest
    difference from its plain version."""
    import torch
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.retrieval import driver as rdriver
    from pyratbay_tpu_torch.retrieval import nested
    from pyratbay_tpu_torch.retrieval.batched import (
        build_forward_batched, build_log_posterior_batched)
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    spec = KERNELS['transit']
    _, obs, _, forward, p0 = make_flagship(workdir, device=dev)
    band0 = forward(p0)['bandflux'].cpu().numpy()
    uncert = np.full(len(band0), NOISE)
    data = band0 + np.random.default_rng(1).normal(0, uncert)
    filters = [f'tophat {band.wl0:.4f} {band.half_width}'
               for band in obs.filters]
    cfg_file = os.path.join(workdir, 'nested.cfg')
    write_retrieval_cfg(
        os.path.join(workdir, 'flagship.cfg'), cfg_file, data, uncert,
        filters, os.path.join(workdir, 'nested.log'),
        extra=('sampler = multinest', f'nlive = {NESTED_NLIVE}'))

    # The main path through the driver, its dead points cut:
    max_iter = args.nested_max_iter or 50 * NESTED_NLIVE
    batch = NESTED_NLIVE // 16
    n_scan = -(-max_iter // batch)
    real_nested = rdriver.sample_nested
    sampler_s = []

    def cut(*a, **kw):
        t0 = time.perf_counter()
        out = real_nested(*a, max_iter=max_iter, **kw)
        sampler_s.append(time.perf_counter() - t0)
        return out

    rdriver.sample_nested = cut
    t0 = time.perf_counter()
    try:
        (rmodel, sizes), launches = counted_run(
            (tk.transit_rt_cuda, ek.emission_rt_cuda),
            lambda: batch_sizes(lambda: run(cfg_file, seed=0)))
    finally:
        rdriver.sample_nested = real_nested
    main_s = time.perf_counter() - t0
    out = np.load(os.path.join(workdir, 'nested.npz'))
    ret = rmodel.ret
    post = out['posterior']
    checks = {
        'on_the_card': rmodel.device.type == 'cuda',
        'finite': all(bool(np.all(np.isfinite(out[k]))) for k in (
            'logz', 'logz_err', 'posterior', 'bestp', 'spec_best',
            'bandflux_best')),
        'logz_err_positive': float(out['logz_err']) > 0,
        'posterior_in_prior_box': bool(np.all(
            (post >= ret.pmin) & (post <= ret.pmax))),
        'k1_every_walk_step': sizes.get(batch, 0) == n_scan * NESTED_WALK,
        'k1_live_set': sizes.get(NESTED_NLIVE, 0) >= 1,
        'one_launch_a_call': sum(sizes.values())
        == launches['transit_rt_cuda'] + launches['transit_one_cuda'],
        'k2_at_b1': sizes.get(1, 0) == launches['transit_one_cuda'],
    }
    emit('main_path_nested', seconds=main_s, sampler_seconds=sampler_s[0],
         nlive=NESTED_NLIVE, batch=batch, nsteps_walk=NESTED_WALK,
         scan_steps=n_scan, max_iter=max_iter,
         cut=None if max_iter == 50 * NESTED_NLIVE else
         f'max_iter {50 * NESTED_NLIVE} -> {max_iter} (the driver\'s '
         'sample_nested wrapped)',
         logz=float(out['logz']), logz_err=float(out['logz_err']),
         n_dead_used=int(len(post)), best_log_post=float(
             out['best_log_post']),
         acceptance_rate=float(out['acceptance_rate']),
         k1_calls_by_batch={str(k): v for k, v in sorted(sizes.items())},
         launches=launches, checks=checks)
    if not all(checks.values()):
        fail(f'nested main path: {checks}')

    # The best fit's log-posterior against CPU float64, and the first scan
    # step on injected draws: every log-likelihood the card computed
    # against CPU float64 at the same parameters.
    gpu_lp = build_log_posterior_batched(rmodel, rmodel.obs, ret)
    cpu_model = Model(cfg_file, device='cpu')
    cpu_obs = rdriver._observation(cpu_model)
    cpu_ret = RetrievalParams(cpu_model, cpu_obs)
    cpu_lp = build_log_posterior_batched(cpu_model, cpu_obs, cpu_ret)
    gpu_fb = build_forward_batched(rmodel, rmodel.obs, ret)
    transform = rdriver.unit_cube_prior(ret, dev)
    rng = np.random.default_rng(2)
    ndim = len(ret.ifree)
    on = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    live_u = on(rng.uniform(size=(NESTED_NLIVE, ndim)))
    pick = torch.as_tensor(rng.integers(0, NESTED_NLIVE - batch, batch),
                           device=dev)
    normal = on(rng.standard_normal((NESTED_WALK, batch, ndim)))
    scales = np.tile([1.0, 0.3, 0.1], 9)[:NESTED_WALK]
    seen = []

    def log_like(u, record=True):
        theta = transform(u)
        lp = gpu_lp(theta)
        if record:
            seen.append((theta, lp, gpu_fb(theta)['bandflux']))
        return lp.double()

    with torch.no_grad():
        live_logl = log_like(live_u)
        nested.scan_step(log_like, live_u, live_logl, pick, normal, batch,
                         scales)
        theta_best = on(out['bestp'][None])
        seen_best = (theta_best, on([float(out['best_log_post'])]),
                     gpu_fb(theta_best)['bandflux'])
        t0 = time.perf_counter()
        rows = []
        for i, (theta, lp, band) in enumerate([seen_best] + seen):
            if i == 1:
                theta, lp, band = (v[:NESTED_INIT_CHECKED]
                                   for v in (theta, lp, band))
            theta_cpu = theta.cpu()
            lp_cpu = torch.cat(chunked_cpu(cpu_lp, theta_cpu)).numpy()
            rows.append((lp.double().cpu().numpy(), lp_cpu,
                         band.double().cpu().numpy()))
        cpu_s = time.perf_counter() - t0
    lp_checks = {}
    largest = {}
    for name, part in (('best_fit', rows[:1]), ('scan_step', rows[1:])):
        lp_g = np.concatenate([r[0] for r in part])
        lp_c = np.concatenate([r[1] for r in part])
        band = np.concatenate([r[2] for r in part])
        fin = np.isfinite(lp_c)
        bound = _lp_bound(lp_c[fin], np.where(np.isfinite(band[fin]),
                                              band[fin], 0), uncert,
                          FORWARD_TOL)
        diff = np.abs(lp_g[fin] - lp_c[fin])
        lp_checks[name] = bool(np.array_equal(np.isfinite(lp_g), fin)) \
            and bool(np.all(diff <= bound))
        largest[name] = dict(
            chains=int(len(lp_c)), finite=int(fin.sum()),
            max_abs_diff=float(diff.max()) if fin.any() else None,
            largest_share_of_bound=float((diff / bound).max())
            if fin.any() else None)
    emit('gpu_vs_cpu_nested', card=card, cpu_seconds=cpu_s,
         walk_steps=NESTED_WALK, init_chains_checked=NESTED_INIT_CHECKED,
         tol=FORWARD_TOL, log_posterior=largest, checks=lp_checks)
    if not all(lp_checks.values()):
        fail(f'nested: GPU f32 log-likelihoods against CPU f64 {largest}')

    # K1 against its plain version at the walk's B = 25, on the operands
    # of one walk forward:
    theta_walk = seen[1][0]
    call, = record_calls(((model_mod, 'transit_spectrum_ensemble'),),
                         lambda: gpu_fb(theta_walk))
    case_abs = check_kernel(spec['name'], tk.transit_rt_cuda,
                            tk.transit_rt_plain,
                            {f'B{batch}_nested_walk': wrapper_case(
                                'transit', rmodel, call)}, spec['tol'])

    # A flagship scan step reads nothing back to the host:
    step = lambda: nested.scan_step(
        lambda u: log_like(u, record=False), live_u, live_logl, pick,
        normal, batch, scales)
    with torch.no_grad():
        step()
        baseline = synchronising_calls(lambda: None)
        syncs = synchronising_calls(step)
    sync_ok = syncs == baseline

    # An analytic Gaussian's evidence on the card (tests/test_nested.py):
    d = 3
    t0 = time.perf_counter()
    gauss = nested.sample_nested(
        lambda th: -0.5 * torch.sum(th**2, dim=1) - 0.5 * d * np.log(
            2 * np.pi),
        lambda u: 10.0 * u - 5.0, d, nlive=400, max_iter=6000,
        nsteps_walk=40, generator=torch.Generator(device=dev).manual_seed(1),
        device=dev, dtype=torch.float64)
    gauss_s = time.perf_counter() - t0
    gauss_ok = bool(abs(gauss['logz'] + d * np.log(10.0)) < 0.5)

    # Times: a walk forward (B = 25) by events and its launches.
    theta_walk = theta_walk.float()
    with torch.no_grad():
        walk_ms = float(np.median(cuda_times(lambda: gpu_lp(theta_walk))))
        _, walk_device_ms, walk_launches = device_ms(
            lambda: gpu_lp(theta_walk), spec['name'], reps=5)
    forwards = n_scan * NESTED_WALK + 1
    checks = {'scan_step_syncs_nothing': sync_ok,
              'gaussian_evidence': gauss_ok}
    emit('times_nested', card=card, run_seconds=sampler_s[0],
         main_path_seconds=main_s, walk_forwards=forwards,
         walk_forwards_per_s=forwards / sampler_s[0],
         dead_points_per_s=n_scan * batch / sampler_s[0],
         walk_forward_ms=walk_ms, walk_forward_device_ms=walk_device_ms,
         launches_per_walk_step=walk_launches,
         scan_step_synchronising_calls=syncs, baseline_calls=baseline,
         gaussian_logz=gauss['logz'], gaussian_logz_true=-d * np.log(10.0),
         gaussian_seconds=gauss_s, checks=checks,
         times_note='run_seconds: host clock around the driver\'s '
                    'sample_nested (its result on the host); walk_forward_ms: '
                    'CUDA events around runs of 4 log-posterior calls at '
                    'B = 25; launches and device ms: torch.profiler')
    if not all(checks.values()):
        fail(f'nested: {checks}')
    if args.profile:
        profile('nested_walk', lambda p: gpu_lp(p), theta_walk, walk_ms)
    return launches, case_abs[f'B{batch}_nested_walk']


# ----------------------------------------------------------------------
# The lbl_retrieval phase: a retrieval of the transit flagship with H2O
# from the 50,000-line TLI file in place of the line sample

LBL_NGEN = 10
LBL_CPU_CHAINS = 2


def run_lbl_retrieval(workdir, dev, args, card):
    """The lbl_retrieval phase: the transit flagship with H2O from
    make_lbl_flagship's 50,000-line TLI file (tlifile in place of the
    line-sample table), 512 chains x 10 generations through the driver
    and its post-processing on the card: every forward computes the
    extinction of 26,112 cells by the direct engine (K4 and K5 a pass,
    DirectLBL.factor_block cells a pass), then K1.  Checks: finite
    results, K4 and K5 on every forward, K4 and K5 against their plain
    versions on one of the forward's own blocks, GPU float32 against
    CPU float64 on 2 chains x 51 layers (the extinction within the
    line-by-line bound, 2e-4 relative above 1e-6 of the maximum; the
    spectrum within it of the row maximum; the log-posterior within
    what that allows).  Times: the forward at B = 512 by events, K4, K5
    and the line factors' device ms, peak memory, DEMC generations/s,
    and K4 and K5's kernel, plain and bound ms at the retrieval's block.
    Returns each kernel's launches on this path, the two line kernels'
    times at the block and their largest differences from the plain
    versions."""
    import torch
    from pyratbay_tpu_torch.benchmark import make_flagship, make_lbl_flagship
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.opacity import lbl_kernel as lk
    from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL
    from pyratbay_tpu_torch.retrieval import driver as rdriver
    from pyratbay_tpu_torch.retrieval.batched import (
        build_forward_batched, build_log_posterior_batched)
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.retrieval.samplers import sample_demc
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    t0 = time.perf_counter()
    _, tli_cfg, _ = make_lbl_flagship(workdir, nlines=NLINES)
    run(tli_cfg)
    tli = os.path.join(workdir, 'flagship_h2o.tli')
    _, obs, _, forward, p0 = make_flagship(workdir, device=dev)
    inputs_s = time.perf_counter() - t0
    flag_cfg = os.path.join(workdir, 'flagship.cfg')
    with open(flag_cfg) as f:
        text = f.read()
    lbl_cfg = os.path.join(workdir, 'flagship_lbl.cfg')
    with open(lbl_cfg, 'w') as f:
        f.write('\n'.join(f'tlifile = {tli}' if ln.startswith(
            'sampled_cross_sec') else ln for ln in text.splitlines()) + '\n')
    model = Model(lbl_cfg, device=dev)
    types = [m[0] for m in model.opacity_models]
    if 'lbl' not in types or 'line_sample' in types:
        fail(f'lbl_retrieval: opacity models {types}')
    ret = RetrievalParams(model, obs)
    forward_b = build_forward_batched(model, obs, ret)
    band0 = forward_b(p0[None])['bandflux'][0].cpu().numpy()
    uncert = np.full(len(band0), NOISE)
    data = band0 + np.random.default_rng(1).normal(0, uncert)
    filters = [f'tophat {band.wl0:.4f} {band.half_width}'
               for band in obs.filters]
    cfg_file = os.path.join(workdir, 'lbl_retrieval.cfg')
    write_retrieval_cfg(lbl_cfg, cfg_file, data, uncert, filters,
                        os.path.join(workdir, 'lbl_retrieval.log'),
                        ngen=LBL_NGEN)
    lbl = model.opacity_models[types.index('lbl')][1]
    direct = model.direct_lbl(lbl)
    block = direct.factor_block()
    ncell = NCHAINS * NLAYERS
    passes = -(-ncell // block)

    # The main path through the driver:
    counters = (lk.wing_sigma_lines_cuda, lk.core_sigma_lines_cuda,
                tk.transit_rt_cuda, ek.emission_rt_cuda)
    t0 = time.perf_counter()
    rmodel, launches = counted_run(counters, lambda: run(cfg_file, seed=0))
    main_s = time.perf_counter() - t0
    out = np.load(os.path.join(workdir, 'lbl_retrieval.npz'))
    base = os.path.join(workdir, 'lbl_retrieval')
    forwards = LBL_NGEN + 1
    checks = {
        'on_the_card': rmodel.device.type == 'cuda',
        'finite': all(bool(np.all(np.isfinite(out[k]))) for k in (
            'posterior', 'bestp', 'spec_best', 'bandflux_best')),
        'accepted': float(out['acceptance_rate']) > 0,
        'k4_every_forward':
            launches['wing_sigma_lines_cuda'] >= forwards * passes,
        'k5_every_forward':
            launches['core_sigma_lines_cuda'] >= forwards * passes,
        'k1_every_generation': launches['transit_rt_cuda'] >= forwards,
        'post_processing': all(os.path.isfile(base + s) for s in POST_FILES),
    }
    emit('main_path_lbl_retrieval', seconds=main_s, inputs_seconds=inputs_s,
         nchains=NCHAINS, generations=LBL_NGEN, cells_per_forward=ncell,
         block=block, passes_per_forward=passes,
         nlines_pad=int(direct.tables()['l_lwn_hi'].shape[0]),
         acceptance_rate=float(out['acceptance_rate']),
         best_log_post=float(out['best_log_post']), launches=launches,
         checks=checks)
    if not all(checks.values()):
        fail(f'lbl_retrieval main path: {checks}')

    # K4 and K5 against their plain versions on one of a B = 512
    # forward's blocks (the first, full one):
    rng = np.random.default_rng(0)
    pb = np.clip(p0 + ret.pstep * rng.standard_normal((NCHAINS, len(p0))),
                 ret.pmin, ret.pmax)
    pb_t = torch.as_tensor(pb, dtype=torch.float32, device=dev)
    blocks = []
    real_batch = DirectLBL._cross_section_batch

    def first_block(self, tables, *cells):
        if not blocks:
            blocks.append(cells)
        return real_batch(self, tables, *cells)

    DirectLBL._cross_section_batch = first_block
    try:
        with torch.no_grad():
            forward_b(pb_t)
    finally:
        DirectLBL._cross_section_batch = real_batch
    ops = lbl_operands(direct, blocks[0], 1, windows=False)
    max_abs, block_ms, block_plain_ms, bounds = {}, {}, {}, {}
    for key, (operands, kw) in ops.items():
        kernel = getattr(lk, LBL[key]['fn'] + '_cuda')
        plain = getattr(lk, LBL[key]['fn'] + '_plain')
        got = kernel(*operands, **kw)
        want = plain(*operands, **kw)
        torch.cuda.synchronize()
        rel, max_abs[key] = masked_rel(got, want)
        emit('kernel_check', kernel=LBL[key]['name'],
             case='lbl_retrieval_block', shape=list(got.shape),
             max_rel_err=rel, max_abs_err=max_abs[key], tol=LBL_TOL)
        if not rel < LBL_TOL:
            fail(f'{LBL[key]["name"]} lbl_retrieval_block: kernel disagrees '
                 f'with plain ({rel})')
        del got, want
        block_ms[key] = float(np.median(cuda_times(
            lambda: kernel(*operands, **kw), repeats=5, inner=2)))
        block_plain_ms[key] = float(np.median(cuda_times(
            lambda: plain(*operands, **kw), repeats=1, warmup=1, inner=1)))
        bounds[key] = lbl_bound(key, operands, kw)
    del ops

    # GPU float32 against CPU float64 on 2 chains x 51 layers: the
    # extinction each forward's direct engine returns, the spectra, the
    # band fluxes and the log-posterior.
    cpu_model = Model(cfg_file, device='cpu')
    cpu_obs = rdriver._observation(cpu_model)
    cpu_ret = RetrievalParams(cpu_model, cpu_obs)
    p2 = np.stack([out['bestp'], pb[1]])
    ecs = []                # the extinction of each call, in turn
    real_fn = DirectLBL.extinction_fn

    def recording(self, block=None):
        fn = real_fn(self, block)

        def ec_fn(temp, dens):
            ecs.append(fn(temp, dens))
            return ecs[-1]

        return ec_fn

    DirectLBL.extinction_fn = recording
    try:
        gpu_fb = build_forward_batched(model, obs, ret)
        cpu_fb = build_forward_batched(cpu_model, cpu_obs, cpu_ret)
    finally:
        DirectLBL.extinction_fn = real_fn
    with torch.no_grad():
        gpu_out = gpu_fb(p2)
        t0 = time.perf_counter()
        cpu_out = cpu_fb(p2)
        cpu_s = time.perf_counter() - t0
        lp_g = build_log_posterior_batched(rmodel, rmodel.obs, rmodel.ret)(
            p2).double().cpu().numpy()
    ec_rel, ec_abs = masked_rel(*ecs)
    spec_rel, spec_abs = rel_err(gpu_out['spectrum'], cpu_out['spectrum'])
    band_g = gpu_out['bandflux'].double().cpu().numpy()
    band_c = cpu_out['bandflux'].numpy()
    # The flagship's log-posterior from the CPU's band fluxes (no priors,
    # offsets or scalings; the two chains inside the bounds):
    lp_c = -0.5 * np.sum(((band_c - data) / uncert)**2, axis=1)
    bound = _lp_bound(lp_c, band_c, uncert, LBL_TOL)
    lp_diff = np.abs(lp_g - lp_c)
    checks = {'extinction': ec_rel < LBL_TOL,
              'spectrum': spec_rel < LBL_TOL,
              'log_posterior': bool(np.all(lp_diff <= bound))}
    emit('gpu_vs_cpu_lbl_retrieval', card=card, chains=LBL_CPU_CHAINS,
         nlayers=NLAYERS, extinction_max_rel_err=ec_rel,
         extinction_max_abs_err=ec_abs, spectrum_max_rel_err=spec_rel,
         spectrum_max_abs_err=spec_abs,
         bandflux_max_rel_err=float(np.max(np.abs(band_g / band_c - 1))),
         log_posterior_abs_diff=lp_diff.tolist(),
         log_posterior_bound=bound.tolist(), tol=LBL_TOL,
         cpu_seconds=cpu_s, checks=checks,
         note='each side\'s forward from the same parameters (its own '
              'state: float32 on the card); the CPU log-posterior from its '
              'band fluxes, -0.5 sum(((band - data) / uncert)^2)')
    if not all(checks.values()):
        fail(f'lbl_retrieval: GPU f32 against CPU f64 {checks}')
    del cpu_model, cpu_fb, ecs

    # Times: the forward at B = 512, its device time by kernel, peak
    # memory, DEMC generations/s.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        forward_ms = float(np.median(cuda_times(
            lambda: forward_b(pb_t), repeats=3, warmup=1, inner=1)))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        k4_ms, total_ms, forward_launches = device_ms(
            lambda: forward_b(pb_t), 'wing_lines', reps=2)
        k5_ms, _, _ = device_ms(lambda: forward_b(pb_t), 'core_lines',
                                reps=2)
        _, factors_ms, factor_launches = device_ms(
            lambda: direct._line_factors(direct.tables(), *blocks[0]),
            'line_factors', reps=3)
    log_post_b = build_log_posterior_batched(rmodel, rmodel.obs, rmodel.ret)
    gens = 5
    gen_times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_demc(log_post_b, rmodel.ret.params, nsamples=NCHAINS * gens,
                    nchains=NCHAINS, pstep=rmodel.ret.pstep,
                    pmin=rmodel.ret.pmin, pmax=rmodel.ret.pmax, device=dev,
                    dtype=rmodel.dtype)
        torch.cuda.synchronize()
        gen_times.append(time.perf_counter() - t0)
    named = lambda values, pick=lambda v: v: {
        LBL[k]['name']: pick(v) for k, v in values.items()}
    block_times = dict(
        cells=int(blocks[0][0].shape[0]), kernel_ms=named(block_ms),
        plain_ms=named(block_plain_ms),
        bound_ms=named(bounds, lambda v: v[0]),
        bound_by=named(bounds, lambda v: v[1]),
        issue_bound_ms=named(bounds, lambda v: v[2]))
    emit('times_lbl_retrieval', card=card, block=block, passes=passes,
         forward_ms=forward_ms,
         forward_spectra_per_s=NCHAINS / (forward_ms * 1e-3),
         forward_device_ms=total_ms, forward_launches=forward_launches,
         device_idle_share=1.0 - total_ms / forward_ms,
         k4_device_ms=k4_ms, k5_device_ms=k5_ms,
         line_factors_device_ms=factors_ms * passes,
         line_factor_launches_a_pass=factor_launches,
         peak_device_gb=peak_gb,
         demc_generations_per_s=gens / float(np.median(gen_times)),
         retrieval_block=block_times,
         times_note='forward_ms: CUDA events around single calls (each '
                    'hundreds of ms), median of 3; device ms and launches: '
                    'torch.profiler, a forward; line factors: one pass '
                    'times the passes; DEMC: host clock, 5 generations '
                    'with the initial ensemble, median of 2')
    if args.profile:
        profile('lbl_retrieval', forward_b, pb_t, forward_ms, reps=1)
    entries = {LBL[k]['name']: dict(
        cells=block_times['cells'], ms=block_ms[k],
        plain_ms=block_plain_ms[k], bound_ms=bounds[k][0],
        bound_by=bounds[k][1]) for k in ('wing_lines', 'core_lines')}
    return launches, entries, {LBL[k]['name']: max_abs[k] for k in max_abs}


# The line_lists phase (run_line_lists): line lists as users have them.
# benchmark.make_line_lists writes every format the readers take over
# the flagship's 5800-9200 cm-1 from one draw of synthetic H2O-like
# lines: HITRAN (161 MB), ExoMol (.trans with .states.bz2 over
# LL_NSTATES states) and repack with LL_NLINES lines each; P&S, Schwenke
# TiO and Plez VO with LL_NLINES_SMALL; VALD with LL_NLINES_VALD Fe
# lines.  HITEMP H2O holds ~1.1e8 lines: the lists are cut for the
# script's time.  The CPU float64 check of the direct table takes
# LL_CPU_POINTS wavenumbers of 4 cells: the CPU's exact Voigt sums over
# 943,477 lines take 0.05-0.07 s a point and cell on the card machine's
# host (PERF.md, section 5).
LL_NLINES = 1_000_000
LL_NLINES_SMALL = 200_000
LL_NLINES_VALD = 20_000
LL_NSTATES = 20_000
LL_CPU_POINTS = 64
LL_RANGE = (6500.0, 8500.0)     # cm-1, the range read of the HITRAN TLI
LL_PARITY_LAYERS = 5            # the parity engine's table on the list
LL_BUDGET_S = 150.0


def run_line_lists(workdir, dev, args, card):
    """The line_lists phase: each format through runmode = tli (the
    driver) and read back; the native HITRAN parse and TLI range read
    against their numpy versions; the ExoMol TLI into the direct table
    on the card (K4, K5) and the parity engine's table (the native
    grouping and scatter); the CLI's -cs hitran and -pf tips in
    processes of their own; a spectrum on the card (K2) from
    the ExoMol table and the CLI's CIA table.  Checks: the TLI files
    read back whole, the native functions equal their numpy versions
    and each ran (its call counter > 0), K4 and K5 against their plain
    versions on a main-path block (LBL_TOL), the table against CPU
    float64 on 4 cells (LBL_TOL on entries above 1e-4 of their row's
    maximum), K2 against its plain version and the spectrum against a
    CPU float64 Model.run (FORWARD_TOL).  Returns each kernel's launches
    on this path and the kernels' largest differences from their plain
    versions."""
    import torch
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch import runtime
    from pyratbay_tpu_torch.benchmark import (
        make_flagship, make_line_lists, synthetic_cia_hitran,
        write_opacity_cfg)
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.io import io as pio
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.opacity import lbl_kernel as lk
    from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL
    from pyratbay_tpu_torch.opacity.linelists import Exomol
    from pyratbay_tpu_torch.opacity.tli import read_tli
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk

    phase_t0 = time.perf_counter()
    natives = (runtime.parse_hitran_records, runtime.tli_extract_range,
               runtime.lbl_group, runtime.lbl_scatter)
    for fn in natives:
        fn.calls = 0
    t0 = time.perf_counter()
    runtime.build_library()
    build_s = time.perf_counter() - t0

    # 1. The inputs, from one seed.
    t0 = time.perf_counter()
    lists = make_line_lists(workdir, nlines=LL_NLINES,
                            nlines_small=LL_NLINES_SMALL,
                            nlines_vald=LL_NLINES_VALD, nstates=LL_NSTATES)
    cia_src = synthetic_cia_hitran(os.path.join(workdir, 'H2-H2.cia'))
    inputs_s = time.perf_counter() - t0
    emit('line_lists_inputs', seconds=inputs_s, runtime_build_seconds=build_s,
         files={fmt: {'file': os.path.basename(e['dbfile']),
                      'bytes': os.path.getsize(e['dbfile']),
                      'pflist': os.path.basename(e['pflist'])}
                for fmt, e in lists.items()})

    # 2. runmode = tli through the driver for each format, read back.
    tli_s = {}
    for fmt, entry in lists.items():
        t0 = time.perf_counter()
        summary = run(entry['tli_cfg'])
        tli_s[fmt] = time.perf_counter() - t0
        _, wn, gf, elow, iso = read_tli(entry['tlifile'])
        s0 = summary[0]
        same_iso = iso[1:] == iso[:-1]
        checks = {
            'read_back': len(wn) == int(s0['n_lines']) > 0,
            'finite': bool(np.all(np.isfinite(wn)) and np.all(np.isfinite(gf))
                           and np.all(np.isfinite(elow))),
            'sorted': bool(np.all(np.diff(wn)[same_iso] >= 0))
            and bool(np.all(np.diff(iso) >= 0)),
            'positive_gf': bool(np.all(gf > 0)),
        }
        emit('main_path_tli', format=fmt, seconds=tli_s[fmt],
             lines_per_s=len(wn) / tli_s[fmt], molecule=s0['molecule'],
             n_lines=int(s0['n_lines']),
             isotopes=[str(i) for i in s0['isotopes']],
             n_lines_iso=[int(n) for n in s0['n_lines_iso']],
             ntemp=int(s0['ntemp']),
             tli_bytes=os.path.getsize(entry['tlifile']), checks=checks)
        if not all(checks.values()):
            fail(f'line_lists {fmt}: {checks}')
    t0 = time.perf_counter()
    exomol = Exomol(lists['exomol']['dbfile'], lists['exomol']['pflist'])
    exomol_init_s = time.perf_counter() - t0

    # The native HITRAN parse against the numpy parse of the same bytes,
    # and the native range read against the numpy mask:
    with open(lists['hitran']['dbfile'], 'rb') as f:
        raw = f.read()
    recsize = raw.index(b'\n') + 1
    parse = {}
    for name, fn in (('native', runtime.parse_hitran_records),
                     ('native_1_thread', lambda r, n: runtime.
                      parse_hitran_records(r, n, 1)),
                     ('numpy', runtime.parse_hitran_records_plain)):
        t0 = time.perf_counter()
        parse[name] = (fn(raw, recsize), time.perf_counter() - t0)
    parse_equal = all(
        all(np.array_equal(a, b) for a, b in zip(parse[name][0],
                                                 parse['numpy'][0]))
        for name in ('native', 'native_1_thread'))
    _, wn, gf, elow, iso = read_tli(lists['hitran']['tlifile'])
    counts = np.unique(iso, return_counts=True)[1]
    ranged = {}
    for name, fn in (('native', runtime.tli_extract_range),
                     ('numpy', runtime.tli_extract_range_plain)):
        t0 = time.perf_counter()
        ranged[name] = (fn(wn, iso, elow, gf, counts, *LL_RANGE),
                        time.perf_counter() - t0)
    range_equal = all(np.array_equal(a, b) for a, b in zip(
        ranged['native'][0], ranged['numpy'][0]))
    mlines = len(raw) // recsize / 1e6
    emit('line_lists_native', card=card, hitran_lines=len(raw) // recsize,
         hitran_bytes=len(raw), threads=runtime.NTHREADS,
         parse_seconds={k: v[1] for k, v in parse.items()},
         parse_s_per_mlines={k: v[1] / mlines for k, v in parse.items()},
         parse_equal=parse_equal, range_cm1=list(LL_RANGE),
         range_lines=len(ranged['native'][0][0]),
         range_seconds={k: v[1] for k, v in ranged.items()},
         range_equal=range_equal, exomol_states=int(len(exomol.e_state)),
         exomol_reader_init_seconds=exomol_init_s,
         note='host CPU of the card\'s machine; numpy: the JAX package\'s '
              'numpy fallbacks, kept as the plain versions')
    if not (parse_equal and range_equal):
        fail(f'line_lists: native and numpy differ (parse {parse_equal}, '
             f'range {range_equal})')
    del raw, parse, ranged, wn, gf, elow, iso

    # 3. The ExoMol TLI into the direct table on the card (K4, K5).
    table_file = os.path.join(workdir, 'exomol_h2o_lbl.npz')
    opacity_cfg = write_opacity_cfg(
        os.path.join(workdir, 'exomol_opacity.cfg'),
        lists['exomol']['tlifile'], table_file)
    t0 = time.perf_counter()
    model = Model(opacity_cfg, device=dev)
    setup_s = time.perf_counter() - t0
    lbl = model.opacity_models[0][1]
    kernels = {key: getattr(lk, LBL[key]['fn'] + '_cuda')
               for key in ('wing_lines', 'core_lines')}
    plains = {key: getattr(lk, LBL[key]['fn'] + '_plain')
              for key in kernels}
    counters = (*kernels.values(), tk.transit_rt_cuda, ek.emission_rt_cuda)
    (call,), table_counts = counted_run(counters, lambda: record_calls(
        ((DirectLBL, '_cross_section_batch'),),
        lambda: model.compute_opacity(engine='direct')))
    table = model.cs_table
    direct = model.direct_lbl(lbl)
    t0 = time.perf_counter()
    model.compute_opacity(engine='direct')
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    ncells = table.shape[0] * table.shape[1]
    nblocks = -(-ncells // 64)
    _, species, _, _, _, read = pio.read_opacity(table_file)
    checks = {
        'shape': list(table.shape) == [10, NLAYERS, NWAVE],
        'finite': bool(np.all(np.isfinite(table))),
        'non_negative': bool(np.all(table >= 0)),
        'read_back': bool(np.array_equal(read, table)) and species == 'H2O',
        'launches': all(table_counts[fn.__name__] >= nblocks
                        for fn in kernels.values()),
    }
    # One main-path block: K4 and K5 against their plain versions, their
    # times (CUDA events around back-to-back launches) and bounds:
    _, tables, t_blk, d_blk, pf_blk = call[0]
    ops = lbl_operands(direct, (t_blk, d_blk, pf_blk), 1, windows=False)
    max_abs, block = {}, {}
    for key, (operands, kw) in ops.items():
        got = kernels[key](*operands, **kw)
        want = plains[key](*operands, **kw)
        torch.cuda.synchronize()
        rel, max_abs[key] = masked_rel(got, want)
        checks[f'{key}_vs_plain'] = rel < LBL_TOL
        run_kernel = lambda: kernels[key](*operands, **kw)
        # The plain versions take ~1 s a block at a million lines: timed
        # twice, after one warm-up call.
        plain_ms = float(np.median(cuda_times(
            lambda: plains[key](*operands, **kw), 2, warmup=1, inner=1)))
        bound = lbl_bound(key, operands, kw)
        block[LBL[key]['name']] = dict(
            max_rel_err=rel, max_abs_err=max_abs[key], tol=LBL_TOL,
            ms=float(np.median(cuda_times(run_kernel, 5))),
            plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
            lmax=int(kw['lmax']))
    del ops
    # Four cells on LL_CPU_POINTS wavenumbers against CPU float64:
    it, il = [0, 9], [0, NLAYERS - 1]
    i0 = (NWAVE - LL_CPU_POINTS) // 2
    cpu_model = Model(opacity_cfg, device='cpu')
    sub_wn = cpu_model.wn[i0:i0 + LL_CPU_POINTS]
    t0 = time.perf_counter()
    cpu = DirectLBL(cpu_model.opacity_models[0][1], wn=sub_wn,
                    device='cpu').tabulate(
        model.cs_temps[it], cpu_model.press[il], cpu_model.base_vmr[il])
    cpu_s = time.perf_counter() - t0
    gpu = table[it][:, il][..., i0:i0 + LL_CPU_POINTS]
    strong = np.abs(cpu) > 1e-4 * np.abs(cpu).max(axis=-1, keepdims=True)
    table_rel = float(np.max(np.abs(gpu - cpu)[strong] / np.abs(cpu[strong])))
    checks['gpu_vs_cpu'] = table_rel < LBL_TOL
    emit('line_lists_table', card=card, tli=os.path.basename(
        lists['exomol']['tlifile']), lines_on_grid=int(lbl.ntransitions),
         table_shape=list(table.shape), blocks=nblocks,
         seconds=table_s, setup_seconds=setup_s,
         points_per_s=table.size / table_s, launches=table_counts,
         block_64_cells=block, gpu_vs_cpu_max_rel_err=table_rel,
         gpu_vs_cpu_cells=[[float(model.cs_temps[t]), int(layer)]
                           for t in it for layer in il],
         gpu_vs_cpu_points=[int(i0), int(i0 + LL_CPU_POINTS)],
         cpu_seconds=cpu_s, tol=LBL_TOL, checks=checks)
    if not all(checks.values()):
        fail(f'line_lists table: {checks}')
    del model, direct, call, tables, t_blk, d_blk, pf_blk
    torch.cuda.empty_cache()

    # The parity engine on the ExoMol list (runmode = opacity in this
    # process: the native grouping and scatter over its lines), one
    # temperature on LL_PARITY_LAYERS layers and a 10 x 10 profile grid:
    parity_cfg = os.path.join(workdir, 'exomol_parity.cfg')
    with open(opacity_cfg) as f:
        text = f.read()
    text = text.replace(table_file, os.path.join(workdir, 'parity.npz'))
    text = text.replace(f'nlayers = {NLAYERS}',
                        f'nlayers = {LL_PARITY_LAYERS}')
    text = text.replace('tmin = 300\ntmax = 3000\ntstep = 300',
                        'tmin = 1500\ntmax = 1500\ntstep = 300')
    with open(parity_cfg, 'w') as f:
        f.write(text + 'ndop = 10\nnlor = 10\n')
    t0 = time.perf_counter()
    parity = run(parity_cfg, device='cpu').cs_table
    parity_s = time.perf_counter() - t0
    calls = {fn.__name__: fn.calls for fn in natives}
    checks = {'parity_finite': bool(np.all(np.isfinite(parity)))
              and parity.shape == (1, LL_PARITY_LAYERS, NWAVE)
              and bool(np.any(parity > 0)),
              'native_calls': all(n > 0 for n in calls.values())}
    emit('line_lists_parity', card=card, seconds=parity_s,
         layers=LL_PARITY_LAYERS, seconds_per_layer=parity_s
         / LL_PARITY_LAYERS, native_calls=calls, checks=checks)
    if not all(checks.values()):
        fail(f'line_lists parity engine: {checks}')

    # 4. The CLI's table tools in processes of their own, then a
    # spectrum on the card from the ExoMol table and the CLI's CIA.
    cli_dir = os.path.join(workdir, 'cli')
    os.makedirs(cli_dir)
    cli_s, written = {}, []
    for tool, cli_args in (('cs', ['-cs', 'hitran', cia_src]),
                           ('pf', ['-pf', 'tips', 'H2O'])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'pyratbay_tpu_torch', *cli_args],
            cwd=cli_dir, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=300)
        cli_s[tool] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f'line_lists: the CLI {cli_args} exited {proc.returncode}: '
                 f'{proc.stderr[-2000:]}')
        written += [line.split("'")[1] for line in proc.stdout.splitlines()
                    if line.startswith('Written')]
    cia_file = os.path.join(cli_dir, written[0])
    with open(os.path.join(cli_dir, written[1]), 'rb') as f, open(
            lists['exomol']['pflist'], 'rb') as g:
        pf_same = f.read() == g.read()
    make_flagship(workdir, device=dev)
    cfg = write_spectrum_cfg(workdir, 'exomol_spectrum', 'transit',
                             cia=(cia_file,), sampled=table_file)
    spec = {}
    t0 = time.perf_counter()
    _, spec_counts = counted_run(counters, lambda: spec.update(
        call=record_calls(((model_mod, 'transit_spectrum_ensemble'),),
                          lambda: spec.update(model=run(cfg)))[0]))
    spec_s = time.perf_counter() - t0
    model = spec['model']
    k2_abs, = check_kernel(
        ONE_CHAIN['name'], tk.transit_one_cuda, tk.transit_one_plain,
        {'B1_line_lists': spec['call']}, ONE_CHAIN['tol']).values()
    _, spectrum = pio.read_spectrum(
        os.path.join(workdir, 'exomol_spectrum.dat'))
    t0 = time.perf_counter()
    cpu = Model(cfg, device='cpu').run()['spectrum']
    cpu_s = time.perf_counter() - t0
    rel, absolute = rel_err(torch.as_tensor(model.spectrum)[None], cpu[None])
    checks = {
        'on_the_card': model.device.type == 'cuda',
        'launches': spec_counts['transit_rt_cuda'] == 0
        and spec_counts['transit_one_cuda'] == 1,
        'sources': {'line sampling', 'CIA H2-H2'} <= {
            m.name for _, m, _ in model.opacity_models},
        'finite': bool(np.all(np.isfinite(spectrum)))
        and spectrum.shape == (NWAVE,),
        'read_back': bool(np.allclose(spectrum, model.spectrum, rtol=1e-8,
                                      atol=0)),
        'cli_pf_file': pf_same,
        'gpu_vs_cpu': rel < FORWARD_TOL,
    }
    emit('line_lists_spectrum', card=card, seconds=spec_s, cpu_seconds=cpu_s,
         cli_seconds=cli_s, cli_files=written, launches=spec_counts,
         gpu_vs_cpu_max_rel_err=rel, gpu_vs_cpu_max_abs_err=absolute,
         tol=FORWARD_TOL, opacity_models=[m.name for _, m, _ in
                                          model.opacity_models],
         checks=checks)
    if not all(checks.values()):
        fail(f'line_lists spectrum: {checks}')
    phase_s = time.perf_counter() - phase_t0
    emit('times_line_lists', card=card, tli_seconds=tli_s,
         table_seconds=table_s, parity_seconds=parity_s,
         spectrum_seconds=spec_s, phase_seconds=phase_s,
         budget_seconds=LL_BUDGET_S)
    launches = {'wing_sigma_lines_cuda': table_counts['wing_sigma_lines_cuda'],
                'core_sigma_lines_cuda': table_counts['core_sigma_lines_cuda'],
                'transit_one_cuda': spec_counts['transit_one_cuda']}
    return launches, {ONE_CHAIN['name']: k2_abs,
                      LBL['wing_lines']['name']: max_abs['wing_lines'],
                      LBL['core_lines']['name']: max_abs['core_lines']}


# The parallel phase (run_parallel): the wave-sharded flagship on
# several processes sharing the card.  Each mesh's ranks are new
# interpreters running parallel_rank(); the library is built before they
# start, so they load it and build nothing.  PAR_GENS generations time
# the DEMC step, PAR_TIMED_GENS more under torch.profiler the device
# time and the collectives (the device marks of their pbt.mesh.all_sum
# spans); the TLI forwards take PAR_TLI_CHAINS chains; the nested
# run on (2, 1) is cut to PAR_NESTED_MAX_ITER dead points (the nested
# phase's 4,000 cut again, for the phase's ~90 s).
PARALLEL_MESHES = (
    # name, ranks, chain shards, tasks
    ('world1', 1, 1, ('transit',)),
    ('wave2', 2, 1, ('transit', 'eclipse', 'tli')),
    ('chains2', 2, 2, ('transit', 'nested')),
)
PAR_GENS = 20
PAR_TIMED_GENS = 3
PAR_TLI_CHAINS = 64
PAR_TLI_FORWARDS = 3
PAR_NESTED_MAX_ITER = 1000
PAR_TIMEOUT = 300.0
PAR_PROBE_ITERS = 20


def _rank_flagship(state, mesh, workdir, rt_path):
    """One rank's part of the main path on the flagship of `rt_path`
    (51 x 3209, NCHAINS chains, wave-sharded over the mesh): the
    ensemble's initial log-posterior and PAR_GENS DEMC generations
    between zeroed launch counters, then PAR_TIMED_GENS under
    torch.profiler (this rank's device time, and its collectives' from
    the device marks of their pbt.mesh.all_sum spans), then the RT kernel against its plain version on
    the rank's own operands (its chains, its window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from pyratbay_tpu_torch import model as model_mod
    from pyratbay_tpu_torch import tracing
    from pyratbay_tpu_torch.parallel.sharded import build_flagship_sharded
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    from pyratbay_tpu_torch.spectrum import emission_kernel as ek
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    model, obs, ret, log_post, step, chains = build_flagship_sharded(
        mesh, os.path.join(workdir, rt_path), nchains=NCHAINS,
        rt_path=rt_path)
    state[rt_path] = (model, obs, ret, log_post)
    syncs = mesh.host_syncs

    def main_path():
        logp0 = step.log_post(chains)
        c, lp = chains, logp0
        torch.cuda.synchronize()
        torch.distributed.barrier()     # the ranks' clocks start together
        t0 = time.perf_counter()
        for _ in range(PAR_GENS):
            c, lp = step(c, lp)
        torch.cuda.synchronize()
        return logp0, c, lp, time.perf_counter() - t0

    with torch.no_grad():
        (logp0, c, lp, gen_s), launches = counted_run(
            (tk.transit_rt_cuda, ek.emission_rt_cuda), main_path)
        host_syncs = mesh.host_syncs - syncs
        # This rank's device time a generation (torch.profiler sees its
        # own process's kernels and copies), and its collectives' (the
        # spans record while the profiler runs):
        recorded = len(tracing.RECORDER.spans)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(PAR_TIMED_GENS):
                c, lp = step(c, lp)
            torch.cuda.synchronize()
        busy_ms = sum(evt.device_time_total for evt in prof.key_averages()
                      if evt.device_type != DeviceType.CPU) \
            / PAR_TIMED_GENS * 1e-3
        tracing.resolve()
        collective_ms = sum(
            s.d1 - s.d0 for s in tracing.RECORDER.spans[recorded:]
            if s.name == 'pbt.mesh.all_sum') / PAR_TIMED_GENS * 1e-6
        # The kernel on the operands of the rank's forward of its chains:
        label = 'transit' if rt_path == 'transit' else 'eclipse'
        wrapper = ('transit_spectrum_ensemble' if label == 'transit'
                   else 'emission_flux_ensemble')
        per = NCHAINS // mesh.shape['chains']
        mine = chains[mesh.coords['chains'] * per:][:per]
        call, = record_calls([(model_mod, wrapper)],
                             lambda: build_forward_batched(
                                 model, obs, ret)(mine))
        kernel, plain = ((tk.transit_rt_cuda, tk.transit_rt_plain)
                         if label == 'transit' else
                         (ek.emission_rt_cuda, ek.emission_rt_plain))
        name = KERNELS[label]['name']
        max_abs = check_kernel(name, kernel, plain, {
            f'parallel_{rt_path}_rank{torch.distributed.get_rank()}':
                wrapper_case(label, model, call)}, KERNELS[label]['tol'])
    return dict(
        logp0=logp0.double().cpu().tolist(),
        chains_moved=float(torch.mean((lp != logp0).double())),
        generations_per_s=PAR_GENS / gen_s,
        collective_ms_per_generation=collective_ms,
        device_busy_ms_per_generation=busy_ms,
        host_syncs_per_generation=host_syncs / (PAR_GENS + 1),
        launches=launches, kernel=name, max_abs_err=max(max_abs.values()),
        nwave_local=model.nwave, chains_local=per)


def _rank_tli(state, mesh, workdir):
    """PAR_TLI_FORWARDS wave-sharded forwards of the flagship with H2O
    from the TLI file (K4 and K5 on the rank's window with the whole line
    list, then K1), the gathered spectrum written for the parent, and K4
    and K5 against their plain versions on a block of the rank's
    forward."""
    import torch
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.opacity import lbl_kernel as lk
    from pyratbay_tpu_torch.opacity.lbl_direct import DirectLBL
    from pyratbay_tpu_torch.parallel.sharded import (
        gather_wave, shard_model_tables)
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    tli_dir = os.environ['PBT_SMOKE_TLI']
    model = Model(os.path.join(tli_dir, 'flagship_lbl.cfg'))
    _, obs, _, _ = state['transit']
    obs = Observation(obs_cfg(obs), model.wn)
    ret = RetrievalParams(model, obs)
    pb = torch.as_tensor(np.load(os.path.join(tli_dir, 'params.npy')),
                         dtype=model.dtype, device=model.device)
    shard_model_tables(model, obs, mesh)
    forward_b = build_forward_batched(model, obs, ret)
    blocks = []
    real_batch = DirectLBL._cross_section_batch

    def first_block(self, tables, *cells):
        if not blocks:
            blocks.append(cells)
        return real_batch(self, tables, *cells)

    def forwards():
        for _ in range(PAR_TLI_FORWARDS):
            out = forward_b(pb)
        return out

    DirectLBL._cross_section_batch = first_block
    try:
        with torch.no_grad():
            out, launches = counted_run(
                (lk.wing_sigma_lines_cuda, lk.core_sigma_lines_cuda,
                 tk.transit_rt_cuda), forwards)
            spectrum = gather_wave(out['spectrum'], mesh)
    finally:
        DirectLBL._cross_section_batch = real_batch
    if torch.distributed.get_rank() == 0:
        np.save(os.path.join(workdir, 'tli_spectrum.npy'),
                spectrum[:, :model.nwave_unpadded].double().cpu().numpy())
    direct = model.direct_lbl(model.opacity_models[0][1])
    max_abs = {}
    for key, (operands, kw) in lbl_operands(
            direct, blocks[0], 1, windows=False).items():
        got = getattr(lk, LBL[key]['fn'] + '_cuda')(*operands, **kw)
        want = getattr(lk, LBL[key]['fn'] + '_plain')(*operands, **kw)
        torch.cuda.synchronize()
        rel, max_abs[LBL[key]['name']] = masked_rel(got, want)
        emit('kernel_check', kernel=LBL[key]['name'],
             case=f'parallel_tli_rank{torch.distributed.get_rank()}',
             shape=list(got.shape), max_rel_err=rel,
             max_abs_err=max_abs[LBL[key]['name']], tol=LBL_TOL)
        if not rel < LBL_TOL:
            fail(f'{LBL[key]["name"]} parallel tli: kernel disagrees with '
                 f'plain ({rel})')
    return dict(launches=launches, max_abs_err=max_abs,
                nwave_local=model.nwave, cells_block=int(
                    blocks[0][0].shape[0]))


def _rank_nested(state, mesh, workdir):
    """sample_nested with the mesh on the transit flagship's sharded
    log-posterior (nlive 400, 25 walk steps, PAR_NESTED_MAX_ITER dead
    points): every walk step's batch split over the chain shards."""
    import torch
    from pyratbay_tpu_torch.retrieval.driver import unit_cube_prior
    from pyratbay_tpu_torch.retrieval.nested import sample_nested
    from pyratbay_tpu_torch.spectrum import transit_kernel as tk
    model, _, ret, log_post = state['transit']
    syncs = mesh.host_syncs
    gen = torch.Generator(device=model.device).manual_seed(0)

    def run():
        torch.distributed.barrier()
        t0 = time.perf_counter()
        out = sample_nested(
            log_post, unit_cube_prior(ret, model.device), len(ret.ifree),
            nlive=NESTED_NLIVE, max_iter=PAR_NESTED_MAX_ITER,
            nsteps_walk=NESTED_WALK, generator=gen, device=model.device,
            mesh=mesh)
        return out, time.perf_counter() - t0

    with torch.no_grad():
        (out, seconds), launches = counted_run((tk.transit_rt_cuda,), run)
    batch = NESTED_NLIVE // 16
    batch -= batch % mesh.shape['chains']
    walks = -(-PAR_NESTED_MAX_ITER // batch) * NESTED_WALK
    return dict(logz=float(out['logz']), logz_err=float(out['logz_err']),
                n_iter=int(out['n_iter']), seconds=seconds, batch=batch,
                walk_forwards_per_s=walks / seconds,
                host_syncs=mesh.host_syncs - syncs, walk_steps=walks,
                finite=bool(np.all(np.isfinite(out['posterior']))),
                in_prior_box=bool(np.all(
                    (out['posterior'] >= ret.pmin)
                    & (out['posterior'] <= ret.pmax))),
                launches=launches)


def parallel_rank():
    """One rank of a run_parallel group: joins the group (PBT_* variables
    from the parent), lays the mesh (PBT_CHAINS_AXIS chain shards), runs
    PBT_SMOKE_TASKS in PBT_SMOKE_DIR (the TLI inputs in PBT_SMOKE_TLI) and
    writes rank<r>.json there."""
    import torch
    from pyratbay_tpu_torch.parallel import distributed
    from pyratbay_tpu_torch.parallel.sharded import make_mesh
    distributed.initialize_distributed()
    mesh = make_mesh(int(os.environ['PBT_CHAINS_AXIS']))
    rank = distributed.process_index()
    workdir = os.environ['PBT_SMOKE_DIR']
    out = dict(rank=rank, backend=mesh.backend,
               mesh=[mesh.shape['chains'], mesh.shape['wave']],
               coords=[mesh.coords['chains'], mesh.coords['wave']],
               device=str(torch.device('cuda', torch.cuda.current_device())))
    state = {}
    tasks = {'transit': lambda: _rank_flagship(state, mesh, rank_dir,
                                               'transit'),
             'eclipse': lambda: _rank_flagship(state, mesh, rank_dir,
                                               'eclipse'),
             'tli': lambda: _rank_tli(state, mesh, rank_dir),
             'nested': lambda: _rank_nested(state, mesh, rank_dir)}
    rank_dir = os.path.join(workdir, f'rank{rank}')
    for task in os.environ['PBT_SMOKE_TASKS'].split(','):
        out[task] = tasks[task]()
    out['collectives'] = mesh.calls
    with open(os.path.join(workdir, f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def run_parallel(workdir, dev, args, card):
    """The parallel phase: the wave-sharded flagship retrieval (51 x 3209,
    512 chains) on process groups on the one card, every rank a new
    interpreter (parallel_rank): a world-1 group (mesh (1, 1), NCCL), two
    ranks sharing the card on (1, 2) (gloo: half the columns each; the
    eclipse flagship and TLI forwards too) and on (2, 1) (256 chains each;
    the nested sampler with the mesh), then mp_probe.  Checks: every rank
    exits 0 within PAR_TIMEOUT; the backend by the rule; each rank's K1
    / K3 / K4 / K5 launches on its main path and against the plain
    versions on its own operands (check_kernel fails the rank); the
    gathered log-posterior of the initial ensemble within the GPU-against-
    CPU bound (FORWARD_TOL) of the unsharded one, computed here without a
    group; the gathered TLI spectrum against the unsharded forward's within
    LBL_TOL; the nested run finite and in the prior box.  Returns the
    launches of each kernel by counter and each kernel's largest
    difference from its plain version."""
    import torch
    from pyratbay_tpu_torch.benchmark import make_lbl_flagship
    from pyratbay_tpu_torch.driver import run
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.parallel.mp_probe import free_port, run_group
    from pyratbay_tpu_torch.parallel.sharded import (
        build_flagship_sharded, make_mesh)
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams

    phase_t0 = time.perf_counter()
    # The unsharded references (no group in this process: a (1, 1) mesh
    # without collectives):
    refs = {}
    for rt_path in ('transit', 'eclipse'):
        model, obs, ret, _, step, chains = build_flagship_sharded(
            make_mesh(device=dev), os.path.join(workdir, 'ref', rt_path),
            device=dev, nchains=NCHAINS, rt_path=rt_path)
        with torch.no_grad():
            lp = step.log_post(chains).double().cpu().numpy()
            band = build_forward_batched(model, obs, ret)(chains)[
                'bandflux'].double().cpu().numpy()
        fin = np.isfinite(lp)
        bound = np.full(len(lp), np.inf)
        bound[fin] = _lp_bound(lp[fin], band[fin], obs.uncert, FORWARD_TOL)
        refs[rt_path] = (lp, bound)
        if rt_path == 'transit':
            flag_obs = obs
    # The TLI inputs, and the unsharded forward at PAR_TLI_CHAINS chains:
    tli_dir = os.path.join(workdir, 'tli')
    _, tli_cfg, _ = make_lbl_flagship(tli_dir, nlines=NLINES)
    run(tli_cfg)
    with open(os.path.join(workdir, 'ref', 'transit', 'flagship.cfg')) as f:
        text = f.read()
    lbl_cfg = os.path.join(tli_dir, 'flagship_lbl.cfg')
    with open(lbl_cfg, 'w') as f:
        f.write('\n'.join(
            f'tlifile = {os.path.join(tli_dir, "flagship_h2o.tli")}'
            if ln.startswith('sampled_cross_sec') else ln
            for ln in text.splitlines()) + '\n')
    tli_model = Model(lbl_cfg, device=dev)
    tli_obs = Observation(obs_cfg(flag_obs), tli_model.wn)
    tli_ret = RetrievalParams(tli_model, tli_obs)
    rng = np.random.default_rng(0)
    pb = np.clip(tli_ret.params + tli_ret.pstep * rng.standard_normal(
        (PAR_TLI_CHAINS, len(tli_ret.params))), tli_ret.pmin, tli_ret.pmax)
    np.save(os.path.join(tli_dir, 'params.npy'), pb)
    with torch.no_grad():
        tli_ref = build_forward_batched(tli_model, tli_obs, tli_ret)(
            torch.as_tensor(pb, dtype=tli_model.dtype, device=dev))[
            'spectrum']
    del tli_model, model, obs, step
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - phase_t0

    launches, max_abs = {}, {}

    def add(counts, err=None):
        for key, val in counts.items():
            launches[key] = launches.get(key, 0) + val
        for key, val in (err or {}).items():
            max_abs[key] = max(max_abs.get(key, 0.0), val)

    for name, nranks, chains_axis, tasks in PARALLEL_MESHES:
        group_dir = os.path.join(workdir, name)
        os.makedirs(group_dir)
        env = dict(os.environ, PBT_COORDINATOR=f'localhost:{free_port()}',
                   PBT_NPROCS=str(nranks), PBT_CHAINS_AXIS=str(chains_axis),
                   PBT_SMOKE_DIR=group_dir, PBT_SMOKE_TASKS=','.join(tasks),
                   PBT_SMOKE_TLI=tli_dir)
        cmd = [sys.executable, '-c', 'import sys, chip_smoke; '
               'sys.exit(chip_smoke.parallel_rank())']
        t0 = time.perf_counter()
        ranks = run_group([(cmd, dict(env, PBT_PROCID=str(r)))
                           for r in range(nranks)], PAR_TIMEOUT, cwd=HERE)
        group_s = time.perf_counter() - t0
        for r, (code, out, err) in enumerate(ranks):
            sys.stdout.write(out)
            if code != 0:
                fail(f'parallel {name}: rank {r} exit {code} after '
                     f'{group_s:.1f} s:\n{err[-3000:]}')
        results = []
        for r in range(nranks):
            with open(os.path.join(group_dir, f'rank{r}.json')) as f:
                results.append(json.load(f))
        want_backend = 'nccl' if nranks <= torch.cuda.device_count() \
            else 'gloo'
        checks = {'backend': all(res['backend'] == want_backend
                                 for res in results),
                  'mesh': all(res['mesh'] == [chains_axis,
                                              nranks // chains_axis]
                              for res in results)}

        def check(key, ok):
            checks[key] = checks.get(key, True) and bool(ok)

        per_rank = []
        for res in results:
            entry = dict(rank=res['rank'], coords=res['coords'],
                         device=res['device'],
                         collectives=res['collectives'])
            for rt_path in ('transit', 'eclipse'):
                if rt_path not in res:
                    continue
                task = res[rt_path]
                lp, bound = refs[rt_path]
                diff = np.abs(np.asarray(task['logp0']) - lp)
                same_inf = np.array_equal(np.isfinite(task['logp0']),
                                          np.isfinite(lp))
                check(f'{rt_path}_log_posterior', same_inf and np.all(
                    diff[np.isfinite(lp)] <= bound[np.isfinite(lp)]))
                kernel = task['launches'][
                    'transit_rt_cuda' if rt_path == 'transit'
                    else 'emission_rt_cuda']
                check(f'{rt_path}_kernel_every_generation',
                      kernel >= PAR_GENS + 1)
                add(task['launches'], {task['kernel']: task['max_abs_err']})
                entry[rt_path] = dict(
                    {k: task[k] for k in task if k != 'logp0'},
                    log_posterior_max_abs_diff=float(np.max(
                        diff[np.isfinite(lp)])),
                    log_posterior_bound_min=float(np.min(bound)))
            if 'tli' in res:
                task = res['tli']
                check('tli_k4_k5', all(
                    task['launches'][k] >= PAR_TLI_FORWARDS for k in (
                        'wing_sigma_lines_cuda', 'core_sigma_lines_cuda')))
                add(task['launches'], task['max_abs_err'])
                entry['tli'] = task
            if 'nested' in res:
                task = res['nested']
                check('nested', task['finite'] and task['in_prior_box']
                      and np.isfinite(task['logz']))
                add(task['launches'])
                entry['nested'] = task
            per_rank.append(entry)
        # Each card's idle share during a generation: the device time of
        # the ranks on it against the generation's time (rank 0's host
        # clock):
        for rt_path in ('transit', 'eclipse'):
            if rt_path in results[0]:
                ms = 1e3 / results[0][rt_path]['generations_per_s']
                busy = {}
                for res in results:
                    busy[res['device']] = busy.get(res['device'], 0.0) \
                        + res[rt_path]['device_busy_ms_per_generation']
                per_rank[0][rt_path]['card_idle_share'] = {
                    card: 1.0 - ms_busy / ms
                    for card, ms_busy in busy.items()}
        if 'tli' in tasks:
            got = np.load(os.path.join(group_dir, 'rank0',
                                       'tli_spectrum.npy'))
            rel, _ = rel_err(torch.as_tensor(got), tli_ref)
            check('tli_spectrum', rel < LBL_TOL)
            per_rank[0]['tli']['spectrum_max_rel_err_vs_unsharded'] = rel
        emit('parallel', mesh=name, card=card, ranks=nranks,
             shape=results[0]['mesh'], backend=results[0]['backend'],
             seconds=group_s, per_rank=per_rank, checks=checks)
        if not all(checks.values()):
            fail(f'parallel {name}: {checks}')

    # The multi-process probe (two ranks on the card, the JAX probe's
    # flagship size):
    t0 = time.perf_counter()
    (code, out, err), = run_group([(
        [sys.executable, '-m', 'pyratbay_tpu_torch.parallel.mp_probe',
         '--nprocs', '2', '--iters', str(PAR_PROBE_ITERS), '--timeout',
         str(PAR_TIMEOUT)], dict(os.environ))], PAR_TIMEOUT + 30, cwd=HERE)
    if code != 0:
        fail(f'mp_probe exit {code}: {out[-2000:]} {err[-2000:]}')
    probe = json.loads(out.strip().splitlines()[-1])
    emit('mp_probe', card=card, seconds=time.perf_counter() - t0, **probe)
    want_backend = 'nccl' if 2 <= torch.cuda.device_count() else 'gloo'
    if probe.get('backend') != want_backend or probe.get('device_name') \
            != torch.cuda.get_device_name(0):
        fail(f'mp_probe: {probe}')
    emit('phase_seconds', name='parallel', setup_seconds=setup_s,
         seconds=time.perf_counter() - phase_t0)
    return launches, max_abs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--profile', action='store_true',
                        help='also print torch.profiler kernel breakdowns')
    parser.add_argument('--seed', type=int, default=1,
                        help='seed of the hires_eclipse phase\'s noise')
    parser.add_argument('--nested-max-iter', type=int,
                        default=NESTED_MAX_ITER,
                        help='dead points of the nested phase\'s run (0: '
                             'the sampler\'s default, 50 nlive)')
    args = parser.parse_args()
    script_t0 = time.perf_counter()
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

    from pyratbay_tpu_torch.atmosphere import chem
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
        kernels = []    # K1, K2, K3, K1's tall function, then K4, K5, K6
        kept = {}       # the transit retrieval's Model, for model_io
        for label, rt_path, nlayers, resolution in (
                ('transit', 'transit', NLAYERS, None),
                ('eclipse', 'eclipse', NLAYERS, None),
                ('transit_81', 'transit', TALL_LAYERS, None),
                ('transit_r115k', 'transit', NLAYERS, R115K)):
            path_dir = os.path.join(workdir, label)
            os.makedirs(path_dir)
            for entry in run_path(label, rt_path, path_dir, dev, args, card,
                                  nlayers,
                                  keep=kept if label == 'transit' else None,
                                  resolution=resolution):
                if not entry.pop('partial', False):
                    kernels.append(entry)
                    continue
                # K1's and K2's launches, checks and figures on another
                # path:
                whole = next(k for k in kernels if k['name'] == entry['name'])
                whole['launches'] += entry.pop('launches')
                whole['launches_by_path'].update(
                    entry.pop('launches_by_path'))
                whole['max_abs_err'] = max(whole['max_abs_err'],
                                           entry.pop('max_abs_err'))
                entry.pop('name')
                whole.update(entry)
            if resolution is not None:
                shutil.rmtree(path_dir, ignore_errors=True)
        path_dir = os.path.join(workdir, 'spectrum')
        os.makedirs(path_dir)
        spectrum_launches, tall, spectrum_models = run_spectrum(
            path_dir, dev, args, card)
        # Each kernel's launches on each path that runs it (K1's counter
        # also counts its tall function's):
        spectrum_launches['transit_rt'] -= spectrum_launches['transit_rt_tall']
        for entry in kernels:
            more = spectrum_launches[entry['name']]
            entry['launches_by_path']['spectrum'] = more
            entry['launches'] += more
        kernels[3]['max_abs_err'] = max(kernels[3]['max_abs_err'],
                                        tall['max_abs_err'])
        kernels[3]['spectrum_operands'] = tall['spectrum_operands']
        kernels[1]['max_abs_err'] = max(kernels[1]['max_abs_err'],
                                        tall['one_max_abs_err'])
        kernels[1]['streamed_launches'] = \
            spectrum_launches['transit_one_streamed']
        # Model files: the transit retrieval's Model and the eclipse
        # spectrum's saved, reopened on the card and run (K2,
        # K3):
        path_dir = os.path.join(workdir, 'model_io')
        os.makedirs(path_dir)
        t0 = time.perf_counter()
        io_launches, io_abs = run_model_io(
            path_dir, dev, args, card, kept.pop('model'),
            spectrum_models.pop('eclipse'))
        del spectrum_models
        emit('phase_seconds', name='model_io',
             seconds=time.perf_counter() - t0)
        for entry, counter in ((kernels[0], 'transit_rt_cuda'),
                               (kernels[1], 'transit_one_cuda'),
                               (kernels[2], 'emission_rt_cuda')):
            entry['launches_by_path']['model_io'] = io_launches[counter]
            entry['launches'] += io_launches[counter]
            if entry['name'] in io_abs:
                entry['max_abs_err'] = max(entry['max_abs_err'],
                                           io_abs[entry['name']])
        # The retrieval as users run it (filter files, the bundled
        # passbands, checkpoints and resume, the post-processing):
        post_launches, envelope_abs = run_retrieval_post(
            workdir, dev, args, card)
        for entry in kernels[:3]:
            more = post_launches[entry['name']]
            entry['launches_by_path']['retrieval_post'] = more
            entry['launches'] += more
        kernels[0]['max_abs_err'] = max(kernels[0]['max_abs_err'],
                                        envelope_abs)
        path_dir = os.path.join(workdir, 'opacity')
        os.makedirs(path_dir)
        kernels += run_opacity(path_dir, dev, args, card)
        # The high-resolution eclipse retrieval with a stellar-model star
        # (K4 and K5 for its table, K3 for its forwards):
        path_dir = os.path.join(workdir, 'hires_eclipse')
        os.makedirs(path_dir)
        hires_launches, hires_k3_abs = run_hires_eclipse(
            path_dir, dev, args, card)
        for entry in kernels:
            more = hires_launches.get(entry['name'])
            if more is None:
                continue
            entry.setdefault('launches_by_path',
                             {'opacity': entry['launches']})
            entry['launches_by_path']['hires_eclipse'] = more
            entry['launches'] += more
        kernels[2]['max_abs_err'] = max(kernels[2]['max_abs_err'],
                                        hires_k3_abs)
        # Thermochemical equilibrium in the retrieval (K1 at B = 512 and
        # B = 1, K3 at B = 512 and B = 1):
        path_dir = os.path.join(workdir, 'equilibrium')
        os.makedirs(path_dir)
        t0 = time.perf_counter()
        eq_launches, eq_abs, solve_entry = run_equilibrium(
            path_dir, dev, args, card)
        emit('phase_seconds', name='equilibrium',
             seconds=time.perf_counter() - t0)
        for entry in kernels:
            more = eq_launches.get(entry['name'])
            if more is None:
                continue
            entry.setdefault('launches_by_path', {})['equilibrium'] = more
            entry['launches'] += more
            entry['max_abs_err'] = max(entry['max_abs_err'],
                                       eq_abs[entry['name']])
        kernels.append(dict(
            name=CHEM['name'], source=CHEM['source'],
            replaces=CHEM['replaces'], launches=eq_launches[CHEM['name']],
            launches_by_path={'equilibrium': eq_launches[CHEM['name']]},
            max_abs_err=eq_abs[CHEM['name']], **solve_entry))
        # Radiative equilibrium of a two-stream model (no kernel of its
        # own; the solve kernel where the model has the network):
        path_dir = os.path.join(workdir, 'radeq')
        os.makedirs(path_dir)
        t0 = time.perf_counter()
        chem.equilibrium_cuda.launches = 0
        run_radeq(path_dir, dev, args, card)
        kernels[-1]['launches_by_path']['radeq'] = \
            chem.equilibrium_cuda.launches
        kernels[-1]['launches'] += chem.equilibrium_cuda.launches
        emit('phase_seconds', name='radeq', seconds=time.perf_counter() - t0)
        # Nested sampling (K1 at B = 400, at the walks' B = 25 and at
        # B = 1) and a retrieval of a TLI model (K4 and K5 on every
        # forward, then K1):
        by_name = {entry['name']: entry for entry in kernels}
        counter_of = {'transit_rt': 'transit_rt_cuda',
                      ONE_CHAIN['name']: 'transit_one_cuda',
                      'emission_rt': 'emission_rt_cuda',
                      LBL['wing_lines']['name']: 'wing_sigma_lines_cuda',
                      LBL['core_lines']['name']: 'core_sigma_lines_cuda'}

        def add_launches(path, counts):
            for name, counter in counter_of.items():
                if counts.get(counter):
                    entry = by_name[name]
                    entry.setdefault('launches_by_path', {})[path] = \
                        counts[counter]
                    entry['launches'] += counts[counter]

        path_dir = os.path.join(workdir, 'nested')
        os.makedirs(path_dir)
        t0 = time.perf_counter()
        nested_launches, nested_abs = run_nested(path_dir, dev, args, card)
        emit('phase_seconds', name='nested', seconds=time.perf_counter() - t0)
        add_launches('nested', nested_launches)
        by_name['transit_rt']['max_abs_err'] = max(
            by_name['transit_rt']['max_abs_err'], nested_abs)
        path_dir = os.path.join(workdir, 'lbl_retrieval')
        os.makedirs(path_dir)
        t0 = time.perf_counter()
        lbl_launches, lbl_block, lbl_abs = run_lbl_retrieval(
            path_dir, dev, args, card)
        emit('phase_seconds', name='lbl_retrieval',
             seconds=time.perf_counter() - t0)
        add_launches('lbl_retrieval', lbl_launches)
        for name, times in lbl_block.items():
            by_name[name]['retrieval_block'] = times
            by_name[name]['max_abs_err'] = max(by_name[name]['max_abs_err'],
                                               lbl_abs[name])
        # Line lists as users have them (K4 and K5 for a table from an
        # ExoMol list, K2 for a spectrum from it):
        path_dir = os.path.join(workdir, 'line_lists')
        os.makedirs(path_dir)
        t0 = time.perf_counter()
        ll_launches, ll_abs = run_line_lists(path_dir, dev, args, card)
        emit('phase_seconds', name='line_lists',
             seconds=time.perf_counter() - t0)
        add_launches('line_lists', ll_launches)
        for name, err in ll_abs.items():
            by_name[name]['max_abs_err'] = max(by_name[name]['max_abs_err'],
                                               err)
        # Several processes on the card: the wave-sharded flagship on
        # (1, 1), (1, 2) and (2, 1) meshes (K1, K3, K4 and K5 on the ranks'
        # windows), the nested sampler with the mesh, mp_probe:
        path_dir = os.path.join(workdir, 'parallel')
        os.makedirs(path_dir)
        par_launches, par_abs = run_parallel(path_dir, dev, args, card)
        add_launches('parallel', par_launches)
        for name, err in par_abs.items():
            by_name[name]['max_abs_err'] = max(by_name[name]['max_abs_err'],
                                               err)
        emit('phase_seconds', name='all', seconds=time.perf_counter()
             - script_t0)
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
    """Device-time breakdown of one call forward_b(pb_t) (torch.profiler):
    the device kernels by self time, their launches, and the device's
    busy share of the call's time `ms_forward` (CUDA events for a
    B = 512 forward; the host clock around a compute_opacity or a
    tabulation block, ending in a synchronize).  Returns the fields it
    prints."""
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
    fields = dict(
        device_busy_us=busy_us,
        device_kernels=sum(calls for _, _, calls in rows),
        forward_us=ms_forward * 1e3,
        device_idle_share=1.0 - busy_us / (ms_forward * 1e3),
        per_forward_device_us=[
            {'name': name[:80], 'us': us, 'calls': calls}
            for us, name, calls in rows[:15]])
    emit('profile', path=label, **fields)
    return fields


if __name__ == '__main__':
    main()
