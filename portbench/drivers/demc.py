"""DEMC traffic on one card: snooker-DEMC generations of the whole
ensemble through pyratbay_tpu_torch's sample_demc, in chunks of
`chunk_gens` generations that carry the chains and the generator on.

Set-up builds the model, the observation and the batched log-posterior,
draws the initial ensemble from the true parameters and runs one chunk
(every shape of the window); setup_s leaves out the seconds of the
observation, which the reference makes.  The window runs chunks until `seconds`
have passed; demc_gen_per_s is the generations completed over the
window's seconds, each chunk's initial forward and history copy to the
host included.  With a trace, a spans phase times the log-posterior
calls, then one chunk runs under torch.profiler.  Then the reference
recomputes the log-posterior of the final chains.
"""
import sys
import time

import numpy as np

from portbench import checks, counts, harness, trace as tr

# A span phase of this many seconds follows the window in a traced run:
SPAN_SECONDS = 3.0


def run(work, config, mix, seed, seconds, trace, t0, device=None):
    import torch
    from pyratbay_tpu_torch.retrieval.batched import (
        build_log_posterior_batched)
    from pyratbay_tpu_torch.retrieval.samplers import sample_demc

    fm = harness.family(config)
    stages = {'imports': time.perf_counter() - t0}
    paths = fm.prepare(config, harness.ROOT)
    stages['inputs'] = time.perf_counter() - t0
    # The observation is the reference's work: its seconds are left out
    # of setup_s.
    observed = fm.Observed(config, paths, harness.seed_int(seed, 1))
    reference_s = time.perf_counter() - t0 - stages['inputs']
    stages['observation_s'] = reference_s
    model, obs, ret = fm.build(config, paths, observed, device)
    stages['model'] = time.perf_counter() - t0
    dev = model.device
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    log_post = build_log_posterior_batched(model, obs, ret)
    nchains, chunk = mix['nchains'], mix['chunk_gens']
    generator = torch.Generator(device=dev).manual_seed(
        harness.seed_int(seed, 2))
    kw = dict(nsamples=nchains * chunk, generator=generator,
              chunk_gens=chunk, pstep=ret.pstep, pmin=ret.pmin,
              pmax=ret.pmax, dtype=model.dtype, device=dev)

    def chunk_run(chains, fn=log_post):
        res = sample_demc(fn, chains, **kw)
        return res['chains'], res['log_post'][-nchains:]

    with torch.no_grad():
        res = sample_demc(log_post, ret.params, nchains=nchains, **kw)
        chains = res['chains']
        sync()
        stages['warm_up'] = time.perf_counter() - t0
        setup_s = stages['warm_up'] - reference_s
        print(f'setup_stages {stages!r}', file=sys.stderr)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        start = chains.cpu().numpy()
        gens = forwards = 0
        t_start = time.perf_counter()
        marks = [t_start]
        while True:
            chains, logp = chunk_run(chains)
            gens += chunk
            forwards += chunk + 1
            marks.append(time.perf_counter())
            window_s = marks[-1] - t_start
            if window_s >= seconds:
                break
        print('chunk_ms ' + ' '.join(
            f'{1e3 * v:.1f}' for v in np.diff(marks)), file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        final = chains.cpu().numpy()

        ctx = {'config': config, 'mix': mix, 'chips': work['chips'],
               'shape': counts.shape_of(config, model.nwave, nchains),
               'window': {'seconds': window_s, 'generations': gens,
                          'forwards': forwards}}
        if trace:
            spans = tr.Spans(log_post, dev)
            span_chains, span_gens = final, 0
            t_span = time.perf_counter()
            while time.perf_counter() - t_span < SPAN_SECONDS:
                span_chains, _ = chunk_run(torch.as_tensor(
                    span_chains, device=dev), spans)
                span_chains = span_chains.cpu().numpy()
                span_gens += chunk
            ctx['sampler'] = {'wall_s': time.perf_counter() - t_span,
                              'log_post_s': sum(spans.host_s),
                              'generations': span_gens}
            ctx['forward_event_ms'] = spans.event_ms()
            if cuda:
                def phase(annotate):
                    def annotated(x):
                        with annotate('portbench.forward'):
                            return log_post(x)
                    chunk_run(torch.as_tensor(span_chains, device=dev),
                              annotated)
                ctx['profile'] = tr.profiled(
                    phase, 'portbench.forward',
                    config['kernels'][mix['kernel']], chunk + 1)

    del model, obs, ret, log_post, chains, res
    if cuda:
        torch.cuda.empty_cache()
    logp = np.asarray(logp)
    correct, compared, nref = checks.judge_demc(
        work['name'], observed.reference, observed, start, final, logp,
        harness.seed_int(seed, 3))
    return {'correct': correct, 'checks': compared,
            'attempted': gens, 'failed': int(np.sum(~np.isfinite(logp))),
            'memory_peak_bytes': peak, 'ctx': ctx,
            'e2e': {'demc_gen_per_s': gens / window_s, 'setup_s': setup_s},
            'compared': nref,
            'answers': {'observed': observed, 'paths': paths,
                        'start': start, 'chains': final, 'logp': logp}}
