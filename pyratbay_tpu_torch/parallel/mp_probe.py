"""Multi-process throughput probe: a process group of `nprocs` ranks.

`python -m pyratbay_tpu_torch.parallel.mp_probe` spawns itself
`--nprocs` times (2 by default) as a torch.distributed process group,
times DEMC generations of the wave-sharded flagship retrieval (the
program tests/test_torch_distributed.py holds against the single-rank
run) and prints one JSON line with the sustained ensemble rate: the JAX
package's keys (nprocs, local_devices, nchains, sec_per_generation,
chain_evals_per_s) and the device, backend and mesh.  The ranks run on
the card (two or more on one card share it through gloo) unless
`--device cpu` is given.  Ranks are new interpreters, never forks of
this one.  Any rank that fails, or a group that outlasts `--timeout`
seconds (every rank is then killed), makes the probe exit non-zero.

    python -m pyratbay_tpu_torch.parallel.mp_probe [--nprocs 2]
        [--device cpu] [--iters 20] [--timeout 850]
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time

# The flagship at the JAX probe's size:
FLAGSHIP = dict(nlayers=21, wl_low=1.1, wl_high=1.3, wnstep=4.0)


def _worker(device, n_iter):
    import tempfile

    import torch

    from .distributed import initialize_distributed, process_index
    from .sharded import build_flagship_sharded, make_mesh

    initialize_distributed(device=device)
    mesh = make_mesh(device=device)
    with tempfile.TemporaryDirectory() as workdir, torch.no_grad():
        model, obs, ret, log_post, step, chains = build_flagship_sharded(
            mesh, workdir, device=device, **FLAGSHIP)
        logp = step.log_post(chains)
        # Warm-up generation:
        chains, logp = step(chains, logp)
        _sync(model.device)
        start = time.perf_counter()
        for _ in range(n_iter):
            chains, logp = step(chains, logp)
        _sync(model.device)
        dt = (time.perf_counter() - start) / n_iter
    nchains = chains.shape[0]
    if process_index() == 0:
        print(json.dumps({
            'nprocs': int(os.environ.get('PBT_NPROCS', 1)),
            'local_devices': 1,
            'nchains': int(nchains),
            'sec_per_generation': round(dt, 5),
            'chain_evals_per_s': round(nchains / dt, 1),
            'device': str(model.device),
            'device_name': (torch.cuda.get_device_name(model.device)
                            if model.device.type == 'cuda' else 'cpu'),
            'backend': mesh.backend,
            'mesh': [mesh.shape['chains'], mesh.shape['wave']],
        }), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _sync(device):
    from .. import tracing
    if device.type == 'cuda':
        tracing.synchronize(device)


def free_port():
    """A port the OS has just handed out (bound to 0, then released)."""
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--nprocs', type=int, default=2)
    parser.add_argument('--device', default=None,
                        help="the ranks' device (default: the card)")
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--timeout', type=float, default=850.0)
    args = parser.parse_args(argv)
    if 'PBT_PROCID' in os.environ:
        return _worker(args.device, args.iters)

    env = dict(os.environ, PBT_COORDINATOR=f'localhost:{free_port()}',
               PBT_NPROCS=str(args.nprocs))
    cmd = [sys.executable, '-m', 'pyratbay_tpu_torch.parallel.mp_probe',
           '--iters', str(args.iters)]
    if args.device is not None:
        cmd += ['--device', args.device]
    ranks = run_group([(cmd, dict(env, PBT_PROCID=str(rank)))
                       for rank in range(args.nprocs)], args.timeout)
    for rank, (code, out, err) in enumerate(ranks):
        if code != 0:
            print(json.dumps({'error': f'rank {rank} exit {code}',
                              'stderr': err[-2000:]}))
            return 1
    lines = [ln for ln in ranks[0][1].splitlines() if ln.startswith('{')]
    if lines:
        print(lines[-1])
        return 0
    print(json.dumps({'error': 'no output from process group'}))
    return 1


def run_group(commands, timeout, cwd=None):
    """Run one process for each (argv, env) of `commands` and wait for
    all: returns (exit code, stdout, stderr) of each.  When one exits
    with another code than 0, or `timeout` seconds pass, every process
    still running is killed (its code is then negative): a rank left
    waiting in a collective for a dead peer never hangs the caller."""
    import contextlib
    import tempfile
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        procs, files = [], []
        try:
            for i, (argv, env) in enumerate(commands):
                out, err = (stack.enter_context(open(
                    os.path.join(tmp, f'{i}.{kind}'), 'w+'))
                    for kind in ('out', 'err'))
                files.append((out, err))
                procs.append(subprocess.Popen(
                    argv, env=env, cwd=cwd, stdout=out, stderr=err,
                    text=True))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = any(p.returncode not in (None, 0) for p in procs)
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
            for proc in procs:
                proc.wait()
        result = []
        for proc, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            result.append((proc.returncode, out.read(), err.read()))
    return result


if __name__ == '__main__':
    sys.exit(main())
