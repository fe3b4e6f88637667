"""One rank of a torch.distributed process group on the CPU (launched by
tests/test_torch_distributed.py); imports no JAX.

The rank joins the group through the port's bootstrap
(pyratbay_tpu_torch.parallel.distributed.initialize_distributed, from
PBT_COORDINATOR / PBT_NPROCS / PBT_PROCID), lays the (chains, wave) mesh
over it (PBT_CHAINS_AXIS chain shards), runs the tasks named in
PBT_TASKS on float64 CPU tensors, and writes what it gathered to
PBT_OUT/<task>_<rank>.npz.  Inputs (parameters, injected draws) are
read from PBT_IN (an .npz the test writes); PBT_WORK is a directory for
the rank's model files.

Tasks:
  transit  the test-size flagship's wave-sharded batched forward
           (wnstep 2) at the input parameters: the whole spectrum and
           band fluxes, gathered over wave and chains;
  eclipse  the same for the eclipse flagship (wnstep 3, an odd width);
  demc     the flagship (wnstep 4) with the input data, sharded:
           chains0, the initial log-posterior and two DEMC generations
           of sharded_retrieval_step on the injected draws;
  nested   sample_nested with mesh on a Gaussian likelihood with the
           injected draws, and on the flagship's log-posterior with
           draws of its own;
  tli      the TLI model of the config PBT_TLI_CFG: the wave-sharded
           forward at the input parameters;
  driver   driver.run of PBT_DRIVER_CFG (a runmode = spectrum config
           with dist_* keys, rank PBT_RANK's; the driver joins the group
           itself).
"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from pyratbay_tpu_torch.parallel import distributed  # noqa: E402
from pyratbay_tpu_torch.parallel import sharded  # noqa: E402

FLAGSHIP = dict(nlayers=21, wl_low=1.1, wl_high=1.3)
NESTED = dict(nlive=24, max_iter=40, nsteps_walk=3)
MU = np.array([0.3, -0.2, 0.5])


def gaussian(theta):
    return -0.5 * torch.sum(((theta - torch.as_tensor(MU)) / 0.4)**2, dim=1)


def task_forward(mesh, inputs, workdir, rt_path, wnstep):
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    model, obs, ret, _, _ = make_flagship(
        workdir, device='cpu', rt_path=rt_path, wnstep=wnstep, **FLAGSHIP)
    sharded.shard_model_tables(model, obs, mesh)
    return sharded_outputs(build_forward_batched(model, obs, ret),
                           inputs['params'], mesh, model)


def sharded_outputs(forward_b, params, mesh, model):
    nbands = None

    def both(p):
        nonlocal nbands
        out = forward_b(p)
        nbands = out['bandflux'].shape[1]
        return torch.cat([sharded.gather_wave(out['spectrum'], mesh),
                          out['bandflux']], dim=1)

    whole = sharded.split_chains(both, mesh)(
        torch.as_tensor(params)).numpy()
    return dict(spectrum=whole[:, :model.nwave_unpadded],
                bandflux=whole[:, -nbands:],
                nwave_local=model.nwave, nwave=model.nwave_unpadded)


def demc_run(mesh, inputs, workdir):
    """build_flagship_sharded's steps with the data of `inputs` (the JAX
    package's synthetic data, so that the two sides' log-posteriors
    differ by their forwards only): chains0, the initial log-posterior
    and two DEMC generations on the injected draws, and the collectives
    these made."""
    from pyratbay_tpu_torch.benchmark import make_flagship
    from pyratbay_tpu_torch.retrieval.batched import (
        build_log_posterior_batched)
    model, obs, ret, _, _ = make_flagship(
        workdir, device='cpu', wnstep=4.0, **FLAGSHIP)
    obs.data = np.array(inputs['data'])
    obs.uncert = np.array(inputs['uncert'])
    sharded.shard_model_tables(model, obs, mesh)
    step, chains = sharded.sharded_retrieval_step(
        build_log_posterior_batched(model, obs, ret), ret, mesh,
        int(inputs['nchains']), device='cpu')
    calls = mesh.calls
    chains0 = chains.clone()
    logp = logp0 = step.log_post(chains)
    for i in range(2):
        draws = {key[len(f'draw{i}_'):]: torch.as_tensor(val)
                 for key, val in inputs.items()
                 if key.startswith(f'draw{i}_')}
        chains, logp = step(chains, logp, draws)
    return dict(chains0=chains0.numpy(), logp0=logp0.numpy(),
                chains=chains.numpy(), logp=logp.numpy(),
                collectives=mesh.calls - calls)


def task_nested(mesh, inputs, workdir):
    from pyratbay_tpu_torch.retrieval.nested import sample_nested
    draws = {key[len('nested_'):]: val for key, val in inputs.items()
             if key.startswith('nested_')}
    gauss = sample_nested(gaussian, lambda u: u, 3, draws=draws, mesh=mesh,
                          **NESTED)
    model, obs, ret, log_post, _, _ = sharded.build_flagship_sharded(
        mesh, workdir, device='cpu', wnstep=4.0, **FLAGSHIP)
    free = np.flatnonzero(np.asarray(ret.pstep) > 0)
    lo = torch.as_tensor(np.asarray(ret.pmin, float))
    span = torch.as_tensor(np.asarray(ret.pmax, float)) - lo

    def transform(u):
        theta = torch.as_tensor(np.asarray(ret.params, float)).expand(
            u.shape[0], -1).clone()
        theta[:, free] = lo[free] + span[free] * u
        return theta

    flag = sample_nested(log_post, transform, len(free), mesh=mesh,
                         generator=torch.Generator().manual_seed(3),
                         **NESTED)
    return {**{f'gauss_{k}': np.asarray(v) for k, v in gauss.items()},
            **{f'flagship_{k}': np.asarray(v) for k, v in flag.items()}}


def task_tli(mesh, inputs, workdir):
    from pyratbay_tpu_torch.model import Model
    from pyratbay_tpu_torch.observation import Observation
    from pyratbay_tpu_torch.retrieval.batched import build_forward_batched
    from pyratbay_tpu_torch.retrieval.params import RetrievalParams

    class ObsCfg:
        data = uncert = obsfile = dunits = None
        offset_inst = uncert_scaling = None
        filters = list(inputs['tli_filters'])

    model = Model(os.environ['PBT_TLI_CFG'], device='cpu')
    obs = Observation(ObsCfg, model.wn)
    ret = RetrievalParams(model, obs)
    sharded.shard_model_tables(model, obs, mesh)
    lbl = model.opacity_models[0][1]
    direct = model.direct_lbl(lbl)
    out = sharded_outputs(build_forward_batched(model, obs, ret),
                          inputs['tli_params'], mesh, model)
    # The cells' line windows reach the lines within the cutoff of the
    # window's points (beyond its edges too):
    lwn = direct.lwn
    need = np.searchsorted(lwn, model.wn[0] - direct.cutoff), \
        np.searchsorted(lwn, model.wn[-1] + direct.cutoff, side='right')
    starts = np.asarray(direct.starts_wf)
    out['window_lines'] = np.array([
        starts.min(), starts.max() + direct.lmax_wf, *need])
    out['wn_local'] = direct.wn
    return out


def main():
    distributed.initialize_distributed(device='cpu')
    rank = distributed.process_index()
    tasks = os.environ['PBT_TASKS'].split(',')
    if tasks == ['driver']:
        # The driver joins the group itself, from its config's keys.
        from pyratbay_tpu_torch.driver import run
        rank = int(os.environ['PBT_RANK'])
        run(os.environ['PBT_DRIVER_CFG'], device='cpu')
        assert distributed.process_count() == 2
        assert distributed.process_index() == rank
        torch.distributed.destroy_process_group()
        return 0
    axis = os.environ.get('PBT_CHAINS_AXIS')
    mesh = sharded.make_mesh(None if axis is None else int(axis),
                             device='cpu')
    inputs = dict(np.load(os.environ['PBT_IN'])) if os.environ.get(
        'PBT_IN') else {}
    workdir = os.path.join(os.environ['PBT_WORK'], f'rank{rank}')
    runs = {
        'transit': lambda: task_forward(mesh, inputs, workdir + 't',
                                        'transit', 2.0),
        'eclipse': lambda: task_forward(mesh, inputs, workdir + 'e',
                                        'eclipse', 3.0),
        'demc': lambda: demc_run(mesh, inputs, workdir + 'd'),
        'nested': lambda: task_nested(mesh, inputs, workdir + 'n'),
        'tli': lambda: task_tli(mesh, inputs, workdir + 'l'),
    }
    with torch.no_grad():
        for task in tasks:
            out = runs[task]()
            np.savez(os.path.join(os.environ['PBT_OUT'],
                                  f'{task}_{rank}.npz'),
                     mesh=[mesh.shape['chains'], mesh.shape['wave']],
                     coords=[mesh.coords['chains'], mesh.coords['wave']],
                     backend=str(mesh.backend),
                     nprocs=distributed.process_count(), **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
