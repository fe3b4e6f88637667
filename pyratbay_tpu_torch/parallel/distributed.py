"""Several processes: the torch.distributed bootstrap.

Port of pyratbay_tpu/parallel/distributed.py.  The reference's
multi-process story is mpi4py rank/size discovery (tools/mpi_tools.py);
here it is one torch.distributed process group, one rank a process and
one device a rank, over which parallel/sharded.py lays its (chains,
wave) mesh.

Configuration, in precedence order (the JAX package's):
  1. config keys  dist_coordinator / dist_nprocs / dist_procid;
  2. environment  PBT_COORDINATOR / PBT_NPROCS / PBT_PROCID;
  3. PBT_NPROCS=auto: torch's env:// rendezvous, which reads RANK,
     WORLD_SIZE, MASTER_ADDR and MASTER_PORT as torchrun sets them (the
     counterpart of jax.distributed.initialize() with no arguments).
The coordinator is host:port (or a URL such as tcp://host:port).

Each rank runs on cuda:(local rank % device_count), the local rank
being LOCAL_RANK (torchrun) or the rank.  The backend follows a rule
and is never chosen by catching a failure:
  * NCCL when every rank of the host has a card of its own (the
    host's ranks, LOCAL_WORLD_SIZE or the group's size, are at most
    its cards);
  * gloo when ranks share a card: NCCL refuses two ranks on one device
    ("Duplicate GPU detected");
  * gloo on the CPU.
"""
import os

import torch
import torch.distributed as dist

from .. import tracing
from ..device import resolve

__all__ = [
    'initialize_distributed', 'is_initialized', 'process_index',
    'process_count', 'backend_for',
]


def backend_for(device, local_ranks):
    """The backend of a group whose `local_ranks` ranks of this host run
    on `device`'s type (the rule of the module docstring)."""
    if torch.device(device).type != 'cuda':
        return 'gloo'
    return 'nccl' if local_ranks <= torch.cuda.device_count() else 'gloo'


def initialize_distributed(cfg=None, device=None):
    """Join the torch.distributed process group if one is configured.

    device: where the ranks run (default: the card; 'cpu' for the CPU,
    where the group is gloo's).  Returns True when running
    multi-process after the call, False for single-process runs.  Safe
    to call more than once: a group already joined is kept.
    """
    if is_initialized():
        return process_count() > 1

    coordinator = nprocs = procid = None
    if cfg is not None:
        coordinator = getattr(cfg, 'dist_coordinator', None)
        nprocs = getattr(cfg, 'dist_nprocs', None)
        procid = getattr(cfg, 'dist_procid', None)
    if coordinator is None:
        coordinator = os.environ.get('PBT_COORDINATOR')
    env_nprocs = os.environ.get('PBT_NPROCS')
    if nprocs is None and env_nprocs:
        nprocs = env_nprocs if env_nprocs == 'auto' else int(env_nprocs)
    if procid is None and os.environ.get('PBT_PROCID'):
        procid = int(os.environ['PBT_PROCID'])

    if coordinator is None and nprocs is None:
        # Nothing configured: stay single-process.
        return False

    if nprocs == 'auto':
        init_method = 'env://'
        nprocs = int(os.environ['WORLD_SIZE'])
        procid = int(os.environ['RANK'])
    else:
        if coordinator is None or nprocs is None or procid is None:
            raise ValueError(
                'A process group needs the coordinator address, the '
                'number of processes and this process\'s rank '
                '(dist_coordinator / dist_nprocs / dist_procid, or '
                'PBT_COORDINATOR / PBT_NPROCS / PBT_PROCID)')
        init_method = coordinator if '://' in coordinator \
            else f'tcp://{coordinator}'
        nprocs, procid = int(nprocs), int(procid)
    local_rank = int(os.environ.get('LOCAL_RANK', procid))
    local_ranks = int(os.environ.get('LOCAL_WORLD_SIZE', nprocs))
    dev, _ = resolve(device)
    backend = backend_for(dev, local_ranks)
    if dev.type == 'cuda':
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=nprocs, rank=procid)
    if nprocs > 1:
        # Each rank writes its own trace file (tracing.py):
        tracing.RECORDER.rank = procid
    return nprocs > 1


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def process_index():
    """This process's rank (0 for single-process runs)."""
    return dist.get_rank() if is_initialized() else 0


def process_count():
    return dist.get_world_size() if is_initialized() else 1
