"""Device and dtype policy of the port."""
import functools

import torch

__all__ = ['resolve', 'index_tensor', 'as_tensors']


def resolve(device=None):
    """(torch.device, dtype): float64 on the CPU, float32 on CUDA.

    The default (None) is the CUDA device: the port runs on the card
    unless the caller names 'cpu'.  A CUDA device that is not available
    raises here instead of silently running on the CPU.
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available: pass device='cpu' to run on "
                'the CPU')
        return device, torch.float32
    if device.type != 'cpu':
        raise ValueError(f'Unsupported device {device}')
    return device, torch.float64


def index_tensor(indices, device):
    """A host list of indices as an int64 tensor on `device`, made once
    for each list and device: indexing a CUDA tensor with a host list
    copies it to the card on every call, and such a copy waits for the
    stream to drain (a host synchronisation)."""
    return _index_tensor(tuple(int(i) for i in indices), str(device))


@functools.lru_cache(maxsize=None)
def _index_tensor(indices, device):
    return torch.as_tensor(indices, dtype=torch.int64, device=device)


def as_tensors(*values):
    """The values as tensors on the device and in the floating dtype of
    the first tensor among them (float64 on the CPU when none is one):
    numpy arrays and numbers passed beside a tensor follow it."""
    like = next((v for v in values if torch.is_tensor(v)), None)
    device = 'cpu' if like is None else like.device
    dtype = like.dtype if like is not None and like.is_floating_point() \
        else torch.float64
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in values]
