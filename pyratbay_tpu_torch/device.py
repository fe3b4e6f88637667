"""Device and dtype policy of the port."""
import torch

__all__ = ['resolve']


def resolve(device=None):
    """(torch.device, dtype): float64 on the CPU, float32 on CUDA.

    A CUDA device that is not available raises here instead of
    silently running on the CPU.
    """
    device = torch.device('cpu' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('CUDA device requested but none is available')
        return device, torch.float32
    if device.type != 'cpu':
        raise ValueError(f'Unsupported device {device}')
    return device, torch.float64
