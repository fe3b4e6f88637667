"""Device and dtype policy of the port."""
import torch

__all__ = ['resolve']


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
