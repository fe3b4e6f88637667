"""The hand-written CUDA transit kernel against its plain PyTorch
version, on a GPU.

This file imports neither JAX nor pyratbay_tpu, so that it also runs on
a machine without them, where tests/conftest.py (which imports JAX)
must be skipped:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device the tests skip.  The bound, 2e-5 of the row
maximum, is the transit bound of tests/test_tpu_hw.py (float32 on the
card against float32 plain torch on the card, differing only in the
order of the sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from pyratbay_tpu_torch.atmosphere.geometry import transit_path_matrix  # noqa: E402
from pyratbay_tpu_torch.spectrum import transit_kernel as tk  # noqa: E402

TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc (run chip_smoke.py)')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _operands(nb, nlayers, nwave, ncia, nr1, seed):
    rng = np.random.default_rng(seed)
    radius = np.sort(
        rng.uniform(1.0, 1.1, (nb, nlayers)), axis=1)[:, ::-1].copy()
    ec1 = rng.lognormal(-3.0, 2.0, (nb, nlayers, nwave)) \
        * np.exp(np.linspace(0.0, 7.0, nlayers))[:, None]
    ec2 = rng.lognormal(-4.0, 1.5, (nb, nlayers, nwave))
    cia_tab = rng.lognormal(-2.0, 1.0, (ncia, nwave))
    cia_w = rng.lognormal(-1.0, 0.5, (nb, nlayers, ncia))
    r1c = rng.lognormal(-2.0, 1.0, (nb, nr1, nlayers))
    r1r = rng.lognormal(-1.0, 1.0, (nb, nr1, nwave))
    return radius, [ec1, ec2], cia_tab, cia_w, r1c, r1r


@pytest.mark.cuda
@pytest.mark.parametrize('with_deck', [True, False])
def test_cuda_kernel_matches_plain(cuda, with_deck):
    nb, nlayers = 6, 51
    radius, parts, cia_tab, cia_w, r1c, r1r = _operands(
        nb, nlayers, 1000, ncia=15, nr1=1, seed=9)
    f32 = lambda a: torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=cuda)
    i64 = lambda a: torch.as_tensor(np.asarray(a), device=cuda)
    itop = np.array([0, 0, 2, 0, 5, 0])
    rr = f32(radius)
    path = transit_path_matrix(rr, i64(itop))
    if with_deck:
        deck_itop = np.array([45, 50, 30, 12, 40, 20])
        rsurf = radius[np.arange(nb), deck_itop] + 0.4 * (
            radius[np.arange(nb), deck_itop - 1]
            - radius[np.arange(nb), deck_itop])
        operands = tk.prep_chains(path, rr, 12.0, i64(itop),
                                  i64(deck_itop + 1), i64(deck_itop),
                                  f32(rsurf))
    else:
        operands = tk.prep_chains(path, rr, 12.0, i64(itop),
                                  i64(np.full(nb, nlayers)))
    kw = dict(cia_w=f32(cia_w), cia_tab=f32(cia_tab), r1_cols=f32(r1c),
              r1_rows=f32(r1r), maxdepth=10.0)
    ec = [f32(p) for p in parts]
    launches = tk.transit_rt_cuda.launches
    got = tk.transit_rt_cuda(ec, *operands, **kw)
    want = tk.transit_rt_plain(ec, *operands, **kw)
    torch.cuda.synchronize()
    assert tk.transit_rt_cuda.launches == launches + 1
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.max(np.abs(got - want) / scale) < TOL


@pytest.mark.cuda
def test_cuda_wrapper_routes_to_kernel(cuda):
    """transit_spectrum_ensemble on CUDA tensors launches the kernel."""
    radius, parts, _, _, _, _ = _operands(2, 12, 64, 1, 1, seed=1)
    rr = torch.as_tensor(radius, dtype=torch.float32, device=cuda)
    path = transit_path_matrix(rr)
    launches = tk.transit_rt_cuda.launches
    out = tk.transit_spectrum_ensemble(
        [torch.as_tensor(parts[0], dtype=torch.float32, device=cuda)],
        path, rr, 10.0, torch.zeros(2, dtype=torch.int64, device=cuda),
        torch.full((2,), 12, device=cuda))
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == (2, 64)
    assert tk.transit_rt_cuda.launches == launches + 1
