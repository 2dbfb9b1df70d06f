"""Each CUDA kernel of the port against its plain PyTorch version, on
the card.

These tests need an NVIDIA GPU and skip without one.  They import
neither JAX nor the JAX package, so they run on a machine with the card
and PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`tests/conftest.py` configures JAX, which that machine does not have.)
`chip_smoke.py` holds the same kernels against their plain versions at
the main path's shapes.
"""
import numpy as np
import pytest
import torch

from mj_envs_torch.physics import kernels as TK


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels run only on an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------

def _both(fn, args, cuda):
    """fn on the card (kernel) and on the CPU (plain version)."""
    dev_args = [torch.as_tensor(np.asarray(a)).to(cuda) for a in args]
    out = fn(*dev_args)
    torch.cuda.synchronize()
    return out, fn(*_t(*args))


def _close(a, b, rtol, atol):
    a = [a] if isinstance(a, torch.Tensor) else a
    b = [b] if isinstance(b, torch.Tensor) else b
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), _np(y), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_chol_factor(cuda):
    H, g, _ = TK.random_spd_problem(np.random.default_rng(9), 64, 33, 1)
    n = TK.launches["chol_factor"]
    (x_k, fac_k), (x_p, fac_p) = _both(TK.chol_solve_factor, (H, g), cuda)
    assert TK.launches["chol_factor"] == n + 1
    _close((x_k, fac_k), (x_p, fac_p), 2e-4, 2e-5)


@pytest.mark.cuda
def test_cuda_chol_solve_fac(cuda):
    H, _, G = TK.random_spd_problem(np.random.default_rng(10), 64, 33, 129)
    fac = _np(TK.chol_factor_plain(torch.as_tensor(H)))
    n = TK.launches["chol_solve_fac"]
    X_k, X_p = _both(TK.chol_solve_mat_fac, (fac, G), cuda)
    assert TK.launches["chol_solve_fac"] == n + 1
    _close(X_k, X_p, 2e-4, 2e-5)


@pytest.mark.cuda
def test_cuda_chol_factor_solve(cuda):
    H, g, _ = TK.random_spd_problem(np.random.default_rng(11), 64, 33, 1)
    H[3] = -H[3]
    n = TK.launches["chol_factor_solve"]
    x_k, x_p = _both(TK.chol_solve, (H, g), cuda)
    assert TK.launches["chol_factor_solve"] == n + 1
    assert torch.isnan(x_k[3]).any()
    _close(x_k[torch.arange(64) != 3], x_p[torch.arange(64) != 3],
           2e-4, 2e-5)


@pytest.mark.cuda
def test_cuda_linesearch_cost(cuda):
    args = TK.random_linesearch_problem(np.random.default_rng(12), 64, 296)
    n = TK.launches["linesearch_cost"]
    (a_k, c_k), (a_p, c_p) = _both(TK.linesearch_cost, args, cuda)
    assert TK.launches["linesearch_cost"] == n + 1
    # alpha: a float32 sum in another order may put phi'(alpha) on the
    # other side of a kink and move alpha within the search's last
    # bisection bracket (chip_smoke.py prints how far, between two row
    # orders of the plain version); the cost at alpha stays flat.
    _close(a_k, a_p, 0.0, 2e-3 * float(a_p.abs().max()))
    _close(c_k, c_p, 1e-5, 1e-6)


@pytest.mark.cuda
def test_cuda_noslip_sweep(cuda):
    args = TK.random_noslip_problem(np.random.default_rng(13), 16, 129)
    n = TK.launches["noslip_sweep"]
    u_k, u_p = _both(lambda *a: TK.noslip_sweep(*a, 20, tol=0.0), args, cuda)
    assert TK.launches["noslip_sweep"] == n + 1
    _close(u_k, u_p, 1e-5, 1e-5)
