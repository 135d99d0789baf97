"""The port's modal filter matrices (hnumo_tpu_torch/basis/filter.py)
against the JAX package's (hnumo_tpu/basis/filter.py), on the CPU: every
weight type x basis type at nop 2..8, to 1e-14 (both are the same float64
NumPy; measured bitwise), and tests/test_basis.py's two properties on the
port's function."""
import numpy as np
import pytest

from hnumo_tpu.basis.filter import filter_matrix as jax_filter_matrix
from hnumo_tpu_torch.basis.filter import filter_matrix

TOL = 1e-14
WEIGHTS = ("erf", "quad", "exp")
BASES = ("legendre", "modal")
NOPS = range(2, 9)


@pytest.mark.parametrize("nop", NOPS)
@pytest.mark.parametrize("basis_type", BASES)
@pytest.mark.parametrize("weight_type", WEIGHTS)
def test_filter_matrix_is_the_jax_package_s(weight_type, basis_type, nop):
    mu = float(np.random.default_rng(nop).uniform(0.05, 1.0))
    got = filter_matrix(nop, mu, weight_type, basis_type)
    want = jax_filter_matrix(nop, mu, weight_type, basis_type)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == want.shape == (nop + 1, nop + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("basis_type", BASES)
@pytest.mark.parametrize("weight_type", WEIGHTS)
def test_filter_matrix_preserves_constants(weight_type, basis_type):
    """F @ 1 = 1: the filter leaves the mean mode alone."""
    f = filter_matrix(4, mu=0.2, weight_type=weight_type, basis_type=basis_type)
    np.testing.assert_allclose(f @ np.ones(5), np.ones(5), atol=1e-12)


def test_filter_mu_zero_is_identity():
    np.testing.assert_allclose(filter_matrix(4, mu=0.0), np.eye(5), atol=1e-13)


def test_unknown_weight_type_raises():
    with pytest.raises(ValueError, match="unknown filter weight type 'boxcar'"):
        filter_matrix(4, 0.5, weight_type="boxcar")
    with pytest.raises(ValueError, match="unknown filter weight type"):
        jax_filter_matrix(4, 0.5, weight_type="boxcar")
