"""Shared helpers of the tests/test_torch_*.py parity tests (no test cases here).

The same inputs, made with numpy from a seed, go through a JAX function
and its counterpart in hnumo_tpu_torch; everything crosses between the two
packages as numpy arrays.
"""
import jax
import numpy as np
import pytest
import torch

from hnumo_tpu.config import Config as JaxConfig
from hnumo_tpu_torch.config import Config as TorchConfig

BASE = dict(nelx=6, nely=5, nopx=4, nopy=4, xdims=(0.0, 2e6),
            ydims=(0.0, 2e6), nlayers=2, dt=400.0, dt_btp=20.0,
            time_final=1e9, test_case="double_gyre", f0=9.3e-5,
            beta=2e-11, botfr=1, cd_mlswe=1e-7,
            method_visc=2, visc_mlswe=100.0, dtype="float64")

TDTYPE = {"float64": torch.float64, "float32": torch.float32}


def jax_config(**over):
    """The JAX package on the path the port mirrors: one Pallas volume
    kernel per stage (interpret mode on the CPU), no megakernel."""
    kw = {**BASE, "use_pallas": "on", "mega": "off", **over}
    return JaxConfig(**kw)


def torch_config(**over):
    """The port on the same path: per stage, no megakernel (these grids are
    under 1024 elements, where "auto" would take the mega path); the
    megakernel tests say mega="on"."""
    return TorchConfig(**{**BASE, "mega": "off", **over})


def to_np(tree):
    """A JAX pytree (NamedTuples of arrays) -> the same of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def tt(a, dtype="float64"):
    return torch.tensor(np.asarray(a), dtype=TDTYPE[dtype])


def perturb(state_np, seed, dtype):
    """Perturbed (qb_df, qprime_df) as numpy, off the rest state so that
    nothing is all zeros (the pattern of tests/test_pallas.py)."""
    rng = np.random.default_rng(seed)
    npd = np.dtype(dtype)
    qb = (state_np.qb_df + 1e-3 * np.abs(rng.normal(size=state_np.qb_df.shape))).astype(npd)
    qp = (state_np.qprime_df + 1e-4 * rng.normal(size=state_np.qprime_df.shape)).astype(npd)
    return rng, qb, qp


def assert_close(got, want, rel, name=""):
    """|got - want| <= rel * max|want| (absolute when the field is all zero)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale if scale > 0 else rel,
                               err_msg=name)


def leaves(tree, prefix=""):
    """(dotted name, leaf) pairs of nested NamedTuples / tuples."""
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from leaves(getattr(tree, f), f"{prefix}{f}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def sumfact_interp(psiq, u):
    """Node->quad interpolation of flat nodal rows u (..., ngl*ngl) as two 1-D
    passes with psiq (ngl, nq), in numpy: the arithmetic of the CUDA volume
    kernels, written independently of the Kronecker matrices."""
    ngl, nq = psiq.shape
    u = np.asarray(u).reshape(u.shape[:-1] + (ngl, ngl))           # [j, i]
    t = np.einsum("...ji,iI->...jI", u, psiq)                      # pass 1, along i
    return np.einsum("...jI,jJ->...JI", t, psiq).reshape(u.shape[:-2] + (nq * nq,))


def sumfact_scatter(psiq, dpsiq, a_ksi, a_eta, s=None):
    """Weak-form scatter of flat quad rows (..., nq*nq) as two 1-D passes:
    a_ksi through (dpsiq along i, psiq along j), a_eta through (psiq, dpsiq),
    s through (psiq, psiq); returns flat nodal rows (..., ngl*ngl)."""
    ngl, nq = psiq.shape

    def sq(a):
        a = np.asarray(a)
        return a.reshape(a.shape[:-1] + (nq, nq))                   # [J, I]

    t1 = np.einsum("...JI,iI->...Ji", sq(a_ksi), dpsiq)            # pass 1, along I
    t2 = np.einsum("...JI,iI->...Ji", sq(a_eta), psiq)
    if s is not None:
        t1 = t1 + np.einsum("...JI,iI->...Ji", sq(s), psiq)
    r = np.einsum("...Ji,jJ->...ji", t1, psiq) + np.einsum("...Ji,jJ->...ji", t2, dpsiq)
    return r.reshape(r.shape[:-2] + (ngl * ngl,))


@pytest.fixture(autouse=True)
def one_thread():
    """A port step on the CPU is thousands of operations on small tensors:
    one intra-op thread runs it several times faster than many, and the
    suite's workers share the machine's cores. Applies to every test of a
    module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
