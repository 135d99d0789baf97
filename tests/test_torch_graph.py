"""The step of hnumo_tpu_torch can be captured as a CUDA graph: it reads
nothing back from the device, on every barotropic path.

A read from the device inside a capture is an error, and a Python branch on
a tensor's value is worse: it is frozen at capture time and the graph takes
that branch forever. A tensor made from host data inside the step is an
error too: the copy from pageable host memory cannot be captured. So one
eager step of each path runs here, on the CPU, with every Tensor method
that hands a value to the host, and `torch.tensor` / `torch.as_tensor` of
anything but a tensor, patched to raise.
The capture and the replay themselves need a CUDA device: chip_smoke.py
holds the graphed step against the eager one there, bitwise. Also here:
the `step_impl` switch, `Config.debug_checks` and `Model.nsteps_total`
against the JAX package's.
"""
import contextlib
import math

import pytest
import torch

from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.core import btp
from hnumo_tpu_torch.core.types import State
from hnumo_tpu_torch.model import Model
from test_torch_common import counting, jax_config, torch_config
from test_torch_common import one_thread  # noqa: F401  (autouse)

HOST_READS = ("__bool__", "item", "tolist", "__float__", "__int__", "numpy", "cpu")


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Every Tensor method of HOST_READS raises inside the block, and so do
    `torch.tensor` and `torch.as_tensor` of host data."""
    with monkeypatch.context() as mp:
        for name in HOST_READS:
            def refuse(*args, _name=name, **kw):
                raise AssertionError(f"Tensor.{_name} called inside the step")
            mp.setattr(torch.Tensor, name, refuse)
        for name in ("tensor", "as_tensor"):
            def from_host(data, *args, _name=name, _make=getattr(torch, name), **kw):
                if not isinstance(data, torch.Tensor):
                    raise AssertionError(f"torch.{_name} of host data called inside the step")
                return _make(data, *args, **kw)
            mp.setattr(torch, name, from_host)
        yield


# (path, config overrides, the function of core/btp that only that path calls)
PATHS = [("megakernel", dict(mega="on"), "barotropic_solve_mega_plain"),
         ("fused", dict(fused_tail="on"), "_barotropic_solve_fused"),
         ("per_stage", dict(), "btp_volume_plain"),
         ("per_stage_uniform", dict(uni_volume="on"), "btp_volume_uni_plain")]


@pytest.mark.parametrize("path,over,marker", PATHS, ids=[p[0] for p in PATHS])
def test_a_step_reads_nothing_back_from_the_device(monkeypatch, path, over, marker):
    m = Model(torch_config(**over), device="cpu")
    assert m.step_impl == "eager"
    seen = counting(monkeypatch, btp, marker)
    s = m.step(m.state0)           # the first step: lazily built caches
    flag = torch.tensor(True)
    with no_host_reads(monkeypatch):
        with pytest.raises(AssertionError, match="__bool__"):
            bool(flag)                 # the patch is in force
        with pytest.raises(AssertionError, match="torch.tensor of host data"):
            torch.tensor([1, 2])
        s2 = m.step(s)
        s3 = m.run(s2, 1, check_ok=False)
    assert len(seen) > 0, f"the {path} path did not run"
    assert bool(s3.ok) and float(s3.t) == pytest.approx(3 * m.cfg.dt)
    for name in ("qb_df", "q_df", "qprime_df"):
        assert torch.isfinite(getattr(s3, name)).all()


# the options off the main path: (path, config overrides, the function of
# core/btp that shows the path ran). A step of each, from the initial state
# (lsrk_ref diverges by design within three steps), after one unpatched
# step that builds the lazy caches.
NEW_PATHS = [
    ("per_direction_faces", dict(batched_faces="off"), "_btp_faces_visc"),
    ("quad_family", dict(method_visc=1), "btp_quad_laplacian"),
    ("lsrk", dict(ti_method_btp="lsrk"), "btp_volume_plain"),
    ("lsrk14", dict(ti_method_btp="lsrk", kstages=14), "btp_volume_plain"),
    ("lsrk_ref_fused", dict(ti_method_btp="lsrk_ref", fused_tail="on"),
     "_barotropic_solve_fused"),
    ("periodic_per_stage", dict(x_boundary=(3, 3), y_boundary=(3, 3)), "btp_volume_plain"),
    ("periodic_fused", dict(x_boundary=(3, 3), y_boundary=(2, 0), fused_tail="on"),
     "_barotropic_solve_fused"),
    ("shear_megakernel", dict(mega="on", ad_mlswe=1e-3, max_shear_dz=5.0),
     "barotropic_solve_mega_plain"),
    ("botfr2_fused", dict(botfr=2, fused_tail="on"), "_barotropic_solve_fused"),
]


@pytest.mark.filterwarnings("ignore:ti_method_btp='lsrk_ref'")
@pytest.mark.parametrize("path,over,marker", NEW_PATHS, ids=[p[0] for p in NEW_PATHS])
def test_a_step_of_each_option_reads_nothing_back(monkeypatch, path, over, marker):
    """The LSRK register reset, the per-direction accumulators, the quad
    viscosity, the periodic exchange and the shear solve read no device
    value on the host: a step of each runs with the host reads patched to
    raise."""
    m = Model(torch_config(**over), device="cpu")
    seen = counting(monkeypatch, btp, marker)
    m.step(m.state0)
    n = len(seen)
    with no_host_reads(monkeypatch):
        s = m.step(m.state0)
    assert n > 0 and len(seen) == 2 * n, f"the {path} path did not run"
    assert bool(s.ok) and float(s.t) == pytest.approx(m.cfg.dt)
    for name in ("qb_df", "q_df", "qprime_df"):
        assert torch.isfinite(getattr(s, name)).all()


def test_the_ssprk_tables_are_floats_of_the_compute_dtype():
    for dtype in ("float64", "float32"):
        m = Model(torch_config(dtype=dtype), device="cpu")
        assert all(type(v) is float for row in m.static.ssprk_a for v in row)
        assert [list(r) for r in m.static.ssprk_a] == m.P.ssprk_a.tolist()
        assert list(m.static.ssprk_beta) == m.P.ssprk_beta.tolist()
        assert m.mega_ops is None or m.mega_ops.a_tab == m.static.ssprk_a


@pytest.mark.filterwarnings("ignore:ti_method_btp='lsrk_ref'")
@pytest.mark.parametrize("method,kstages", [("lsrk", 5), ("lsrk", 14), ("lsrk_ref", 5)])
def test_the_lsrk_tables_are_floats_of_the_compute_dtype(method, kstages):
    """Under lsrk and lsrk_ref the host tables are the LSRK ones (A in
    column 0, B in beta), as P's."""
    from hnumo_tpu_torch.basis.ssprk import ssprk_coefficients

    a64, b64 = ssprk_coefficients(kstages, "lsrk")
    for dtype in ("float64", "float32"):
        m = Model(torch_config(dtype=dtype, ti_method_btp=method, kstages=kstages),
                  device="cpu")
        assert all(type(v) is float for row in m.static.ssprk_a for v in row)
        assert [list(r) for r in m.static.ssprk_a] == m.P.ssprk_a.tolist()
        assert list(m.static.ssprk_beta) == m.P.ssprk_beta.tolist()
        assert [r[0] for r in m.static.ssprk_a] == pytest.approx(list(a64[:, 0]), rel=1e-7)
        assert list(m.static.ssprk_beta) == pytest.approx(list(b64), rel=1e-7)


@pytest.mark.parametrize("impl,match", [
    ("grpah", "step_impl must be one of"), ("", "step_impl must be one of"),
    ("graph", "step_impl='graph' needs a CUDA device")])
def test_step_impl_is_validated(impl, match):
    with pytest.raises(ValueError, match=match):
        Model(torch_config(nelx=2, nely=2), device="cpu", step_impl=impl)


def test_step_impl_defaults_to_eager_on_the_cpu():
    assert Model(torch_config(nelx=2, nely=2), device="cpu").step_impl == "eager"
    m = Model(torch_config(nelx=2, nely=2), device="cpu", step_impl="eager")
    assert m.step_impl == "eager"


def _poisoned(s: State, name: str) -> State:
    bad = getattr(s, name).clone()
    bad.view(-1)[7] = math.nan
    return s._replace(**{name: bad})


@pytest.mark.parametrize("name", ["qb_df", "q_df", "qprime_df"])
def test_debug_checks_raise_on_a_non_finite_state(name):
    m = Model(torch_config(nelx=3, nely=2, debug_checks=True), device="cpu")
    s = m.step(m.state0)                    # a sane step passes the check
    with pytest.raises(FloatingPointError, match="debug_checks: .* non-finite"):
        m.step(_poisoned(s, name))
    off = Model(torch_config(nelx=3, nely=2), device="cpu")
    out = off.step(_poisoned(off.state0, name))   # off: no check, no raise
    assert not torch.isfinite(out.qb_df).all()


@pytest.mark.parametrize("times", [dict(), dict(time_final=10800.0, dt=100.0),
                                   dict(time_initial=3.0, time_final=25.0, time_scale=3600.0,
                                        dt=450.0)])
def test_nsteps_total_is_the_reference_s(times):
    over = dict(nelx=2, nely=2, **times)
    jm = JaxModel(jax_config(**over))
    m = Model(torch_config(**over), device="cpu")
    assert m.nsteps_total == jm.nsteps_total
