"""The frozen bounds equal the port's measurement helpers' at two shapes."""
import pytest

from portbench import bounds


def _model(**over):
    from hnumo_tpu_torch.config import Config
    from hnumo_tpu_torch.model import Model

    kw = dict(nelx=4, nely=3, nopx=4, nopy=4, xdims=(0.0, 4e6 / 3), ydims=(0.0, 1e6),
              nlayers=2, dt=500.0, dt_btp=25.0, test_case="double_gyre", f0=9.3e-5,
              beta=2e-11, botfr=1, cd_mlswe=1e-7, method_visc=2, visc_mlswe=100.0,
              dtype="float32")
    return Model(Config(**{**kw, **over}), device="cpu")


def _shape(m):
    c = m.cfg
    return bounds.shape_of({"nopx": c.nopx, "nelx": c.nelx, "nely": c.nely, "dt": c.dt,
                            "dt_btp": c.dt_btp, "kstages": c.kstages,
                            "visc_mlswe": c.visc_mlswe, "test_case": c.test_case,
                            "dtype": c.dtype, "dg_integ_exact": c.dg_integ_exact})


@pytest.mark.parametrize("over", [dict(), dict(nopx=3, nopy=3, nelx=5, nely=2,
                                               xdims=(0.0, 5e6), visc_mlswe=0.0,
                                               dtype="float64", dt=400.0, dt_btp=40.0)])
def test_frozen_bounds_equal_the_ports(over):
    from hnumo_tpu_torch.tools import _measure

    m = _model(**over)
    s = _shape(m)
    assert bounds.volume_bound(s) == _measure.volume_bound(m)
    assert {**bounds.mega_bound(s), "barriers": s.nsub} == _measure.mega_bound(m)
    for grad in (None, False, True):
        assert bounds.fused_bounds(s, grad) == _measure.fused_bounds(m, grad)
    assert s.flat_bottom == m.static.flat_bottom
    assert (bounds.HBM_BYTES_PER_S, bounds.F32_FLOPS_PER_S) == (
        _measure.HBM_BYTES_PER_S, _measure.F32_FLOPS_PER_S)
    assert bounds.KERNEL_SYMBOLS == _measure.KERNEL_SYMBOLS


def test_kernel_bounds_read_the_path_from_the_kernels_that_ran():
    s = bounds.shape_of({"nopx": 4, "nelx": 8, "nely": 8, "dt": 500.0, "dt_btp": 25.0,
                         "visc_mlswe": 100.0, "test_case": "double_gyre", "dtype": "float32"})
    fused = bounds.kernel_bounds(s, ["btp_volume_uni", "btp_faces", "btp_update"])
    assert fused["btp_volume_uni"] == bounds.fused_bounds(s)["btp_volume_uni"]
    alone = bounds.kernel_bounds(s, ["btp_volume_uni"])
    assert alone["btp_volume_uni"] == bounds.fused_bounds(s, grad=False)["btp_volume_uni"]
    assert bounds.kernel_bounds(s, ["btp_mega"])["btp_mega"] == bounds.mega_bound(s)
