"""ops/bcl_flux: the baroclinic layer-momentum face fluxes of
core/bcl.layer_momentum_fluxes, as a CUDA kernel and its plain version.

On the CPU: the plain version, through layer_momentum_fluxes, gives bit for
bit what the function gave before its body moved (portbench/reference keeps
a frozen copy of it that imports nothing of the port), and the JAX package's
layer_momentum_fluxes within 1e-12 (f64) on the same tables and inputs;
over 1-3, 5 and 10 layers, walls and x-periodic sides, p=4 with exact and
inexact integration and p=8, on a 3x2 grid. A CPU model resolves `impl`
to the plain version and builds no kernel; the CUDA wrapper refuses what it
does not take, and takes more layers than its register build holds. The kernel
itself is held against the plain version on the card (chip_smoke.py
phase 31).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.core import bcl as j_bcl
from hnumo_tpu.core import types as j_types
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.core import bcl as t_bcl
from hnumo_tpu_torch.core import types as t_types
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.ops import bcl_flux
from portbench.reference.core import bcl as frozen_bcl
from test_torch_common import assert_close, jax_config, to_np, torch_config, tt
from test_torch_common import one_thread  # noqa: F401  (autouse)

GRID = dict(nelx=3, nely=2)
XPER = dict(x_boundary=(3, 3), y_boundary=(4, 4))
# the double gyre has 2 layers; the lake at rest takes any number
LAYERS = {1: dict(nlayers=1, test_case="lakeatrest"), 2: dict(nlayers=2),
          3: dict(nlayers=3, test_case="lakeatrest"),
          5: dict(nlayers=5, test_case="lakeatrest"),
          10: dict(nlayers=10, test_case="lakeatrest")}
# (id, config overrides)
CASES = [(f"L{L}-{bcs}", dict(**LAYERS[L], **({} if bcs == "walls" else XPER)))
         for L in (1, 2, 3) for bcs in ("walls", "xper")]
CASES += [("L2-p4-inexact", dict(dg_integ_exact=False)),
          ("L2-p8", dict(nopx=8, nopy=8)),
          ("L3-xper-p8", dict(**LAYERS[3], nopx=8, nopy=8, **XPER)),
          ("L5-walls", LAYERS[5]), ("L10-xper", dict(**LAYERS[10], **XPER))]


def flux_inputs(P, g, nlayers: int, seed: int):
    """Numpy inputs of layer_momentum_fluxes at the sizes of (P, g): a
    qprime_df off rest (a thickness perturbation of ~1e-3 of each layer,
    velocity primes ~0.1 m/s), face averages around the reference state
    (mu ~ 1e-3, barotropic velocities ~0.1 m/s, momentum fluxes and dH of
    the reference's size), and a momentum RHS to add into."""
    rng = np.random.default_rng(seed)
    dref = np.asarray(P.dpp_ref_df)
    qp = np.stack([1e-3 * dref * rng.normal(size=dref.shape),
                   0.1 * rng.normal(size=dref.shape),
                   0.1 * rng.normal(size=dref.shape)])

    def face_avg(fg):
        shape = np.asarray(fg.nx).shape
        pb = np.asarray(fg.pbprime_face_L)
        hedge = np.asarray(fg.Hedge_ref)

        def r(scale):
            return scale * rng.normal(size=shape)

        mu = {k: r(1e-3) for k in ("muL", "muR", "mue")}
        fa = dict(dH=r(1e-3) * hedge,
                  **{k: r(1e-2) * pb for k in ("QuU", "QuV", "QvU", "QvV", "fluxU", "fluxV")},
                  muL=mu["muL"], muR=mu["muR"],
                  mu2L=mu["muL"] * (2.0 + mu["muL"]), mu2R=mu["muR"] * (2.0 + mu["muR"]),
                  mue2=mu["mue"] * (2.0 + mu["mue"]),
                  **{k: r(0.1) for k in ("ubL", "ubR", "vbL", "vbR")})
        ngl = np.asarray(fg.nx_df).shape[-1]
        fa["gvL"] = fa["gvR"] = np.zeros((4,) + shape[:-1] + (ngl,))
        return fa

    ngl = np.asarray(g.psiq).shape[0]
    rhs = rng.normal(size=(2, nlayers) + dref.shape[1:3] + (ngl, ngl))
    return qp, face_avg(P.faces.x), face_avg(P.faces.y), rhs


def averages(types, fx, fy, cast):
    """A BtpAverages of `types` whose face fields are fx, fy (dicts of numpy);
    the fields layer_momentum_fluxes does not read are zero."""
    faces = types.Pair(types.BtpFaceAvg(**{k: cast(v) for k, v in fx.items()}),
                       types.BtpFaceAvg(**{k: cast(v) for k, v in fy.items()}))
    zero = cast(np.zeros(()))
    return types.BtpAverages(**{f: zero for f in types.BtpAverages._fields if f != "faces"},
                             faces=faces)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """The JAX model and the port's on the JAX model's tables (f64), and one
    set of inputs."""
    over = {**GRID, **request.param[1]}
    jm = JaxModel(jax_config(**over))
    P_np, g_np, s_np = to_np(jm.P), to_np(jm.g), to_np(jm.state0)
    inputs = flux_inputs(P_np, g_np, over.get("nlayers", 2), seed=17)
    return over, jm, (P_np, g_np, s_np), inputs


def torch_run(over, tables, inputs, dtype, fn):
    P, g, s = from_numpy_tables(*tables, "cpu", dtype)
    tm = TorchModel.from_tables(torch_config(**over, dtype="float64" if dtype == torch.float64
                                             else "float32"), P, g, s, device="cpu")
    qp, fx, fy, rhs = inputs

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    qpt = cast(qp)
    qpf = t_bcl.extract_qprime_faces(tm.bc, qpt)
    avg = averages(t_types, fx, fy, cast)
    return fn(tm.static, tm.P, tm.g, tm.bc, avg, qpf, cast(rhs)), tm


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_fluxes_are_the_function_before_the_move(case, dtype):
    over, _, tables, inputs = case
    calls = bcl_flux.bcl_momentum_fluxes_plain.calls
    got, tm = torch_run(over, tables, inputs, dtype, t_bcl.layer_momentum_fluxes)
    assert tm.static.impl == "plain"
    assert bcl_flux.bcl_momentum_fluxes_plain.calls == calls + 1
    want, _ = torch_run(over, tables, inputs, dtype, frozen_bcl.layer_momentum_fluxes)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_plain_fluxes_match_the_jax_package(case):
    over, jm, tables, inputs = case
    got, _ = torch_run(over, tables, inputs, torch.float64, t_bcl.layer_momentum_fluxes)
    qp, fx, fy, rhs = inputs
    qpj = jnp.asarray(qp)
    want = j_bcl.layer_momentum_fluxes(jm.static, jm.P, jm.g, jm.bc,
                                       averages(j_types, fx, fy, jnp.asarray),
                                       j_bcl.extract_qprime_faces(jm.bc, qpj), jnp.asarray(rhs))
    # the fluxes alone, without the momentum RHS they are added into
    assert_close(got - tt(rhs), np.asarray(want) - rhs, 1e-12, "layer_momentum_fluxes")


def _small(**over):
    from hnumo_tpu_torch.config import Config

    return Config(**{**dict(nelx=3, nely=2, nopx=4, nopy=4, xdims=(0.0, 2e6),
                            ydims=(0.0, 2e6), nlayers=2, dt=400.0, dt_btp=20.0,
                            time_final=1e9, test_case="double_gyre", f0=9.3e-5,
                            beta=2e-11, mega="off"), **over})


def test_cpu_model_takes_the_plain_fluxes_twice_a_step():
    m = TorchModel(_small(), device="cpu")
    assert m.static.impl == "plain"
    calls = bcl_flux.bcl_momentum_fluxes_plain.calls
    launches = bcl_flux.bcl_momentum_fluxes_cuda.launches
    m.step(m.state0)
    assert bcl_flux.bcl_momentum_fluxes_plain.calls == calls + 2    # predictor, corrector
    assert bcl_flux.bcl_momentum_fluxes_cuda.launches == launches


def _wrapper_operands(nlayers: int = 2):
    """layer_momentum_fluxes' operands of the 3x2 grid (f64) as ops/bcl_flux takes them."""
    m = TorchModel(_small(dtype="float64", **LAYERS[nlayers]), device="cpu")
    qp, fx, fy, _ = flux_inputs(to_np(m.P), to_np(m.g), nlayers, seed=3)

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    qpf = t_bcl.extract_qprime_faces(m.bc, cast(qp))
    return dict(psiq=m.g.psiq, alpha=m.P.alpha, grav=m.static.gravity, qprime_faces=qpf,
                avg_faces=averages(t_types, fx, fy, cast).faces, geom_faces=m.P.faces)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    ops = _wrapper_operands()
    fluxes = bcl_flux.bcl_momentum_fluxes_cuda
    launches = fluxes.launches
    # everything right but the device
    with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
        fluxes(**ops)
    # a dtype the kernel has no build of
    with pytest.raises(ValueError, match="float32/float64, got torch.float16"):
        fluxes(**{**ops, "psiq": ops["psiq"].half()})
    # one operand of another dtype than the rest
    fx = ops["avg_faces"].x
    mixed = ops["avg_faces"]._replace(x=fx._replace(muL=fx.muL.float()))
    with pytest.raises(ValueError, match=r"avg_faces\.x\.muL is torch.float32"):
        fluxes(**{**ops, "avg_faces": mixed})
    # a non-contiguous operand
    gx = ops["geom_faces"].x
    strided = gx._replace(jac=gx.jac.transpose(0, 1).contiguous().transpose(0, 1))
    assert not strided.jac.is_contiguous()
    with pytest.raises(ValueError, match=r"geom_faces\.x\.jac is not contiguous"):
        fluxes(**{**ops, "geom_faces": ops["geom_faces"]._replace(x=strided)})
    # an operand of another shape
    short = ops["geom_faces"]._replace(y=ops["geom_faces"].y._replace(
        P_ref_edge=ops["geom_faces"].y.P_ref_edge[:-1]))
    with pytest.raises(ValueError, match=r"geom_faces\.y\.P_ref_edge has shape"):
        fluxes(**{**ops, "geom_faces": short})
    # more layers than a column carries
    with pytest.raises(ValueError, match="at most 64 layers, got 65"):
        fluxes(**{**ops, "alpha": torch.ones(65, dtype=torch.float64)})
    assert fluxes.launches == launches


@pytest.mark.parametrize("nlayers", [5, 10])
def test_cuda_wrapper_takes_more_layers_than_its_register_build(nlayers):
    """Above the 4 layers a column keeps in registers the kernel carries
    them in local memory: operands of 5 and 10 layers pass every check
    but the device's."""
    ops = _wrapper_operands(nlayers)
    assert ops["alpha"].shape == (nlayers,)
    with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
        bcl_flux.bcl_momentum_fluxes_cuda(**ops)


def test_a_mesh_read_from_a_file_gives_the_kernel_operands_it_takes(tmp_path, monkeypatch):
    """A deformed mesh with bathymetry from an MSH file: the operands a
    step hands to the face fluxes pass every check of the CUDA wrapper
    but the device's: the mesh's host tables are transposed arrays, and
    the kernel takes only contiguous operands."""
    from test_gmsh import make_msh

    path = tmp_path / "basin.msh"
    make_msh(path, 6, 5, (0.0, 2.0e6), (0.0, 2.0e6), deform=0.2,
             bathy=lambda x, y: -9928.0 + 1500.0 * np.exp(-((x - 1e6) ** 2 + (y - 1e6) ** 2)
                                                          / 4e5 ** 2))
    m = TorchModel(_small(dtype="float32", lread_external_grid=True, mesh_file=str(path),
                          lread_external_bathy=True), device="cpu")
    assert not m.static.uniform_geom
    seen = []

    def spy(*ops):
        seen.append(ops)
        return bcl_flux.bcl_momentum_fluxes_plain(*ops)

    monkeypatch.setattr(t_bcl, "bcl_momentum_fluxes_plain", spy)
    m.step(m.state0)
    assert len(seen) == 2
    for ops in seen:
        with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
            bcl_flux.bcl_momentum_fluxes_cuda(*ops)


def test_kernel_sources_follow_the_path_and_a_cpu_model_builds_none(monkeypatch):
    """model.kernel_sources names the sources of the kernels a step on each
    barotropic path launches, the baroclinic layer momentum's with them
    (face fluxes, volume term, and the nodal-family viscosity where it is
    on), and none under impl="plain"; a CPU model compiles nothing."""
    from types import SimpleNamespace

    import hnumo_tpu_torch.model as model

    def no_build(names):
        raise AssertionError(f"a CPU model built {names}")

    monkeypatch.setattr(model, "build_libraries", no_build)
    assert model.kernel_sources(TorchModel(_small(), device="cpu").static) == []
    k = dict(impl="kernel", use_visc=True, method_visc=2)
    paths = {"per-stage": dict(mega=False, fused_tail=False, uni_volume=False),
             "uniform volume": dict(mega=False, fused_tail=False, uni_volume=True),
             "fused": dict(mega=False, fused_tail=True, uni_volume=True),
             "mega": dict(mega=True, fused_tail=False, uni_volume=False)}
    bcl = ["bcl_flux", "bcl_mom_volume", "bcl_visc"]
    want = {"per-stage": ["btp_volume"] + bcl,
            "uniform volume": ["btp_volume_uni"] + bcl,
            "fused": ["btp_volume_uni", "btp_faces", "btp_update"] + bcl,
            "mega": ["btp_mega"] + bcl}
    for name, flags in paths.items():
        assert model.kernel_sources(SimpleNamespace(**flags, **k)) == want[name]
        assert model.kernel_sources(SimpleNamespace(**flags, **{**k, "impl": "plain"})) == []
    # no viscosity, or the quad family's: no nodal viscosity kernel
    for visc in (dict(use_visc=False), dict(method_visc=1)):
        flags = SimpleNamespace(**paths["mega"], **{**k, **visc})
        assert model.kernel_sources(flags) == ["btp_mega", "bcl_flux", "bcl_mom_volume"]


def test_wrapper_and_source_agree_on_limits_and_the_symbol_stays_generic():
    """MAX_LAYERS / MAX_NQ are the source's LMAX / MAX_THREADS, and the
    kernel's symbol is none of the barotropic kernels' that the benchmark
    and the bench tool count as such (so its time stays in
    other_device_ms_per_step)."""
    from hnumo_tpu_torch.ops import _build
    from hnumo_tpu_torch.tools._measure import KERNEL_SYMBOLS
    from portbench.bounds import KERNEL_SYMBOLS as BENCH_SYMBOLS

    src = (pathlib.Path(_build.CSRC_DIR) / "bcl_flux.cu").read_text()
    assert re.search(r"constexpr int LMAX = (\d+);", src).group(1) == str(bcl_flux.MAX_LAYERS)
    assert (re.search(r"constexpr int MAX_THREADS = (\d+);", src).group(1)
            == str(bcl_flux.MAX_NQ))
    assert "bcl_flux_kernel(" in src
    for sym in list(KERNEL_SYMBOLS.values()) + list(BENCH_SYMBOLS.values()):
        assert sym not in "bcl_flux_kernel"
    assert [f.name for f in _build.source_files("bcl_flux")] == ["bcl_flux.cu"]
