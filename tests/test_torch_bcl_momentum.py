"""ops/bcl_mom_volume and ops/bcl_visc: the baroclinic layer-momentum
volume term (core/bcl.layer_momentum_volume) and the nodal-family
baroclinic viscosity (core/viscosity.bcl_nodal_laplacian), each as a CUDA
kernel and its plain version.

On the CPU: the plain versions, through those two functions, give bit for
bit what the functions gave before their bodies moved (portbench/reference
keeps frozen copies of them that import nothing of the port), and the JAX
package's functions within 1e-12 (f64) on the same tables and inputs; over
1-3, 5 and 10 layers, walls and x-periodic sides, p=4 with exact and
inexact integration and p=8, and the reference's stress slip at 2 and 3
layers, on a 3x2 grid. A CPU model resolves `flux_impl` to the plain
versions and builds no kernel; the CUDA wrappers refuse what they do not
take. The kernels themselves are held against the plain versions on the
card (chip_smoke.py phase 32).
"""
import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnumo_tpu.core import bcl as j_bcl
from hnumo_tpu.core import types as j_types
from hnumo_tpu.core import viscosity as j_visc
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.core import bcl as t_bcl
from hnumo_tpu_torch.core import types as t_types
from hnumo_tpu_torch.core import viscosity as t_visc
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.ops import bcl_mom_volume, bcl_visc
from portbench.reference.core import bcl as frozen_bcl
from portbench.reference.core import viscosity as frozen_visc
from test_torch_bcl_flux import CASES, GRID, LAYERS, _small, averages, flux_inputs
from test_torch_common import assert_close, jax_config, to_np, torch_config

STRESS_SLIP = dict(compat_reference_stress=True)
MOMENTUM_CASES = CASES + [("L2-stress-slip", STRESS_SLIP),
                          ("L3-stress-slip", dict(**LAYERS[3], **STRESS_SLIP))]


def momentum_inputs(P, g, nlayers: int, seed: int):
    """Numpy inputs of the two functions at the sizes of (P, g): the face
    averages of test_torch_bcl_flux.flux_inputs with LDG gradient traces,
    element averages around the reference state (mu ~ 1e-3, barotropic
    velocities ~ 0.1 m/s, momentum fluxes and dH of the reference's size),
    layer momenta of ~0.1 m/s times the thickness, and the viscosity's
    coupling fields (thicknesses off the reference, velocity gradients of
    ~1e-6 /s). Returns (qprime_df, q_df, avg fields, face averages x, y,
    coupling fields)."""
    qp, fx, fy, _ = flux_inputs(P, g, nlayers, seed)
    rng = np.random.default_rng(seed + 1)
    dref = np.asarray(P.dpp_ref_df)
    nod, quad = dref.shape[1:], np.asarray(P.pbprime).shape
    for fa in (fx, fy):
        shape = fa["gvL"].shape
        fa["gvL"], fa["gvR"] = 1e-6 * rng.normal(size=shape), 1e-6 * rng.normal(size=shape)
    q_df = np.stack([1e-3 * dref * rng.normal(size=dref.shape),
                     0.1 * dref * rng.normal(size=dref.shape),
                     0.1 * dref * rng.normal(size=dref.shape)])
    mu, mu_df = 1e-3 * rng.normal(size=quad), 1e-3 * rng.normal(size=nod)
    pb, href = np.asarray(P.pbprime), np.asarray(P.H_bcl_ref)
    avg = dict(dH=1e-3 * href * rng.normal(size=quad),
               **{k: 1e-2 * pb * rng.normal(size=quad) for k in ("Qu", "Qv", "Quv", "mfU",
                                                                 "mfV")},
               mu=mu, mu2=mu * (2.0 + mu),
               **{k: 0.1 * rng.normal(size=quad) for k in ("ub", "vb")},
               **{k: 1e-4 * rng.normal(size=quad) for k in ("tbU", "tbV")},
               mu2_df=mu_df * (2.0 + mu_df),
               **{k: 0.1 * rng.normal(size=nod) for k in ("ub_df", "vb_df")},
               graduvb=1e-6 * rng.normal(size=(4,) + nod))
    dpv = dref * (1.0 + 1e-3 * rng.normal(size=dref.shape))
    faces = {d: np.asarray(getattr(P.faces, d).nx_df).shape for d in "xy"}
    # the traces of dpp_graduv (4 channels) and of dpprime_visc
    scale = np.array([1e-6] * 4 + [1.0]).reshape(5, 1, 1, 1, 1, 1) * dref.mean()
    coup = dict(dpprime_visc=dpv, dpp_graduv=dpv[None] * 1e-6 * rng.normal(size=(4,) + dref.shape),
                graduv_dpp_face={d: rng.normal(size=(5, 2, nlayers) + faces[d]) * scale
                                 for d in "xy"})
    return qp, q_df, avg, fx, fy, coup


def full_averages(types, avg, fx, fy, cast):
    """A BtpAverages of `types` from numpy fields."""
    faces = averages(types, fx, fy, cast).faces
    return types.BtpAverages(**{k: cast(v) for k, v in avg.items()}, faces=faces)


def coupling(types, coup, cast):
    """A CouplingFields of `types` whose viscosity fields are `coup`'s; the
    fields bcl_nodal_laplacian does not read are zero."""
    zero = cast(np.zeros(()))
    gf = coup["graduv_dpp_face"]
    return types.CouplingFields(**{
        **{f: zero for f in types.CouplingFields._fields},
        "dpprime_visc": cast(coup["dpprime_visc"]), "dpp_graduv": cast(coup["dpp_graduv"]),
        "graduv_dpp_face": types.Pair(cast(gf["x"]), cast(gf["y"]))})


@pytest.fixture(scope="module", params=MOMENTUM_CASES, ids=[c[0] for c in MOMENTUM_CASES])
def case(request):
    """The JAX model and the port's on the JAX model's tables (f64), and one
    set of inputs."""
    over = {**GRID, **request.param[1]}
    jm = JaxModel(jax_config(**over))
    P_np, g_np, s_np = to_np(jm.P), to_np(jm.g), to_np(jm.state0)
    inputs = momentum_inputs(P_np, g_np, over.get("nlayers", 2), seed=23)
    return over, jm, (P_np, g_np, s_np), inputs


def torch_model(over, tables, dtype):
    P, g, s = from_numpy_tables(*tables, "cpu", dtype)
    return TorchModel.from_tables(torch_config(**over, dtype="float64" if dtype == torch.float64
                                               else "float32"), P, g, s, device="cpu")


def torch_run(over, tables, inputs, dtype, which, fn):
    """`fn` of the volume term ("volume") or of the viscosity ("visc") on the
    port's model and `inputs` in `dtype`."""
    tm = torch_model(over, tables, dtype)
    qp, q_df, avg, fx, fy, coup = inputs

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    a = full_averages(t_types, avg, fx, fy, cast)
    if which == "volume":
        return fn(tm.static, tm.P, tm.g, a, cast(qp), cast(q_df)), tm
    return fn(tm.static, tm.P, tm.g, tm.bc, coupling(t_types, coup, cast), a), tm


FUNCTIONS = {"volume": (t_bcl.layer_momentum_volume, frozen_bcl.layer_momentum_volume,
                        bcl_mom_volume.bcl_mom_volume_plain),
             "visc": (t_visc.bcl_nodal_laplacian, frozen_visc.bcl_nodal_laplacian,
                      bcl_visc.bcl_visc_plain)}


@pytest.mark.parametrize("which", ["volume", "visc"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_versions_are_the_functions_before_the_move(case, dtype, which):
    over, _, tables, inputs = case
    fn, frozen, plain = FUNCTIONS[which]
    calls = plain.calls
    got, tm = torch_run(over, tables, inputs, dtype, which, fn)
    assert tm.static.flux_impl == "plain"
    assert plain.calls == calls + 1
    want, _ = torch_run(over, tables, inputs, dtype, which, frozen)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", ["volume", "visc"])
def test_plain_versions_match_the_jax_package(case, which):
    over, jm, tables, inputs = case
    got, _ = torch_run(over, tables, inputs, torch.float64, which, FUNCTIONS[which][0])
    qp, q_df, avg, fx, fy, coup = inputs
    a = full_averages(j_types, avg, fx, fy, jnp.asarray)
    if which == "volume":
        want = j_bcl.layer_momentum_volume(jm.static, jm.P, jm.g, a, jnp.asarray(qp),
                                           jnp.asarray(q_df))
    else:
        want = j_visc.bcl_nodal_laplacian(jm.static, jm.P, jm.g, jm.bc,
                                          coupling(j_types, coup, jnp.asarray), a)
    assert_close(got, np.asarray(want), 1e-12, FUNCTIONS[which][0].__name__)


def test_the_stress_slip_moves_the_volume_term():
    """The reference's slip in the stress distribution is a different
    function of the same inputs: the stress-slip cases test a path of
    their own."""
    jm = JaxModel(jax_config(**GRID))
    tables = to_np(jm.P), to_np(jm.g), to_np(jm.state0)
    inputs = momentum_inputs(tables[0], tables[1], 2, seed=29)
    fn = t_bcl.layer_momentum_volume
    plain, _ = torch_run(GRID, tables, inputs, torch.float64, "volume", fn)
    slip, _ = torch_run({**GRID, **STRESS_SLIP}, tables, inputs, torch.float64, "volume", fn)
    # the stress terms are a small part of the whole; their change stands
    # far above the f64 rounding of the whole (~1e-16 of its max)
    assert float((plain - slip).abs().max()) > 1e-10 * float(plain.abs().max())


def test_cpu_model_takes_the_plain_versions_twice_a_step():
    m = TorchModel(_small(method_visc=2, visc_mlswe=100.0), device="cpu")
    assert m.static.flux_impl == "plain" and m.static.use_visc
    plains = (bcl_mom_volume.bcl_mom_volume_plain, bcl_visc.bcl_visc_plain)
    cudas = (bcl_mom_volume.bcl_mom_volume_cuda, bcl_visc.bcl_visc_cuda)
    calls = [f.calls for f in plains]
    launches = [f.launches for f in cudas]
    m.step(m.state0)
    assert [f.calls for f in plains] == [c + 2 for c in calls]    # predictor, corrector
    assert [f.launches for f in cudas] == launches


def test_the_quad_family_keeps_its_own_laplacian():
    """method_visc == 1 takes bcl_quad_laplacian, never the nodal kernel."""
    m = TorchModel(_small(method_visc=1, visc_mlswe=100.0), device="cpu")
    calls = bcl_visc.bcl_visc_plain.calls
    m.step(m.state0)
    assert bcl_visc.bcl_visc_plain.calls == calls


def _wrapper_operands(nlayers: int = 2, **over):
    """The two functions' operands on the 3x2 grid (f64), from a CPU model."""
    m = TorchModel(_small(dtype="float64", method_visc=2, visc_mlswe=100.0, **LAYERS[nlayers],
                          **over), device="cpu")
    qp, q_df, avg, fx, fy, coup = momentum_inputs(to_np(m.P), to_np(m.g), nlayers, seed=3)

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    a = full_averages(t_types, avg, fx, fy, cast)
    vol = dict(static=m.static, P=m.P, g=m.g, avg=a, qprime_df=cast(qp), q_df=cast(q_df))
    visc = dict(static=m.static, P=m.P, g=m.g, bc=m.bc, coup=coupling(t_types, coup, cast),
                avg=a)
    return vol, visc


def test_volume_wrapper_refuses_what_the_kernel_does_not_take():
    vol, _ = _wrapper_operands()
    fn = bcl_mom_volume.bcl_mom_volume_cuda
    launches = fn.launches
    with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
        fn(**vol)
    g16 = vol["g"]._replace(psiq=vol["g"].psiq.half())
    with pytest.raises(ValueError, match="float32/float64, got torch.float16"):
        fn(**{**vol, "g": g16})
    mixed = vol["avg"]._replace(mu=vol["avg"].mu.float())
    with pytest.raises(ValueError, match=r"avg\.mu is torch.float32"):
        fn(**{**vol, "avg": mixed})
    strided = vol["g"]._replace(wjac=vol["g"].wjac.transpose(-1, -2).contiguous()
                                .transpose(-1, -2))
    assert not strided.wjac.is_contiguous()
    with pytest.raises(ValueError, match=r"g\.wjac is not contiguous"):
        fn(**{**vol, "g": strided})
    short = vol["P"]._replace(P_ref_q=vol["P"].P_ref_q[:-1])
    with pytest.raises(ValueError, match=r"P\.P_ref_q has shape"):
        fn(**{**vol, "P": short})
    with pytest.raises(ValueError, match=r"q_df has shape"):
        fn(**{**vol, "q_df": vol["q_df"][1:]})
    many = vol["P"]._replace(alpha=torch.ones(65, dtype=torch.float64))
    with pytest.raises(ValueError, match="at most 64 layers, got 65"):
        fn(**{**vol, "P": many, "static": dataclasses.replace(vol["static"], nlayers=65)})
    assert fn.launches == launches


def test_volume_wrapper_bounds_layers_stress_slip_and_quadrature():
    fn = bcl_mom_volume.bcl_mom_volume_cuda
    vol, _ = _wrapper_operands(5)
    slip = dataclasses.replace(vol["static"], compat_reference_stress=True)
    with pytest.raises(ValueError, match="compat_reference_stress takes at most 3 layers"):
        fn(**{**vol, "static": slip})
    # 5 layers pass every check but the device's: they go to local memory
    with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
        fn(**vol)
    p9, _ = _wrapper_operands(2, nopx=9, nopy=9)
    assert p9["g"].psiq.shape[1] > bcl_mom_volume.MAX_NQ
    with pytest.raises(ValueError, match=f"at most {bcl_mom_volume.MAX_NQ} quadrature"):
        fn(**p9)


def test_visc_wrapper_refuses_what_the_kernel_does_not_take():
    _, visc = _wrapper_operands()
    fn = bcl_visc.bcl_visc_cuda
    launches = fn.launches
    with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
        fn(**visc)
    g16 = visc["g"]._replace(dpsi=visc["g"].dpsi.half())
    with pytest.raises(ValueError, match="float32/float64, got torch.float16"):
        fn(**{**visc, "g": g16})
    gf = visc["coup"].graduv_dpp_face
    short = visc["coup"]._replace(graduv_dpp_face=gf._replace(y=gf.y[:, :, :, 1:]))
    with pytest.raises(ValueError, match=r"coup\.graduv_dpp_face\.y has shape"):
        fn(**{**visc, "coup": short})
    fx = visc["avg"].faces.x
    mixed = visc["avg"]._replace(faces=visc["avg"].faces._replace(x=fx._replace(
        gvR=fx.gvR.float())))
    with pytest.raises(ValueError, match=r"avg\.faces\.x\.gvR is torch.float32"):
        fn(**{**visc, "avg": mixed})
    # gvL / gvR need each channel contiguous: a transposed face axis is refused
    bad = fx.gvL.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not bad[0].is_contiguous()
    odd = visc["avg"]._replace(faces=visc["avg"].faces._replace(x=fx._replace(gvL=bad)))
    with pytest.raises(ValueError, match=r"avg\.faces\.x\.gvL is not contiguous"):
        fn(**{**visc, "avg": odd})
    strided = visc["g"]._replace(massinv=visc["g"].massinv.transpose(-1, -2).contiguous()
                                 .transpose(-1, -2))
    with pytest.raises(ValueError, match=r"g\.massinv is not contiguous"):
        fn(**{**visc, "g": strided})
    assert fn.launches == launches


def test_visc_wrapper_takes_the_flat_paths_face_averages(monkeypatch):
    """On the per-stage and fused paths the face averages' gvL / gvR are
    views of one accumulator of both directions (channels apart, each
    contiguous): the operands a step hands the viscosity pass every check of
    the CUDA wrapper but the device's."""
    m = TorchModel(_small(method_visc=2, visc_mlswe=100.0), device="cpu")
    assert not m.static.mega
    seen = []

    def spy(*ops):
        seen.append(ops)
        return bcl_visc.bcl_visc_plain(*ops)

    monkeypatch.setattr(t_visc, "bcl_visc_plain", spy)
    m.step(m.state0)
    assert len(seen) == 2
    assert not seen[0][5].faces.x.gvL.is_contiguous()
    for ops in seen:
        with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
            bcl_visc.bcl_visc_cuda(*ops)


@pytest.mark.parametrize("config", [dict(), dict(dtype="float32"), dict(nelx=5, nely=4),
                                    dict(mega="on"), dict(fused_tail="on")],
                         ids=["f64", "f32", "5x4", "mega", "fused"])
def test_a_step_gives_the_volume_kernel_operands_it_takes(config, monkeypatch):
    """The operands a step hands the volume term pass every check of the
    CUDA wrapper but the device's, on every barotropic path, in f32 (whose
    δ-form tables are recomputed on the device) and on grids whose host
    metric tables are strided views."""
    m = TorchModel(_small(method_visc=2, visc_mlswe=100.0, **config), device="cpu")
    seen = []

    def spy(*ops):
        seen.append(ops)
        return bcl_mom_volume.bcl_mom_volume_plain(*ops)

    monkeypatch.setattr(t_bcl, "bcl_mom_volume_plain", spy)
    m.step(m.state0)
    assert len(seen) == 2
    for ops in seen:
        with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
            bcl_mom_volume.bcl_mom_volume_cuda(*ops)


SOURCES = {"bcl_mom_volume": (bcl_mom_volume, "bcl_mom_volume_kernel"),
           "bcl_visc": (bcl_visc, "bcl_visc_kernel")}


@pytest.mark.parametrize("name", list(SOURCES))
def test_wrapper_and_source_agree_and_the_symbol_stays_generic(name):
    """The wrapper's limits are the source's, its operand list has the
    source's length, and the kernel's symbol is none of the barotropic
    kernels' that the benchmark and the bench tool count as such (so its time
    stays in other_device_ms_per_step)."""
    from hnumo_tpu_torch.ops import _build
    from hnumo_tpu_torch.tools._measure import KERNEL_SYMBOLS
    from portbench.bounds import KERNEL_SYMBOLS as BENCH_SYMBOLS

    module, symbol = SOURCES[name]
    src = (pathlib.Path(_build.CSRC_DIR) / f"{name}.cu").read_text()
    limits = {"bcl_mom_volume": (("LMAX", "MAX_LAYERS"), ("MAX_NQ", "MAX_NQ")),
              "bcl_visc": (("MAX_NGL", "MAX_NGL"),)}[name]
    for const, attr in limits:
        assert re.search(rf"constexpr int {const} = (\d+);", src).group(1) == \
            str(getattr(module, attr))
    enum = re.search(r"enum \{\n(.*?)\n\s*NIN\n\};", src, re.S).group(1)
    names = re.findall(r"\bk[A-Z]\w*", re.sub(r"//[^\n]*", "", enum))
    assert len(names) == len(module.OPERANDS)
    assert f"{symbol}(" in src
    for sym in list(KERNEL_SYMBOLS.values()) + list(BENCH_SYMBOLS.values()):
        assert sym not in symbol
    assert [f.name for f in _build.source_files(name)] == [f"{name}.cu"]
