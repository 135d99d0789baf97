"""ops/bcl_mass: the thickness update of the baroclinic step
(core/stepper._thickness_update: the layer mass update, the
negative-thickness check and the mass consistency) as two CUDA kernels and
their plain version.

On the CPU: the plain version, through _thickness_update, gives bit for bit
what the update gave before its body moved (portbench/reference keeps frozen
copies of it that import nothing of the port), and the JAX package's
_thickness_update within 1e-12 (f64) on the same tables and inputs, its `ok`
alike; over free-slip, no-slip and copy walls, periodic x and y sides, 1, 2,
5 and 20 layers, p=4 and p=8, on a 3x2 grid, and on each block of an 8x8
grid split 2x2 over gloo ranks (bit for bit the serial update, the `ok` of
a negative thickness in one block and-reduced to every rank). A CPU model
takes the plain version twice a step and builds no kernel; the CUDA wrapper
refuses what it does not take. The kernels themselves are held against the
plain version on the card (chip_smoke.py phase 33).
"""
import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_decomp_ranks as R
from hnumo_tpu.core import bcl as j_bcl
from hnumo_tpu.core import stepper as j_stepper
from hnumo_tpu.core import types as j_types
from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.core import bcl as t_bcl
from hnumo_tpu_torch.core import stepper as t_stepper
from hnumo_tpu_torch.core import types as t_types
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.ops import bcl_mass
from hnumo_tpu_torch.parallel.launch import start_function
from portbench.reference.core import stepper as frozen_stepper
from test_torch_bcl_flux import _small
from test_torch_common import assert_close, jax_config, to_np, torch_config
from test_torch_common import one_thread  # noqa: F401  (autouse)

TESTS = pathlib.Path(__file__).resolve().parent
GRID = dict(nelx=3, nely=2)
# the double gyre has 2 layers; the lake at rest takes any number
LAKE = dict(test_case="lakeatrest")
NO_SLIP = dict(x_boundary=(2, 0), y_boundary=(2, 2))     # no-slip and copy walls
XPER = dict(x_boundary=(3, 3), y_boundary=(4, 4))
YPER = dict(x_boundary=(4, 4), y_boundary=(3, 3))
# (id, config overrides)
CASES = [("L2-free-slip", {}), ("L2-no-slip", NO_SLIP), ("L2-xper", XPER),
         ("L2-yper", YPER), ("L1-free-slip", dict(nlayers=1, **LAKE)),
         ("L5-xper", dict(nlayers=5, **LAKE, **XPER)),
         ("L20-no-slip", dict(nlayers=20, **LAKE, **NO_SLIP)),
         ("L2-p8", dict(nopx=8, nopy=8)),
         ("L5-yper-p8", dict(nlayers=5, **LAKE, **YPER, nopx=8, nopy=8))]


def mass_inputs(P, seed: int):
    """Numpy inputs of the thickness update at the sizes of the tables P
    (numpy or tensors): layer thicknesses ~1e-3 of the reference off it and
    layer momenta of ~0.1 m/s times the thickness (q_df), primes of the same
    sizes (qprime_df), and the barotropic averages the update reads around
    the reference state: mu ~ 1e-3, velocities ~ 0.1 m/s, mass fluxes ~ 0.1
    m/s times the reference pressure, in the elements and on the faces.
    Returns (q_df, qprime_df, element averages, face averages {d: ...})."""
    rng = np.random.default_rng(seed)
    dref = np.asarray(P.dpp_ref_df)
    pb = np.asarray(P.pbprime)

    def n(*shape):
        return rng.normal(size=shape)

    q_df = np.stack([1e-3 * dref * n(*dref.shape), 0.1 * dref * n(*dref.shape),
                     0.1 * dref * n(*dref.shape)])
    qp = np.stack([1e-3 * dref * n(*dref.shape), 0.1 * n(*dref.shape),
                   0.1 * n(*dref.shape)])
    avg = dict(mu=1e-3 * n(*pb.shape), ub=0.1 * n(*pb.shape), vb=0.1 * n(*pb.shape),
               mfU=0.1 * pb * n(*pb.shape), mfV=0.1 * pb * n(*pb.shape))
    faces = {}
    for d in "xy":
        fg = getattr(P.faces, d)
        shape = np.asarray(fg.nx).shape
        pbf = np.asarray(fg.pbprime_face_L)
        faces[d] = dict(**{k: 0.1 * n(*shape) for k in ("ubL", "ubR", "vbL", "vbR")},
                        **{k: 1e-3 * n(*shape) for k in ("muL", "muR")},
                        **{k: 0.1 * pbf * n(*shape) for k in ("fluxU", "fluxV")})
    return q_df, qp, avg, faces


def averages(types, avg, faces, cast):
    """A BtpAverages of `types` whose fields the update reads are `avg`'s and
    `faces`' (numpy, cast by `cast`), the others zero."""
    zero = cast(np.zeros(()))

    def face(fa):
        return types.BtpFaceAvg(**{f: cast(fa[f]) if f in fa else zero
                                   for f in types.BtpFaceAvg._fields})

    return types.BtpAverages(**{f: cast(avg[f]) if f in avg else zero
                                for f in types.BtpAverages._fields if f != "faces"},
                             faces=types.Pair(face(faces["x"]), face(faces["y"])))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """The JAX model and the port's on the JAX model's tables (f64), and one
    set of inputs."""
    over = {**GRID, **request.param[1]}
    jm = JaxModel(jax_config(**over))
    P_np, g_np, s_np = to_np(jm.P), to_np(jm.g), to_np(jm.state0)
    return over, jm, (P_np, g_np, s_np), mass_inputs(P_np, seed=53)


def torch_run(over, tables, inputs, dtype, fn):
    """`fn` (the thickness update's signature) on the port's model of the
    tables and `inputs` in `dtype`; returns ((q_df, ok), model)."""
    P, g, s = from_numpy_tables(*tables, "cpu", dtype)
    tm = TorchModel.from_tables(torch_config(**over, dtype="float64" if dtype == torch.float64
                                             else "float32"), P, g, s, device="cpu")
    q_df, qp, avg, faces = inputs

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    qpt = cast(qp)
    qpf = t_bcl.extract_qprime_faces(tm.bc, qpt)
    return fn(tm.static, tm.P, tm.g, tm.bc, averages(t_types, avg, faces, cast), cast(q_df),
              qpt, qpf), tm


def jax_run(jm, inputs):
    q_df, qp, avg, faces = inputs
    qpj = jnp.asarray(qp)
    return j_stepper._thickness_update(
        jm.static, jm.P, jm.g, jm.bc, averages(j_types, avg, faces, jnp.asarray),
        jnp.asarray(q_df), qpj, j_bcl.extract_qprime_faces(jm.bc, qpj))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_update_is_the_update_before_the_move(case, dtype):
    over, _, tables, inputs = case
    calls = bcl_mass.bcl_mass_plain.calls
    (q, ok), tm = torch_run(over, tables, inputs, dtype, t_stepper._thickness_update)
    assert tm.static.impl == "plain"
    assert bcl_mass.bcl_mass_plain.calls == calls + 1
    (q_want, ok_want), _ = torch_run(over, tables, inputs, dtype,
                                     frozen_stepper._thickness_update)
    assert q.dtype == dtype and q.shape == q_want.shape
    assert torch.equal(q, q_want)
    assert ok.dtype == torch.bool and bool(ok) and bool(ok_want)


def test_plain_update_matches_the_jax_package(case):
    over, jm, tables, inputs = case
    (q, ok), _ = torch_run(over, tables, inputs, torch.float64, t_stepper._thickness_update)
    q_want, ok_want = jax_run(jm, inputs)
    assert_close(q, np.asarray(q_want), 1e-12, "_thickness_update")
    assert bool(ok) is bool(ok_want) is True


@pytest.mark.parametrize("where", [(0,) * 5, (-1,) * 5],
                         ids=["first-node", "last-node"])
def test_ok_turns_false_on_a_negative_full_thickness(where):
    """One node of one layer whose full thickness the mass update leaves
    negative: the check says so, as the JAX package's does; the rest of the
    update goes on as before."""
    over = {**GRID, **LAKE, "nlayers": 3}
    jm = JaxModel(jax_config(**over))
    tables = to_np(jm.P), to_np(jm.g), to_np(jm.state0)
    q_df, qp, avg, faces = mass_inputs(tables[0], seed=59)
    q_df = q_df.copy()
    q_df[(0,) + where] = -2.0 * np.asarray(tables[0].dpp_ref_df)[where]
    inputs = (q_df, qp, avg, faces)
    for dtype in (torch.float64, torch.float32):
        (q, ok), _ = torch_run(over, tables, inputs, dtype, t_stepper._thickness_update)
        assert ok.dtype == torch.bool and not bool(ok)
        (q_want, _), _ = torch_run(over, tables, inputs, dtype,
                                   frozen_stepper._thickness_update)
        assert torch.equal(q, q_want)
    assert not bool(jax_run(jm, inputs)[1])


def test_cpu_model_takes_the_plain_version_twice_a_step():
    m = TorchModel(_small(), device="cpu")
    assert m.static.impl == "plain"
    calls = bcl_mass.bcl_mass_plain.calls
    launches = bcl_mass.bcl_mass_cuda.launches
    m.step(m.state0)
    assert bcl_mass.bcl_mass_plain.calls == calls + 2    # predictor, corrector
    assert bcl_mass.bcl_mass_cuda.launches == launches


def _wrapper_operands(**over):
    """The update's operands on the 3x2 grid (f64), from a CPU model."""
    m = TorchModel(_small(dtype="float64", **over), device="cpu")
    q_df, qp, avg, faces = mass_inputs(m.P, seed=3)

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    qpt = cast(qp)
    return dict(static=m.static, P=m.P, g=m.g, bc=m.bc,
                avg=averages(t_types, avg, faces, cast), q_df=cast(q_df), qprime_df=qpt,
                qprime_faces=t_bcl.extract_qprime_faces(m.bc, qpt))


def test_cuda_wrapper_refuses_what_the_kernels_do_not_take():
    ops = _wrapper_operands()
    fn = bcl_mass.bcl_mass_cuda
    launches = fn.launches
    # everything right but the device
    with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
        fn(**ops)
    # a dtype the kernels have no build of
    g16 = ops["g"]._replace(psiq=ops["g"].psiq.half())
    with pytest.raises(ValueError, match="float32/float64, got torch.float16"):
        fn(**{**ops, "g": g16})
    # one operand of another dtype than the rest
    fx = ops["avg"].faces.x
    mixed = ops["avg"]._replace(faces=ops["avg"].faces._replace(x=fx._replace(
        fluxU=fx.fluxU.float())))
    with pytest.raises(ValueError, match=r"avg\.faces\.x\.fluxU is torch.float32"):
        fn(**{**ops, "avg": mixed})
    # a non-contiguous operand
    strided = ops["g"]._replace(massinv=ops["g"].massinv.transpose(-1, -2).contiguous()
                                .transpose(-1, -2))
    assert not strided.massinv.is_contiguous()
    with pytest.raises(ValueError, match=r"g\.massinv is not contiguous"):
        fn(**{**ops, "g": strided})
    tr = ops["qprime_faces"][1]
    odd = (ops["qprime_faces"][0], tr._replace(yr=tr.yr.transpose(0, 1).contiguous()
                                               .transpose(0, 1)), ops["qprime_faces"][2])
    with pytest.raises(ValueError, match=r"qprime_faces\.1\.yr is not contiguous"):
        fn(**{**ops, "qprime_faces": odd})
    # operands of another shape
    gy = ops["P"].faces.y
    short = ops["P"]._replace(faces=ops["P"].faces._replace(y=gy._replace(
        dpp_ref_face_q=gy.dpp_ref_face_q[1:])))
    with pytest.raises(ValueError, match=r"P\.faces\.y\.dpp_ref_face_q has shape"):
        fn(**{**ops, "P": short})
    with pytest.raises(ValueError, match=r"q_df has shape"):
        fn(**{**ops, "q_df": ops["q_df"][1:]})
    with pytest.raises(ValueError, match=r"avg\.mfV has shape"):
        fn(**{**ops, "avg": ops["avg"]._replace(mfV=ops["avg"].mfV[:1])})
    # more layers than the kernels take
    many = ops["P"]._replace(dpp_ref_df=torch.ones((65,) + ops["P"].dpp_ref_df.shape[1:],
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="at most 64 layers, got 65"):
        fn(**{**ops, "P": many, "static": dataclasses.replace(ops["static"], nlayers=65)})
    assert fn.launches == launches


def test_cuda_wrapper_bounds_quadrature_and_takes_many_layers():
    """Any number of layers up to 64 runs the same build (the layers are
    streamed): 20 layers pass every check but the device's; more quadrature
    points an element side than a block holds do not."""
    fn = bcl_mass.bcl_mass_cuda
    with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
        fn(**_wrapper_operands(nlayers=20, test_case="lakeatrest"))
    p9 = _wrapper_operands(nopx=9, nopy=9)
    assert p9["g"].psiq.shape[1] > bcl_mass.MAX_NQ
    with pytest.raises(ValueError, match=f"at most {bcl_mass.MAX_NQ} quadrature"):
        fn(**p9)


@pytest.mark.parametrize("config", [dict(), dict(dtype="float32"), dict(nelx=5, nely=4),
                                    dict(mega="on"), dict(fused_tail="on"),
                                    dict(x_boundary=(3, 3), fused_tail="on")],
                         ids=["f64", "f32", "5x4", "mega", "fused", "xper-fused"])
def test_a_step_gives_the_kernels_operands_they_take(config, monkeypatch):
    """The operands a step hands the thickness update pass every check of
    the CUDA wrapper but the device's, on every barotropic path (whose
    averages are views of its accumulators), in f32 and on grids whose host
    metric tables are strided views."""
    m = TorchModel(_small(method_visc=2, visc_mlswe=100.0, **config), device="cpu")
    seen = []

    def spy(*ops):
        seen.append(ops)
        return bcl_mass.bcl_mass_plain(*ops)

    monkeypatch.setattr(t_stepper, "bcl_mass_plain", spy)
    m.step(m.state0)
    assert len(seen) == 2
    for ops in seen:
        with pytest.raises(ValueError, match="takes CUDA tensors, got cpu"):
            bcl_mass.bcl_mass_cuda(*ops)


SYMBOLS = ("bcl_mass_update_kernel", "bcl_mass_consistency_kernel")


def test_wrapper_and_source_agree_and_the_symbols_stay_generic():
    """The wrapper's limits and operand count are the source's, and neither
    kernel's symbol holds one of the barotropic kernels' that the benchmark
    and the bench tool count as such (so their time stays in
    other_device_ms_per_step)."""
    from hnumo_tpu_torch.ops import _build
    from hnumo_tpu_torch.tools._measure import KERNEL_SYMBOLS
    from portbench.bounds import KERNEL_SYMBOLS as BENCH_SYMBOLS

    src = (pathlib.Path(_build.CSRC_DIR) / "bcl_mass.cu").read_text()
    for const, attr in (("LMAX", "MAX_LAYERS"), ("MAX_NQ", "MAX_NQ")):
        assert re.search(rf"constexpr int {const} = (\d+);", src).group(1) == \
            str(getattr(bcl_mass, attr))

    def enum(last):
        body = next(b for b in src.split("enum {")[1:] if re.search(rf"\n\s*{last}\n\}};", b))
        body = body.split("};")[0]
        return re.findall(r"\b[kf][A-Z]\w*", re.sub(r"//[^\n]*", "", body))

    assert len(enum("NEL")) == len(bcl_mass.ELEMENT_OPERANDS)
    assert len(enum("NFD")) == len(bcl_mass.face_operands("x"))
    assert len(bcl_mass.OPERANDS) == len(enum("NEL")) + 2 * len(enum("NFD"))
    for symbol in SYMBOLS:
        assert f"{symbol}(" in src
        for sym in list(KERNEL_SYMBOLS.values()) + list(BENCH_SYMBOLS.values()):
            assert sym not in symbol
    assert [f.name for f in _build.source_files("bcl_mass")] == ["bcl_mass.cu"]


# ---- the blocks of a decomposition ---------------------------------------------

SPLIT_CASES = [("no-slip", dict(x_boundary=(2, 0), y_boundary=(4, 4))),
               ("xper", dict(x_boundary=(3, 3))), ("yper", dict(y_boundary=(3, 3)))]


@pytest.fixture(scope="module")
def split():
    """Each case's inputs on R.BUMP's 8x8 grid through the serial port model's
    plain update, and through a 2x2 split of it over gloo ranks (each rank
    its block); one more run of the first case's with one negative full
    thickness in the last block's elements."""
    cases, serial = [], {}
    for name, over in SPLIT_CASES:
        m = TorchModel(R.bump_config(**over), device="cpu")
        inputs = mass_inputs(m.P, seed=61)
        cases.append((name, over, inputs))
        serial[name] = _serial(m, inputs)
    q_df, qp, avg, faces = cases[0][2]
    q_df = q_df.copy()
    q_df[0, -1, -1, -1, 1, 1] = -2.0 * np.asarray(m.P.dpp_ref_df)[-1, -1, -1, 1, 1]
    cases.append(("negative", cases[0][1], (q_df, qp, avg, faces)))
    run = start_function("torch_decomp_ranks:mass_ranks", (2, 2), "gloo", device="cpu",
                         kwargs=dict(cases=cases), pythonpath=[TESTS])
    return cases, serial, run.result(240.0)


def _serial(m, inputs):
    q_df, qp, avg, faces = inputs

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    qpt = cast(qp)
    q, ok = t_stepper._thickness_update(
        m.static, m.P, m.g, m.bc, averages(t_types, avg, faces, cast), cast(q_df), qpt,
        t_bcl.extract_qprime_faces(m.bc, qpt))
    return q.numpy(), bool(ok)


@pytest.mark.parametrize("name", [c[0] for c in SPLIT_CASES])
def test_split_blocks_are_the_serial_update(split, name):
    """Each block's update is the serial update's slice bit for bit, through
    the plain version once, with the 4 halo exchanges of the δdp' traces;
    and the serial update matches the JAX package's within 1e-12."""
    cases, serial, ranks = split
    q_serial, ok_serial = serial[name]
    assert ok_serial
    for r in ranks:
        got = r[name]
        (y0, y1), (x0, x1) = got["bounds"]
        assert got["calls"] == 1 and got["exchanges"] == 4 and got["ok"] and got["local_ok"]
        assert np.array_equal(got["q"], q_serial[..., y0:y1, x0:x1, :, :])
    over, inputs = next((c[1], c[2]) for c in cases if c[0] == name)
    jm = JaxModel(jax_config(**{**R.BUMP, **over}))
    assert_close(q_serial, np.asarray(jax_run(jm, inputs)[0]), 1e-12, name)


def test_split_ok_is_and_reduced_over_the_blocks(split):
    """A negative full thickness in one element of the last block only: that
    block's own check fails, and the and-reduced `ok` is false on every
    rank, as the serial update's."""
    _, serial, ranks = split
    for r in ranks:
        (y0, y1), (x0, x1) = r["negative"]["bounds"]
        assert r["negative"]["local_ok"] is not (y1 == x1 == 8)
        assert r["negative"]["ok"] is False
    assert sorted(r["negative"]["local_ok"] for r in ranks) == [False, True, True, True]
