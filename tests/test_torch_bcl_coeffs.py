"""ops/bcl_coeffs: the barotropic-baroclinic coupling coefficients
(core/coupling.btp_bcl_coeffs) as two CUDA kernels and their plain version.

On the CPU: the plain version, through btp_bcl_coeffs, gives bit for bit
what the function gave before its body moved (portbench/reference keeps a
frozen copy of it that imports nothing of the port), in f64 and f32, over
free-slip, no-slip and copy walls, periodic x and y sides, 1, 2, 5 and 20
layers, p=4 and p=8, inexact integration, viscosity off and the quad
family; a CPU model takes it twice a step and builds no kernel; the CUDA
wrapper refuses what the kernels do not take, and takes what a step hands
it on every barotropic path. On a CUDA card (skipped without one): the
kernels against the plain version over chip_smoke.py phase 34's cases,
each field within 1e-12 (f64) or 2e-5 (f32) of its max.
"""
import dataclasses
import pathlib
import re
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from hnumo_tpu_torch.core import coupling
from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.ops import bcl_coeffs
from portbench.reference.core import coupling as frozen_coupling
from test_torch_bcl_flux import _small
from test_torch_common import one_thread  # noqa: F401  (autouse)

LAKE = dict(test_case="lakeatrest")
NO_SLIP = dict(x_boundary=(2, 0), y_boundary=(2, 2))     # no-slip and copy walls
XPER = dict(x_boundary=(3, 3), y_boundary=(4, 4))
YPER = dict(x_boundary=(4, 4), y_boundary=(3, 3))
VISC = dict(method_visc=2, visc_mlswe=100.0)
# (id, config overrides of _small's 3x2 grid)
CASES = [("L2-free-slip", VISC), ("L2-no-slip", {**VISC, **NO_SLIP}),
         ("L2-xper", {**VISC, **XPER}), ("L2-yper", {**VISC, **YPER}),
         ("L1", dict(nlayers=1, **LAKE, **VISC)),
         ("L5-xper", dict(nlayers=5, **LAKE, **XPER, **VISC)),
         ("L20-no-slip", dict(nlayers=20, **LAKE, **NO_SLIP, **VISC)),
         ("L2-p8", dict(nopx=8, nopy=8, **VISC)),
         ("L2-inexact", dict(dg_integ_exact=False, **VISC)),
         ("L2-visc-off", {}), ("L2-quad-family", dict(method_visc=1, visc_mlswe=100.0))]


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    return request.param[1]


@pytest.mark.parametrize("half", ["predictor", "corrector"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_coeffs_are_the_coeffs_before_the_move(case, dtype, half):
    m = Model(_small(dtype=dtype, **case), device="cpu")
    assert m.static.impl == "plain"
    ops = chip_smoke.coeffs_operands(m, chip_smoke.perturbed_inputs, seed=71,
                                     corrector=half == "corrector")
    calls = bcl_coeffs.bcl_coeffs_plain.calls
    got = coupling.btp_bcl_coeffs(*ops)
    assert bcl_coeffs.bcl_coeffs_plain.calls == calls + 1
    want = frozen_coupling.btp_bcl_coeffs(*ops)
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert _same(a, b), name
    assert got.dpprime_visc is ops[6] and got.dpprime_visc_q is ops[7]


def test_cpu_model_takes_the_plain_version_twice_a_step():
    m = Model(_small(**VISC), device="cpu")
    assert m.static.impl == "plain"
    calls = bcl_coeffs.bcl_coeffs_plain.calls
    launches = bcl_coeffs.bcl_coeffs_cuda.launches
    m.step(m.state0)
    assert bcl_coeffs.bcl_coeffs_plain.calls == calls + 2    # predictor, corrector
    assert bcl_coeffs.bcl_coeffs_cuda.launches == launches


def _wrapper_operands(**over):
    """The coefficients' operands on the 3x2 grid (f64), from a CPU model."""
    m = Model(_small(dtype="float64", **{**VISC, **over}), device="cpu")
    return m, list(chip_smoke.coeffs_operands(m, chip_smoke.perturbed_inputs, seed=3))


def _refused(ops, match):
    with pytest.raises(ValueError, match=match):
        bcl_coeffs.bcl_coeffs_cuda(*ops)


def test_cuda_wrapper_refuses_what_the_kernels_do_not_take():
    m, ops = _wrapper_operands()
    launches = bcl_coeffs.bcl_coeffs_cuda.launches
    # everything right but the device
    _refused(ops, "takes CUDA tensors, got cpu")
    g = ops[2]
    # a dtype the kernels have no build of
    _refused(ops[:2] + [g._replace(psiq=g.psiq.half())] + ops[3:],
             "float32/float64, got torch.float16")
    # one operand of another dtype than the rest
    fx = ops[1].faces.x
    mixed = ops[1]._replace(faces=ops[1].faces._replace(x=fx._replace(
        P_ref_edge=fx.P_ref_edge.float())))
    _refused(ops[:1] + [mixed] + ops[2:], r"P\.faces\.x\.P_ref_edge is torch.float32")
    # a non-contiguous operand
    strided = g._replace(ksi_y=g.ksi_y.transpose(-1, -2).contiguous().transpose(-1, -2))
    assert not strided.ksi_y.is_contiguous()
    _refused(ops[:2] + [strided] + ops[3:], r"g\.ksi_y is not contiguous")
    tr = ops[5][2]
    odd = (ops[5][0], ops[5][1], tr._replace(xl=tr.xl.transpose(0, 1).contiguous()
                                             .transpose(0, 1)))
    _refused(ops[:5] + [odd] + ops[6:], r"qprime_faces\.2\.xl is not contiguous")
    # operands of another shape
    _refused(ops[:6] + [ops[6][:1]] + ops[7:], r"dpprime_visc has shape")
    short = ops[1]._replace(P_ref_q=ops[1].P_ref_q[1:])
    _refused(ops[:1] + [short] + ops[2:], r"P\.P_ref_q has shape")
    gy = ops[1].faces.y
    short = ops[1]._replace(faces=ops[1].faces._replace(y=gy._replace(
        dpp_ref_face_q=gy.dpp_ref_face_q[1:])))
    _refused(ops[:1] + [short] + ops[2:], r"P\.faces\.y\.dpp_ref_face_q has shape")
    # more layers than the kernels take
    many = ops[1]._replace(dpp_ref_q=torch.ones((65,) + ops[1].dpp_ref_q.shape[1:],
                                                dtype=torch.float64))
    _refused([dataclasses.replace(ops[0], nlayers=65), many] + ops[2:],
             "at most 64 layers, got 65")
    assert bcl_coeffs.bcl_coeffs_cuda.launches == launches


def test_cuda_wrapper_bounds_quadrature_and_takes_many_layers():
    """Any number of layers up to 64 runs the same build (the layers are
    streamed): 20 layers pass every check but the device's; more quadrature
    points an element side than the kernels take do not."""
    _refused(_wrapper_operands(nlayers=20, test_case="lakeatrest")[1],
             "takes CUDA tensors, got cpu")
    m, p9 = _wrapper_operands(nopx=9, nopy=9)
    assert p9[2].psiq.shape[1] > bcl_coeffs.MAX_NQ
    _refused(p9, f"at most {bcl_coeffs.MAX_NQ} quadrature")


@pytest.mark.parametrize("config", [dict(), dict(dtype="float32"), dict(nelx=5, nely=4),
                                    dict(mega="on"), dict(fused_tail="on"),
                                    dict(x_boundary=(3, 3), fused_tail="on"),
                                    dict(method_visc=1), dict(visc_mlswe=0.0)],
                         ids=["f64", "f32", "5x4", "mega", "fused", "xper-fused",
                              "quad-family", "visc-off"])
def test_a_step_gives_the_kernels_operands_they_take(config, monkeypatch):
    """The operands a step hands the coefficients (the predictor's primes
    and traces, and the corrector's averages of them) pass every check of
    the CUDA wrapper but the device's, on every barotropic path, in f32 and
    on grids whose host metric tables are strided views."""
    m = Model(_small(**{**VISC, **config}), device="cpu")
    seen = []

    def spy(*ops):
        seen.append(ops)
        return bcl_coeffs.bcl_coeffs_plain(*ops)

    monkeypatch.setattr(coupling, "bcl_coeffs", SimpleNamespace(bcl_coeffs_plain=spy))
    m.step(m.state0)
    assert len(seen) == 2
    for ops in seen:
        _refused(ops, "takes CUDA tensors, got cpu")


SYMBOLS = ("bcl_coeffs_nodal_kernel", "bcl_coeffs_edge_kernel")


def test_wrapper_and_source_agree_and_the_symbols_stay_generic():
    """The wrapper's limits and operand count are the source's, and neither
    kernel's symbol holds one of the barotropic kernels' that the benchmark
    and the bench tool count as such (so their time stays in
    other_device_ms_per_step)."""
    from hnumo_tpu_torch.ops import _build
    from hnumo_tpu_torch.tools._measure import KERNEL_SYMBOLS
    from portbench.bounds import KERNEL_SYMBOLS as BENCH_SYMBOLS

    src = (pathlib.Path(_build.CSRC_DIR) / "bcl_coeffs.cu").read_text()
    for const, attr in (("LMAX", "MAX_LAYERS"), ("MAX_NQ", "MAX_NQ")):
        assert re.search(rf"constexpr int {const} = (\d+);", src).group(1) == \
            str(getattr(bcl_coeffs, attr))

    def enum(last):
        body = next(b for b in src.split("enum {")[1:] if re.search(rf"\n\s*{last}\n\}};", b))
        body = body.split("};")[0]
        return re.findall(r"\b[kf][A-Z]\w*", re.sub(r"//[^\n]*", "", body))

    assert len(enum("NEL")) == len(bcl_coeffs.ELEMENT_OPERANDS)
    assert len(enum("NFD")) == len(bcl_coeffs.face_operands("x"))
    assert len(bcl_coeffs.OPERANDS) == len(enum("NEL")) + 2 * len(enum("NFD"))
    for symbol in SYMBOLS:
        assert f"{symbol}(" in src
        for sym in list(KERNEL_SYMBOLS.values()) + list(BENCH_SYMBOLS.values()):
            assert sym not in symbol
    assert [f.name for f in _build.source_files("bcl_coeffs")] == ["bcl_coeffs.cu"]


# ---- on a CUDA card -------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("the kernels of csrc/bcl_coeffs.cu run only on a CUDA card")


@pytest.fixture(scope="module", params=["float64", "float32"])
def card_cases(request, cuda_card):
    return request.param, chip_smoke.coeffs_cases(request.param)


@pytest.mark.card
def test_kernels_match_the_plain_version_on_the_card(card_cases):
    """Every field within 1e-12 (f64) or 2e-5 (f32) of its max: the same
    operations summed in another order (the tensor-product contractions
    sum-factorised within a thread, the layer sums streamed), of ~10-100
    terms each; over the cell's 25x25 and chip_smoke.py phase 34's cases,
    the blocks of 2x2 splits among them. On the stepped 25x25 state the
    δ-form pressure sums cancel terms ~1e4 times larger than themselves, so
    there they are held instead against the plain version in f64 (f32: to
    twice the f32 plain version's own error; chip_smoke.PRESSURE_FIELDS)."""
    dtype, cases = card_cases
    tol = chip_smoke.F32_TOL if dtype == "float32" else chip_smoke.F64_TOL
    assert (chip_smoke.F64_TOL, chip_smoke.F32_TOL) == (1e-12, 2e-5)
    launches = bcl_coeffs.bcl_coeffs_cuda.launches
    for what, ops, exempt in cases:
        chip_smoke.check_coeffs_case(ops, tol, f"{dtype} {what}", exempt)
    # a call a case, and one more where f32 fields are held against f64
    calls = len(cases) + sum(1 for _, _, exempt in cases if exempt and dtype == "float32")
    assert bcl_coeffs.bcl_coeffs_cuda.launches == launches + 2 * calls


@pytest.mark.card
def test_65_layers_raise_on_the_card(cuda_card):
    m = Model(chip_smoke.small_config(3, 2, "float64", 1, nlayers=2))
    ops = list(chip_smoke.coeffs_operands(m, chip_smoke.perturbed_inputs, seed=5))
    many = ops[1]._replace(dpp_ref_q=torch.ones((65,) + ops[1].dpp_ref_q.shape[1:],
                                                dtype=torch.float64, device="cuda"))
    with pytest.raises(ValueError, match="at most 64 layers, got 65"):
        bcl_coeffs.bcl_coeffs_cuda(dataclasses.replace(ops[0], nlayers=65), many, *ops[2:])


@pytest.mark.parametrize("walls", sorted(chip_smoke.COEFFS_SPLITS))
def test_split_block_operands_give_the_whole_grid_s_coefficients(walls):
    """The blocks of a 2x2 split that phase 34 and the card test hand the
    kernels are what a rank of the decomposition holds: through the plain
    version each block's coefficients are the whole grid's cut to the block,
    bit for bit (its viscous traces come through the stand-in axes' ghost
    edges)."""
    from hnumo_tpu_torch.parallel.sharding import block_bounds

    m = Model(chip_smoke.small_config(8, 6, "float64", 1, **chip_smoke.COEFFS_SPLITS[walls]),
              device="cpu")
    ops = chip_smoke.coeffs_operands(m, chip_smoke.perturbed_inputs, seed=9)
    whole = chip_smoke.coupling_leaves(bcl_coeffs.bcl_coeffs_plain(*ops))
    for iy in range(2):
        for ix in range(2):
            y0, y1 = block_bounds(6, 2, iy)
            x0, x1 = block_bounds(8, 2, ix)
            got = chip_smoke.coupling_leaves(bcl_coeffs.bcl_coeffs_plain(
                *chip_smoke.block_coeffs_operands(m, ops, ((2, 2), (iy, ix)))))
            for name, t in whole.items():
                if name.endswith(".x"):
                    want = t[..., y0:y1, x0:x1 + 1, :]
                elif name.endswith(".y"):
                    want = t[..., y0:y1 + 1, x0:x1, :]
                else:
                    want = t[..., y0:y1, x0:x1, :, :]
                assert torch.equal(got[name], want), (name, iy, ix)
