"""ops/bcl_mom_update: the end of each baroclinic half-step (the momentum
update's tail after the layer momentum's three terms, and evaluate_bcl /
evaluate_bcl_v1 without the new primes' face traces) as a CUDA kernel and its
plain version.

On the CPU: the plain version, through core/stepper._momentum_update, gives
bit for bit what the momentum update and evaluate_bcl / _v1 gave before their
bodies moved (portbench/reference keeps a frozen copy of them that imports
nothing of the port), in f64 and f32, both halves, over free-slip, no-slip and
copy walls, periodic x and y sides, 1, 2, 5 and 20 layers, p=4 and p=8,
inexact integration, viscosity off, the quad family and the shear stress; a
CPU model takes it twice a step and builds no kernel; the CUDA wrapper refuses
what the kernel does not take, and takes what a step hands it on every
barotropic path; a 2x2 split's blocks give the whole grid's fields. On a CUDA
card (skipped without one): the kernel against the plain version over
chip_smoke.py phase 35's cases, each field within 1e-12 (f64) or 2e-5 (f32)
of its max.
"""
import dataclasses
import pathlib
import re

import pytest
import torch

import chip_smoke
from hnumo_tpu_torch.core import stepper
from hnumo_tpu_torch.core.faces import BCs, apply_wall_projection, scatter_face_x
from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.ops import bcl_mom_update
from portbench.reference.core import bcl as frozen_bcl
from portbench.reference.core import stepper as frozen_stepper
from test_torch_common import one_thread  # noqa: F401  (autouse)

LAKE = dict(test_case="lakeatrest")
NO_SLIP = dict(x_boundary=(2, 0), y_boundary=(2, 2))     # no-slip and copy walls
XPER = dict(x_boundary=(3, 3), y_boundary=(4, 4))
YPER = dict(x_boundary=(4, 4), y_boundary=(3, 3))
VISC = dict(method_visc=2, visc_mlswe=100.0)
SHEAR = dict(ad_mlswe=chip_smoke.SHEAR_AD)
# (id, config overrides of _small's 3x2 grid)
CASES = [("L2-free-slip", VISC), ("L2-no-slip", {**VISC, **NO_SLIP}),
         ("L2-xper", {**VISC, **XPER}), ("L2-yper", {**VISC, **YPER}),
         ("L1", dict(nlayers=1, **LAKE, **VISC)),
         ("L5-xper", dict(nlayers=5, **LAKE, **XPER, **VISC)),
         ("L20-no-slip", dict(nlayers=20, **LAKE, **NO_SLIP, **VISC)),
         ("L2-p8", dict(nopx=8, nopy=8, **VISC)),
         ("L2-inexact", dict(dg_integ_exact=False, **VISC)),
         ("L2-visc-off", {}), ("L2-quad-family", dict(method_visc=1, visc_mlswe=100.0)),
         ("L2-shear", {**VISC, **SHEAR}), ("L3-shear-no-slip", dict(nlayers=3, **LAKE,
                                                                    **NO_SLIP, **SHEAR))]
HALVES = ["predictor", "corrector"]


def _small(dtype="float64", nelx=3, nely=2, **over):
    """chip_smoke.py's 3x2 double gyre (p=4, 2 layers, free-slip walls, bottom
    drag) without viscosity; `over` replaces any other field."""
    return chip_smoke.small_config(nelx, nely, dtype, 1, visc=False, **over)


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    return request.param[1]


def _frozen(ops, dpprime):
    """What core/stepper gave before the move: the frozen momentum update, then
    the frozen evaluate_bcl (predictor) or evaluate_bcl_v1 and the stack of the
    kept thickness prime (corrector)."""
    static, P, g, bc, avg, coup, q_df, qp, qpf, qb = ops
    q = frozen_stepper._momentum_update(*ops)
    if dpprime is None:
        q, qprime, _ = frozen_bcl.evaluate_bcl(static, P, bc, q, qp, qb)
        return q, qprime
    q, qprime = frozen_bcl.evaluate_bcl_v1(P, q, qp, qb)
    return q, torch.stack([dpprime, qprime[1], qprime[2]])


@pytest.mark.parametrize("half", HALVES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_update_is_the_update_before_the_move(case, dtype, half):
    m = Model(_small(dtype=dtype, **case), device="cpu")
    assert m.static.impl == "plain"
    ops = chip_smoke.half_step_operands(m, chip_smoke.perturbed_inputs, seed=71)
    dpp = chip_smoke.kept_dpprime(m.P, ops[6]) if half == "corrector" else None
    calls = bcl_mom_update.bcl_mom_update_plain.calls
    got = stepper._momentum_update(*ops, dpprime=dpp)
    assert bcl_mom_update.bcl_mom_update_plain.calls == calls + 1
    want = _frozen(ops, dpp)
    for name, a, b in zip(("q_df", "qprime_df"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
    assert torch.equal(got[0][0], ops[6][0])
    if dpp is not None:
        assert torch.equal(got[1][0], dpp)


def test_cpu_model_takes_the_plain_version_twice_a_step():
    m = Model(_small(**VISC), device="cpu")
    assert m.static.impl == "plain"
    calls = bcl_mom_update.bcl_mom_update_plain.calls
    launches = bcl_mom_update.bcl_mom_update_cuda.launches
    m.step(m.state0)
    assert bcl_mom_update.bcl_mom_update_plain.calls == calls + 2    # predictor, corrector
    assert bcl_mom_update.bcl_mom_update_cuda.launches == launches


def _wrapper_operands(corrector=True, **over):
    """The update's operands on the 3x2 grid (f64), from a CPU model."""
    m = Model(_small(dtype="float64", **{**VISC, **over}), device="cpu")
    return m, list(chip_smoke.mom_update_operands(m, chip_smoke.perturbed_inputs, seed=3,
                                                  corrector=corrector))


def _refused(ops, match):
    with pytest.raises(ValueError, match=match):
        bcl_mom_update.bcl_mom_update_cuda(*ops)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    m, ops = _wrapper_operands()
    launches = bcl_mom_update.bcl_mom_update_cuda.launches
    # everything right but the device
    _refused(ops, "takes CUDA tensors, got cpu")
    # a dtype the kernel has no build of
    _refused(ops[:4] + [ops[4].half()] + ops[5:], "float32/float64, got torch.float16")
    # one operand of another dtype than the rest
    P = ops[1]
    _refused(ops[:1] + [P._replace(a_bcl=P.a_bcl.float())] + ops[2:],
             r"P\.a_bcl is torch.float32")
    # a non-contiguous operand
    qb = ops[8].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not qb.is_contiguous()
    _refused(ops[:8] + [qb] + ops[9:], r"qb_df is not contiguous")
    faces = ops[6]
    sx = faces.x[1].transpose(0, 1).contiguous().transpose(0, 1)
    odd = faces._replace(x=(faces.x[0], sx) + tuple(faces.x[2:]))
    _refused(ops[:6] + [odd] + ops[7:], r"faces\.x\.1 is not contiguous")
    # operands of another shape
    _refused(ops[:5] + [ops[5][:, :1]] + ops[6:], r"rhs_vol has shape")
    _refused(ops[:9] + [ops[9][:, :-1]], r"dpprime has shape")
    short = faces._replace(y=tuple(t[:, :-1] for t in faces.y))
    _refused(ops[:6] + [short] + ops[7:], r"faces\.y\.0 has shape")
    # a viscosity that is neither a field nor none
    _refused(ops[:7] + [1.0] + ops[8:], r"rhs_visc is 1\.0")
    # more layers than a column carries
    q65 = torch.zeros((3, 65) + ops[4].shape[2:], dtype=torch.float64)
    _refused([dataclasses.replace(ops[0], nlayers=65)] + ops[1:4] + [q65] + ops[5:],
             "at most 64 layers, got 65")
    assert bcl_mom_update.bcl_mom_update_cuda.launches == launches


@pytest.mark.parametrize("over", [dict(nlayers=20, **LAKE), dict(nopx=9, nopy=9),
                                  dict(visc_mlswe=0.0), dict(method_visc=1)],
                         ids=["L20", "p9", "visc-off", "quad-family"])
def test_cuda_wrapper_takes_any_layers_and_order(over):
    """The layers are streamed and each thread takes one node, so any number
    of layers up to 64 and any order run the same build; without viscosity
    its field is 0.0. These pass every check but the device's."""
    for corrector in (False, True):
        _refused(_wrapper_operands(corrector, **over)[1], "takes CUDA tensors, got cpu")


@pytest.mark.parametrize("config", [dict(), dict(dtype="float32"), dict(nelx=5, nely=4),
                                    dict(mega="on"), dict(fused_tail="on"),
                                    dict(x_boundary=(3, 3), fused_tail="on"),
                                    dict(method_visc=1), dict(visc_mlswe=0.0), SHEAR],
                         ids=["f64", "f32", "5x4", "mega", "fused", "xper-fused",
                              "quad-family", "visc-off", "shear"])
def test_a_step_gives_the_kernel_operands_it_takes(config, monkeypatch):
    """The operands a step hands the update (the predictor's, and the
    corrector's with the thickness prime it keeps) pass every check of the
    CUDA wrapper but the device's, on every barotropic path, in f32 and on
    grids whose host metric tables are strided views."""
    m = Model(_small(**{**VISC, **config}), device="cpu")
    seen = []

    def spy(*ops):
        seen.append(ops)
        return bcl_mom_update.bcl_mom_update_plain(*ops)

    monkeypatch.setattr(stepper, "bcl_mom_update_plain", spy)
    m.step(m.state0)
    assert len(seen) == 2 and seen[0][-1] is None and seen[1][-1] is not None
    for ops in seen:
        _refused(ops, "takes CUDA tensors, got cpu")


@pytest.mark.parametrize("half", HALVES)
@pytest.mark.parametrize("walls", sorted(chip_smoke.COEFFS_SPLITS))
def test_split_block_operands_give_the_whole_grid_s_update(walls, half):
    """The blocks of a 2x2 split that phase 35 and the card test hand the
    kernel are what a rank of the decomposition holds: through the plain
    version each block's new q_df and primes are the whole grid's cut to the
    block, bit for bit (the face values of a block's edge faces are those the
    whole grid computes there, as a split's exchanged traces give them)."""
    from hnumo_tpu_torch.parallel.sharding import block_bounds

    m = Model(chip_smoke.small_config(8, 6, "float64", 1, **chip_smoke.COEFFS_SPLITS[walls]),
              device="cpu")
    ops = chip_smoke.mom_update_operands(m, chip_smoke.sheared_inputs, seed=9,
                                         corrector=half == "corrector")
    whole = bcl_mom_update.bcl_mom_update_plain(*ops)
    for iy in range(2):
        for ix in range(2):
            y0, y1 = block_bounds(6, 2, iy)
            x0, x1 = block_bounds(8, 2, ix)
            got = bcl_mom_update.bcl_mom_update_plain(
                *chip_smoke.block_mom_update_operands(m, ops, ((2, 2), (iy, ix))))
            for name, a, b in zip(("q_df", "qprime_df"), got, whole):
                assert torch.equal(a, b[..., y0:y1, x0:x1, :, :]), (name, iy, ix)


class _Owner:
    def __init__(self, first, last):
        self.first, self.last = first, last


@pytest.mark.parametrize("codes", [(4, 4, 4, 4), (2, 0, 2, 2), (0, 4, 2, 0), (3, 3, 4, 4),
                                   (4, 4, 3, 3), (5, 2, 0, 4)])
@pytest.mark.parametrize("place", ["whole", "first", "last", "inner"])
def test_wall_bits_are_the_projection_and_the_scatter_s_walls(codes, place):
    """What the kernel takes of the walls, decoded node by node as it decodes
    them, is core/faces.apply_wall_projection's mask and scatter_face_x/_y's
    wall face, for every side's code and every place of a block."""
    axis = {"whole": None, "first": _Owner(True, False), "last": _Owner(False, True),
            "inner": _Owner(False, False)}[place]
    bc = BCs(*codes, ax=axis, ay=axis)
    xwall, ywall, bits = bcl_mom_update.wall_bits(bc)
    ly, lx, ngl = 3, 4, 3
    ones = torch.ones((ly, lx, ngl, ngl), dtype=torch.float64)
    mu, mv = apply_wall_projection(ones, ones, bc)
    zero = torch.zeros((2, ly, lx, ngl, ngl), dtype=torch.bool)
    for ey in range(ly):
        for ex in range(lx):
            for j in range(ngl):
                for i in range(ngl):
                    z = 0
                    if i == 0 and ex == 0:
                        z |= bits & 3
                    if i == ngl - 1 and ex == lx - 1:
                        z |= (bits >> 2) & 3
                    if j == 0 and ey == 0:
                        z |= (bits >> 4) & 3
                    if j == ngl - 1 and ey == ly - 1:
                        z |= (bits >> 6) & 3
                    zero[0, ey, ex, j, i] = bool(z & 1)
                    zero[1, ey, ex, j, i] = bool(z & 2)
    assert torch.equal(zero[0], mu == 0) and torch.equal(zero[1], mv == 0)
    # the scatter's wall face: face 0's value lands with -S on the first element
    S = torch.ones((ly, lx + 1, ngl), dtype=torch.float64)
    west = scatter_face_x(torch.zeros_like(ones), S, bc, S_right=2 * S)[:, 0, :, 0]
    assert bool((west == (-1.0 if xwall else 2.0)).all())
    assert ywall == int(codes[2] != 3 and place in ("whole", "first"))


def test_wrapper_and_source_agree_and_the_symbol_stays_generic():
    """The wrapper's limit, operand count and launch modes are the source's,
    and the kernel's symbol holds none of the barotropic kernels' that the
    benchmark and the bench tool count as such (so its time stays in
    other_device_ms_per_step)."""
    from hnumo_tpu_torch.ops import _build
    from hnumo_tpu_torch.tools._measure import KERNEL_SYMBOLS
    from portbench.bounds import KERNEL_SYMBOLS as BENCH_SYMBOLS

    src = (pathlib.Path(_build.CSRC_DIR) / "bcl_mom_update.cu").read_text()
    assert re.search(r"constexpr int LMAX = (\d+);", src).group(1) == \
        str(bcl_mom_update.MAX_LAYERS)
    body = re.sub(r"//[^\n]*", "", src.split("enum {\n  kQd")[1].split("};")[0])
    single = re.findall(r"\bk[A-Z]\w*", "kQd" + body.split("kSx")[0])
    assert "kSx,\n  kSy = kSx + 4,\n  NIN = kSy + 4" in re.sub(r"[ \t]*//[^\n]*", "",
                                                                src)
    assert len(single) + 8 == len(bcl_mom_update.OPERANDS)
    assert "enum { MODE_WHOLE, MODE_FIRST, MODE_REST };" in src
    assert (bcl_mom_update.WHOLE, bcl_mom_update.FIRST, bcl_mom_update.REST) == (0, 1, 2)
    assert "bcl_mom_update_kernel(" in src
    for sym in list(KERNEL_SYMBOLS.values()) + list(BENCH_SYMBOLS.values()):
        assert sym not in "bcl_mom_update_kernel"
    assert [f.name for f in _build.source_files("bcl_mom_update")] == ["bcl_mom_update.cu"]


# ---- on a CUDA card -------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("the kernel of csrc/bcl_mom_update.cu runs only on a CUDA card")


@pytest.fixture(scope="module", params=["float64", "float32"])
def card_cases(request, cuda_card):
    return request.param, chip_smoke.mom_update_cases(request.param)


@pytest.mark.card
def test_kernel_matches_the_plain_version_on_the_card(card_cases):
    """Every field within 1e-12 (f64) or 2e-5 (f32) of its max, the thickness
    and the kept thickness prime bitwise: the same operations in the same
    order, each rounded as the plain version rounds it, but the layer sums
    above two layers, which torch.sum adds in an order of its own; over the
    cell's 25x25 and chip_smoke.py phase 35's cases, the blocks of 2x2
    splits among them. A call is one launch, two with the shear stress."""
    dtype, cases = card_cases
    tol = chip_smoke.F32_TOL if dtype == "float32" else chip_smoke.F64_TOL
    assert (chip_smoke.F64_TOL, chip_smoke.F32_TOL) == (1e-12, 2e-5)
    launches = bcl_mom_update.bcl_mom_update_cuda.launches
    for what, ops in cases:
        chip_smoke.compare_mom_update(ops, tol, f"{dtype} {what}")
    want = sum(2 if ops[0].ad_mlswe > 0 else 1 for _, ops in cases)
    assert bcl_mom_update.bcl_mom_update_cuda.launches == launches + want


@pytest.mark.card
def test_65_layers_raise_on_the_card(cuda_card):
    m = Model(chip_smoke.small_config(3, 2, "float64", 1, nlayers=2))
    ops = list(chip_smoke.mom_update_operands(m, chip_smoke.perturbed_inputs, seed=5))
    q65 = torch.zeros((3, 65) + ops[4].shape[2:], dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="at most 64 layers, got 65"):
        bcl_mom_update.bcl_mom_update_cuda(dataclasses.replace(ops[0], nlayers=65),
                                           *ops[1:4], q65, *ops[5:])
