"""The port's own build_precomputed against the JAX package's.

Every field of Precomputed, the shared fields of StaticConfig and the
initial state: f64 at 1e-13 of each field's max (the host parts are the same
NumPy code; only the casts differ), f32 at 1e-6 (the f32 reference tables
are recomputed by each package's own f32 operators). And the f32 rest-state
invariant: the quad reference table is exactly what the port's own
interpolation gives, so δ is exactly 0 at rest."""
import dataclasses

import numpy as np
import pytest
import torch

from hnumo_tpu.model import Model as JaxModel
from hnumo_tpu_torch.core.init import StaticConfig
from hnumo_tpu_torch.convert import from_numpy_tables
from hnumo_tpu_torch.core.faces import extract_faces, face_n2q
from hnumo_tpu_torch.model import Model as TorchModel
from hnumo_tpu_torch.ops.dg import interp_n2q
from test_torch_common import (TDTYPE, assert_close, jax_config, leaves, to_np,
                               torch_config)

REL = {"float64": 1e-13, "float32": 1e-6}
CASES = [("float64", "double_gyre", 1), ("float32", "double_gyre", 1),
         ("float64", "bump", 0), ("float64", "seamount", 2)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def pair(request):
    dtype, case, botfr = request.param
    over = dict(dtype=dtype, test_case=case, botfr=botfr)
    return dtype, JaxModel(jax_config(**over)), TorchModel(torch_config(**over), device="cpu")


def test_precomputed_fields(pair):
    dtype, jm, tm = pair
    want = dict(leaves(to_np(jm.P)))
    got = dict(leaves(tm.P))
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == TDTYPE[dtype], name
        assert_close(got[name], w, REL[dtype], name)


def test_device_geom_and_state0(pair):
    dtype, jm, tm = pair
    for (name, w), (_, g_) in zip(leaves(to_np(jm.g)), leaves(tm.g)):
        assert_close(g_, w, REL[dtype], name)
    s_j, s_t = to_np(jm.state0), tm.state0
    for name in ("qb_df", "q_df", "qprime_df"):
        assert_close(getattr(s_t, name), getattr(s_j, name), REL[dtype], name)
    assert float(s_t.t) == float(s_j.t) and bool(s_t.ok) is True
    assert s_t.ok.dtype == torch.bool


def test_static_shared_fields(pair):
    _, jm, tm = pair
    for f in dataclasses.fields(StaticConfig):
        if f.name in ("volume_impl", "mega_impl", "tail_impl"):   # the port's own switches
            continue
        assert getattr(tm.static, f.name) == getattr(jm.static, f.name), f.name
    assert tm.static.volume_impl == "plain" and tm.static.mega_impl == "plain"
    assert tm.static.tail_impl == "plain"
    assert tm.static.mega == jm.static.mega


def test_rest_state_delta_is_exactly_zero(pair):
    dtype, _, tm = pair
    P, g = tm.P, tm.g
    if dtype == "float32":
        assert torch.equal(interp_n2q(g, P.dpp_ref_df), P.dpp_ref_q)
        flr, _ = extract_faces(P.dpp_ref_df, tm.bc)
        assert torch.equal(flr.xl, P.faces.x.dpp_ref_face)
        assert torch.equal(face_n2q(g.psiq, flr.xl), P.faces.x.dpp_ref_face_q)
        assert torch.equal(face_n2q(g.psiq, flr.yl), P.faces.y.dpp_ref_face_q)
    resid = torch.sum(P.dpp_ref_df, 0) - P.pbprime_df
    assert torch.equal(resid, P.sum_ref_residual)
    # the initial prime-thickness perturbation is an exact zero (rest state)
    assert float(tm.state0.qprime_df[0].abs().max()) == 0.0


def test_convert_roundtrip(pair):
    """from_numpy_tables carries every field across unchanged."""
    dtype, jm, _ = pair
    P, g, s = from_numpy_tables(to_np(jm.P), to_np(jm.g), to_np(jm.state0),
                                "cpu", TDTYPE[dtype])
    for (name, w), (_, got) in zip(leaves(to_np(jm.P)), leaves(P)):
        assert_close(got, w, 0.0, name)
    for (name, w), (_, got) in zip(leaves(to_np(jm.g)), leaves(g)):
        assert_close(got, w, 0.0, name)
    assert_close(s.qprime_df, np.asarray(jm.state0.qprime_df), 0.0)
    assert s.ok.dtype == torch.bool and bool(s.ok)
    # plain tuples and dicts are taken as well as NamedTuples
    P2, _, _ = from_numpy_tables(to_np(jm.P)._asdict() | {"faces": tuple(
        f._asdict() for f in to_np(jm.P).faces)}, tuple(to_np(jm.g)),
        to_np(jm.state0)._asdict(), "cpu", TDTYPE[dtype])
    assert torch.equal(P2.faces.y.jac, P.faces.y.jac)
