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


def counting(monkeypatch, module, name):
    """Replace module.name by a wrapper that counts its calls; returns the
    list that grows by one per call."""
    fn, seen = getattr(module, name), []

    def wrapper(*args, **kw):
        seen.append(1)
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, wrapper)
    return seen


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


# ---- whole steps of the options off the main path ---------------------------

SHEAR = dict(ad_mlswe=1e-3, max_shear_dz=5.0)
PERIODIC = {"x": dict(x_boundary=(3, 3), y_boundary=(2, 0)),
            "y": dict(x_boundary=(0, 4), y_boundary=(3, 3)),
            "xy": dict(x_boundary=(3, 3), y_boundary=(3, 3))}

# (id, config overrides, dtype, steps, barotropic path of both packages)
STEP_CASES_FACES_LSRK = [
    ("per_dir", dict(batched_faces="off"), "float64", 2, "per_stage"),
    ("per_dir-visc0-k3", dict(batched_faces="off", visc_mlswe=0.0, kstages=3),
     "float64", 2, "per_stage"),
    ("quad", dict(method_visc=1), "float64", 2, "per_stage"),
    ("lsrk5", dict(ti_method_btp="lsrk"), "float64", 2, "per_stage"),
    ("lsrk14", dict(ti_method_btp="lsrk", kstages=14), "float64", 2, "per_stage"),
    ("lsrk_ref", dict(ti_method_btp="lsrk_ref"), "float64", 1, "per_stage"),
    ("lsrk_ref-fused", dict(ti_method_btp="lsrk_ref", fused_tail="on"), "float64", 1, "fused"),
    ("f32-per_dir", dict(batched_faces="off"), "float32", 2, "per_stage"),
    ("f32-quad", dict(method_visc=1), "float32", 2, "per_stage"),
    ("f32-lsrk5", dict(ti_method_btp="lsrk"), "float32", 2, "per_stage"),
]
STEP_CASES_DRAG = [
    ("shear", SHEAR, "float64", 2, "per_stage"),
    ("shear-compat", dict(compat_reference_stress=True, **SHEAR), "float64", 2, "per_stage"),
    ("shear-mega", dict(mega="on", **SHEAR), "float64", 2, "mega"),
    ("botfr2-per_stage", dict(botfr=2), "float64", 2, "per_stage"),
    ("botfr2-fused", dict(botfr=2, fused_tail="on"), "float64", 2, "fused"),
    ("botfr2-mega", dict(botfr=2, mega="on"), "float64", 2, "mega"),
    ("f32-shear", SHEAR, "float32", 2, "per_stage"),
    ("f32-botfr2", dict(botfr=2), "float32", 2, "per_stage"),
]
STEP_CASES_PERIODIC = [
    (f"periodic_{d}-{path}", dict(**PERIODIC[d], **({"fused_tail": "on"} if path == "fused"
                                                  else {})), "float64", 2, path)
    for d in ("x", "y", "xy") for path in ("per_stage", "fused")
]
# f32 with walls in y, the chip's periodic configuration. Doubly periodic,
# qprime's max is small enough that both packages' f32 runs lie ~8.4e-5 of
# it from the f64 solution (the port's no further than the JAX package's),
# so their difference is no test of the port there: f64 gates it.
STEP_CASES_PERIODIC.append(("f32-periodic_x-fused", dict(fused_tail="on", **PERIODIC["x"]),
                            "float32", 2, "fused"))

STEP_REL = {"float64": 1e-11, "float32": 1e-4}


def check_steps_against_jax(over, dtype, nsteps, path, monkeypatch):
    """`nsteps` steps of the JAX Model and of the port's Model (own tables)
    from the initial state of the configuration `over`: each channel of
    each state field (f32: each field) within STEP_REL of its max; the
    port's path proved by the plain versions' counters and by counting its
    face pipeline."""
    from hnumo_tpu.model import Model as JaxModel
    from hnumo_tpu_torch.core import btp
    from hnumo_tpu_torch.model import Model as TorchModel
    from hnumo_tpu_torch.ops import btp_tail, btp_volume, btp_volume_uni, mega

    jm = JaxModel(jax_config(dtype=dtype, **over))
    assert jm.static.use_pallas
    assert (jm.static.mega, jm.static.fused_tail) == (path == "mega", path == "fused")
    s = jm.state0
    for _ in range(nsteps):
        s = jm.step(s)
    want = to_np(s)

    tm = TorchModel(torch_config(dtype=dtype, **over), device="cpu")
    st = tm.static
    assert (st.mega, st.fused_tail) == (path == "mega", path == "fused")
    assert st.batched_faces == jm.static.batched_faces
    counters = {"volume": btp_volume.btp_volume_plain,
                "volume_uni": btp_volume_uni.btp_volume_uni_plain,
                "faces": btp_tail.btp_faces_plain, "update": btp_tail.btp_update_plain,
                "mega": mega.barotropic_solve_mega_plain}
    before = {k: f.calls for k, f in counters.items()}
    seen = {name: counting(monkeypatch, btp, name)
            for name in ("_btp_faces_visc", "_btp_faces_visc_flat")}
    got = tm.run(tm.state0, nsteps, check_ok=False)

    nsub = 2 * nsteps * st.n_btp * st.kstages
    calls = {k: f.calls - before[k] for k, f in counters.items()}
    expect = dict.fromkeys(counters, 0)
    if path == "mega":
        expect["mega"] = 2 * nsteps
    elif path == "fused":
        expect.update(volume_uni=nsub, faces=nsub, update=nsub)
    else:
        expect["volume"] = nsub
    assert calls == expect
    per_stage = path == "per_stage"
    assert (len(seen["_btp_faces_visc"]), len(seen["_btp_faces_visc_flat"])) == (
        (0 if st.batched_faces else nsub, nsub if st.batched_faces else 0) if per_stage
        else (0, 0))

    assert bool(got.ok) and bool(want.ok)
    for name in ("qb_df", "q_df", "qprime_df"):
        if dtype == "float32":
            # over each field's max, as tests/test_torch_step.py: a channel
            # that holds a perturbation (δdp, pb') carries the rounding of
            # the full variable it was formed from
            assert_close(getattr(got, name), getattr(want, name), STEP_REL[dtype], name)
            continue
        for c, w in enumerate(getattr(want, name)):
            assert_close(getattr(got, name)[c], w, STEP_REL[dtype], f"{name}[{c}]")
