"""The frozen float64 trajectories and the CI bump values, for the port.

The port's own copies of what tools/freeze_goldens.py (the two
configurations and the state fingerprint) and tests/test_golden.py (the
tolerances, the reference's CI bump values) hold for the JAX package, so
that the port replays tests/goldens/bump_traj.npz and dgyre_traj.npz, and
the 108-step CI bump (reference CI/bump/numo3d.in, checked by
CI/bump/check.F90:41-83), without importing either. tests/test_torch_golden*.py
run them on the CPU, chip_smoke.py on the card.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import Config

GOLDEN_DIR = Path(__file__).resolve().parents[2] / "tests" / "goldens"

# a fingerprint entry passes at rtol 1e-9 and, in absolute terms, 1e-13 of
# its variable's scale (the largest |max|): means and sums of nearly
# cancelling fields carry reduction noise far above their own tiny value
RTOL = 1e-9
ATOL_OVER_SCALE = 1e-13

# reference CI/bump/ref_mlswe_FIN.txt: per layer, (max, min) at t=10800 s
REF_FIN = {
    1: dict(h=(0.201449116645e2, 0.198079626307e2),
            u=(0.132668224164e-2, -0.132668287181e-2),
            v=(0.132668258603e-2, -0.132668290397e-2),
            ssh=(0.143070025622e-4, -0.188256860127e-4)),
    2: dict(h=(0.201920273076e2, 0.198550996224e2),
            u=(0.131238487936e-2, -0.131238569024e-2),
            v=(0.131238505181e-2, -0.131238545749e-2),
            ssh=(-0.198079726924e2, -0.201449003776e2)),
}
FIN_RTOL = 1e-5          # each max / min over the larger of the two
MASS_LOSS_TOL = 1e-12    # per layer, relative (CI/bump/check.F90:58-62)


def bump_config(**kw) -> Config:
    """The reference CI bump case: 10x10, p=4, 2 layers, 108 steps."""
    kw.setdefault("dtype", "float64")
    return Config(nelx=10, nely=10, nopx=4, nopy=4,
                  xdims=(0.0, 2e3), ydims=(0.0, 2e3), nlayers=2,
                  x_boundary=(4, 4), y_boundary=(4, 4),
                  dt=100.0, dt_btp=1.8, time_final=10800.0,
                  test_case="bump", **kw)


def dgyre_config(**kw) -> Config:
    """The reference double gyre (Examples/double_gyre/numo3d.in): 25x25,
    p=4, 2 layers, wind, linear bottom friction, nodal-family viscosity."""
    kw.setdefault("dtype", "float64")
    return Config(nelx=25, nely=25, nopx=4, nopy=4,
                  xdims=(0.0, 2e6), ydims=(0.0, 2e6), nlayers=2,
                  x_boundary=(4, 4), y_boundary=(4, 4),
                  dt=500.0, dt_btp=25.0, time_final=1e9,
                  test_case="double_gyre", f0=0.93e-4, beta=2.0e-11,
                  botfr=1, cd_mlswe=1.0e-7, method_visc=3, visc_mlswe=50.0,
                  **kw)


def fingerprint(state) -> dict:
    """Global min / max / mean / L2 per channel and a strided sample of the
    state, as tools/freeze_goldens.py takes them."""
    out = {}
    for name in ("q_df", "qb_df", "qprime_df"):
        a = getattr(state, name).detach().cpu().numpy().astype(np.float64)
        flat = a.reshape(a.shape[0], -1)
        out[f"{name}_min"] = flat.min(axis=1)
        out[f"{name}_max"] = flat.max(axis=1)
        out[f"{name}_mean"] = flat.mean(axis=1)
        out[f"{name}_l2"] = np.sqrt((flat ** 2).mean(axis=1))
        out[f"{name}_sample"] = flat[:, ::97].copy()
    return out


def replay(model, name: str, max_steps: int | None = None) -> tuple[float, str]:
    """Step `model` from its initial state through the checkpoints of
    tests/goldens/<name>.npz (up to `max_steps`) and hold each fingerprint
    against the frozen one. Raises AssertionError outside the tolerance;
    returns the largest deviation over its allowance (|got - want| /
    (atol + rtol |want|)), at most 1 when it passes, and where it was."""
    g = np.load(GOLDEN_DIR / f"{name}.npz")
    checkpoints = [int(c) for c in g["checkpoints"]
                   if max_steps is None or c <= max_steps]
    s, done, worst, where = model.state0, 0, 0.0, ""
    for nst in checkpoints:
        s = model.run(s, nst - done)
        done = nst
        for key, val in fingerprint(s).items():
            ref = g[f"s{nst}_{key}"]
            scale = np.max(np.abs(g[f"s{nst}_{key.rsplit('_', 1)[0]}_max"])) + 1e-300
            allow = ATOL_OVER_SCALE * scale + RTOL * np.abs(ref)
            ratio = float(np.max(np.abs(val - ref) / allow))
            if not ratio <= 1.0:
                raise AssertionError(
                    f"{name} step {nst}: {key} deviates from the frozen f64 "
                    f"trajectory by {ratio:.3g} times its tolerance")
            if ratio > worst:
                worst, where = ratio, f"step {nst} {key}"
    return worst, where


def ci_bump(model) -> dict:
    """The 108-step CI bump from `model`'s initial state, held against the
    reference's FIN values and the per-layer mass gate. Raises
    AssertionError outside them; returns the worst relative deviation of a
    FIN value and the worst relative mass loss."""
    from ..io.diagnostics import compute_mass, derived_fields

    s = model.state0
    mass0 = compute_mass(model, s)
    s = model.run(s, model.nsteps_total)
    mass = compute_mass(model, s)
    h, u, v, _, ssh = derived_fields(model, s)
    worst_fin = worst_mass = 0.0
    for k in range(model.cfg.nlayers):
        loss = abs(mass[k] - mass0[k]) / mass0[k]
        if not loss < MASS_LOSS_TOL:
            raise AssertionError(f"layer {k + 1} mass loss {loss:.3e} > {MASS_LOSS_TOL}")
        worst_mass = max(worst_mass, loss)
        for nm, arr in (("h", h[k]), ("u", u[k]), ("v", v[k]), ("ssh", ssh[k])):
            gmax, gmin = REF_FIN[k + 1][nm]
            scale = max(abs(gmax), abs(gmin))
            for which, got, want in (("max", arr.max(), gmax), ("min", arr.min(), gmin)):
                dev = abs(got - want) / scale
                if not dev < FIN_RTOL:
                    raise AssertionError(
                        f"layer {k + 1} {nm} {which} {got:.12e} against the "
                        f"reference's {want:.12e}: {dev:.3e} > {FIN_RTOL}")
                worst_fin = max(worst_fin, dev)
    return {"steps": model.nsteps_total, "fin_rel_dev": worst_fin,
            "mass_rel_loss": worst_mass}
