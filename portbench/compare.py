"""What decides `correct`: the state that the timed path produced against
the plain reference's, and the run layer's files against that state.

Every number here is a widest gap: over each channel of a field (a
variable of qb_df; a variable and layer of q_df and qprime_df), the
largest absolute difference over that channel's largest absolute
reference value, and the largest over the channels of one kind: the
thickness and pressure channels apart from the momentum channels, which
start from rest and carry far smaller signals early in a run."""
from __future__ import annotations

import numpy as np
import torch

# the channels of each field, by kind: its thickness and pressure channels
# (pb, pb'; the thickness perturbations) and its momentum channels (the
# barotropic and layer momenta; the layer velocities' deviations)
GROUPS = {"mass": {"qb_df": (0, 1), "q_df": (0,), "qprime_df": (0,)},
          "momentum": {"qb_df": (2, 3), "q_df": (1, 2), "qprime_df": (1, 2)}}


def channel_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Relative gap of each channel: the leading dim (the variable) and,
    for a layered field, each layer; a channel that is zero throughout in
    the reference reads its absolute gap."""
    lead = 1 if want.dim() == 5 else 2
    got = got.double().to(want.device).flatten(lead)
    want = want.double().flatten(lead)
    diff = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    return torch.where(scale > 0, diff / scale.clamp_min(1e-300), diff)


def state_gaps(prefix: str, got, want) -> dict:
    """{prefix_mass, prefix_momentum}: the widest channel gap of each kind
    over the three fields; a non-finite value in `got` reads inf."""
    out = {}
    for kind, fields in GROUPS.items():
        worst = 0.0
        for name, rows in fields.items():
            g, w = getattr(got, name), getattr(want, name)
            if not bool(torch.isfinite(g).all()):
                worst = float("inf")
                break
            worst = max(worst, float(channel_gaps(g, w)[list(rows)].max()))
        out[f"{prefix}_{kind}"] = worst
    return out


def total_mass(state, dp_ref: torch.Tensor, wjac: torch.Tensor) -> float:
    """Sum over the layers and nodes of wjac * (dp_ref + the stored
    thickness perturbation), in float64: the integral of the pressure
    thickness, as the mass gate takes it."""
    dp = dp_ref.double() + state.q_df[0].double().to(dp_ref.device)
    return float((wjac.double() * dp).sum())


def read_txt(path) -> dict:
    """A txt snapshot (src/diagnostics.F90:77-89): nlayers, npoin, dt,
    dt_btp, the (x, y) pairs, pb, pbub, pbvb, then h, u, v, eta layer by
    layer, then zbot, one value per line."""
    with open(path) as f:
        vals = f.read().split()
    L, n = int(vals[0]), int(vals[1])
    data = np.array(vals[2:], dtype=np.float64)
    i = 2 + 2 * n
    out = {}
    for name in ("pb", "pbub", "pbvb"):
        out[name] = data[i:i + n]
        i += n
    for name in ("h", "u", "v", "eta"):
        out[name] = data[i:i + L * n].reshape(L, n)
        i += L * n
    return out


def derived(state, dp_ref: torch.Tensor, alpha, gravity: float) -> dict:
    """pb, pbub, pbvb and each layer's h, u, v of `state`, in float64 NumPy,
    flattened in the element-major node order of a snapshot."""
    qb = state.qb_df.double().cpu().numpy()
    q = state.q_df.double().cpu().numpy()
    dp = dp_ref.double().cpu().numpy() + q[0]
    L = dp.shape[0]
    a = np.asarray(alpha, dtype=np.float64).reshape(L, *([1] * (dp.ndim - 1)))
    return {"pb": qb[0].ravel(), "pbub": qb[2].ravel(), "pbvb": qb[3].ravel(),
            "h": (a / gravity * dp).reshape(L, -1), "u": (q[1] / dp).reshape(L, -1),
            "v": (q[2] / dp).reshape(L, -1)}


def snapshot_gap(snap: dict, want: dict) -> float:
    """Widest relative gap between a snapshot's fields and the state's."""
    gap = 0.0
    for name, w in want.items():
        w = np.atleast_2d(w)
        s = np.atleast_2d(snap[name])
        scale = np.abs(w).max(axis=1)
        diff = np.abs(s - w).max(axis=1)
        gap = max(gap, float(np.max(np.where(scale > 0, diff / np.maximum(scale, 1e-300), diff))))
    return gap


def last_mass_line(path) -> tuple[int, list[float]]:
    """The step and the per-layer masses of a mass log's last line."""
    with open(path) as f:
        last = f.read().split("\n")
    last = [ln for ln in last if ln.strip()][-1].split()
    return int(last[0]), [float(v) for v in last[1:]]


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; `correct` when every number is at
    most its limit. A number with no limit fails (a cell's limits are set
    from readings, never left out)."""
    checks, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        passed = limit is not None and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
