"""Carry tables and state across from another implementation, via NumPy.

`from_numpy_tables` takes the JAX package's `Precomputed`, `DeviceGeom` and
`State` as NamedTuples (or plain tuples / dicts) of NumPy arrays — the
caller does the `np.asarray`, so this package never sees a foreign array
type — and returns the port's containers as tensors on one device. Fields
are matched by name where names are given and by position otherwise; the
two packages keep their fields in the same order.

`mega_tables_from_padded` brings the element and face tables of the JAX
package's megakernel operands (rows padded to lane blocks) into the layout
of this package's `ops/mega.MegaStatic`, so that a test can compare the
fields the two share.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import FaceDirGeom, Pair, Precomputed, State
from .ops.dg import DeviceGeom


def _fields(src, cls) -> dict:
    """{field name: value} of `src` for the NamedTuple class `cls`."""
    if isinstance(src, dict):
        items = src
    elif hasattr(src, "_asdict"):
        items = src._asdict()
    else:
        if len(src) != len(cls._fields):
            raise ValueError(
                f"{cls.__name__} has {len(cls._fields)} fields, got {len(src)}")
        items = dict(zip(cls._fields, src))
    missing = [f for f in cls._fields if f not in items]
    if missing:
        raise ValueError(f"{cls.__name__}: missing fields {missing}")
    return {f: items[f] for f in cls._fields}


def from_numpy_tables(P_np, g_np, state_np, device, dtype: torch.dtype):
    """Returns the port's (Precomputed, DeviceGeom, State) on `device`.

    Floating arrays are cast to `dtype`; `State.ok` stays boolean."""
    def cast(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def face_geom(src):
        return FaceDirGeom(**{k: cast(v) for k, v in _fields(src, FaceDirGeom).items()})

    pf = _fields(P_np, Precomputed)
    faces = pf.pop("faces")
    fx, fy = (faces["x"], faces["y"]) if isinstance(faces, dict) else (faces[0], faces[1])
    P = Precomputed(**{k: cast(v) for k, v in pf.items()},
                    faces=Pair(face_geom(fx), face_geom(fy)))
    g = DeviceGeom(**{k: cast(v) for k, v in _fields(g_np, DeviceGeom).items()})
    sf = _fields(state_np, State)
    state = State(qb_df=cast(sf["qb_df"]), q_df=cast(sf["q_df"]),
                  qprime_df=cast(sf["qprime_df"]), t=cast(sf["t"]),
                  ok=torch.tensor(np.asarray(sf["ok"]), dtype=torch.bool,
                                     device=device))
    return P, g, state


# lane blocks of the JAX package's megakernel side tables
_JAX_NGL_BLOCK = 8
_JAX_NQ_BLOCK = 16


def mega_tables_from_padded(mops_np, nelem: int, ngl: int, nq: int) -> dict:
    """The fields that the JAX package's MegaStatic (a NamedTuple or dict of
    NumPy arrays) shares with ops/mega.MegaStatic, as NumPy arrays in this
    package's layout: channel-row blocks `(C*E, padded)` become `(C, E, m)`,
    side tables `(C*E, 4*block)` become `(C, E, 4, m)`; the lane padding is
    dropped."""
    src = mops_np if isinstance(mops_np, dict) else mops_np._asdict()
    npts, nqq = ngl * ngl, nq * nq

    def rows(name, C, m):
        a = np.asarray(src[name])
        return a.reshape(C, nelem, a.shape[-1])[..., :m]

    def sides(name, C, block, m):
        a = np.asarray(src[name])
        return a.reshape(C, nelem, 4, block)[..., :m]

    return {
        "ptab": rows("ptab", 8, nqq),
        "btp_ref3": rows("btp_ref3", 3, npts),
        "massinv": rows("massinv3", 3, npts)[0],
        "pbprime_df": rows("pbprime_df", 1, npts)[0],
        "opbp_df": rows("opbp_df", 1, npts)[0],
        "masku": rows("masku", 1, npts)[0],
        "maskv": rows("maskv", 1, npts)[0],
        "ftab": sides("ftab", 13, _JAX_NQ_BLOCK, nq),
        "ntab": sides("ntab", 3, _JAX_NGL_BLOCK, ngl),
        # wall flag per (element, side) and wall mirror sign per (channel,
        # element, side): 1 away from the walls
        "wall": sides("mbnd_q", 4, _JAX_NQ_BLOCK, 1)[0, ..., 0] > 0,
        "mir_q": sides("mir_q", 4, _JAX_NQ_BLOCK, 1)[..., 0],
        "a_tab": np.asarray(src["a_tab"]),
        "b_tab": np.asarray(src["b_tab"]).reshape(-1),
    }
