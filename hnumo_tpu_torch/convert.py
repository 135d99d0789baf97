"""Carry tables and state across from another implementation, via NumPy.

`from_numpy_tables` takes the JAX package's `Precomputed`, `DeviceGeom` and
`State` as NamedTuples (or plain tuples / dicts) of NumPy arrays — the
caller does the `np.asarray`, so this package never sees a foreign array
type — and returns the port's containers as tensors on one device. Fields
are matched by name where names are given and by position otherwise; the
two packages keep their fields in the same order.

`block_from_numpy` does the same for one block of a domain decomposition:
it takes the JAX package's whole-grid arrays (what its `to_host` gathers)
to a rank's block, cut as `parallel/sharding.local_tables` cuts the port's
own, so that a decomposed model of each package steps on the same tables.

`mega_tables_from_padded` brings the element and face tables of the JAX
package's megakernel operands (rows padded to lane blocks) into the layout
of this package's `ops/mega.MegaStatic`, so that a test can compare the
fields the two share.

`vol_ops_uni_from_padded`, `face_tables_from_padded` and
`update_ops_from_padded` do the same for the three operand bundles of the
fused barotropic stage (the JAX package's `BtpVolOpsUni`, `FaceTailTables`,
`UpdateOps`): the edge-replicated elements and faces that pad them to a tile
multiple are dropped, so that a test can run a stage of this package on the
other package's own tables.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import FaceDirGeom, Pair, Precomputed, State
from .ops.btp_tail import FaceTailTables, UpdateOps
from .ops.btp_volume_uni import BtpVolOpsUni
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


def block_from_numpy(P_np, g_np, state_np, block, device, dtype: torch.dtype):
    """from_numpy_tables for one block: (Precomputed, DeviceGeom, State) of
    the block `block` (a parallel/sharding.Decomposition, or ((py, px),
    (iy, ix))) out of the JAX package's whole-grid tables and state."""
    from .parallel.sharding import local_state, local_tables

    P, g, state = from_numpy_tables(P_np, g_np, state_np, "cpu", dtype)
    g, P = local_tables(g, P, block)
    state = local_state(state, block)

    def dev(tree):
        return type(tree)(*[dev(t) if isinstance(t, tuple) else t.to(device)
                            for t in tree])
    return dev(P), dev(g), dev(state)


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


def _asdict(src) -> dict:
    return src if isinstance(src, dict) else src._asdict()


def vol_ops_uni_from_padded(ops_np, like: BtpVolOpsUni) -> BtpVolOpsUni:
    """The JAX package's BtpVolOpsUni (NumPy arrays; element axis padded) as
    this package's: its Kronecker matrices and element tables, the latter cut
    to the element count of `like`, replace those of `like` — the bundle this
    package built for the same grid (`operators_uniform`), which supplies the
    1-D tables the other package does not carry."""
    src = _asdict(ops_np)
    E = like.ptab.shape[1]

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=like.K.dtype, device=like.K.device)

    grad = {k: (None if src.get(k) is None else cast(src[k])) for k in ("Gx", "Gy")}
    return like._replace(K=cast(src["K"]), M2=cast(src["M2"]),
                         ptab=cast(np.asarray(src["ptab"])[:, :E]),
                         pbp_df=cast(np.asarray(src["pbp_df"])[:E]), **grad)


def face_tables_from_padded(tabs_np, use_visc: bool, device,
                            dtype: torch.dtype) -> FaceTailTables:
    """The JAX package's FaceTailTables (NumPy arrays; face axis padded to
    `Fp`) as this package's, cut to the nfx + nfy faces; `bgf` is None when
    inviscid (there it is a block of zeros)."""
    src = _asdict(tabs_np)
    nfx, nfy = int(src["nfx"]), int(src["nfy"])
    F = nfx + nfy

    def cast(a):
        return torch.tensor(np.asarray(a)[:, :F], dtype=dtype, device=device)

    return FaceTailTables(
        ftab=cast(src["ftab"]), ntab=cast(src["ntab"]),
        bgf=cast(src["bgf"]) if use_visc else None,
        psiq=torch.tensor(np.asarray(src["psiq"]), dtype=dtype, device=device),
        nfx=nfx, nfy=nfy)


def update_ops_from_padded(uops_np, like: UpdateOps) -> UpdateOps:
    """The JAX package's UpdateOps (NumPy arrays; element axis padded) as this
    package's: its matrices and element tables replace those of `like`
    (`build_update_ops` on the same grid), which supplies the 1-D tables."""
    src = _asdict(uops_np)
    E = like.ref.shape[1]

    def cast(a):
        return torch.tensor(np.asarray(a), dtype=like.ref.dtype, device=like.ref.device)

    return like._replace(
        Escat=cast(src["Escat"]), Evisc=cast(src["Evisc"]), Vx=cast(src["Vx"]),
        Vy=cast(src["Vy"]), pbprime_df=cast(np.asarray(src["pbprime_df"])[:E]),
        ref=cast(np.asarray(src["ref"])[:, :E]))
