"""Face trace extraction, BC mirrors, halo exchange and face scatter.

Counterpart of hnumo_tpu/core/faces.py: on a structured element grid every
trace is a static slice and every neighbor trace a shift, so extraction and
scatter are pure slicing + adds.

Every function here works on one block of elements. With `BCs.ax` / `BCs.ay`
None the block is the whole grid and owns both domain edges (the serial
code). Under a domain decomposition (parallel/sharding.py) they are the
block's `Axis` handles: the ghost edge slab of a neighbouring block arrives
through `_from_prev` / `_from_next` (one point-to-point exchange per
direction and sense for the whole channel stack, in place of the JAX
package's cyclic `ppermute`), and the domain-boundary closures (wall
mirrors, the periodic wrap) apply on the blocks that own a domain edge
only. Each process knows its own place, so the masks are Python bools: the
serial and the decomposed code differ only in where a ghost slab comes
from. An axis of one block is None, the serial code.

Face index convention (see hnumo_tpu_torch.mesh.grid): a block of (ly, lx)
elements has (ly, lx+1) x-faces and (ly+1, lx) y-faces; face fx sits
between elements fx-1 | fx. A face shared by two blocks is computed
REDUNDANTLY on both, from the same exchanged traces, and each block scatters
only into its own elements. Interior faces use the canonical orientation
L=west/south element, normal +x/+y. Boundary faces follow the reference
convention: L = the interior element, normal outward from the domain
(west/south boundary normal is -x/-y).

BC codes (reference face(8) = -code, src/p4est.c:1669;
src/mod_barotropic_terms.F90:79-92): 3=periodic, 4=free-slip (reflect
normal component), 2=no-slip (negate vector); 0=copy. Input code 5 is
treated as no-slip, as in the JAX package.

Nothing here mutates its arguments: the scatter and projection functions
return new tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import Tensor


class BCs(NamedTuple):
    """Static boundary-condition codes (west, east, south, north) plus the
    decomposition's axis handles for the element columns (ax) and rows (ay):
    parallel/sharding.Axis, or None for an axis of one block."""

    west: int
    east: int
    south: int
    north: int
    ax: object = None
    ay: object = None

    @property
    def x_periodic(self) -> bool:
        return self.west == 3

    @property
    def y_periodic(self) -> bool:
        return self.south == 3


class FaceLR(NamedTuple):
    """Left/right traces per direction."""

    xl: Tensor
    xr: Tensor
    yl: Tensor
    yr: Tensor


def _edge_masks(ax):
    """(am I the domain's west/south block, am I its east/north block)."""
    if ax is None:
        return True, True
    return ax.first, ax.last


def _from_prev(ax, slab: Tensor) -> Tensor:
    """Ghost slab from the previous block along `ax` (cyclic): my west/south
    ghost is the previous block's east/north edge slab."""
    if ax is None:
        return slab
    return ax.exchange(slab, from_prev=True)


def _from_next(ax, slab: Tensor) -> Tensor:
    """Ghost slab from the next block along `ax` (cyclic)."""
    if ax is None:
        return slab
    return ax.exchange(slab, from_prev=False)


def _mirror_signs(nchan: int, code: int, direction: str, vec_pairs) -> list:
    """Per-channel mirror sign (+1 copy / -1 negate) for one wall.

    Scalar channels copy; vector pairs: free-slip negates the normal
    component, no-slip negates both components."""
    sign = [1.0] * nchan
    if code == 4:
        for (iu, iv) in vec_pairs:
            sign[iu if direction == "x" else iv] = -1.0
    elif code in (2, 5):
        for (iu, iv) in vec_pairs:
            sign[iu] = -1.0
            sign[iv] = -1.0
    return sign


@functools.lru_cache(maxsize=None)
def _mirror_sign_tensor(nchan: int, code: int, direction: str, vec_pairs,
                        ndim: int, dtype: torch.dtype, device: torch.device) -> Tensor:
    """_mirror_signs as a (nchan, 1, ..., 1) tensor of `ndim` dims on `device`.

    Cached: the barotropic stage asks for the same few sign vectors
    thousands of times per step, and each fresh one would be a host-to-device
    copy inside the stage loop. The cache holds a handful of tiny tensors."""
    s = _mirror_signs(nchan, code, direction, vec_pairs)
    return torch.tensor(s, dtype=dtype, device=device).reshape(
        (nchan,) + (1,) * (ndim - 1))


def extract_faces_stacked(q: Tensor, bc: BCs, vec_pairs=()):
    """Nodal (or quad) face traces with BC closure — channel-stacked.

    q: (C, ..., ly, lx, m, m) stacked fields. Channels named in `vec_pairs`
    (tuples of (iu, iv) indices) form vector fields and get the
    free-slip/no-slip wall mirror; the rest get scalar copy mirrors.

    The halo exchange is one call of _from_prev / _from_next per direction
    and sense on the whole channel stack (4 in all), not one per field, as
    in the JAX package (the reference packs all variables of a face into one
    MPI message, src/send_receive_bound.F90).

    Returns stacked (xl, xr, yl, yr); x-traces (C, ..., ly, lx+1, m),
    y-traces (C, ..., ly+1, lx, m).
    """
    east = q[..., :, :, :, -1]     # (C, ..., ly, lx, m)
    west = q[..., :, :, :, 0]
    north = q[..., :, :, -1, :]
    south = q[..., :, :, 0, :]
    return extract_faces_from_slabs(east, west, north, south, bc, vec_pairs)


def extract_faces_from_slabs(east: Tensor, west: Tensor, north: Tensor,
                             south: Tensor, bc: BCs, vec_pairs=()):
    """extract_faces_stacked from the four edge slabs (C, ..., ly, lx, m).

    Lets a caller that holds its fields in the flat element-major layout
    (the fused barotropic path) build traces from strided views of the
    edge nodes, without the structured field."""
    C = east.shape[0]
    vec_pairs = tuple(tuple(p) for p in vec_pairs)

    def msig(code, direction):
        return _mirror_sign_tensor(C, code, direction, vec_pairs, east.ndim,
                                   east.dtype, east.device)

    # ---- x-direction (face axis extends the lx axis = -2 of the slabs) ----
    ghost_w = _from_prev(bc.ax, east[..., -1:, :])
    ghost_e = _from_next(bc.ax, west[..., :1, :])
    w_own = west[..., :1, :]
    e_own = east[..., -1:, :]
    if bc.x_periodic:
        xl0, xr0, xrL = ghost_w, w_own, ghost_e
    else:
        wfirst, elast = _edge_masks(bc.ax)
        xl0 = w_own if wfirst else ghost_w
        xr0 = msig(bc.west, "x") * w_own if wfirst else w_own
        xrL = msig(bc.east, "x") * e_own if elast else ghost_e
    xl = torch.cat([xl0, east], dim=-2)
    xr = torch.cat([xr0, west[..., 1:, :], xrL], dim=-2)

    # ---- y-direction (face axis extends the ly axis = -3 of the slabs) ----
    ghost_s = _from_prev(bc.ay, north[..., -1:, :, :])
    ghost_n = _from_next(bc.ay, south[..., :1, :, :])
    s_own = south[..., :1, :, :]
    n_own = north[..., -1:, :, :]
    if bc.y_periodic:
        yl0, yr0, yrL = ghost_s, s_own, ghost_n
    else:
        sfirst, nlast = _edge_masks(bc.ay)
        yl0 = s_own if sfirst else ghost_s
        yr0 = msig(bc.south, "y") * s_own if sfirst else s_own
        yrL = msig(bc.north, "y") * n_own if nlast else ghost_n
    yl = torch.cat([yl0, north], dim=-3)
    yr = torch.cat([yr0, south[..., 1:, :, :], yrL], dim=-3)

    return xl, xr, yl, yr


def extract_faces_multi(q: Tensor, bc: BCs, vec_pairs=()) -> list[FaceLR]:
    """Per-channel FaceLR view of extract_faces_stacked (same semantics)."""
    xl, xr, yl, yr = extract_faces_stacked(q, bc, vec_pairs)
    return [FaceLR(xl=xl[c], xr=xr[c], yl=yl[c], yr=yr[c])
            for c in range(q.shape[0])]


def extract_faces(u: Tensor, bc: BCs, v: Tensor | None = None):
    """Nodal (or quad) face traces with BC closure.

    u: (..., ly, lx, m, m) field. If `v` is given, (u, v) is treated as a
    vector field and wall mirrors are applied per BC code; otherwise scalar
    copy mirrors. Returns FaceLR for u (and for v when given, else None).
    x-traces have shape (..., ly, lx+1, m); y-traces (..., ly+1, lx, m).
    """
    if v is None:
        return extract_faces_multi(u[None], bc)[0], None
    outs = extract_faces_multi(torch.stack([u, v]), bc, vec_pairs=((0, 1),))
    return outs[0], outs[1]


def face_views_x(S: Tensor, bc: BCs):
    """Element-aligned edge-add views of x-face scatter values.

    Returns (Sw, Se), each (..., ly, lx, m), such that
    `scatter_face_x(rhs, S, bc)` == adding Se to each element's east edge and
    Sw to its west edge."""
    Se = -S[..., :, 1:, :]
    w0 = S[..., :, :1, :]
    if not bc.x_periodic and _edge_masks(bc.ax)[0]:
        w0 = -w0
    Sw = torch.cat([w0, S[..., :, 1:-1, :]], dim=-2)
    return Sw, Se


def face_views_y(S: Tensor, bc: BCs):
    """Element-aligned edge-add views of y-face scatter values (see
    face_views_x). Returns (Ss, Sn), each (..., ly, lx, m)."""
    Sn = -S[..., 1:, :, :]
    s0 = S[..., :1, :, :]
    if not bc.y_periodic and _edge_masks(bc.ay)[0]:
        s0 = -s0
    Ss = torch.cat([s0, S[..., 1:-1, :, :]], dim=-3)
    return Ss, Sn


def face_n2q(psiq: Tensor, f: Tensor) -> Tensor:
    """Interpolate face-nodal traces (..., ngl) to face quad points (..., nq)."""
    return torch.einsum("...n,nq->...q", f, psiq)


def face_quad_scatter(psiq: Tensor, jac_face: Tensor, flux: Tensor) -> Tensor:
    """Per-face nodal scatter values S_n = sum_q jac_face_q * psi_n(q) * flux_q.

    flux: (..., nfaces..., nq); jac_face broadcastable to it. Returns (..., ngl).
    Matches the face Gauss-Lobatto integration of reference flux kernels
    (src/mod_rhs_btp.F90:320-363).
    """
    return torch.einsum("...q,nq->...n", jac_face * flux, psiq)


def scatter_face_x(rhs: Tensor, S: Tensor, bc: BCs, S_right: Tensor | None = None) -> Tensor:
    """Accumulate x-face scatter values into element east/west edges.

    rhs: (..., ly, lx, m, m); S: (..., ly, lx+1, m) per-face values.
    Sign convention: L side receives -S, R side +S_right (defaults to S),
    matching reference flux kernels (src/mod_rhs_btp.F90:347-359; the layer
    momentum flux scatters side-specific H values,
    src/mod_create_rhs_mlswe.F90:786-812). At a domain-west wall the interior
    element is the L side of face 0, so it receives -S there; on a block
    that does not own the west edge face 0 is an ordinary shared face, and
    its R side (this block) receives +S_right.
    Returns a new tensor.
    """
    if S_right is None:
        S_right = S
    out = rhs.clone()
    out[..., :, :, :, -1] -= S[..., :, 1:, :]
    wall = not bc.x_periodic and _edge_masks(bc.ax)[0]
    w0 = -S[..., :, :1, :] if wall else S_right[..., :, :1, :]
    out[..., :, :, :, 0] += torch.cat([w0, S_right[..., :, 1:-1, :]], dim=-2)
    return out


def scatter_face_y(rhs: Tensor, S: Tensor, bc: BCs, S_right: Tensor | None = None) -> Tensor:
    """Accumulate y-face scatter values into element north/south edges.
    Returns a new tensor."""
    if S_right is None:
        S_right = S
    out = rhs.clone()
    out[..., :, :, -1, :] -= S[..., 1:, :, :]
    wall = not bc.y_periodic and _edge_masks(bc.ay)[0]
    s0 = -S[..., :1, :, :] if wall else S_right[..., :1, :, :]
    out[..., :, :, 0, :] += torch.cat([s0, S_right[..., 1:-1, :, :]], dim=-3)
    return out


def apply_face_plus_minus(rhs_u, rhs_v, SxU, SxV, SyU, SyV, bc: BCs):
    """LDG face signs of the viscous fluxes: L side +, R side - (reference
    src/mod_laplacian_quad.F90:704-716). Returns new tensors."""
    rhs_u = scatter_face_x(rhs_u, -SxU, bc)
    rhs_u = scatter_face_y(rhs_u, -SyU, bc)
    rhs_v = scatter_face_x(rhs_v, -SxV, bc)
    rhs_v = scatter_face_y(rhs_v, -SyV, bc)
    return rhs_u, rhs_v


def apply_wall_projection(qu: Tensor, qv: Tensor, bc: BCs):
    """Project nodal momentum at wall nodes (free-slip: zero normal comp;
    no-slip: zero vector). Reference btp_mom_boundary_df / layer_mom_boundary_df
    (src/mod_barotropic_terms.F90:165-217, src/mod_layer_terms.F90:529-584).

    qu, qv: (..., ly, lx, ngl, ngl). Structured-grid form: x-walls zero the
    x-momentum at west/east edge nodes, y-walls the y-momentum; no-slip zeroes
    both. Corner nodes receive both projections, as in the reference loop.
    Only the blocks that own a domain edge apply its projection.
    Returns new tensors.
    """
    wfirst, elast = _edge_masks(bc.ax)
    sfirst, nlast = _edge_masks(bc.ay)
    qu, qv = qu.clone(), qv.clone()
    x_idx = {"w": (Ellipsis, slice(None), 0, slice(None), 0),
             "e": (Ellipsis, slice(None), -1, slice(None), -1)}
    y_idx = {"s": (Ellipsis, 0, slice(None), 0, slice(None)),
             "n": (Ellipsis, -1, slice(None), -1, slice(None))}

    for code, side, owner in ((bc.west, "w", wfirst), (bc.east, "e", elast)):
        if not owner:
            continue
        if code == 4:
            qu[x_idx[side]] = 0.0
        elif code in (2, 5):
            qu[x_idx[side]] = 0.0
            qv[x_idx[side]] = 0.0
    for code, side, owner in ((bc.south, "s", sfirst), (bc.north, "n", nlast)):
        if not owner:
            continue
        if code == 4:
            qv[y_idx[side]] = 0.0
        elif code in (2, 5):
            qu[y_idx[side]] = 0.0
            qv[y_idx[side]] = 0.0
    return qu, qv


def wall_projection_masks(shape, bc: BCs, dtype: torch.dtype, device):
    """Multiplicative masks equivalent to apply_wall_projection.

    shape: (ly, lx, ngl, ngl). Returns (mask_u, mask_v) with 0.0 at nodes
    where that momentum component is zeroed by the wall projection, 1.0
    elsewhere: ones on the edges of a block that owns no wall."""
    ones = torch.ones(shape, dtype=dtype, device=device)
    return apply_wall_projection(ones, ones, bc)


def all_shards_and(ok: Tensor, bc: BCs) -> Tensor:
    """Logical AND of a boolean scalar over all blocks: one all-reduce under
    a decomposition, `ok` itself on one block."""
    axis = bc.ax if bc.ax is not None else bc.ay
    if axis is None:
        return ok
    return axis.dec.all_and(ok)
