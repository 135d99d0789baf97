"""Structured 2D DG mesh + geometry tables, element-major layout.

Own copy for the PyTorch package of hnumo_tpu/mesh/grid.py: the brick
constructor and the isoparametric curvilinear ones that external (gmsh) meshes
take (mesh/gmsh.py).

Replaces the reference's p4est brick + metric machinery
(src/mod_p4est.F90:216-415, src/metrics_quad.F90:8-126,
src/create_normals_quad.F90:8-216, src/create_mass.F90:5-39) with a
regular (nely, nelx) logical element grid. All shipped reference cases are
bricks rescaled to [xdims]x[ydims] (src/mod_p4est.F90:344-370), so this
covers them exactly; the geometry arrays are kept fully general
(per-element, per-point metrics) so curvilinear/gmsh meshes can reuse the
same compute path.

Layout convention (no indirection):
  nodal fields   (..., nely, nelx, ngl_j, ngl_i)   j=y-node, i=x-node
  quad fields    (..., nely, nelx, nq_j, nq_i)
  x-face fields  (..., nely, nelx+1, n)            n along y
  y-face fields  (..., nely+1, nelx, n)            n along x
DG nodes are duplicated per element; the lumped mass matrix is just the
per-node jacobian weight (reference sums jac into distinct DG dofs,
src/create_mass.F90:5-39, so mass==jac pointwise).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..basis.lgl import Basis1D


@dataclasses.dataclass
class Geometry:
    """Static geometry tables (host NumPy, float64). Cast on device transfer."""

    nelx: int
    nely: int
    ngl: int
    nq: int
    # basis tables
    psiq: np.ndarray      # (ngl, nq) node->quad interpolation
    dpsiq: np.ndarray     # (ngl, nq) node->quad derivative (d/dxi)
    dpsi: np.ndarray      # (ngl, ngl) nodal differentiation matrix
    wgl: np.ndarray       # (ngl,)
    wnq: np.ndarray       # (nq,)
    xgl: np.ndarray
    xnq: np.ndarray
    # coordinates
    coord: np.ndarray     # (nely, nelx, ngl, ngl, 2) nodal (x, y)
    coord_q: np.ndarray   # (nely, nelx, nq, nq, 2)
    # volume metrics at quad points (each (nely, nelx, nq, nq))
    ksiq_x: np.ndarray
    ksiq_y: np.ndarray
    etaq_x: np.ndarray
    etaq_y: np.ndarray
    wjac: np.ndarray      # w_i w_j |J| at quad points
    # volume metrics at nodal points (each (nely, nelx, ngl, ngl))
    ksi_x: np.ndarray
    ksi_y: np.ndarray
    eta_x: np.ndarray
    eta_y: np.ndarray
    wjac_df: np.ndarray   # lumped DG mass
    massinv: np.ndarray   # 1 / wjac_df
    # face geometry, quad resolution
    jac_facex: np.ndarray  # (nely, nelx+1, nq)
    nx_x: np.ndarray       # (nely, nelx+1, nq) outward-from-L normal x-comp
    ny_x: np.ndarray
    jac_facey: np.ndarray  # (nely+1, nelx, nq)
    nx_y: np.ndarray
    ny_y: np.ndarray
    # face geometry, nodal resolution
    jac_facex_df: np.ndarray  # (nely, nelx+1, ngl)
    jac_facey_df: np.ndarray
    nx_x_df: np.ndarray
    ny_x_df: np.ndarray
    nx_y_df: np.ndarray
    ny_y_df: np.ndarray
    # BC codes (west, east, south, north); 3=periodic, 4=free-slip, 2/5=no-slip
    bc: tuple[int, int, int, int] = (4, 4, 4, 4)

    @property
    def x_periodic(self) -> bool:
        return self.bc[0] == 3

    @property
    def y_periodic(self) -> bool:
        return self.bc[2] == 3


def _metrics_from_coords(x, y, D_ksi_j, D_ksi_i, w_j, w_i):
    """Curvilinear inverse metrics + weighted jacobian at the target grid.

    x, y: (nely, nelx, ngl, ngl) nodal coordinates.
    D_ksi_i: (ngl, m) interpolation/derivative operator applied on the i axis.
    Returns dict of (nely, nelx, m, m) arrays. Matches the 2D branch of
    reference src/metrics_quad.F90:63-119 (z collapsed, zeta_z=1).
    """
    def apply(u, Aj, Ai):
        return np.einsum("eyji,jJ,iI->eyJI", u, Aj, Ai, optimize=True)

    # interpolate mapping derivatives to target points
    P_j, D_j = D_ksi_j
    P_i, D_i = D_ksi_i
    x_ksi = apply(x, P_j, D_i)
    x_eta = apply(x, D_j, P_i)
    y_ksi = apply(y, P_j, D_i)
    y_eta = apply(y, D_j, P_i)
    xj = x_ksi * y_eta - x_eta * y_ksi  # 2D jacobian determinant
    ksi_x = y_eta / xj
    ksi_y = -x_eta / xj
    eta_x = -y_ksi / xj
    eta_y = x_ksi / xj
    wjac = w_j[None, None, :, None] * w_i[None, None, None, :] * np.abs(xj)
    return dict(ksi_x=ksi_x, ksi_y=ksi_y, eta_x=eta_x, eta_y=eta_y, wjac=wjac,
                x_ksi=x_ksi, x_eta=x_eta, y_ksi=y_ksi, y_eta=y_eta)


def _face_geometry_from_coords(coord: np.ndarray, deriv: np.ndarray,
                               wline: np.ndarray, bc) -> tuple:
    """General curvilinear face normals + jacobians from nodal coordinates.

    coord: (nely, nelx, ngl, ngl, 2). deriv: (ngl, m) tangential derivative
    operator at the m face points (dpsiq for the quad grid, dpsi for nodal).
    Face geometry is evaluated from the LEFT element's edge (west/south
    neighbor; the single interior element at boundaries, with the normal
    flipped outward — reference p4est convention,
    src/create_normals_quad.F90:95-212).
    """
    x, y = coord[..., 0], coord[..., 1]
    x_periodic, y_periodic = bc[0] == 3, bc[2] == 3

    # --- x-faces: tangent = d(x,y)/d(eta) along a constant-xi edge --------
    def xface_tangent(xe, ye):  # (nely, F, ngl) edge coords -> (nely, F, m)
        return (np.einsum("efj,jm->efm", xe, deriv, optimize=True),
                np.einsum("efj,jm->efm", ye, deriv, optimize=True))

    # edge arrays: x[:, e, j, -1] -> (nely, nelx, ngl) with j last
    east_x = x[:, :, :, -1]
    east_y = y[:, :, :, -1]
    if x_periodic:
        edge_x = np.concatenate([east_x[:, -1:], east_x], axis=1)
        edge_y = np.concatenate([east_y[:, -1:], east_y], axis=1)
        flip0 = False
    else:
        edge_x = np.concatenate([x[:, :1, :, 0], east_x], axis=1)
        edge_y = np.concatenate([y[:, :1, :, 0], east_y], axis=1)
        flip0 = True
    tx, ty = xface_tangent(edge_x, edge_y)
    norm = np.hypot(tx, ty)
    nx_x, ny_x = ty / norm, -tx / norm    # +grad(xi) direction (outward-from-L)
    if flip0:
        nx_x[:, 0], ny_x[:, 0] = -nx_x[:, 0], -ny_x[:, 0]
    jac_facex = wline[None, None, :] * norm

    # --- y-faces: tangent = d(x,y)/d(xi) along a constant-eta edge --------
    north_x, north_y = x[:, :, -1, :], y[:, :, -1, :]
    if y_periodic:
        edge_x = np.concatenate([north_x[-1:], north_x], axis=0)
        edge_y = np.concatenate([north_y[-1:], north_y], axis=0)
        flip0 = False
    else:
        edge_x = np.concatenate([x[:1, :, 0, :], north_x], axis=0)
        edge_y = np.concatenate([y[:1, :, 0, :], north_y], axis=0)
        flip0 = True
    tx = np.einsum("fei,im->fem", edge_x, deriv, optimize=True)
    ty = np.einsum("fei,im->fem", edge_y, deriv, optimize=True)
    norm = np.hypot(tx, ty)
    nx_y, ny_y = -ty / norm, tx / norm    # +grad(eta) direction
    if flip0:
        nx_y[0], ny_y[0] = -nx_y[0], -ny_y[0]
    jac_facey = wline[None, None, :] * norm

    return jac_facex, nx_x, ny_x, jac_facey, nx_y, ny_y


def build_geometry_from_coords(
    coord: np.ndarray,
    nop: int,
    bc: tuple[int, int, int, int] = (4, 4, 4, 4),
    exact_integration: bool = True,
) -> Geometry:
    """Build geometry tables from general (curvilinear) nodal coordinates.

    coord: (nely, nelx, ngl, ngl, 2) isoparametric LGL node positions —
    the general path used by external/gmsh meshes (reference read_gmsh +
    metrics, src/read_gmsh.F90:249-330, src/metrics_quad.F90:8-126).
    """
    b = Basis1D(nop, exact_integration)
    ngl, nq = b.ngl, b.nq
    nely, nelx = coord.shape[0], coord.shape[1]
    if coord.shape[2] != ngl or coord.shape[3] != ngl:
        raise ValueError(f"coord node axes {coord.shape[2:4]} != ngl {ngl}")
    x, y = coord[..., 0], coord[..., 1]

    coord_q = np.stack(
        [np.einsum("eyji,jJ,iI->eyJI", c, b.psiq, b.psiq, optimize=True)
         for c in (x, y)], axis=-1)

    mq = _metrics_from_coords(x, y, (b.psiq, b.dpsiq), (b.psiq, b.dpsiq), b.wnq, b.wnq)
    eye = np.eye(ngl)
    mn = _metrics_from_coords(x, y, (eye, b.dpsi), (eye, b.dpsi), b.wgl, b.wgl)

    jac_facex, nx_x, ny_x, jac_facey, nx_y, ny_y = _face_geometry_from_coords(
        coord, b.dpsiq, b.wnq, bc)
    (jac_facex_df, nx_x_df, ny_x_df,
     jac_facey_df, nx_y_df, ny_y_df) = _face_geometry_from_coords(
        coord, b.dpsi, b.wgl, bc)

    return Geometry(
        nelx=nelx, nely=nely, ngl=ngl, nq=nq,
        psiq=b.psiq, dpsiq=b.dpsiq, dpsi=b.dpsi,
        wgl=b.wgl, wnq=b.wnq, xgl=b.xgl, xnq=b.xnq,
        coord=coord, coord_q=coord_q,
        ksiq_x=mq["ksi_x"], ksiq_y=mq["ksi_y"], etaq_x=mq["eta_x"], etaq_y=mq["eta_y"],
        wjac=mq["wjac"],
        ksi_x=mn["ksi_x"], ksi_y=mn["ksi_y"], eta_x=mn["eta_x"], eta_y=mn["eta_y"],
        wjac_df=mn["wjac"], massinv=1.0 / mn["wjac"],
        jac_facex=jac_facex, nx_x=nx_x, ny_x=ny_x,
        jac_facey=jac_facey, nx_y=nx_y, ny_y=ny_y,
        jac_facex_df=jac_facex_df, jac_facey_df=jac_facey_df,
        nx_x_df=nx_x_df, ny_x_df=ny_x_df, nx_y_df=nx_y_df, ny_y_df=ny_y_df,
        bc=bc,
    )


def build_geometry_from_corners(
    corners: np.ndarray,
    nop: int,
    bc: tuple[int, int, int, int] = (4, 4, 4, 4),
    exact_integration: bool = True,
) -> Geometry:
    """Geometry from bilinear corner vertices (nely+1, nelx+1, 2): populate
    LGL nodes per element by bilinear mapping (the reference's high-order
    fill of a linear gmsh grid, src/read_gmsh.F90:249-330)."""
    b = Basis1D(nop, exact_integration)
    s = (b.xgl + 1.0) / 2.0
    c00 = corners[:-1, :-1][:, :, None, None, :]
    c01 = corners[:-1, 1:][:, :, None, None, :]
    c10 = corners[1:, :-1][:, :, None, None, :]
    c11 = corners[1:, 1:][:, :, None, None, :]
    sj = s[None, None, :, None, None]
    si = s[None, None, None, :, None]
    coord = ((1 - sj) * ((1 - si) * c00 + si * c01)
             + sj * ((1 - si) * c10 + si * c11))
    return build_geometry_from_coords(coord, nop, bc=bc,
                                      exact_integration=exact_integration)


def build_geometry(
    nelx: int,
    nely: int,
    nop: int,
    xdims: tuple[float, float],
    ydims: tuple[float, float],
    bc: tuple[int, int, int, int] = (4, 4, 4, 4),
    exact_integration: bool = True,
) -> Geometry:
    """Build the full geometry for a uniform structured brick."""
    b = Basis1D(nop, exact_integration)
    ngl, nq = b.ngl, b.nq

    dx = (xdims[1] - xdims[0]) / nelx
    dy = (ydims[1] - ydims[0]) / nely

    ex = np.arange(nelx)
    ey = np.arange(nely)
    # nodal coordinates per element
    xn = xdims[0] + dx * (ex[None, :, None, None] + (b.xgl[None, None, None, :] + 1.0) / 2.0)
    yn = ydims[0] + dy * (ey[:, None, None, None] + (b.xgl[None, None, :, None] + 1.0) / 2.0)
    x = np.broadcast_to(xn, (nely, nelx, ngl, ngl)).copy()
    y = np.broadcast_to(yn, (nely, nelx, ngl, ngl)).copy()
    coord = np.stack([x, y], axis=-1)

    xqn = xdims[0] + dx * (ex[None, :, None, None] + (b.xnq[None, None, None, :] + 1.0) / 2.0)
    yqn = ydims[0] + dy * (ey[:, None, None, None] + (b.xnq[None, None, :, None] + 1.0) / 2.0)
    coord_q = np.stack(
        [np.broadcast_to(xqn, (nely, nelx, nq, nq)), np.broadcast_to(yqn, (nely, nelx, nq, nq))],
        axis=-1,
    ).copy()

    mq = _metrics_from_coords(x, y, (b.psiq, b.dpsiq), (b.psiq, b.dpsiq), b.wnq, b.wnq)
    eye = np.eye(ngl)
    mn = _metrics_from_coords(x, y, (eye, b.dpsi), (eye, b.dpsi), b.wgl, b.wgl)

    # ---- face geometry -------------------------------------------------
    # x-faces (normal +-x): outward-from-L normal; L is the west element for
    # interior faces and the single interior element for boundary faces
    # (reference p4est convention: boundary normals point out of the domain,
    # src/create_normals_quad.F90:95-212).
    def face_tables(npts, wline):
        # x-faces: along-face coordinate is y. For the affine brick the face
        # tangent length is dy/2 everywhere; keep per-face arrays for later
        # curvilinear support.
        jac_x = np.full((nely, nelx + 1, npts), (dy / 2.0)) * wline[None, None, :]
        nx_x = np.ones((nely, nelx + 1, npts))
        nx_x[:, 0, :] = -1.0 if bc[0] != 3 else 1.0  # west wall: outward -x
        ny_x = np.zeros((nely, nelx + 1, npts))
        jac_y = np.full((nely + 1, nelx, npts), (dx / 2.0)) * wline[None, None, :]
        ny_y = np.ones((nely + 1, nelx, npts))
        ny_y[0, :, :] = -1.0 if bc[2] != 3 else 1.0  # south wall: outward -y
        nx_y = np.zeros((nely + 1, nelx, npts))
        return jac_x, nx_x, ny_x, jac_y, nx_y, ny_y

    jac_facex, nx_x, ny_x, jac_facey, nx_y, ny_y = face_tables(nq, b.wnq)
    jac_facex_df, nx_x_df, ny_x_df, jac_facey_df, nx_y_df, ny_y_df = face_tables(ngl, b.wgl)

    return Geometry(
        nelx=nelx, nely=nely, ngl=ngl, nq=nq,
        psiq=b.psiq, dpsiq=b.dpsiq, dpsi=b.dpsi,
        wgl=b.wgl, wnq=b.wnq, xgl=b.xgl, xnq=b.xnq,
        coord=coord, coord_q=coord_q,
        ksiq_x=mq["ksi_x"], ksiq_y=mq["ksi_y"], etaq_x=mq["eta_x"], etaq_y=mq["eta_y"],
        wjac=mq["wjac"],
        ksi_x=mn["ksi_x"], ksi_y=mn["ksi_y"], eta_x=mn["eta_x"], eta_y=mn["eta_y"],
        wjac_df=mn["wjac"], massinv=1.0 / mn["wjac"],
        jac_facex=jac_facex, nx_x=nx_x, ny_x=ny_x,
        jac_facey=jac_facey, nx_y=nx_y, ny_y=ny_y,
        jac_facex_df=jac_facex_df, jac_facey_df=jac_facey_df,
        nx_x_df=nx_x_df, ny_x_df=ny_x_df, nx_y_df=nx_y_df, ny_y_df=ny_y_df,
        bc=bc,
    )
