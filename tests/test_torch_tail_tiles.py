"""The tile decomposition of the CUDA face and update kernels
(hnumo_tpu_torch/ops/csrc/btp_faces.cu, btp_update.cu) as a numpy model,
against the plain versions `btp_faces_plain` / `btp_update_plain`.

The kernels cannot run without a card; this model repeats what their blocks
do, tile by tile, with their index arithmetic: a tile of G consecutive faces
(elements), its inputs copied run by run into a stage (the slot layout of the
sources, the rest of the stage left NaN so that a read past the tile's runs
or of a slot that was not staged spoils the result), one thread's work per
(face, quad point), (face, edge node), (channel, face, node) for F and per
(element, node), all three rows, for U, and every output written once (a
count per value says so). It covers full tiles and a ragged last tile, face
and element counts 0, 1, 2 and 3 modulo 4, viscous and inviscid, p=4 and
p=8, and the tile sizes the kernels choose in f32 and in f64 (the layout
rule of the sources, mirrored here). Tolerance 1e-12 of each output's max in
f64: the same operations as the plain versions, in another order of
summation. The kernels themselves are held against the plain versions on the
card by chip_smoke.py."""
import functools

import numpy as np
import pytest
import torch

from hnumo_tpu_torch.model import Model
from hnumo_tpu_torch.ops import btp_tail as tb
from test_torch_common import assert_close, torch_config

# ---- the layout rule of the sources (btp_tail_common.cuh, btp_faces.cu,
# btp_update.cu): slots of a stage, shared memory of a block, tile size,
# blocks per SM ----

SMEM_LIMIT = 232448      # btp_volume_common.cuh kSmemLimit
F_NODAL, F_QUAD = 39, 31          # btp_faces.cu kNodalSlots, kQuadSlots
U_NODAL, U_EDGE = 27, 5           # btp_update.cu kNodalSlots, kEdgeSlots


def slot_values(count, itemsize):
    per16 = 16 // itemsize
    return (count + per16 - 1) // per16 * per16


def faces_smem(itemsize, n, m, G):
    sv = functools.partial(slot_values, itemsize=itemsize)
    stage = F_NODAL * sv(G * n) + F_QUAD * sv(G * m)
    return itemsize * (2 * sv(stage) + sv(3 * sv(G * m)) + sv(n * m))


def update_smem(itemsize, n, G):
    sv = functools.partial(slot_values, itemsize=itemsize)
    npts = n * n
    stage = U_NODAL * sv(G * npts) + U_EDGE * sv(G * 4 * n)
    return itemsize * (2 * sv(stage) + sv(4 * sv(G * npts)) + sv(n * n) + sv(2 * npts)
                       + sv(npts))


def tile_budget(blocks):
    return 233472 // blocks - 1024


def pick_tile(bytes_of, most, blocks):
    G = most
    while G >= 8 and bytes_of(G) > tile_budget(blocks):
        G //= 2
    while G >= 1 and bytes_of(G) > SMEM_LIMIT:
        G //= 2
    return G


def faces_tile(itemsize, n, m):
    return pick_tile(lambda G: faces_smem(itemsize, n, m, G), 24, 2)


def update_tile(itemsize, n):
    return pick_tile(lambda G: update_smem(itemsize, n, G), 16, 2)


def test_the_layout_rule_gives_the_tiles_the_sources_describe():
    """Tiles of 24 faces / 16 elements at p=4 in f32 (two blocks per SM),
    halved in f64 and where p=8 needs more room, never below 4 where the
    card's limit allows 4."""
    assert [faces_tile(4, 5, 9), faces_tile(8, 5, 9), faces_tile(4, 9, 17),
            faces_tile(8, 9, 17)] == [24, 12, 12, 6]
    assert [update_tile(4, 5), update_tile(8, 5), update_tile(4, 9),
            update_tile(8, 9)] == [16, 8, 4, 4]
    assert faces_smem(4, 5, 9, 24) == 93792 and update_smem(4, 5, 16) == 106032
    assert 2 * (faces_smem(4, 5, 9, 24) + 1024) <= 228 * 1024
    assert 2 * (update_smem(4, 5, 16) + 1024) <= 228 * 1024
    # one stage of a full f32 tile: 474 values a viscous face, 775 an element
    assert F_NODAL * 5 + F_QUAD * 9 == 474 and U_NODAL * 25 + U_EDGE * 20 == 775


# ---- the ring's copy of one tile ------------------------------------------------


class Stage:
    """One stage of shared memory: `nslots` slots of `slot` values, NaN until
    a run is copied in. Counts the runs that take the 16-byte route."""

    def __init__(self, nslots, slot, itemsize):
        self.v = np.full((nslots, slot), np.nan)
        self.itemsize = itemsize
        self.aligned = self.ragged = 0

    def copy(self, slot0, src, off, count, nchan=None):
        """Channels of `src` (C, N) flattened per channel: run c is
        src[c, off:off+count] -> slot slot0 + c. The route follows the rule of
        stage_runs: 16 bytes a copy when the run's start, the channel stride
        and the length are multiples of 16 bytes (the array itself is taken
        as 16-byte aligned, as PyTorch allocates it)."""
        src = np.asarray(src)
        nchan = src.shape[0] if nchan is None else nchan
        bits = (off * self.itemsize) | (src.shape[1] * self.itemsize * (nchan > 1)) | (
            count * self.itemsize)
        if bits % 16 == 0:
            self.aligned += 1
        else:
            self.ragged += 1
        self.v[slot0:slot0 + nchan, :count] = src[:nchan, off:off + count]


class Once:
    """An output written value by value, each value exactly once."""

    def __init__(self, shape):
        self.v = np.full(shape, np.nan)
        self.n = np.zeros(shape, dtype=int)

    def put(self, c, idx, val):
        self.v[c, idx] = val
        self.n[c, idx] += 1

    def done(self):
        assert (self.n == 1).all(), "every output value is written exactly once"
        return self.v


# ---- kernel F --------------------------------------------------------------------


def faces_tiled(tabs, trL, trR, af, ag, visc, G, itemsize):
    """btp_faces.cu, tile by tile. Returns (S, Sv, af_new, ag_new, stages)."""
    psiq = tabs.psiq.numpy()
    n, m = psiq.shape
    F = trL.shape[1]
    flat_n = lambda a: a.numpy().reshape(a.shape[0], -1)          # (C, F*n)
    tl, tr, nt = flat_n(trL), flat_n(trR), flat_n(tabs.ntab)
    ft, af0 = flat_n(tabs.ftab), flat_n(af)
    S, af_new = Once((3, F * n)), Once((16, F * m))
    Sv, ag_new = (Once((2, F * n)), Once((8, F * n))) if visc else (None, None)
    C = 8 if visc else 4
    sn, sq_ = slot_values(G * n, itemsize), slot_values(G * m, itemsize)
    stages = []
    for tile in range(-(-F // G)):
        f0 = tile * G
        g = min(G, F - f0)
        on, oq = f0 * n, f0 * m
        stN, stQ = Stage(F_NODAL, sn, itemsize), Stage(F_QUAD, sq_, itemsize)
        stN.copy(0, tl, on, g * n, C)                 # kTrL
        stN.copy(8, tr, on, g * n, C)                 # kTrR
        stN.copy(16, nt, on, g * n)                   # kNtab
        if visc:
            stN.copy(21, flat_n(tabs.bgf), on, g * n)  # kBgf
            stN.copy(31, flat_n(ag), on, g * n)        # kAg
        stQ.copy(0, ft, oq, g * m)                    # kFtab
        stQ.copy(15, af0, oq, g * m)                  # kAf
        stages.append((stN, stQ))
        sN, sQ = stN.v, stQ.v

        # phase 1a: thread P = (face fl, quad point q)
        P = np.arange(g * m)
        fl, q = P // m, P % m
        rows = np.concatenate([sN[0:4], sN[8:12], sN[16:18]])      # trL 0-3, trR 0-3, pbdf
        v = np.zeros((10, g * m))
        for k in range(n):
            v += rows[:, fl * n + k] * psiq[k, q]
        l0, l1, l2, l3, r0, r1, r2, r3, pbl, pbr = v
        (nx, ny, jacf, cpL, cpR, cpub, omE, cmL, cmR, cmLR, Hedge,
         Qe_uu, Qe_uv, Qe_vv, dHe) = sQ[0:15, P]
        pU_L = nx * l2 + ny * l3
        pU_R = -(nx * r2 + ny * r3)
        mue = (cpL * l1 + cpR * r1 + cpub * (pU_L + pU_R)) * omE
        mue2 = mue * (2.0 + mue)
        ope_e = 1.0 + mue
        flux_ex = cmL * l2 + cmR * r2 + cmLR * nx * (l1 - r1)
        flux_ey = cmL * l3 + cmR * r3 + cmLR * ny * (l1 - r1)
        ul, ur, vl, vr = l2 / l0, r2 / r0, l3 / l0, r3 / r0
        quu = 0.5 * (ul * l2 + ur * r2) + ope_e * Qe_uu
        quv = 0.5 * (vl * l2 + vr * r2) + ope_e * Qe_uv
        qvu = 0.5 * (ul * l3 + ur * r3) + ope_e * Qe_uv
        qvv = 0.5 * (vl * l3 + vr * r3) + ope_e * Qe_vv
        dH_f = dHe + mue2 * (Hedge + dHe)
        fl_x = nx * quu + ny * quv - 0.5 * cmLR * (r2 - l2)
        fl_y = nx * qvu + ny * qvv - 0.5 * cmLR * (r3 - l3)
        muL, muR = l1 / pbl, r1 / pbr
        inc = [dH_f, quu, quv, qvu, qvv, muL, muR, muL * (2.0 + muL), muR * (2.0 + muR),
               flux_ex, flux_ey, mue2, ul, ur, vl, vr]
        for c in range(16):
            af_new.put(c, oq + P, sQ[15 + c, P] + inc[c])
        sqv = np.full((3, sq_), np.nan)
        sqv[0, P] = jacf * (nx * flux_ex + ny * flux_ey)
        sqv[1, P] = jacf * (nx * dH_f + fl_x)
        sqv[2, P] = jacf * (ny * dH_f + fl_y)

        # phase 1b: thread t = (face, edge node)
        if visc:
            t = np.arange(g * n)
            b = sN[21:31, t]
            gl, gr = sN[4:8, t], sN[12:16, t]
            for c in range(4):
                ag_new.put(c, on + t, sN[31 + c, t] + gl[c])
                ag_new.put(4 + c, on + t, sN[35 + c, t] + gr[c])
            flv = b[4] * gl + b[0:4]
            frv = b[9] * gr + b[5:9]
            nxdf, nydf, jacdf = sN[18, t], sN[19, t], sN[20, t]
            Sv.put(0, on + t, jacdf * ((0.5 * (flv[0] + frv[0]) - flv[0] * nxdf)
                                       + (0.5 * (flv[1] + frv[1]) - flv[1] * nydf)))
            Sv.put(1, on + t, jacdf * ((0.5 * (flv[2] + frv[2]) - flv[2] * nxdf)
                                       + (0.5 * (flv[3] + frv[3]) - flv[3] * nydf)))

        # phase 2: thread t = (channel c, face fl, node k)
        t = np.arange(3 * g * n)
        c, r = t // (g * n), t % (g * n)
        fl, k = r // n, r % n
        acc = np.zeros(t.size)
        for qq in range(m):
            acc += sqv[c, fl * m + qq] * psiq[k, qq]
        for cc in range(3):
            S.put(cc, on + r[c == cc], acc[c == cc])
    shape_n = (F, n)
    out = (S.done().reshape(3, *shape_n),
           Sv.done().reshape(2, *shape_n) if visc else None,
           af_new.done().reshape(16, F, m),
           ag_new.done().reshape(8, *shape_n) if visc else None)
    return out, stages


@functools.lru_cache(maxsize=None)
def _psiq(nop):
    m = Model(torch_config(nelx=2, nely=2, nopx=nop, nopy=nop, fused_tail="on"),
              device="cpu")
    return m.g.psiq, m.tail_ops.upd


def _faces_inputs(F, nop, visc, seed):
    """Random face operands of F faces: traces and pb' near 1.5 (their
    interpolants stay away from 0), tables and accumulators O(1)."""
    psiq, _ = _psiq(nop)
    ngl, nq = psiq.shape
    rng = np.random.default_rng(seed)

    def t(*shape, mean=0.0, amp=1.0):
        return torch.tensor(mean + amp * rng.normal(size=shape), dtype=torch.float64)

    C = 8 if visc else 4
    trL, trR = t(C, F, ngl), t(C, F, ngl)
    for tr in (trL, trR):
        tr[0] = 1.5 + 0.1 * tr[0]
    ntab = t(5, F, ngl)
    ntab[:2] = 1.5 + 0.1 * ntab[:2]
    tabs = tb.FaceTailTables(ftab=t(15, F, nq), ntab=ntab,
                             bgf=t(10, F, ngl) if visc else None, psiq=psiq,
                             nfx=F // 2, nfy=F - F // 2)
    return tabs, trL, trR, t(16, F, nq), t(8, F, ngl) if visc else None


@pytest.mark.parametrize("tile", ["f32", "f64", "4", "1"])
@pytest.mark.parametrize("nop", [4, 8])
@pytest.mark.parametrize("visc", [True, False], ids=["visc", "inviscid"])
@pytest.mark.parametrize("F", [24, 49, 82, 71], ids=lambda F: f"F{F}mod4={F % 4}")
def test_face_kernel_tiles_match_plain(F, visc, nop, tile):
    tabs, trL, trR, af, ag = _faces_inputs(F, nop, visc, seed=F + nop)
    ngl, nq = tabs.psiq.shape
    itemsize = 8 if tile == "f64" else 4
    G = {"f32": faces_tile(4, ngl, nq), "f64": faces_tile(8, ngl, nq)}.get(tile) or int(tile)
    (S, Sv, af_k, ag_k), stages = faces_tiled(tabs, trL, trR, af, ag, visc, G, itemsize)
    keep = [x.clone() for x in (trL, trR, tabs.ftab, tabs.ntab)]
    S_p, Sv_p, af_p, ag_p = tb.btp_faces_plain(tabs, trL, trR, af.clone(),
                                               None if ag is None else ag.clone(),
                                               use_visc=visc)
    for a, b in zip(keep, (trL, trR, tabs.ftab, tabs.ntab)):
        assert torch.equal(a, b)
    assert_close(S, S_p.numpy(), 1e-12, "S")
    assert_close(af_k, af_p.numpy(), 1e-12, "af")
    if visc:
        assert_close(Sv, Sv_p.numpy(), 1e-12, "Sv")
        assert_close(ag_k, ag_p.numpy(), 1e-12, "ag")
    # the last tile is ragged unless G divides F; whole tiles of G faces with
    # G a multiple of 4 (2 in f64) take the 16-byte route exactly when F does
    ntiles = -(-F // G)
    assert len(stages) == ntiles and (F % G != 0) == (F - (ntiles - 1) * G < G)
    if G % (16 // itemsize) == 0:
        whole = stages[:-1] if F % G else stages
        routes = {(st.aligned > 0, st.ragged > 0) for pair in whole for st in pair}
        assert routes <= ({(True, False)} if F % (16 // itemsize) == 0 else
                          {(False, True), (True, True)})


# ---- kernel U --------------------------------------------------------------------


def update_tiled(ops, w, rhs, edges, vedges, qb0, qb1, qb2, gv, pbpv, bdg, mask, visc, G,
                 itemsize):
    """btp_update.cu, tile by tile: one thread per (element, node), all three
    rows. Returns the new state (4, E, npts)."""
    a0, a1, a2, dtt = w
    n = ops.dpsi.shape[0]
    npts = n * n
    E = rhs.shape[1]
    dpsi, wn2, minv = ops.dpsi.numpy(), ops.wn2.numpy(), ops.minv.numpy()
    nu = ops.visc
    fl = lambda a: a.numpy().reshape(a.shape[0], -1) if a.ndim == 3 else a.numpy().reshape(1, -1)
    out = Once((4, E * npts))
    sn, se = slot_values(G * npts, itemsize), slot_values(G * 4 * n, itemsize)
    for tile in range(-(-E // G)):
        e0 = tile * G
        g = min(G, E - e0)
        on, oe = e0 * npts, e0 * 4 * n
        stN, stE = Stage(U_NODAL, sn, itemsize), Stage(U_EDGE, se, itemsize)
        stN.copy(0, fl(rhs), on, g * npts)                          # kRhs
        for slot, qb in ((3, qb0), (6, qb1), (9, qb2)):             # rows 1..3
            stN.copy(slot, fl(qb)[1:4], on, g * npts)
        stN.copy(12, fl(ops.ref), on, g * npts)                     # kRef
        stN.copy(15, fl(ops.pbprime_df), on, g * npts)              # kPbdf
        stN.copy(16, fl(mask), on, g * npts)                        # kMask
        stE.copy(0, fl(edges), oe, g * 4 * n)                       # kEdges
        if visc:
            stN.copy(18, fl(gv), on, g * npts)                      # kGv
            stN.copy(22, fl(pbpv), on, g * npts)                    # kPbpv
            stN.copy(23, fl(bdg), on, g * npts)                     # kBdg
            stE.copy(3, fl(vedges), oe, g * 4 * n)                  # kVedges
        sN, sE = stN.v, stE.v
        P = np.arange(g * npts)
        el, nn = P // npts, P % npts
        j, i = nn // n, nn % n
        # phase 1 (visc)
        qq = np.full((4, sn), np.nan)
        if visc:
            for c in range(4):
                qq[c, P] = wn2[c & 1, nn] * (sN[22, P] * sN[18 + c, P] + sN[23 + c, P])
        # phase 2: the edge slots of node (j, i), looked up once
        sx = np.where(i == 0, j, np.where(i == n - 1, n + j, -1))
        sy = np.where(j == 0, 2 * n + i, np.where(j == n - 1, 3 * n + i, -1))

        def place(slot):
            e = sE[slot]
            acc = np.zeros(P.size)
            acc = acc + np.where(sx >= 0, e[el * 4 * n + np.maximum(sx, 0)], 0.0)
            return acc + np.where(sy >= 0, e[el * 4 * n + np.maximum(sy, 0)], 0.0)

        mi = minv[nn]
        v = []
        for c in range(3):
            rr = sN[c, P] + mi * place(c) + sN[12 + c, P]
            if visc and c > 0:
                X = 2 * (c - 1)
                acc = np.zeros(P.size)
                for k in range(n):
                    acc = acc + qq[X, el * npts + j * n + k] * dpsi[i, k]
                    acc = acc + qq[X + 1, el * npts + k * n + i] * dpsi[j, k]
                rr = rr + nu * mi * (place(3 + c - 1) - acc)
            v.append(a0 * sN[3 + c, P] + a1 * sN[6 + c, P] + a2 * sN[9 + c, P] + dtt * rr)
        out.put(0, on + P, v[0] + sN[15, P])
        out.put(1, on + P, v[0])
        out.put(2, on + P, v[1] * sN[16, P])
        out.put(3, on + P, v[2] * sN[17, P])
    return out.done().reshape(4, E, npts)


def _update_inputs(E, nop, visc, seed):
    _, ops = _psiq(nop)
    npts = ops.minv.shape[0]
    ngl = ops.dpsi.shape[0]
    rng = np.random.default_rng(seed)

    def t(*shape, amp=1.0):
        return torch.tensor(amp * rng.normal(size=shape), dtype=torch.float64)

    ops = ops._replace(ref=t(3, E, npts), pbprime_df=t(E, npts))
    qb1 = t(4, E, npts)
    op = dict(rhs=t(3, E, npts), edges=t(3, E, 4 * ngl), qb0=qb1 + t(4, E, npts, amp=1e-3),
              qb1=qb1, qb2=qb1 + t(4, E, npts, amp=1e-3),
              mask=torch.tensor(rng.integers(0, 2, size=(2, E, npts)), dtype=torch.float64),
              vedges=t(2, E, 4 * ngl) if visc else None, gv=t(4, E, npts) if visc else None,
              pbpv=t(1, E, npts) if visc else None, bdg=t(4, E, npts) if visc else None)
    return ops, op


@pytest.mark.parametrize("tile", ["f32", "f64", "1"])
@pytest.mark.parametrize("nop", [4, 8])
@pytest.mark.parametrize("visc", [True, False], ids=["visc", "inviscid"])
@pytest.mark.parametrize("E", [24, 49, 30, 35], ids=lambda E: f"E{E}mod4={E % 4}")
def test_update_kernel_tiles_match_plain(E, visc, nop, tile):
    ops, op = _update_inputs(E, nop, visc, seed=E + nop)
    ngl = ops.dpsi.shape[0]
    itemsize = 8 if tile == "f64" else 4
    G = {"f32": update_tile(4, ngl), "f64": update_tile(8, ngl)}.get(tile) or int(tile)
    w = (0.25, 0.5, 0.25, 0.7)
    args = [op[k] for k in ("rhs", "edges", "vedges", "qb0", "qb1", "qb2", "gv", "pbpv",
                            "bdg", "mask")]
    got = update_tiled(ops, w, *args, visc, G, itemsize)
    want = tb.btp_update_plain(ops, w, *args, use_visc=visc)
    for c, name in enumerate(("pb", "pbpert", "pbub", "pbvb")):
        assert_close(got[c], want[c].numpy(), 1e-12, name)
    assert np.isfinite(got).all()
