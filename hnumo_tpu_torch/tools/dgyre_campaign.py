"""Long-horizon double-gyre campaign of the port.

    python3 hnumo_tpu_torch/tools/dgyre_campaign.py --days 100 \
        --out docs/artifacts/dgyre_f32_h100.json        # f32, on the CUDA device
    python3 hnumo_tpu_torch/tools/dgyre_campaign.py --days 1 --f64 --cpu

The counterpart of tools/dgyre_campaign.py: the reference's double-gyre
experiment (Examples/double_gyre/numo3d.in: 25x25 elements, p=4, 2 layers,
wind stress, linear bottom friction, beta plane, nodal-family viscosity)
for N model days, sampled every `--sample-days` with the reference's own KE
diagnostic (Examples/double_gyre/compute_ke.m: per-layer volume-weighted
mean kinetic energy, scaled by 1e4) computed with the DG quadrature,

    ke_k = 1e4 * sum(wjac * 0.5*(u_k^2+v_k^2) * h_k) / sum(wjac * h_k),

SSH and velocity extrema and the relative mass drift. It writes the JAX
tool's artifact schema, rewritten after every sample so that a cut run
leaves everything sampled so far. The model steps through `Model.step`: on
a CUDA device a captured CUDA graph per step (`step_impl="graph"`), on the
CPU eagerly. The artifact's `config.device` is the card's name and power
limit as nvidia-smi gives them (or "cpu"). tests/test_torch_campaign.py holds
the committed f32 artifact inside the band of tests/test_campaign.py around
docs/artifacts/dgyre_f64_cpu.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):          # run as a script
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from hnumo_tpu_torch.io.diagnostics import derived_fields  # noqa: E402
from hnumo_tpu_torch.tools._measure import card  # noqa: E402
from hnumo_tpu_torch.tools.goldens import dgyre_config  # noqa: E402


# the f32 acceptance band of tests/test_campaign.py around the f64 campaign:
# KE over the whole horizon (relative, with a floor of 5% of the largest
# f64 KE over the near-zero spin-up), |u|max likewise, SSH extrema only
# through the deterministic spin-up (after the jet's instability the eddies'
# phase diverges between any two roundings), and the mass drift
KE_REL, UMAX_REL, SSH_REL, SSH_UNTIL_DAYS, MASS_DRIFT = 0.02, 0.03, 0.10, 25.0, 1e-5


def band(d32: dict, d64: dict, min_common: int = 100) -> dict:
    """How far the artifact `d32` lies from the f64 artifact `d64` on the
    samples they share: max relative KE and |u|max deviation, max SSH
    extremum deviation over the f64 spin-up scale, and d32's mass drift.
    Raises AssertionError outside the band."""
    r64 = {round(r["t_days"], 3): r for r in d64["records"]}
    r32 = {round(r["t_days"], 3): r for r in d32["records"]}
    common = sorted(set(r64) & set(r32))
    if len(common) < min_common:
        raise AssertionError(f"{len(common)} samples in common, fewer than {min_common}")

    def series(r, key):
        return np.array([r[t][key] for t in common])

    ke64, u64 = series(r64, "ke_total"), series(r64, "umax")
    ke = float((np.abs(series(r32, "ke_total") - ke64)
                / np.maximum(np.abs(ke64), 0.05 * np.abs(ke64).max())).max())
    um = float((np.abs(series(r32, "umax") - u64) / np.maximum(u64, 0.05 * u64.max())).max())
    early = [t for t in common if t <= SSH_UNTIL_DAYS]
    s64 = np.array([[r64[t]["ssh_min"], r64[t]["ssh_max"]] for t in early])
    s32 = np.array([[r32[t]["ssh_min"], r32[t]["ssh_max"]] for t in early])
    ssh = float(np.abs(s32 - s64).max() / np.abs(s64).max())
    out = {"samples": len(common), "ke_rel": ke, "umax_rel": um, "ssh_rel": ssh,
           "mass_rel_drift": d32["mass_rel_drift"]}
    for key, limit in (("ke_rel", KE_REL), ("umax_rel", UMAX_REL), ("ssh_rel", SSH_REL),
                       ("mass_rel_drift", MASS_DRIFT)):
        if not out[key] < limit:
            raise AssertionError(f"outside the f64 band: {key} {out[key]:.3e} >= {limit}")
    return out


def sample(model, state) -> dict:
    """One time-series record from a model state (read back, numpy f64)."""
    wj = model.g.wjac_df.detach().cpu().numpy().astype(np.float64)
    h, u, v, _, ssh = derived_fields(model, state)
    vol = wj[None] * h
    volsum = vol.reshape(vol.shape[0], -1).sum(axis=1)
    s = (0.5 * (u * u + v * v) * vol).reshape(vol.shape[0], -1).sum(axis=1)
    ke_layers = 1e4 * s / volsum
    return dict(
        ke=[float(k) for k in ke_layers],
        ke_total=float(ke_layers.sum()),
        mass=float(volsum.sum()),
        ssh_max=float(ssh[0].max()), ssh_min=float(ssh[0].min()),
        umax=float(np.abs(u).max()), vmax=float(np.abs(v).max()),
    )


def device_label(device: torch.device) -> str:
    """"<name>, <power limit>" of the CUDA device from nvidia-smi, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return card(device.index if device.index is not None else torch.cuda.current_device())


def campaign_config(f64: bool = False, nel: int = 25):
    """The committed campaign's configuration; another `nel` scales dt and
    dt_btp as the JAX tool does."""
    cfg = dgyre_config(dtype="float64" if f64 else "float32")
    if nel != 25:
        cfg = dataclasses.replace(cfg, nelx=nel, nely=nel, dt=500.0 * 25 / nel,
                                  dt_btp=25.0 * 25 / nel)
    return cfg


def run(model, days: float, sample_days: float = 0.5, out: str | None = None,
        log=None) -> dict:
    """Step `model` from its initial state for `days` model days, sampling
    every `sample_days`, and return the artifact (also written to `out`
    after every sample). The first step (on a CUDA device: warm-up and
    capture of the graph) is left out of `wall_s` and `ms_per_step`."""
    cfg = model.cfg
    steps_per_sample = max(1, round(sample_days * 86400.0 / cfg.dt))
    n_samples = int(round(days * 86400.0 / cfg.dt / steps_per_sample))
    label = device_label(model.device)

    s = model.step(model.state0)
    ok = bool(s.ok)
    records = []
    t0 = time.perf_counter()
    done = 1

    def artifact(final):
        wall = time.perf_counter() - t0
        mass0 = records[0]["mass"] if records else float("nan")
        return dict(
            config=dict(nel=cfg.nelx, nop=cfg.nopx, nlayers=cfg.nlayers,
                        dt=cfg.dt, dt_btp=cfg.dt_btp, dtype=cfg.dtype,
                        device=label, step_impl=model.step_impl),
            days=days, steps=done, wall_s=round(wall, 1),
            ms_per_step=round(wall / max(done - 1, 1) * 1e3, 2),
            ok=ok, complete=final,
            mass_rel_drift=(max(abs(r["mass"] - mass0) for r in records)
                            / mass0 if records else None),
            records=records,
        )

    def write(art):
        if out:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            tmp = out + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(art))
            os.replace(tmp, out)

    complete = ok
    for i in range(n_samples if ok else 0):
        target = (i + 1) * steps_per_sample
        while done < target:
            s = model.step(s)
            done += 1
        ok = bool(s.ok)
        if not ok:
            print(f"ABORT at step {done} (negative thickness)", file=sys.stderr)
            complete = False
            break
        rec = sample(model, s)
        rec["step"] = done
        rec["t_days"] = done * cfg.dt / 86400.0
        records.append(rec)
        if log is not None:
            print(f"day {rec['t_days']:7.2f}  KE {rec['ke_total']:.6f} "
                  f"(l1 {rec['ke'][0]:.6f} l2 {rec['ke'][1]:.6f})  "
                  f"ssh [{rec['ssh_min']:+.3f},{rec['ssh_max']:+.3f}]  "
                  f"|u|max {rec['umax']:.4f}", file=log, flush=True)
        write(artifact(False))
    final = artifact(complete)
    write(final)
    return final


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--days", type=float, default=100.0)
    ap.add_argument("--sample-days", type=float, default=0.5,
                    help="model days between samples")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run eagerly on the CPU")
    ap.add_argument("--nel", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from hnumo_tpu_torch.model import Model

    m = Model(campaign_config(args.f64, args.nel), device="cpu" if args.cpu else None)
    art = run(m, args.days, args.sample_days, out=args.out, log=sys.stderr)
    if args.out:
        print(f"wrote {args.out} ({art['steps']} steps, {art['wall_s']} s, "
              f"{art['ms_per_step']} ms/step)", file=sys.stderr)
    else:
        print(json.dumps(art))
    return 0 if art["complete"] else 1


if __name__ == "__main__":
    sys.exit(main())
