"""Find a cell of BENCHMARK.json and the files that belong to it, by name."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT, here: Path = HERE) -> dict:
    """Everything one run of workload `name` needs: its entry in
    BENCHMARK.json, its configuration's file (configs/<config>.json, as
    `configs` names it), its traffic (traffic/<traffic>.json), its limits
    (checks/<workload>.json) and the names of the metrics it reports."""
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    checks_path = here / "checks" / f"{name}.json"
    limits = json.loads(checks_path.read_text())["limits"] if checks_path.exists() else {}

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {"name": name, "workload": w, "config": config, "traffic": traffic,
            "limits": limits, "chips": w["chips"],
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}
