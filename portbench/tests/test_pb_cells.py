"""A cell made of new data files alone is found and run by name, and the
comparison fails a run whose timed path is broken underneath."""
import json
from time import perf_counter

import pytest
import torch

from portbench import entries, run
from portbench.tests.conftest import make_tiny_cell


def _run(root, name, hook=None):
    return run.run_cell(name, 2**31 + 11, 0.3, False, device="cpu", root=root,
                        here=root / "portbench", model_step_hook=hook)[0]


@pytest.mark.parametrize("mix", ["steady", "campaign"])
def test_a_cell_of_data_files_is_found_and_run(tmp_path, mix):
    root = make_tiny_cell(tmp_path)
    res = _run(root, f"tiny.{mix}")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"sypd", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"


def _unchanged(m):
    inner = m.step
    first = []

    def step(s):
        if len(first) < 2:        # the start steps run; every later step returns its input
            first.append(1)
            return inner(s)
        return s
    return step


def _half(m):
    inner = m.step

    def step(s):
        out = inner(s)
        ney = s.q_df.shape[2]
        fields = []
        for a, b in zip(out, s):
            if a.dim() >= 4:
                a = a.clone()
                a[..., : ney // 2, :, :, :] = b[..., : ney // 2, :, :, :]
            fields.append(a)
        return type(out)(*fields)
    return step


def _altered(m):
    inner = m.step

    def step(s):
        out = inner(s)
        q = out.q_df.clone()
        q[0, 0, 0, 0, 2, 2] += 0.01 * float(q[0].abs().max())
        return out._replace(q_df=q)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_grid_left_out", "answer_altered"])
def test_a_broken_timed_path_reads_not_correct(tmp_path, fault):
    root = make_tiny_cell(tmp_path)
    res = _run(root, "tiny.steady", fault)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_no_limit_is_not_correct(tmp_path):
    root = make_tiny_cell(tmp_path)
    (root / "portbench/checks/tiny.steady.json").unlink()
    assert not _run(root, "tiny.steady")["correct"]


def test_the_run_refuses_without_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        run.run_cell("dgyre25.steady", 1, 1.0, False)


def test_every_entry_is_found_by_its_name():
    for name in ("model_step", "runner_run"):
        assert callable(entries.find(name))
    with pytest.raises(ModuleNotFoundError):
        entries.find("no_such_entry")


@pytest.mark.parametrize("mix", ["steady", "campaign"])
def test_the_warm_up_is_outside_set_up_and_window(tmp_path, mix):
    root = make_tiny_cell(tmp_path)
    path = root / f"portbench/traffic/tiny_{mix}.json"
    traffic = json.loads(path.read_text())
    traffic["warmup_seconds"] = 1.5
    path.write_text(json.dumps(traffic))
    t0 = perf_counter()
    res, rec = run.run_cell(f"tiny.{mix}", 5, 0.3, False, device="cpu", root=root,
                            here=root / "portbench", t_start=t0)
    assert res["correct"], res["checks"]
    assert rec["setup_s"] + 1.5 + rec["wall_s"] <= perf_counter() - t0
    assert rec["wall_s"] < 1.5
