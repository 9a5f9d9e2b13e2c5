"""BENCHMARK.json against the benchmark's contract, every entry found by
name in its own file, and a new configuration, mix, cell and metric added
by new files and entries alone (in a copy)."""

import json
import re
import time
from pathlib import Path

import pytest

from portbench import harness

import cpu_cells

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    f = json.loads((ROOT / cfg["file"]).read_text())
    assert f["name"] == cfg["name"] and f["source"] == cfg["source"]
    assert sorted(f["reduced"]) == sorted(cfg["reduced"]) and len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) and k in f for k in cfg["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in cfg["reduced"])
    assert _line(cfg["why"]) and _line(cfg["source"])
    assert (PB / "references" / f"{f['reference']}.py").exists()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_entry_and_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and _line(cell["why"])
    spec = harness.load_spec(cell["name"])
    assert spec.cell["config"] == cell["config"] and spec.cell["traffic"] == cell["traffic"]
    assert spec.mix["loop"] in ("open", "closed")
    if spec.mix["loop"] == "open":
        assert spec.cell["rate_per_s"] > 0
    experts = {"route_deficit"} if spec.config.get("num_local_experts") else set()
    assert set(spec.cell["check"]) == {"served_tokens", "logit_gap"} | experts
    assert set(spec.cell["slo_fit"]) == {"k0_s", "k1_s_per_prompt_token", "k2_s_per_new_token"}
    assert "setup_s" in spec.end_to_end and len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert callable(spec.reader(m).read)


def test_metric_entries():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and _line(m["layer"]) and m["better"] in ("lower", "higher")
        for cell in m["workloads"]:
            assert cell in CELLS and _reports(E2E[m["moves"]], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


def test_new_config_mix_cell_and_metric_are_new_files_only(one_thread, tmp_path):
    root = cpu_cells.make(tmp_path)
    before = {p.relative_to(PB): p.read_bytes() for p in PB.rglob("*")
              if p.is_file() and "out" not in p.relative_to(PB).parts
              and "tests" not in p.relative_to(PB).parts and "__pycache__" not in str(p)}
    (root / "metrics" / "served_rows.py").write_text(
        "def read(ctx):\n    return sum(r.batch for r in ctx.records)\n")
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "served_rows", "unit": "rows", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny-moe.tiny-open"]})
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, f"{rel} was edited"
    r = harness.run("tiny-moe.tiny-open", 4, 1.0, False, t_start=time.perf_counter(),
                    device="cpu", root=root)
    assert r["metrics"]["served_rows"]["value"] >= r["attempted"] > 0
    assert "served_rows" not in harness.load_spec("tiny-dense.tiny-open", root).end_to_end
