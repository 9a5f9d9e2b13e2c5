"""The port's golden scenarios against the committed snapshots.

``tests/goldens/`` holds the reference's ``summarize()`` output for every
registered scenario and for each A/B fork (one subdirectory per fork).
The port's ``run_golden`` -- featurizer -> CSOAA agents (on the CPU here)
-> scheduler -> simulator -- must reproduce every snapshot exactly: each
summary value equals the committed one with tolerance 0, so any drift in
a ported module shows here. The snapshots are read, never written.
"""

import dataclasses
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.serving.golden import golden_cases, golden_specs, run_golden  # noqa: E402

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
CASES = golden_cases()


def test_every_snapshot_on_disk_is_covered():
    on_disk = {p.relative_to(GOLDEN_DIR).as_posix() for p in GOLDEN_DIR.rglob("*.json")}
    assert on_disk == set(CASES)
    assert len(CASES) == 22


@pytest.mark.parametrize("path", sorted(CASES))
def test_port_reproduces_golden_exactly(path):
    scenario, flags = CASES[path]
    golden = json.loads((GOLDEN_DIR / path).read_text())
    assert golden["spec"] == dataclasses.asdict(golden_specs()[scenario])
    got = run_golden(scenario, device="cpu", **flags)
    want = golden["summary"]
    assert set(got) == set(want)
    for key, expect in want.items():
        assert got[key] == expect, f"{path}: {key} = {got[key]!r}, golden {expect!r}"
