"""The one generator: the same seed gives the same invocations, two seeds
give the same sizes and arrivals in another order with other tokens."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

PB = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (PB / "traffic").glob("*.json"))


def _gen(mix, seed, seconds=20.0):
    m = traffic.load(PB / "traffic" / f"{mix}.json")
    return m, traffic.generate(m, seed, 1000, rate=4.0, seconds=seconds)


def _key(invs):
    return [(i.due, tuple(tuple(p.tolist()) for p in i.prompts), i.max_new) for i in invs]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_invocations(mix):
    assert _key(_gen(mix, 2**31 + 17)[1]) == _key(_gen(mix, 2**31 + 17)[1])


@pytest.mark.parametrize("mix", MIXES)
def test_two_seeds_same_work_in_another_order(mix):
    m, a = _gen(mix, 11)
    _, b = _gen(mix, 2**33 + 12)
    assert _key(a) != _key(b)
    assert [i.shape for i in a] != [i.shape for i in b]
    assert Counter(i.shape for i in a) == Counter(i.shape for i in b)
    if m["loop"] == "open":
        gaps = lambda inv: sorted(np.round(np.diff([i.due for i in inv] + [20.0]), 9))  # noqa: E731
        assert gaps(a) == gaps(b)


# an open-loop mix (the classify parameters of PERF.md's Open question 1)
OPEN = {"loop": "open", "batch": {"values": [1, 2, 4, 8], "weights": [0.4, 0.2, 0.2, 0.2]},
        "prompt_tokens": {"loguniform": [64, 1024]},
        "max_new_tokens": {"values": [1, 2, 4, 8], "weights": [0.4, 0.2, 0.2, 0.2]},
        "shape_seed": 0, "block": 10,
        "stratify_by": {"prefill_tokens": 1.0, "decode_steps": 2000.0}}


def test_open_loop_fills_the_window_at_the_rate():
    invs = traffic.generate(OPEN, 5, 1000, rate=4.0, seconds=51.0)
    assert len(invs) == traffic.open_loop_count(4.0, 51.0) == 204
    dues = [i.due for i in invs]
    assert dues[0] == 0.0 and all(b > a for a, b in zip(dues, dues[1:])) and dues[-1] < 51.0
    shares = Counter(i.batch for i in invs)
    assert [shares[b] for b in (1, 2, 4, 8)] == traffic._counts(204, [0.4, 0.2, 0.2, 0.2])
    lens = [len(p) for i in invs for p in i.prompts]
    assert 64 <= min(lens) and max(lens) <= 1024
    assert all(1 <= t < 1000 for i in invs for p in i.prompts for t in p)


def test_balanced_order_takes_one_of_each_stratum_a_block():
    rng = np.random.default_rng(0)
    order = traffic.balanced_order(list(range(40)), 8, rng)
    assert sorted(order) == list(range(40))
    for k in range(0, 40, 8):
        assert sorted(o // 5 for o in order[k:k + 8]) == list(range(8))


def test_closed_loop_replays_a_fixed_set_of_documents():
    m, invs = _gen("longdoc", 3)
    assert len(invs) == m["documents"] and all(i.due is None and i.batch == 1 for i in invs)
    assert 4096 <= min(i.padded_len for i in invs) and max(i.padded_len for i in invs) <= 32000
    assert json.dumps(m)  # a data file, read as is
