"""The port's allocator stack against the JAX reference.

* cost functions and featurizer arrays equal the reference's exactly;
* inside the port, the arena engine equals the legacy engine bit for bit
  (allocations and weights), across growth and slot reuse;
* against JAX, CSOAA weights agree within float32 tolerance, and the
  allocations served over the quickstart's 120-request stream
  (examples/quickstart.py:45-57) are equal. The smallest top-2 cost gap
  seen on that stream is reported, so a near-tie is visible before it
  flips an allocation.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import allocator as JA  # noqa: E402
from repro.core import cost_functions as JCF  # noqa: E402
from repro.core import featurizer as JF  # noqa: E402
from repro_torch.core import agent_arena as TAA  # noqa: E402
from repro_torch.core import allocator as TA  # noqa: E402
from repro_torch.core import cost_functions as TCF  # noqa: E402
from repro_torch.core import featurizer as TF  # noqa: E402

COST_FNS = ["absolute_vcpu_costs", "proportional_vcpu_costs", "memory_costs"]


def _rand_obs(rng, cf=TCF):
    alloc_v = int(rng.integers(1, 33))
    return cf.Observation(
        exec_time_s=float(rng.uniform(0.05, 30.0)),
        slo_s=float(rng.uniform(0.1, 20.0)),
        alloc_vcpus=alloc_v,
        max_vcpus_used=float(rng.uniform(0.01, 1.0) * alloc_v),
        alloc_mem_mb=int(rng.integers(128, 8192)),
        max_mem_used_mb=float(rng.uniform(16.0, 6000.0)),
        oom_killed=bool(rng.random() < 0.05),
    )


def _as_jax_obs(o):
    return JCF.Observation(**{f: getattr(o, f) for f in o.__dataclass_fields__})


@pytest.mark.parametrize("name", COST_FNS)
def test_cost_functions_equal_reference(name):
    rng = np.random.default_rng(11)
    obs = [_rand_obs(rng) for _ in range(200)]
    n = 40 if name == "memory_costs" else 32
    port, jax_fn = getattr(TCF, name), getattr(JCF, name)
    rows = np.stack([port(o, n) for o in obs])
    assert np.array_equal(rows, np.stack([jax_fn(_as_jax_obs(o), n) for o in obs]))
    batch = TCF.BATCHED_COST_FNS[port](obs, n)
    assert np.array_equal(batch, rows)
    assert np.array_equal(batch, JCF.BATCHED_COST_FNS[jax_fn]([_as_jax_obs(o) for o in obs], n))


@pytest.mark.parametrize("input_type", sorted(JF.FEATURE_SCHEMAS) + ["unknown-type"])
def test_featurizer_arrays_equal_reference(input_type):
    rng = np.random.default_rng(len(input_type))
    port, ref = TF.Featurizer(), JF.Featurizer()
    schema = JF.FEATURE_SCHEMAS.get(input_type, ["payload"])
    for i in range(12):
        meta = {nm: float(rng.uniform(0, 10 ** rng.integers(1, 7))) for nm in schema}
        if "encoding" in meta:
            meta["encoding"] = ["h264", "vp9", "mystery"][i % 3]
        if i % 4 == 0:  # the background (metadata-store) path
            port.persist_object(f"o{i}", input_type, meta)
            ref.persist_object(f"o{i}", input_type, meta)
        a = port.extract("fn", input_type, meta, object_id=f"o{i}")
        b = ref.extract("fn", input_type, meta, object_id=f"o{i}")
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)
    assert port.feature_dim(input_type) == ref.feature_dim(input_type)


# --------------------------------------------------- arena == legacy (port)
def _pair(**kw):
    return (TA.ResourceAllocator(engine="arena", device="cpu", **kw),
            TA.ResourceAllocator(engine="legacy", device="cpu", **kw))


def _assert_same_weights(arena, legacy, fn):
    got = arena._arena.weights(fn)
    ag = legacy._agents[fn]
    for a, b in zip(got, (ag.vcpu.w, ag.vcpu.g2, ag.mem.w, ag.mem.g2)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_arena_equals_legacy_on_random_stream(seed):
    rng = np.random.default_rng(seed)
    n_fns = 1 + seed % 5
    fns = [f"f{i}" for i in range(n_fns)]
    dims = {f: int(rng.integers(1, 7)) for f in fns}
    arena, legacy = _pair(vcpu_confidence=2, mem_confidence=3)
    touched = set()
    for _ in range(40):
        fn = fns[int(rng.integers(n_fns))]
        x = rng.standard_normal(dims[fn]).astype(np.float32)
        if rng.random() < 0.5:
            size = float(rng.uniform(0, 3000))
            assert arena.allocate(fn, x, size) == legacy.allocate(fn, x, size)
        else:
            obs = _rand_obs(rng)
            arena.feedback(fn, x, obs)
            legacy.feedback(fn, x, obs)
            touched.add(fn)
        assert arena.agent_updates(fn) == legacy.agent_updates(fn)
    items = [(f, rng.standard_normal(dims[f]).astype(np.float32), 0.0) for f in fns]
    assert arena.allocate_batch(items) == legacy.allocate_batch(items)
    for fn in touched:
        _assert_same_weights(arena, legacy, fn)


def test_arena_growth_and_release_keep_agents_isolated():
    """Twenty functions outgrow the initial capacity (4 -> 32 rows, more
    than one 16-row bucket per flush); a released slot is zeroed and its
    next tenant learns exactly like a fresh legacy agent."""
    rng = np.random.default_rng(7)
    arena, legacy = _pair(vcpu_confidence=1, mem_confidence=1)
    fns = [f"g{i}" for i in range(20)]
    xs = {f: rng.standard_normal(3).astype(np.float32) for f in fns}
    for _ in range(2):
        for f in fns:
            obs = _rand_obs(rng)
            arena.feedback(f, xs[f], obs)
            legacy.feedback(f, xs[f], obs)
    for f in fns:
        assert arena.allocate(f, xs[f]) == legacy.allocate(f, xs[f])
        _assert_same_weights(arena, legacy, f)
    va = arena._arena._arena(arena.n_vcpu_classes, 3)
    assert va.capacity == 32 and len({va.slot(f) for f in fns}) == 20
    arena.release("g3")
    legacy.release("g3")
    assert arena.agent_updates("g3") == (0, 0)
    for _ in range(2):
        obs = _rand_obs(rng)
        arena.feedback("fresh", xs["g3"], obs)
        legacy.feedback("fresh", xs["g3"], obs)
    assert arena.allocate("fresh", xs["g3"]) == legacy.allocate("fresh", xs["g3"])
    _assert_same_weights(arena, legacy, "fresh")


def test_bucket_padding_is_a_no_op():
    """A pass of 5 rows runs as one 8-row bucket; the 3 padding rows
    change nothing and the 5 real rows equal one-at-a-time updates."""
    rng = np.random.default_rng(3)
    eng = TAA.ArenaEngine(n_vcpu_classes=32, n_mem_classes=40,
                          vcpu_cost_fn=TCF.absolute_vcpu_costs, mem_class_mb=128,
                          device="cpu")
    ar = eng._arena(32, 4)
    slots = [ar.slot(f"f{i}") for i in range(5)]
    ar.w[:5] = torch.from_numpy(rng.standard_normal((5, 32, 5)).astype(np.float32))
    xbs = np.concatenate([rng.standard_normal((5, 4)), np.ones((5, 1))], 1).astype(np.float32)
    costs = (1 + 30 * rng.random((5, 32))).astype(np.float32)
    w0, g0 = ar.w.clone(), ar.g2.clone()
    eng._update_rows(ar, slots, xbs, costs)
    for i in range(5):
        w1, g1 = TAA._csc_update(w0[i], g0[i], torch.from_numpy(xbs[i, :4]),
                                 torch.from_numpy(costs[i]), 0.5)
        assert torch.equal(ar.w[i], w1) and torch.equal(ar.g2[i], g1)
    assert torch.equal(ar.w[5:], w0[5:])


# -------------------------------------------------------- port vs JAX
def test_csoaa_weights_match_jax_within_float32_tolerance():
    rng = np.random.default_rng(21)
    port = TA.ResourceAllocator(device="cpu")
    ref = JA.ResourceAllocator()
    fns = {"a": 5, "b": 3, "c": 6}
    for _ in range(60):
        fn = list(fns)[int(rng.integers(3))]
        x = rng.standard_normal(fns[fn]).astype(np.float32)
        obs = _rand_obs(rng)
        port.feedback(fn, x, obs)
        ref.feedback(fn, x, _as_jax_obs(obs))
    for fn in fns:
        for got, want in zip(port._arena.weights(fn), ref._arena.weights(fn)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _quickstart_stream():
    """(features, prompt_len) for the quickstart's 120-request stream:
    the same numpy draws, after the three demo prompts."""
    rng = np.random.default_rng(0)
    for n in (8, 19, 33):
        rng.integers(1, 1024, size=n)
    feat = TF.Featurizer()
    for _ in range(120):
        n = int(rng.choice([16, 64, 256]))
        yield feat.extract("serve-qwen", "request",
                           {"prompt_tokens": n, "batch": 1, "max_new_tokens": 16,
                            "image_tiles": 0, "audio_seconds": 0}), n


def _serve_cost(vcpus, prompt_len):
    return 0.05 + 0.004 * prompt_len / min(vcpus, max(prompt_len // 16, 1))


def _top2_gap(agent_w, x):
    costs = np.sort(TAA._csc_predict(torch.from_numpy(agent_w), torch.from_numpy(x)).numpy())
    return float(costs[1] - costs[0])


def test_quickstart_stream_allocations_equal_jax():
    port = TA.ResourceAllocator(device="cpu")
    ref = JA.ResourceAllocator()
    min_gap, served = np.inf, 0
    for i, (x, n) in enumerate(_quickstart_stream()):
        a, b = port.allocate("serve-qwen", x), ref.allocate("serve-qwen", x)
        gaps = []
        if a.vcpu_predicted or a.mem_predicted:
            w = port._arena.weights("serve-qwen")
            gaps = [_top2_gap(w[0], x), _top2_gap(w[2], x)]
            min_gap = min(min_gap, *gaps)
            served += 1
        assert dataclasses.astuple(a) == dataclasses.astuple(b), (
            f"request {i}: port {a} vs jax {b}; top-2 cost gaps {gaps}")
        obs = dict(exec_time_s=_serve_cost(a.vcpus, n), slo_s=0.25,
                   alloc_vcpus=a.vcpus, max_vcpus_used=min(a.vcpus, max(n // 16, 1)),
                   alloc_mem_mb=a.mem_mb, max_mem_used_mb=32 + 0.5 * n)
        port.feedback("serve-qwen", x, TCF.Observation(**obs))
        ref.feedback("serve-qwen", x, JCF.Observation(**obs))
    assert served > 100
    print(f"quickstart stream: {served} predicted allocations equal; "
          f"smallest top-2 cost gap {min_gap:.3g}")
