"""The port's launch tooling against the reference's.

* ``make_prefill_step`` / ``make_serve_step`` on reduced qwen2.5-3b,
  mixtral-8x7b and whisper-tiny at small ``ShapeConfig``s (prefill_32k's
  kind and name, and long_500k's long-context prefill with a window that
  binds), then decode steps, against the reference's steps: logits and
  caches within the float32 TOL (2e-5 x max(|ref|, 1)).
* ``make_train_step`` (remat on, as the reference passes it): 2 float32
  steps from the same params and AdamW state on reduced qwen2.5-3b and
  mixtral-8x7b; losses and grad norms within 1e-5 relative, params within
  0.1 x lr per element (tests/test_torch_training.py's bars).
* ``adamw_config_for``, ``eval_param_shapes`` and ``eval_opt_shapes``
  equal the reference's trees (paths, shapes, dtypes) for all 10 configs.
* ``roofline_terms`` and ``model_flops_estimate`` equal the reference's
  for every arch x shape.
* The dry run: plan-only records (no card) for qwen, mixtral, mamba2 and
  whisper x all shapes on the one-card mesh within a time bound; the
  one-card plan is the tensors' bytes; the FLOP count of one reduced dense
  prefill equals its matmul arithmetic (kernel and plain step); the CLI
  writes its JSON; ``--run`` needs a card.
"""

import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import hlo_analysis as JHA  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import roofline as RF  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import optimizer as TOPT  # noqa: E402

TOL = 2e-5
LOOP_REL = 1e-5
PARAM_MAX_LR = 0.1


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= TOL * max(np.max(np.abs(want)), 1.0), what


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


def _reduced(arch, **changes):
    changes.setdefault("dtype", "float32")
    cfg = dataclasses.replace(TC.get_reduced_config(arch), **changes)
    jcfg = dataclasses.replace(JC.get_reduced_config(arch), **changes)
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                               device="cpu")
    return cfg, jcfg, params, jparams


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape_name", [  # whisper-tiny has no long-context variant
    ("qwen2.5-3b", "prefill_32k"), ("qwen2.5-3b", "long_500k"),
    ("mixtral-8x7b", "prefill_32k"), ("mixtral-8x7b", "long_500k"),
    ("whisper-tiny", "prefill_32k")])
def test_prefill_and_serve_steps_match_reference(arch, shape_name):
    cfg, jcfg, params, jparams = _reduced(arch, long_context_window=16)
    shape = TC.ShapeConfig(shape_name, 24, 2, "prefill")
    jshape = JC.ShapeConfig(shape_name, 24, 2, "prefill")
    assert TC.effective_decode_window(cfg, shape) == JC.effective_decode_window(jcfg, jshape)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(2, 24)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        logits, cache = TS.make_prefill_step(cfg, shape)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
    jlogits, jcache = JS.make_prefill_step(jcfg, jshape)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(logits, jlogits, "prefill logits")
    for key in jcache:
        _close(cache[key], jcache[key], f"cache {key}")
    serve, jserve = TS.make_serve_step(cfg), JS.make_serve_step(jcfg)
    for t in rng.integers(1, cfg.vocab_size, size=(3, 2)).astype(np.int32):
        with torch.no_grad():
            logits, cache = serve(params, cache, torch.from_numpy(t))
        jlogits, jcache = jserve(jparams, jcache, jnp.asarray(t))
        _close(logits, jlogits, "serve logits")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b"])
def test_train_step_matches_reference(arch):
    cfg, jcfg, params, jparams = _reduced(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    opt_cfg, jopt_cfg = TOPT.AdamWConfig(**kw), JOPT.AdamWConfig(**kw)
    opt, jopt = TOPT.init_opt_state(opt_cfg, params), JOPT.init_opt_state(jopt_cfg, jparams)
    step, jstep = TS.make_train_step(cfg, opt_cfg), jax.jit(JS.make_train_step(jcfg, jopt_cfg))
    rng = np.random.default_rng(4)
    for _ in range(2):
        toks = rng.integers(1, cfg.vocab_size, size=(2, 33)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        params, opt, metrics = step(params, opt, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
        jparams, jopt, jmetrics = jstep(jparams, jopt, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
        for key in ("loss", "grad_norm", "aux_loss"):
            want = float(jmetrics[key])
            assert abs(float(metrics[key]) - want) <= LOOP_REL * max(abs(want), 1e-12), key
    got, want = _flat(params), _flat(jparams)
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.max(np.abs(_np(got[key]) - _np(w))) <= PARAM_MAX_LR * kw["lr"], key


# ---------------------------------------------------------------------------
# Trees, roofline, model FLOPs
# ---------------------------------------------------------------------------


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_and_opt_shapes_equal_reference(arch):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    assert TS.adamw_config_for(cfg) == TOPT.AdamWConfig(**dataclasses.asdict(
        JS.adamw_config_for(jcfg)))
    pshapes, jpshapes = TS.eval_param_shapes(cfg), JS.eval_param_shapes(jcfg)
    assert all(t.device.type == "meta" for t in _flat(pshapes).values())
    assert _layout(pshapes) == _layout(jpshapes)
    assert _layout(TS.eval_opt_shapes(cfg, pshapes)) == _layout(
        JS.eval_opt_shapes(jcfg, jpshapes))


def test_roofline_and_model_flops_equal_reference():
    kw = dict(per_device_flops=3.1e15, per_device_bytes=2.2e12,
              per_device_collective_bytes=4.0e10, chips=256, model_flops=5.5e17,
              peak_flops=M.PEAK_FLOPS_BF16, hbm_bw=M.HBM_BW, link_bw=M.NVLINK_BW)
    assert RF.roofline_terms(**kw).to_dict() == JHA.roofline_terms(**kw).to_dict()
    assert RF.roofline_terms(**dict(kw, per_device_flops=0.0)).to_dict() == \
        JHA.roofline_terms(**dict(kw, per_device_flops=0.0)).to_dict()
    for arch in TC.ARCH_IDS:
        cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
        for name, shape in TC.SHAPES.items():
            assert RF.model_flops_estimate(cfg, shape) == JHA.model_flops_estimate(
                jcfg, JC.SHAPES[name]), (arch, name)


def test_meshes_and_constants():
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    multi = M.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert M.one_gpu_mesh().shape == {"data": 1, "model": 1}
    assert {k: f().label for k, f in M.MESHES.items()} == {
        "1x1": "1x1", "16x16": "16x16", "2x16x16": "2x16x16"}
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.NVLINK_BW) == (989e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def test_dryrun_plans_and_costs_four_families_in_bounded_time(tmp_path):
    t0 = time.perf_counter()
    lines = []
    for arch in ("qwen2.5-3b", "mixtral-8x7b", "mamba2-1.3b", "whisper-tiny"):
        for shape in TC.SHAPES:
            rec = D.run_one(arch, shape, "1x1", tmp_path, log=lines.append)
            if rec.get("skipped"):
                assert (arch, shape) == ("whisper-tiny", "long_500k")
                continue
            p = rec["plan"]
            assert p["total_bytes"] == sum(p[k] for k in ("params_bytes", "opt_state_bytes",
                                                          "cache_bytes", "input_bytes"))
            assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
            r = rec["roofline"]
            assert r["collective_s"] == 0.0 and r["compute_s"] == pytest.approx(
                rec["cost"]["flops"] / M.PEAK_FLOPS_BF16)
            # the floor is the work the function needs: never above the
            # step as written, and at least the plan read once
            f = rec["floor"]
            assert 0 < f["bound_s"] <= max(r["compute_s"], r["memory_s"])
            assert f["bytes"] > p["total_bytes"] and f["flops"] <= rec["cost_plain"]["flops"]
    assert len(list(tmp_path.glob("*.json"))) == 16 and len(lines) == 16
    assert time.perf_counter() - t0 < 240


def test_dryrun_one_card_plan_is_the_tensors_bytes():
    cfg = TC.get_config("qwen2.5-3b")
    plan = D.plan(cfg, dataclasses.replace(TC.DECODE_32K, global_batch=32), M.one_gpu_mesh())
    params = cfg.param_count() * 2
    cache = 2 * 36 * 32 * 32768 * 2 * 128 * 2 + 32 * 4
    assert (plan["params_bytes"], plan["cache_bytes"], plan["input_bytes"]) == (
        params, cache, 32 * 4)
    train = D.plan(cfg, dataclasses.replace(TC.TRAIN_4K, global_batch=1), M.one_gpu_mesh())
    assert train["opt_state_bytes"] == 2 * 4 * cfg.param_count() + 4
    assert train["input_bytes"] == 2 * 4096 * 4
    # on the production mesh the rules cut the per-device bytes
    prod = D.plan(cfg, TC.DECODE_32K, M.make_production_mesh())
    assert prod["cache_bytes"] < 4 * cache * 128 // 32 // 16
    arctic_cfg = TC.get_config("arctic-480b")
    arctic = D.plan(arctic_cfg, TC.PREFILL_32K, M.one_gpu_mesh())
    # bf16 weights and float32 routers, 953.8 GB
    assert arctic["params_bytes"] == sum(t.numel() * t.element_size() for t in _flat(
        TS.eval_param_shapes(arctic_cfg)).values()) == 953_764_775_936
    assert not arctic["fits_card"]


def test_dryrun_flops_of_a_reduced_dense_prefill_are_its_matmuls():
    cfg = TC.get_reduced_config("qwen2.5-3b")
    B, S = 2, 64
    shape = TC.ShapeConfig("prefill_32k", S, B, "prefill")
    D_, H, Hkv, hd, F_, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             cfg.d_ff, cfg.vocab_size)
    proj = 2 * B * S * (D_ * H * hd + 2 * D_ * Hkv * hd + H * hd * D_ + 3 * D_ * F_)
    head = 2 * B * S * D_ * V
    plain = 4 * B * H * hd * S * S  # the plain path multiplies the whole score matrix
    band = 4 * B * H * hd * S * (S + 1) // 2  # the kernel the causal band
    assert D.step_cost(cfg, shape, use_kernels=False)["flops"] == (
        cfg.num_layers * (proj + plain) + head)
    assert D.step_cost(cfg, shape)["flops"] == cfg.num_layers * (proj + band) + head
    assert D.live_pairs(S, True, 16) == 16 * 17 // 2 + (S - 16) * 16
    assert D.live_pairs(S, False, 16) == S * S - (S - 16) * (S - 15) // 2


def test_dryrun_floor_counts_what_the_step_must_move_and_compute():
    """A reduced dense decode step must read the plan (weights, cache, the
    token) and write its logits, ``pos`` and one K/V row per layer; a
    train step's FLOPs are three forwards with attention over the causal
    band, and it writes back its parameters and moments."""
    cfg = TC.get_reduced_config("qwen2.5-3b")
    one = M.one_gpu_mesh()
    B, W = 2, 64
    dec = TC.ShapeConfig("decode_32k", W, B, "decode")
    plan = D.plan(cfg, dec, one)
    cost = D.step_cost(cfg, dec)
    itemsize = 2  # bfloat16
    row = cfg.num_layers * B * cfg.num_kv_heads * cfg.head_dim * itemsize
    assert cost["written_bytes"] == B * cfg.vocab_size * itemsize + B * 4 + 2 * row
    f = D.floor(cfg, dec, plan, cost)
    assert f["bytes"] == plan["total_bytes"] + cost["written_bytes"]
    assert f["flops"] == cost["flops"] and f["by"] == "bytes"
    assert f["bound_s"] == pytest.approx(f["bytes"] / M.HBM_BW)

    S = 64
    train = TC.ShapeConfig("train_4k", S, B, "train")
    tplan = D.plan(cfg, train, one)
    tcost = D.step_cost(cfg, train)
    assert tcost["written_bytes"] == tplan["params_bytes"] + tplan["opt_state_bytes"]
    D_, H, Hkv, hd, F_, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             cfg.d_ff, cfg.vocab_size)
    proj = 2 * B * S * (D_ * H * hd + 2 * D_ * Hkv * hd + H * hd * D_ + 3 * D_ * F_)
    band = 4 * B * H * hd * S * (S + 1) // 2
    forward = cfg.num_layers * (proj + band) + 2 * B * S * D_ * V
    tf = D.floor(cfg, train, tplan, tcost)
    assert tf["flops"] == 3 * forward < tcost["flops"]
    assert tf["bytes"] == tplan["total_bytes"] + tcost["written_bytes"]


def test_dryrun_cli_writes_records_and_run_needs_the_card(tmp_path, monkeypatch):
    D.main(["--arch", "qwen2.5-3b", "--shape", "long_500k", "--mesh", "2x16x16",
            "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen2_5-3b__long_500k__2x16x16.json").read_text())
    assert rec["chips"] == 512 and "cost" not in rec and rec["plan"]["cache_bytes"] > 0
    D.main(["--arch", "whisper-tiny", "--shape", "long_500k", "--out", str(tmp_path)])
    assert json.loads((tmp_path / "whisper-tiny__long_500k__1x1.json").read_text())["skipped"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.measure(TC.get_reduced_config("qwen2.5-3b"), TC.DECODE_32K, params={})


def test_arctic_published_config_is_refused_on_the_card_before_allocating(monkeypatch):
    """``get_config("arctic-480b")`` is the published config now (counts and
    plans); serving it on an 80 GB card (a fake device) raises before any
    weight is made."""
    from types import SimpleNamespace

    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving import engine as engine_mod

    card = SimpleNamespace(total_memory=80 * 10 ** 9)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: card)

    def no_alloc(*args, **kwargs):
        raise AssertionError("nothing may be allocated before the check")

    monkeypatch.setattr(engine_mod, "init_params", no_alloc)
    with pytest.raises(ValueError, match="953.7 GB of bfloat16 weights exceed .* 80.0 GB"):
        serve_mod.main(["--arch", "arctic-480b", "--requests", "1"])
