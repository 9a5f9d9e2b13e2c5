"""The port's hybrid (Zamba2) path against the JAX reference on the same inputs.

Inputs come from a numpy seed and go to both packages; weights are the
reference's ``init_params`` carried over with ``params_from_numpy``.

* The configs, the analytic parameter count (6,751,130,832 at full width),
  ``num_attn_layers`` / ``num_ssm_layers`` and the parameter layout
  (``shared_attn`` included) equal the reference's.
* ``forward_seq`` logits, the prefill cache (``ssd``, ``conv``, ``k``,
  ``v``, ``pos``) and 8 teacher-forced decode steps at ``cache_window``
  16 (the ring wraps), on reduced Zamba2 (2 layers, one application of
  the shared block) and on a 5-layer variant with ``attn_every`` 2 (the
  block fires at layers 0, 2 and 4: three cache slots, so an off-by-one
  in the slot index shows), in float32 within 2e-5 x max(|ref|, 1); the
  JAX side runs with ``use_pallas`` off and on (interpret mode).
* The shared block on identical inputs, over a sequence and for one
  decode step (its ring write included), in float32 within 2e-5 x
  max(|ref|, 1) and in bfloat16 within 0.02 relative; a bf16 model's
  cache dtypes. (Why bf16 is held per block: see the model section.)
* The serve CLI (``--arch zamba2-7b --reduced --device cpu``) gives the
  JAX engine's tokens, and ``examples/quickstart_torch.py`` on the CPU
  prints the allocation lines of ``examples/quickstart.py``.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import kv_cache as JKV  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import shared_fields  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import kv_cache as TKV  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "zamba2-7b"
F32_TOL = 2e-5  # tests/test_kernels.py TOL[float32], scaled by max(|ref|, 1)
BF16_REL = 0.02  # tests/test_kernels.py:145 relative-logit bar
STEPS, BATCH, WINDOW = 8, 2, 16
# the reduced config (one application) and a deeper cut of it (three)
VARIANTS = {"reduced": {}, "five_layers": {"num_layers": 5, "attn_every": 2}}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.max(np.abs(got - want))), float(np.max(np.abs(want)))
    if dtype == "float32":
        assert err <= F32_TOL * max(scale, 1.0), (what, err)
    else:
        assert err <= BF16_REL * scale, (what, err / scale)


def _configs(variant, dtype):
    kw = dict(VARIANTS[variant], dtype=dtype)
    return (dataclasses.replace(get_reduced_config(ARCH), **kw),
            dataclasses.replace(jax_reduced_config(ARCH), **kw))


@functools.lru_cache(maxsize=None)
def _weights(variant, dtype):
    """(port params, JAX params) holding identical values."""
    cfg, jcfg = _configs(variant, dtype)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return params_from_numpy(tree, cfg, device="cpu"), jparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


def _layout(tree):
    return {k: _layout(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


# ------------------------------------------------------- configs and counts


def test_configs_match_the_reference():
    for port, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_reduced_config(ARCH), jax_reduced_config(ARCH))):
        assert shared_fields(port) == dataclasses.asdict(ref)
        assert port.family == "hybrid"


@pytest.mark.parametrize("reduced", [True, False])
def test_count_params_analytic_matches_jax(reduced):
    cfg = (get_reduced_config if reduced else get_config)(ARCH)
    jcfg = (jax_reduced_config if reduced else jax_config)(ARCH)
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)
    assert cfg.param_count() == JM.count_params_analytic(jcfg)
    if not reduced:
        assert cfg.param_count() == 6_751_130_832


@pytest.mark.parametrize("arch,variant,attn,ssm", [
    (ARCH, None, 14, 81),                # full width: ceil(81 / 6) applications
    (ARCH, "reduced", 1, 2),
    (ARCH, "five_layers", 3, 5),
    ("mamba2-1.3b", None, 0, 48),
    ("qwen2.5-3b", None, 36, 0),
    ("mixtral-8x7b", None, 32, 0),
])
def test_num_attn_and_ssm_layers_match_reference(arch, variant, attn, ssm):
    if variant is None:
        cfg, jcfg = get_config(arch), jax_config(arch)
    else:
        cfg, jcfg = _configs(variant, "bfloat16")
    assert TKV.num_attn_layers(cfg) == JKV.num_attn_layers(jcfg) == attn
    assert TKV.num_ssm_layers(cfg) == JKV.num_ssm_layers(jcfg) == ssm


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_tree_matches_reference_layout(variant):
    """init_params gives the reference's keys, shapes and leaf types: the
    stacked Mamba2 blocks and one unstacked shared attention block."""
    cfg, jcfg = _configs(variant, "bfloat16")
    port = TM.init_params(torch.Generator().manual_seed(0), cfg)
    _, jparams = _weights(variant, "bfloat16")
    assert _layout(port) == _layout(jparams)
    assert set(port["shared_attn"]) == {"norm1", "attn", "norm2", "mlp"}
    assert port["shared_attn"]["norm1"].shape == (cfg.d_model,)
    assert TM.count_params(port) == JM.count_params(jparams)
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)


def test_params_from_numpy_carries_the_shared_block():
    """The unstacked ``shared_attn`` subtree comes over key for key, in the
    model's dtype, with no value changed."""
    params, jparams = _weights("reduced", "bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(jparams["shared_attn"])[0]
    assert len(flat) == 9  # norm1, wq, wk, wv, wo, norm2 and the three MLP weights
    for path, leaf in flat:
        node = params["shared_attn"]
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == leaf.shape
        assert np.array_equal(_f32(node), _f32(leaf)), path


# ---------------------------------------------------------------- the model
#
# Model-level parity runs in float32, where the two frameworks differ only
# in summation order. bfloat16 is held block by block on identical inputs:
# on these random weights the reference's own two bf16 paths (use_pallas
# off and on) already differ by about 0.02 of the largest logit on the
# reduced config and by more on the five-layer variant (the next test), so
# the 0.02 relative-logit bar (tests/test_kernels.py:145) lies inside the
# bf16 rounding noise of a whole hybrid model and would not tell a fault
# from rounding.


def test_reference_bf16_paths_differ_by_more_than_the_logit_bar():
    """The reference against itself, bf16, on the forward_seq inputs below:
    its plain and its Pallas path differ by more than 0.02 of the largest
    logit on the five-layer variant. (Should this stop holding, a
    whole-model bf16 check against JAX becomes meaningful again.)"""
    gaps = {}
    for variant in VARIANTS:
        _, jcfg = _configs(variant, "bfloat16")
        _, jparams = _weights(variant, "bfloat16")
        toks = _tokens(1, (BATCH, 2 * jcfg.ssm_chunk), jcfg.vocab_size)
        plain, pallas = (_f32(jax.jit(functools.partial(
            JM.forward_seq, cfg=jcfg, use_pallas=up))(jparams, tokens=toks)[0])
            for up in (False, True))
        gaps[variant] = float(np.max(np.abs(pallas - plain)) / np.max(np.abs(plain)))
    print(f"reference bf16, use_pallas on vs off, relative logit gap: {gaps}")
    assert gaps["five_layers"] > BF16_REL, gaps


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_seq_logits_match_jax(variant, use_pallas):
    """Two SSD chunks, so every Mamba2 layer carries a state across them."""
    cfg, jcfg = _configs(variant, "float32")
    params, jparams = _weights(variant, "float32")
    toks = _tokens(1, (BATCH, 2 * cfg.ssm_chunk), cfg.vocab_size)
    want, _, _ = jax.jit(functools.partial(
        JM.forward_seq, cfg=jcfg, use_pallas=use_pallas))(jparams, tokens=toks)
    got, cache = TM.forward_seq(params, cfg, torch.from_numpy(toks))
    assert cache is None
    _check(got, want, "float32", "forward_seq logits")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_cache_and_teacher_forced_decode_match_jax(variant, use_pallas):
    """Prefill one 64-token chunk into a 16-slot ring (it keeps the last
    16 positions), then 8 decode steps fed the same teacher tokens on both
    sides; the caches, K/V application by application, after the prefill
    and at the end."""
    cfg, jcfg = _configs(variant, "float32")
    params, jparams = _weights(variant, "float32")
    toks = _tokens(2, (BATCH, cfg.ssm_chunk), cfg.vocab_size)
    teacher = _tokens(3, (STEPS, BATCH), cfg.vocab_size)

    prefill = jax.jit(functools.partial(JM.forward_prefill, cfg=jcfg, cache_window=WINDOW,
                                        use_pallas=use_pallas))
    decode = jax.jit(functools.partial(JM.forward_decode, cfg=jcfg, use_pallas=use_pallas))
    ref_logits, ref_cache = prefill(jparams, tokens=toks)
    logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                       cache_window=WINDOW)
    _check(logits, ref_logits, "float32", "prefill logits")
    assert set(cache) == set(ref_cache) == {"ssd", "conv", "k", "v", "pos"}
    apps = TKV.num_attn_layers(cfg)
    assert cache["k"].shape == (apps, BATCH, WINDOW, cfg.num_kv_heads, cfg.head_dim)
    for name in ("ssd", "conv", "k", "v"):
        assert tuple(cache[name].shape) == ref_cache[name].shape, name
        _check(cache[name], ref_cache[name], "float32", f"prefill cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))

    for step in range(STEPS):
        ref_logits, ref_cache = decode(jparams, token=teacher[step], cache=ref_cache)
        logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(teacher[step]),
                                          cache)
        _check(logits, ref_logits, "float32", f"decode step {step} logits")
    for name in ("ssd", "conv"):
        _check(cache[name], ref_cache[name], "float32", f"decode cache {name}")
    for name in ("k", "v"):
        for app in range(apps):
            _check(cache[name][app], ref_cache[name][app], "float32",
                   f"decode cache {name} application {app}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))


def test_bf16_prefill_cache_keeps_the_reference_dtypes():
    """A bf16 model's caches: K/V and conv in bf16, the SSD state in f32."""
    cfg, jcfg = _configs("five_layers", "bfloat16")
    params, jparams = _weights("five_layers", "bfloat16")
    toks = _tokens(2, (BATCH, cfg.ssm_chunk), cfg.vocab_size)
    _, ref_cache = jax.jit(functools.partial(JM.forward_prefill, cfg=jcfg,
                                             cache_window=WINDOW))(jparams, tokens=toks)
    _, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks), cache_window=WINDOW)
    for name, leaf in ref_cache.items():
        assert str(cache[name].dtype).replace("torch.", "") == str(leaf.dtype), name
        assert tuple(cache[name].shape) == leaf.shape, name


def _shared_block(dtype):
    cfg, jcfg = _configs("reduced", dtype)
    params, jparams = _weights("reduced", dtype)
    return cfg, jcfg, params["shared_attn"], jparams["shared_attn"]


def _pair(arr, dtype):
    return jnp.asarray(arr, dtype), torch.from_numpy(arr).to(getattr(torch, dtype))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_block_over_a_sequence_matches_jax(dtype, use_pallas):
    """The shared attention + MLP block over a 64-token sequence on
    identical inputs: its output and the RoPE'd K and V it caches."""
    cfg, jcfg, p, jp = _shared_block(dtype)
    rng = np.random.default_rng(13)
    S = cfg.ssm_chunk
    jx, tx = _pair(rng.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32), dtype)
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (BATCH, S))
    want, _, (jk, jv, _, _) = JM._attn_full(jp, jcfg, jx, jpos, None, None, use_pallas)
    tpos = torch.arange(S, dtype=torch.int32)[None].expand(BATCH, S)
    got, _, (k, v) = TM._attn_full(p, cfg, tx, TM.position_tables(cfg, tpos), None, True)
    for what, a, b in (("out", got, want), ("k", k, jk), ("v", v, jv)):
        _check(a, b, dtype, f"shared block {what}")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_block_decode_step_matches_jax(dtype, use_pallas):
    """One token of the shared block against a wrapped 16-slot ring, as the
    reference's hybrid decode body computes it (rms_norm, attention, MLP),
    then the token's K/V written to its ring slot."""
    cfg, jcfg, p, jp = _shared_block(dtype)
    rng = np.random.default_rng(14)
    jx, tx = _pair(rng.standard_normal((BATCH, cfg.d_model)).astype(np.float32), dtype)
    shape = (BATCH, WINDOW, cfg.num_kv_heads, cfg.head_dim)
    jk, tk = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    pos = np.array([70, 23], np.int32)
    a = JL.rms_norm(jx, jp["norm1"], jcfg.norm_eps)
    o, nk, nv = JM._attn_decode(jp, jcfg, a, jk, jv, jnp.asarray(pos), None, None, use_pallas)
    h = jx + o
    want = h + JL.mlp(jp["mlp"], jcfg, JL.rms_norm(h, jp["norm2"], jcfg.norm_eps))
    got = TM._block_decode(p, cfg, tx, tk, tv, TM.decode_tables(cfg, torch.from_numpy(pos), WINDOW),
                           True)
    _check(got, want, dtype, "shared block decode out")
    _check(tk, JKV.ring_write(jk, nk, jnp.asarray(pos)), dtype, "ring k")
    _check(tv, JKV.ring_write(jv, nv, jnp.asarray(pos)), dtype, "ring v")


# ---------------------------------------------------------- the serve path


def _to_jax(params, dtype):
    """The port's parameters as JAX arrays: float32 leaves stay float32."""
    if isinstance(params, dict):
        return {k: _to_jax(v, dtype) for k, v in params.items()}
    keep = params.dtype == torch.float32
    return jnp.asarray(params.float().numpy(), jnp.float32 if keep else dtype)


def test_serve_cli_zamba2_reduced_cpu_matches_jax_engine(monkeypatch, capsys):
    """``--arch zamba2-7b --reduced --device cpu``: the hybrid path through
    the launcher's loop, no CUDA kernel touched, greedy tokens equal to the
    JAX engine's on the same weights."""
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU run must not touch the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    ops.reset_launch_counts()
    served = serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "6", "--seed", "0"])
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "moe_gmm": 0, "moe_gmm_grouped": 0}
    out = capsys.readouterr().out
    assert "serving zamba2-7b-reduced (reduced, hybrid, bfloat16)" in out
    assert out.count("req ") == 3 and len(served) == 3

    cfg = get_reduced_config(ARCH)
    params = ServingEngine(cfg, seed=0, device="cpu").params
    assert set(params["shared_attn"]) == {"norm1", "attn", "norm2", "mlp"}
    # the port pads the prompts (8, 24 or 48 tokens) to their own length;
    # the JAX engine pads to a multiple of its chunk, here 8 (the SSD's
    # result at any chunk is the same recurrence), so both prefill the
    # same unpadded prompt
    jax_engine = JaxEngine(dataclasses.replace(jax_reduced_config(ARCH), ssm_chunk=8),
                           _to_jax(params, jnp.bfloat16), cache_window=serve_mod.CACHE_WINDOW)
    for rec in served:
        assert len(rec.prompt) in (8, 24, 48)
        ref = jax_engine.generate([rec.prompt], max_new_tokens=6)
        assert rec.result.tokens == ref.tokens


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_prints_the_reference_allocations(capsys):
    """The port's quickstart on the CPU: the engine generates 3 x 16
    tokens, and the three allocations after the 120-request stream are the
    JAX quickstart's, line for line."""
    _example("quickstart_torch").main(device="cpu")
    port = capsys.readouterr().out
    _example("quickstart").main()
    ref = capsys.readouterr().out

    def allocations(out):
        return [line for line in out.splitlines() if "prompt=" in line]

    assert "[engine] generated 3x16 tokens" in port
    assert len(allocations(port)) == 3
    assert allocations(port) == allocations(ref)
