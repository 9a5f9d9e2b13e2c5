"""The port's remaining decoder-only configs against the JAX reference.

nemotron-4-15b (GQA at G = 6, squared-ReLU MLP), codeqwen1.5-7b (MHA, QKV
bias), phi3-mini-3.8b (MHA at head_dim 96) and internvl2-76b (the vlm:
patch embeddings prepended to the tokens; served as its 40-layer cut).
Inputs come from a numpy seed and go to both packages; weights are the
reference's ``init_params`` carried over with ``params_from_numpy``.

* The configs (published, reduced and the 40-layer cut), the analytic
  parameter counts, the parameter layout and its conversion equal the
  reference's.
* The MLP block on identical inputs against ``repro.models.layers.mlp``:
  float32 within 2e-5 x max(|ref|, 1), bfloat16 within 0.02 relative.
* Each reduced model's prefill + 8 teacher-forced decode steps (a 16-slot
  ring that wraps) in float32 within 2e-5 x max(|ref|, 1), with equal
  greedy tokens at every step; the JAX side with ``use_pallas`` off and on
  (interpret mode).
* internvl2's prefix with left padding (the pads sit between the patches
  and the text, the reference's quirk), zeros and random patch embeddings,
  against the JAX engine.
* The serve CLI with ``--reduced --device cpu``: no kernel launched, and
  the JAX engine's tokens on the same weights. The published internvl2-76b
  is refused before anything is allocated.
"""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import shared_fields  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCHS = ["nemotron-4-15b", "codeqwen1.5-7b", "phi3-mini-3.8b", "internvl2-76b"]
F32_TOL = 2e-5  # tests/test_kernels.py TOL[float32], scaled by max(|ref|, 1)
BF16_REL = 0.02  # tests/test_kernels.py:145 relative-logit bar
PROMPT, WINDOW, STEPS, BATCH = 24, 16, 8, 2
# count_params_analytic of the reference, at the published widths
PARAMS = {"nemotron-4-15b": 15_628_376_064, "codeqwen1.5-7b": 8_190_038_016,
          "phi3-mini-3.8b": 3_821_079_552, "internvl2-76b": 70_553_706_496,
          "internvl2-76b-40l": 36_327_530_496}


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


def _configs(arch, dtype):
    return (dataclasses.replace(get_reduced_config(arch), dtype=dtype),
            dataclasses.replace(jax_reduced_config(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype):
    """(port params, JAX params) holding identical values."""
    cfg, jcfg = _configs(arch, dtype)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return params_from_numpy(tree, cfg, device="cpu"), jparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


def _patches(cfg, seed, batch=BATCH):
    """Random patch embeddings for a vlm (None for any other family)."""
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _layout(tree):
    return {k: _layout(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def _to_jax(params, dtype):
    if isinstance(params, dict):
        return {k: _to_jax(v, dtype) for k, v in params.items()}
    return jnp.asarray(params.float().numpy(), dtype)


# ------------------------------------------------------- configs and counts


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_reduced_config(arch), jax_reduced_config(arch))):
        assert shared_fields(port) == dataclasses.asdict(ref)
    assert get_config(arch).family == ("vlm" if arch == "internvl2-76b" else "dense")


def test_internvl2_one_card_cut_is_the_published_config_at_40_layers():
    cut, full = get_config("internvl2-76b-40l"), jax_config("internvl2-76b")
    assert cut.num_layers == 40 and full.num_layers == 80
    assert shared_fields(cut) == dataclasses.asdict(dataclasses.replace(
        full, name="internvl2-76b-40l", num_layers=40))
    assert cut.frontend_tokens == 256


@pytest.mark.parametrize("arch", ARCHS + ["internvl2-76b-40l"])
def test_count_params_analytic_matches_jax(arch):
    cfg = get_config(arch)
    jcfg = dataclasses.replace(jax_config(arch.removesuffix("-40l")),
                               num_layers=cfg.num_layers)
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jcfg) == PARAMS[arch]
    assert cfg.param_count() == PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_count_params_matches_jax(arch):
    cfg, jcfg = _configs(arch, "bfloat16")
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference_layout(arch):
    """init_params gives the reference's keys, shapes and leaf types: the
    squared-ReLU MLP holds wu and wd alone, the vlm the dense block."""
    cfg, jcfg = _configs(arch, "bfloat16")
    port = TM.init_params(torch.Generator().manual_seed(0), cfg)
    _, jparams = _weights(arch, "bfloat16")
    assert _layout(port) == _layout(jparams)
    keys = {"wu", "wd"} if cfg.mlp_type == "squared_relu" else {"wg", "wu", "wd"}
    assert set(port["blocks"]["mlp"]) == keys
    assert TM.count_params(port) == JM.count_params(jparams) == TM.count_params_analytic(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_the_tree_unchanged(arch):
    """Every leaf comes over key for key, in the model's dtype, no value
    changed (nemotron's two-matrix MLP and internvl2's tree included)."""
    params, jparams = _weights(arch, "bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(_layout(params), is_leaf=lambda x:
                                                        isinstance(x, tuple)))
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == leaf.shape
        assert np.array_equal(_f32(node), _f32(leaf)), path


def test_weights_are_drawn_in_bounded_blocks(monkeypatch):
    """A stacked weight is drawn a block of rows at a time, so its float32
    temporary never exceeds ``layers._DRAW`` values (internvl2-76b-40l's
    40 stacked MLP matrices fit the card only so), with the scale of one
    whole draw."""
    drawn = []
    randn = torch.randn

    def counting(shape, *args, **kwargs):
        drawn.append(int(np.prod(shape)))
        return randn(shape, *args, **kwargs)

    monkeypatch.setattr(TL, "_DRAW", 1000)
    monkeypatch.setattr(torch, "randn", counting)
    w = TL.dense_init(torch.Generator().manual_seed(0), 64, 48, torch.bfloat16, lead=(3, 2))
    assert w.shape == (3, 2, 64, 48) and w.dtype == torch.bfloat16
    assert sum(drawn) == w.numel() and max(drawn) <= 1000
    assert abs(float(w.float().std()) - 64 ** -0.5) < 0.01


# ---------------------------------------------------------------- the MLP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_block_matches_jax(arch, dtype):
    """Layer 0's MLP on identical inputs (nemotron's squared ReLU, squared
    in the model's dtype on both sides; SwiGLU for the others)."""
    cfg, jcfg = _configs(arch, dtype)
    params, jparams = _weights(arch, dtype)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, 5, cfg.d_model)).astype(np.float32)
    p = TM._layer(params["blocks"], 0)["mlp"]
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["mlp"])
    want = JL.mlp(jp, jcfg, jnp.asarray(x, jcfg.dtype))
    got = TL.mlp(p, cfg, torch.from_numpy(x).to(cfg.torch_dtype))
    assert got.dtype == cfg.torch_dtype
    _check(got, want, dtype, f"{arch} mlp")


def test_unknown_mlp_type_raises():
    cfg = dataclasses.replace(get_reduced_config("nemotron-4-15b"), mlp_type="gelu")
    x = torch.zeros((1, 2, cfg.d_model))
    for fn in (lambda: TL.init_mlp(torch.Generator().manual_seed(0), cfg),
               lambda: TL.mlp_param_count(cfg), lambda: TL.mlp({}, cfg, x)):
        with pytest.raises(ValueError, match="gelu"):
            fn()


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_jax(arch, use_pallas):
    """A 24-token prompt (behind random patch embeddings for internvl2)
    into a 16-slot ring, then 8 decode steps fed the same teacher tokens
    on both sides: logits and the ring after each, greedy tokens equal."""
    cfg, jcfg = _configs(arch, "float32")
    params, jparams = _weights(arch, "float32")
    toks = _tokens(2, (BATCH, PROMPT), cfg.vocab_size)
    teacher = _tokens(3, (STEPS, BATCH), cfg.vocab_size)
    patches = _patches(cfg, 4)
    kw = {} if patches is None else {"patch_embeds": patches}
    tkw = {} if patches is None else {"patch_embeds": torch.from_numpy(patches)}

    prefill = jax.jit(functools.partial(JM.forward_prefill, cfg=jcfg, cache_window=WINDOW,
                                        use_pallas=use_pallas))
    decode = jax.jit(functools.partial(JM.forward_decode, cfg=jcfg, use_pallas=use_pallas))
    ref_logits, ref_cache = prefill(jparams, tokens=toks, **kw)
    logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                       cache_window=WINDOW, **tkw)
    _check(logits, ref_logits, "float32", "prefill logits")
    assert np.array_equal(_f32(logits).argmax(-1), _f32(ref_logits).argmax(-1))
    assert set(cache) == set(ref_cache) == {"k", "v", "pos"}
    for name in ("k", "v"):
        _check(cache[name], ref_cache[name], "float32", f"prefill cache {name}")
    # the prefix counts: the text starts at position frontend_tokens
    assert cache["pos"].tolist() == [cfg.frontend_tokens + PROMPT] * BATCH
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))

    for step in range(STEPS):
        ref_logits, ref_cache = decode(jparams, token=teacher[step], cache=ref_cache)
        logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(teacher[step]),
                                          cache)
        _check(logits, ref_logits, "float32", f"decode step {step} logits")
        assert np.array_equal(_f32(logits).argmax(-1), _f32(ref_logits).argmax(-1)), step
    for name in ("k", "v"):
        _check(cache[name], ref_cache[name], "float32", f"decode cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_logits_match_jax(arch):
    cfg, jcfg = _configs(arch, "float32")
    params, jparams = _weights(arch, "float32")
    toks = _tokens(1, (BATCH, 33), cfg.vocab_size)
    patches = _patches(cfg, 5)
    kw = {} if patches is None else {"patch_embeds": patches}
    want, _, _ = jax.jit(functools.partial(JM.forward_seq, cfg=jcfg))(jparams, tokens=toks,
                                                                      **kw)
    got, cache = TM.forward_seq(params, cfg, torch.from_numpy(toks),
                                patch_embeds=None if patches is None
                                else torch.from_numpy(patches))
    assert cache is None
    assert got.shape == (BATCH, cfg.frontend_tokens + 33, cfg.vocab_size)
    _check(got, want, "float32", "forward_seq logits")


def test_vlm_forward_needs_patch_embeds():
    cfg = get_reduced_config("internvl2-76b")
    params, _ = _weights("internvl2-76b", "bfloat16")
    with pytest.raises(ValueError, match="patch_embeds"):
        TM.forward_seq(params, cfg, torch.ones((1, 4), dtype=torch.int32))


# ------------------------------------------------- internvl2's patch prefix


@pytest.mark.parametrize("patches", ["zeros", "random"])
def test_vlm_prefix_with_left_padding_matches_jax_engine(patches):
    """Two prompts of 8 and 24 tokens in one batch: the short one is
    left-padded before the patches are prepended, so its 16 pad tokens sit
    between the image and the text and are attended to, as in the
    reference (engine.py:53-62 with model.py:265-267). Greedy tokens and
    the prefill logits equal the JAX engine's; without ``patch_embeds``
    both engines use zeros."""
    arch = "internvl2-76b"
    cfg, jcfg = _configs(arch, "float32")
    params, jparams = _weights(arch, "float32")
    prompts = [list(_tokens(8, (8,), cfg.vocab_size)), list(_tokens(9, (24,), cfg.vocab_size))]
    emb = None if patches == "zeros" else _patches(cfg, 10)
    port = ServingEngine(cfg, params, cache_window=WINDOW, device="cpu")
    ref = JaxEngine(jcfg, jparams, cache_window=WINDOW)
    got = port.generate(prompts, max_new_tokens=6,
                        patch_embeds=None if emb is None else torch.from_numpy(emb))
    want = ref.generate(prompts, max_new_tokens=6,
                        patch_embeds=None if emb is None else jnp.asarray(emb))
    assert got.tokens == want.tokens

    padded = port._pad_batch(prompts)
    assert padded.shape == (2, 24) and int(padded[0, :16].abs().sum()) == 0
    pe = (np.zeros((2, cfg.frontend_tokens, cfg.d_model), np.float32) if emb is None else emb)
    want_logits, _ = JM.forward_prefill(jparams, jcfg, jnp.asarray(padded.numpy()),
                                        patch_embeds=jnp.asarray(pe), cache_window=WINDOW)
    logits, _ = TM.forward_prefill(params, cfg, padded, patch_embeds=torch.from_numpy(pe),
                                   cache_window=WINDOW)
    _check(logits, want_logits, "float32", "vlm prefill logits")
    # the pads are not masked: the short prompt alone gives other logits
    alone, _ = TM.forward_prefill(params, cfg, padded[:1, 16:],
                                  patch_embeds=torch.from_numpy(pe[:1]), cache_window=WINDOW)
    assert float((alone - logits[:1]).abs().max()) > 1e-3


def test_engine_defaults_vlm_patches_to_zeros():
    """Without ``patch_embeds`` the engine prefills zeros of
    (B, frontend_tokens, d_model) in the model's dtype."""
    cfg = get_reduced_config("internvl2-76b")
    params, _ = _weights("internvl2-76b", "bfloat16")
    engine = ServingEngine(cfg, params, cache_window=WINDOW, device="cpu")
    prompt = list(_tokens(11, (8,), cfg.vocab_size))
    zeros = torch.zeros((1, cfg.frontend_tokens, cfg.d_model), dtype=torch.bfloat16)
    assert (engine.generate([prompt], max_new_tokens=4).tokens
            == engine.generate([prompt], max_new_tokens=4, patch_embeds=zeros).tokens)


# ---------------------------------------------------------- the serve path


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_reduced_cpu_matches_jax_engine(arch, monkeypatch, capsys):
    """``--arch <id> --reduced --device cpu``: the loop runs on the plain
    versions (no kernel launched, the CUDA build never touched); the served
    tokens are the port engine's, and in float32 on the same weights the
    port's tokens equal the JAX engine's."""
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU run must not touch the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    ops.reset_launch_counts()
    served = serve_mod.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "6", "--seed", "0"])
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "moe_gmm": 0, "moe_gmm_grouped": 0}
    cfg = get_reduced_config(arch)
    out = capsys.readouterr().out
    assert f"serving {cfg.name} (reduced, {cfg.family}, bfloat16)" in out
    assert out.count("req ") == 3 and len(served) == 3

    engine = ServingEngine(cfg, seed=0, cache_window=serve_mod.CACHE_WINDOW, device="cpu")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _to_jax(engine.params, jnp.float32)
    port32 = ServingEngine(cfg32, params_from_numpy(jax.tree_util.tree_map(
        np.asarray, params32), cfg32, device="cpu"), cache_window=serve_mod.CACHE_WINDOW,
        device="cpu")
    jax32 = JaxEngine(dataclasses.replace(jax_reduced_config(arch), dtype="float32"),
                      params32, cache_window=serve_mod.CACHE_WINDOW)
    for rec in served:
        assert len(rec.prompt) in (8, 24, 48)
        assert rec.result.tokens == engine.generate([rec.prompt], max_new_tokens=6).tokens
        want = jax32.generate([rec.prompt], max_new_tokens=6).tokens
        assert port32.generate([rec.prompt], max_new_tokens=6).tokens == want


def test_internvl2_is_refused_before_allocating(monkeypatch):
    """``--arch internvl2-76b`` on CUDA: 141.1 GB of bf16 weights against an
    80 GB card (a fake device, so no card is needed) raises and names the
    40-layer cut; the cut (72.7 GB) and nemotron (31.3 GB) pass."""
    card = SimpleNamespace(total_memory=80 * 10 ** 9)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: card)

    def no_alloc(*args, **kwargs):
        raise AssertionError("nothing may be allocated before the check")

    monkeypatch.setattr(engine_mod, "init_params", no_alloc)
    with pytest.raises(ValueError, match="141.1 GB.*80.0 GB.*internvl2-76b-40l"):
        serve_mod.main(["--arch", "internvl2-76b", "--requests", "1"])
    for arch in ("internvl2-76b-40l", "nemotron-4-15b", "codeqwen1.5-7b", "phi3-mini-3.8b"):
        engine_mod._check_fits(get_config(arch), torch.device("cuda"))
