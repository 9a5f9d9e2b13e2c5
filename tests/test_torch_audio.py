"""The port's audio family (whisper-tiny, the encoder-decoder) against the
JAX reference.

Inputs come from a numpy seed and go to both packages; weights are the
reference's ``init_params`` carried over with ``params_from_numpy``.

* The configs, the analytic parameter counts (61,822,464 at the published
  widths), the parameter layout and its conversion (``encoder``,
  ``enc_pos``, ``dec_pos``, each block's ``norm_x`` and ``xattn``) equal
  the reference's.
* The encoder alone, and a decoder block with its cross-attention over a
  whole sequence, on identical inputs: float32 within 2e-5 x max(|ref|, 1),
  bfloat16 within 0.02 relative.
* Prefill + 8 teacher-forced decode steps in float32 against the
  reference's ``forward_decode`` (never its ``forward_seq``: the reference's
  decode takes its cross query from another stream, a quirk the port
  keeps), at windows 128 and 16, random and zero frame embeddings, the JAX
  side with ``use_pallas`` off and on (interpret mode): logits and caches
  within 2e-5 x max(|ref|, 1), greedy tokens equal. The quirk itself: the
  port's decode differs from its own ``forward_seq`` exactly as the
  reference's does.
* A decode position past 447 reads ``dec_pos[447]``, as the reference's
  clamp does; a prefill of more than 448 tokens is refused before the
  encoder runs.
* bf16 is no kernel test for this model: the reference's own two bf16
  paths differ by more than half the 0.02 bar, and the port's bf16 path
  with float32 attention probabilities (as its kernels keep them) by more
  than the bar, so the card holds reduced whisper in float32.
* The plain cross-attention equals the decode-kernel formulation (every
  frame valid, the query at position encoder_seq - 1) through both
  packages' ``decode_attention`` references and the Pallas kernel in
  interpret mode, within tests/test_kernels.py's TOL.
* The serve CLI (``--arch whisper-tiny --reduced --device cpu``) launches
  no kernel, and its tokens equal the JAX engine's on the same weights.
* ``forward_train``: the loss and every float32 gradient leaf against
  ``jax.value_and_grad`` of the reference's, within 1e-4 x max |g_ref|; a
  4-step run of both packages' ``train`` from one reference checkpoint
  within 1e-5 relative; and a checkpoint of the audio tree written by the
  port byte-equal to the reference's.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training import data as JDATA  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro.training import train_loop as JLOOP  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import shared_fields  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training import data as TDATA  # noqa: E402
from repro_torch.training import optimizer as TOPT  # noqa: E402
from repro_torch.training import train_loop as TLOOP  # noqa: E402

ARCH = "whisper-tiny"
F32_TOL = 2e-5  # tests/test_kernels.py TOL[float32], scaled by max(|ref|, 1)
BF16_REL = 0.02  # tests/test_kernels.py:145 relative-logit bar
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels.py:19
GRAD_TOL = 1e-4  # per leaf, x max |g_ref| (tests/test_torch_training.py)
LOOP_REL = 1e-5  # whole-run losses and grad norms, relative
PARAMS = 61_822_464  # the reference's count_params_analytic, published widths
PROMPT, STEPS, BATCH = 24, 8, 2


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))), float(np.max(np.abs(want)))


def _check(got, want, dtype, what):
    err, scale = _err(got, want)
    if dtype == "float32":
        assert err <= F32_TOL * max(scale, 1.0), (what, err)
    else:
        assert err <= BF16_REL * scale, (what, err / scale)


def _configs(dtype):
    return (dataclasses.replace(get_reduced_config(ARCH), dtype=dtype),
            dataclasses.replace(jax_reduced_config(ARCH), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _weights(dtype, seed=0):
    """(port params, JAX params) holding identical values."""
    cfg, jcfg = _configs(dtype)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return params_from_numpy(tree, cfg, device="cpu"), jparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


def _frames(cfg, kind, seed=4, batch=BATCH):
    """Frame embeddings in the model's dtype's values: random (a different
    row per sequence, so a mix of batch rows in the encoder shows) or zeros."""
    shape = (batch, cfg.encoder_seq, cfg.d_model)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(_f32(jnp.asarray(x, cfg.dtype)))  # writable, for torch.from_numpy


def _layout(tree):
    return {k: _layout(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


# ------------------------------------------------------- configs and counts


def test_configs_match_the_reference():
    for port, jx in ((get_config(ARCH), jax_config(ARCH)),
                     (get_reduced_config(ARCH), jax_reduced_config(ARCH))):
        assert shared_fields(port) == dataclasses.asdict(jx)
        assert port.family == "audio" and port.is_encoder_decoder


@pytest.mark.parametrize("reduced", [False, True])
def test_count_params_analytic_matches_jax(reduced):
    cfg = (get_reduced_config if reduced else get_config)(ARCH)
    jcfg = (jax_reduced_config if reduced else jax_config)(ARCH)
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)
    assert cfg.param_count() == JM.count_params_analytic(jcfg)
    if not reduced:
        assert TM.count_params_analytic(cfg) == PARAMS


def test_param_tree_matches_reference_layout():
    """init_params gives the reference's keys, shapes and leaf types: each
    decoder block with ``norm_x`` and ``xattn``, the stacked encoder
    blocks and norm, ``enc_pos`` and ``dec_pos`` at the reference's 0.02
    scale."""
    cfg, _ = _configs("bfloat16")
    port = TM.init_params(torch.Generator().manual_seed(0), cfg)
    _, jparams = _weights("bfloat16")
    assert _layout(port) == _layout(jparams)
    assert {"norm_x", "xattn"} <= set(port["blocks"])
    assert set(port["encoder"]) == {"blocks", "norm"}
    assert port["enc_pos"].shape == (cfg.encoder_seq, cfg.d_model)
    assert port["dec_pos"].shape == (cfg.max_target_positions, cfg.d_model)
    for key in ("enc_pos", "dec_pos"):
        assert abs(float(port[key].float().std()) - 0.02) < 0.002, key
    assert TM.count_params(port) == JM.count_params(jparams) == TM.count_params_analytic(cfg)


def test_params_from_numpy_carries_the_audio_tree():
    params, jparams = _weights("bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(_flat(params))
    seen = set()
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == leaf.shape
        assert np.array_equal(_f32(node), _f32(leaf)), path
        seen.add(path[0].key if path[0].key != "blocks" else path[1].key)
    assert {"encoder", "enc_pos", "dec_pos", "norm_x", "xattn"} <= seen


# --------------------------------------------------- the encoder and blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    cfg, jcfg = _configs(dtype)
    params, jparams = _weights(dtype)
    fe = _frames(cfg, "random", seed=6)
    want = JM._run_encoder(jparams, jcfg, jnp.asarray(fe, jcfg.dtype))
    for use_kernels in (False, True):  # the CPU takes the plain versions either way
        got = TM._run_encoder(params, cfg, torch.from_numpy(fe).to(cfg.torch_dtype),
                              use_kernels)
        assert got.dtype == cfg.torch_dtype and got.shape == fe.shape
        _check(got, want, dtype, f"encoder use_kernels={use_kernels}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_block_matches_jax(dtype):
    """Decoder layer 0 over a 24-token sequence with the cross-attention
    over an encoder output: the block's output, its self K/V (no RoPE) and
    the cross K/V it hands to the cache."""
    cfg, jcfg = _configs(dtype)
    params, jparams = _weights(dtype)
    rng = np.random.default_rng(7)
    x, enc = (np.array(_f32(jnp.asarray(rng.standard_normal((BATCH, n, cfg.d_model)),
                                        cfg.dtype))) for n in (PROMPT, cfg.encoder_seq))
    pos = np.tile(np.arange(PROMPT, dtype=np.int32), (BATCH, 1))
    jbp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])
    jx, _, jkv = JM._attn_full(jbp, jcfg, jnp.asarray(x, jcfg.dtype), jnp.asarray(pos), None,
                               jnp.asarray(enc, jcfg.dtype), False)
    tx, aux, tkv = TM._attn_full(TM._layer(params["blocks"], 0), cfg,
                                 torch.from_numpy(x).to(cfg.torch_dtype), None, None, False,
                                 torch.from_numpy(enc).to(cfg.torch_dtype))
    assert aux is None and tx.dtype == cfg.torch_dtype
    _check(tx, jx, dtype, "block output")
    for name, got, want in zip(("k", "v", "xk", "xv"), tkv, jkv):
        _check(got, want, dtype, name)


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("frames", ["random", "zeros"])
@pytest.mark.parametrize("window", [128, 16])
def test_prefill_and_teacher_forced_decode_match_jax(window, frames, use_pallas):
    """A 24-token prompt into a ring of ``window`` slots (16 wraps), then 8
    decode steps fed the same teacher tokens on both sides: logits and the
    caches after each, greedy tokens equal."""
    cfg, jcfg = _configs("float32")
    params, jparams = _weights("float32")
    toks = _tokens(2, (BATCH, PROMPT), cfg.vocab_size)
    teacher = _tokens(3, (STEPS, BATCH), cfg.vocab_size)
    fe = _frames(cfg, frames)

    prefill = jax.jit(functools.partial(JM.forward_prefill, cfg=jcfg, cache_window=window,
                                        use_pallas=use_pallas))
    decode = jax.jit(functools.partial(JM.forward_decode, cfg=jcfg, use_pallas=use_pallas))
    ref_logits, ref_cache = prefill(jparams, tokens=toks, frame_embeds=fe)
    logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                       frame_embeds=torch.from_numpy(fe), cache_window=window)
    _check(logits, ref_logits, "float32", "prefill logits")
    assert np.array_equal(_f32(logits).argmax(-1), _f32(ref_logits).argmax(-1))
    assert set(ref_cache) == {"k", "v", "xk", "xv", "pos"} <= set(cache)
    assert cache["xk"].shape == (cfg.num_layers, BATCH, cfg.encoder_seq, cfg.num_kv_heads,
                                 cfg.head_dim)
    assert all(cache["xk"][i].is_contiguous() for i in range(cfg.num_layers))
    for name in ("k", "v", "xk", "xv"):
        _check(cache[name], ref_cache[name], "float32", f"prefill cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    # the decode kernel's mask over the frames: every one live
    assert cache["cross_positions"].tolist() == [list(range(cfg.encoder_seq))] * BATCH
    assert bool(cache["cross_valid"].all())
    assert cache["cross_q_pos"].tolist() == [cfg.encoder_seq - 1] * BATCH

    for step in range(STEPS):
        ref_logits, ref_cache = decode(jparams, token=teacher[step], cache=ref_cache)
        logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(teacher[step]), cache)
        _check(logits, ref_logits, "float32", f"decode step {step} logits")
        assert np.array_equal(_f32(logits).argmax(-1), _f32(ref_logits).argmax(-1)), step
    for name in ("k", "v", "xk", "xv"):
        _check(cache[name], ref_cache[name], "float32", f"decode cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))


def test_decode_quirk_differs_from_forward_seq_as_the_reference_does():
    """The reference's decode takes the cross query from rms_norm(a + out)
    with a = rms_norm(h, norm1) (model.py:547, 578-580), its full forward
    from rms_norm(h + o) (:213-214). So neither package's decode continues
    its own forward_seq; the port's gap equals the reference's."""
    cfg, jcfg = _configs("float32")
    params, jparams = _weights("float32")
    toks = _tokens(2, (BATCH, PROMPT), cfg.vocab_size)
    teacher = _tokens(3, (STEPS, BATCH), cfg.vocab_size)
    fe = _frames(cfg, "random")
    full = np.concatenate([toks, teacher.T], axis=1)
    seq, _ = TM.forward_seq(params, cfg, torch.from_numpy(full),
                            frame_embeds=torch.from_numpy(fe))
    jseq, _, _ = JM.forward_seq(jparams, jcfg, jnp.asarray(full), frame_embeds=jnp.asarray(fe))
    logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                       frame_embeds=torch.from_numpy(fe), cache_window=128)
    jlogits, jcache = JM.forward_prefill(jparams, jcfg, jnp.asarray(toks),
                                         frame_embeds=jnp.asarray(fe), cache_window=128)
    # the prefill's last position is the full forward's: no quirk there
    _check(logits, seq[:, PROMPT - 1], "float32", "prefill vs forward_seq")
    for step in range(STEPS - 1):
        logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(teacher[step]), cache)
        jlogits, jcache = JM.forward_decode(jparams, jcfg, jnp.asarray(teacher[step]), jcache)
        gap = _f32(logits) - _f32(seq[:, PROMPT + step])
        jgap = _f32(jlogits) - _f32(jseq[:, PROMPT + step])
        scale = float(np.max(np.abs(_f32(jseq[:, PROMPT + step]))))
        assert float(np.max(np.abs(jgap))) > 1e-3 * scale, step  # the quirk is there
        assert float(np.max(np.abs(gap - jgap))) <= F32_TOL * max(scale, 1.0), step


def test_decode_clamps_positions_past_the_cap():
    """At position 460 the decoder reads dec_pos[447] (reference
    model.py:568-570): logits equal the reference's at that position, and
    they move with dec_pos row 447 and not with row 446."""
    cfg, jcfg = _configs("float32")
    params, jparams = _weights("float32")
    toks = _tokens(5, (BATCH, 8), cfg.vocab_size)
    fe = _frames(cfg, "random")
    tok = _tokens(6, (BATCH,), cfg.vocab_size)
    cap = cfg.max_target_positions
    _, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                  frame_embeds=torch.from_numpy(fe), cache_window=16)
    _, jcache = JM.forward_prefill(jparams, jcfg, jnp.asarray(toks),
                                   frame_embeds=jnp.asarray(fe), cache_window=16)
    cache["pos"] = torch.full((BATCH,), cap + 12, dtype=torch.int32)
    jcache = dict(jcache, pos=jnp.full((BATCH,), cap + 12, jnp.int32))
    snapshot = {k: v.clone() for k, v in cache.items()}
    logits, _ = TM.forward_decode(params, cfg, torch.from_numpy(tok), cache)
    jlogits, _ = JM.forward_decode(jparams, jcfg, jnp.asarray(tok), jcache)
    _check(logits, jlogits, "float32", "decode past the cap")
    for row, moves in ((cap - 1, True), (cap - 2, False)):
        moved = dict(params, dec_pos=params["dec_pos"].clone())
        moved["dec_pos"][row] += 1.0
        again, _ = TM.forward_decode(moved, cfg, torch.from_numpy(tok),
                                     {k: v.clone() for k, v in snapshot.items()})
        assert (float((again - logits).abs().max()) > 1e-3) == moves, row


def test_prefill_past_the_cap_is_refused_before_the_encoder_runs(monkeypatch):
    cfg, _ = _configs("float32")
    params, _ = _weights("float32")
    fe = torch.from_numpy(_frames(cfg, "zeros", batch=1))

    def no_encoder(*args, **kwargs):
        raise AssertionError("nothing may be computed before the check")

    monkeypatch.setattr(TM, "_run_encoder", no_encoder)
    toks = torch.ones((1, cfg.max_target_positions + 1), dtype=torch.int32)
    for fn in (TM.forward_prefill, TM.forward_seq):
        with pytest.raises(ValueError, match="449 target positions exceed "
                                             "max_target_positions 448"):
            fn(params, cfg, toks, frame_embeds=fe)
    with pytest.raises(ValueError, match="449 target positions"):
        TM.forward_train(params, cfg, toks, toks, frame_embeds=fe)


def test_encoder_decoder_forward_needs_frame_embeds():
    cfg, _ = _configs("bfloat16")
    params, _ = _weights("bfloat16")
    with pytest.raises(ValueError, match="frame_embeds"):
        TM.forward_seq(params, cfg, torch.ones((1, 4), dtype=torch.int32))


def _teacher_forced(prefill, decode, toks, teacher, fe):
    logits, cache = prefill(toks, fe)
    out = [_f32(logits)]
    for t in teacher:
        logits, cache = decode(t, cache)
        out.append(_f32(logits))
    return out


def _rel_gap(a, b):
    return max(float(np.max(np.abs(x - y)) / np.max(np.abs(y))) for x, y in zip(a, b))


def test_bf16_rounding_alone_reaches_the_logit_bar(monkeypatch):
    """Reduced whisper in bf16 on chip_smoke.py's reduced-phase inputs
    (its seeded weights, prompt, teacher tokens and random frame
    embeddings; window 128): the reference's Pallas and plain paths, run
    on those weights, differ by more than half of BF16_REL, and the port's
    path with float32 attention probabilities (a stand-in for its kernels,
    which keep their softmax in float32) differs from its plain path by
    more than BF16_REL. So the card's check of this model runs in float32."""
    cfg, jcfg = _configs("bfloat16")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)  # chip_smoke.py's
    jparams = _to_jax(params, jnp.bfloat16)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
    teacher = rng.integers(1, cfg.vocab_size, size=(STEPS, BATCH)).astype(np.int32)
    fe = rng.standard_normal((BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    ref_runs = []
    for use_pallas in (False, True):
        pf = jax.jit(functools.partial(JM.forward_prefill, cfg=jcfg, cache_window=128,
                                       use_pallas=use_pallas))
        dc = jax.jit(functools.partial(JM.forward_decode, cfg=jcfg, use_pallas=use_pallas))
        ref_runs.append(_teacher_forced(
            lambda t, f: pf(jparams, tokens=t, frame_embeds=jnp.asarray(f, jnp.bfloat16)),
            lambda t, c: dc(jparams, token=t, cache=c), toks, teacher, fe))
    assert 0.5 * BF16_REL < _rel_gap(*ref_runs) < BF16_REL  # 0.0142

    def f32_probs(fn):
        def wrapped(q, k, v, *args, **kwargs):
            return fn(q.float(), k.float(), v.float(), *args, **kwargs).to(q.dtype)
        return wrapped

    def port_run():
        return _teacher_forced(
            lambda t, f: TM.forward_prefill(params, cfg, torch.from_numpy(t),
                                            frame_embeds=torch.from_numpy(f).bfloat16(),
                                            cache_window=128),
            lambda t, c: TM.forward_decode(params, cfg, torch.from_numpy(t), c),
            toks, teacher, fe)

    plain = port_run()
    monkeypatch.setattr(ops, "flash_attention", f32_probs(ops.flash_attention))
    monkeypatch.setattr(ops, "decode_attention", f32_probs(ops.decode_attention))
    assert _rel_gap(port_run(), plain) > BF16_REL  # 0.0211


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_cross_attention_equals_the_decode_kernel_formulation(dt):
    """One query against every frame, unmasked (L.sdpa(causal=False)), is
    the decode kernel's function with every frame valid at positions
    0..S_enc-1 and the query at S_enc-1: through the port's and the
    reference's decode_attention references and the Pallas kernel."""
    cfg, _ = _configs(dt)
    rng = np.random.default_rng(11)
    H, Hkv, D, S_enc = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.encoder_seq
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((BATCH, 1, H, D), (BATCH, S_enc, Hkv, D), (BATCH, S_enc, Hkv, D))]
    q, k, v = (torch.from_numpy(a).to(cfg.torch_dtype) for a in arrays)
    jq, jk, jv = (jnp.asarray(a, cfg.dtype) for a in arrays)
    plain = TL.sdpa(q, k, v, causal=False)
    assert plain.dtype == cfg.torch_dtype
    positions = np.broadcast_to(np.arange(S_enc, dtype=np.int32), (BATCH, S_enc)).copy()
    valid = np.ones((BATCH, S_enc), bool)
    q_pos = np.full((BATCH,), S_enc - 1, np.int32)
    tkw = [torch.from_numpy(a) for a in (positions, valid, q_pos)]
    jkw = [jnp.asarray(a) for a in (positions, valid, q_pos)]
    for what, got in (
            ("port ref", ref.decode_attention_ref(q, k, v, *tkw)),
            ("port ops (CPU)", ops.decode_attention(q, k, v, *tkw)),
            ("jax ref", jref.decode_attention_ref(jq, jk, jv, *jkw)),
            ("pallas interpret", jax_decode(jq, jk, jv, *jkw, block_kv=32, interpret=True))):
        err, scale = _err(got, plain)
        assert err <= KERNEL_TOL[dt] * max(scale, 1.0), (what, err)
    # and it is the full forward's cross-attention for a one-token query
    full = JL.sdpa(jq, jk, jv, causal=False)
    err, scale = _err(plain, full)
    assert err <= KERNEL_TOL[dt] * max(scale, 1.0)


# ---------------------------------------------------------- the serve path


def test_engine_defaults_frame_embeds_to_zeros():
    cfg, _ = _configs("bfloat16")
    params, _ = _weights("bfloat16")
    engine = ServingEngine(cfg, params, cache_window=16, device="cpu")
    prompt = list(_tokens(12, (8,), cfg.vocab_size))
    zeros = torch.zeros((1, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16)
    noise = torch.from_numpy(_frames(cfg, "random", batch=1)).to(torch.bfloat16)
    default = engine.generate([prompt], max_new_tokens=4).tokens
    assert default == engine.generate([prompt], max_new_tokens=4, frame_embeds=zeros).tokens
    assert default != engine.generate([prompt], max_new_tokens=4, frame_embeds=noise).tokens


@pytest.mark.parametrize("frames", ["random", "zeros"])
def test_engine_matches_jax_engine_on_a_padded_batch(frames):
    """Prompts of 8 and 24 tokens left-padded into one batch, each row
    with its own frame embeddings."""
    cfg, jcfg = _configs("float32")
    params, jparams = _weights("float32")
    prompts = [list(_tokens(8, (8,), cfg.vocab_size)), list(_tokens(9, (24,), cfg.vocab_size))]
    fe = _frames(cfg, frames, seed=13)
    got = ServingEngine(cfg, params, cache_window=16, device="cpu").generate(
        prompts, max_new_tokens=6, frame_embeds=torch.from_numpy(fe))
    want = JaxEngine(jcfg, jparams, cache_window=16).generate(
        prompts, max_new_tokens=6, frame_embeds=jnp.asarray(fe))
    assert got.tokens == want.tokens


def _to_jax(params, dtype):
    if isinstance(params, dict):
        return {k: _to_jax(v, dtype) for k, v in params.items()}
    return jnp.asarray(params.float().numpy(), dtype)


def test_serve_cli_reduced_cpu_matches_jax_engine(monkeypatch, capsys):
    """``--arch whisper-tiny --reduced --device cpu``: the loop runs on the
    plain versions (no kernel launched, the CUDA build never touched); the
    served tokens are the port engine's, and in float32 on the same
    weights the port's tokens equal the JAX engine's."""
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU run must not touch the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    ops.reset_launch_counts()
    served = serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "6", "--seed", "0"])
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "moe_gmm": 0, "moe_gmm_grouped": 0}
    cfg = get_reduced_config(ARCH)
    out = capsys.readouterr().out
    assert f"serving {cfg.name} (reduced, audio, bfloat16)" in out
    assert out.count("req ") == 3 and len(served) == 3

    engine = ServingEngine(cfg, seed=0, cache_window=serve_mod.CACHE_WINDOW, device="cpu")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _to_jax(engine.params, jnp.float32)
    port32 = ServingEngine(cfg32, params_from_numpy(jax.tree_util.tree_map(
        np.asarray, params32), cfg32, device="cpu"), cache_window=serve_mod.CACHE_WINDOW,
        device="cpu")
    jax32 = JaxEngine(dataclasses.replace(jax_reduced_config(ARCH), dtype="float32"),
                      params32, cache_window=serve_mod.CACHE_WINDOW)
    for rec in served:
        assert len(rec.prompt) in (8, 24, 48)
        assert rec.result.tokens == engine.generate([rec.prompt], max_new_tokens=6).tokens
        want = jax32.generate([rec.prompt], max_new_tokens=6).tokens
        assert port32.generate([rec.prompt], max_new_tokens=6).tokens == want


# ---------------------------------------------------------------- training


def test_forward_train_gradients_match_reference():
    cfg, jcfg = _configs("float32")
    params, jparams = _weights("float32", seed=1)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, size=(BATCH, 65)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    fe = _frames(cfg, "random", seed=3)

    def loss_fn(p):
        return JM.forward_train(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels),
                                frame_embeds=jnp.asarray(fe), remat=False)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in _flat(params).items()}

    def unflat(prefix, node):
        return {k: unflat(f"{prefix}{k}/", v) if isinstance(v, dict) else leaves[prefix + k]
                for k, v in node.items()}

    loss, metrics = TM.forward_train(unflat("", params), cfg, torch.from_numpy(tokens),
                                     torch.from_numpy(labels),
                                     frame_embeds=torch.from_numpy(fe), remat=False)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    assert float(metrics["aux_loss"]) == float(jmetrics["aux_loss"]) == 0.0
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(leaves) == sorted(jflat)
    for key, want in jflat.items():
        err = float(np.max(np.abs(_f32(leaves[key].grad) - want)))
        scale = float(np.max(np.abs(want)))
        assert scale > 0 and err <= GRAD_TOL * scale, (key, err, scale)


def test_train_matches_reference_from_the_same_checkpoint(tmp_path, capsys):
    """Both packages' ``train`` resume from one step-0 checkpoint the
    reference writes and run 4 float32 steps, each batch with zero frame
    embeddings (as both launchers feed them): losses and grad norms within
    1e-5 relative; each package restores the other's final checkpoint."""
    steps, lr = 4, 1e-3
    cfg, jcfg = _configs("float32")
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, batch_size=2, seed=3)
    okw = dict(lr=lr, warmup_steps=2, total_steps=steps)
    start = tmp_path / "step0.msgpack"
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    JCK.save_checkpoint(str(start), step=0, params=jparams,
                        opt_state=JOPT.init_opt_state(JOPT.AdamWConfig(**okw), jparams))
    shape = (2, cfg.encoder_seq, cfg.d_model)
    runs = {}
    for name, mod, c in (("jax", JLOOP, jcfg), ("port", TLOOP, cfg)):
        loop = mod.TrainLoopConfig(steps=steps, log_every=1, ckpt_every=steps,
                                   ckpt_dir=str(tmp_path / name))
        if name == "jax":
            extra = {"extra_batch_fn": lambda step: {"frame_embeds": jnp.zeros(shape)}}
        else:
            extra = {"extra_batch_fn": lambda step: {"frame_embeds": torch.zeros(shape)},
                     "device": "cpu"}
        data = (JDATA if name == "jax" else TDATA).DataConfig(**kw)
        opt = (JOPT if name == "jax" else TOPT).AdamWConfig(**okw)
        runs[name] = mod.train(c, data_cfg=data, opt_cfg=opt, loop=loop,
                               resume_from=str(start), **extra)
    assert capsys.readouterr().out.count(f"step {steps:5d} loss=") == 2
    jx, got = runs["jax"], runs["port"]
    assert got["step"] == jx["step"] == list(range(1, steps + 1))
    np.testing.assert_allclose(got["loss"], jx["loss"], rtol=LOOP_REL)
    np.testing.assert_allclose(got["grad_norm"], jx["grad_norm"], rtol=LOOP_REL)
    name = f"ckpt_{steps:06d}.msgpack"
    tb = TCK.load_checkpoint(str(tmp_path / "jax" / name))
    for key, leaf in _flat(TCK.restore_into(got["final_params"], tb["params"])).items():
        assert np.array_equal(_f32(leaf), np.asarray(tb["params"][key], np.float32)), key
    jb = JCK.load_checkpoint(str(tmp_path / "port" / name))
    jp = JCK.restore_into(jx["final_params"], jb["params"])
    tfinal = _flat(got["final_params"])
    for key, leaf in _flat(jax.tree_util.tree_map(np.asarray, jp)).items():
        assert np.array_equal(leaf, _f32(tfinal[key])), key


def test_checkpoint_of_the_audio_tree_is_byte_equal(tmp_path):
    """The bf16 audio params (encoder, positions, cross blocks) with a
    float32 opt state: the port's file equals the reference's byte for
    byte, and each reads the other's."""
    cfg, jcfg = _configs("bfloat16")
    params, jparams = _weights("bfloat16")
    okw = dict(lr=1e-3)
    jopt = JOPT.init_opt_state(JOPT.AdamWConfig(**okw), jparams)
    topt = TOPT.init_opt_state(TOPT.AdamWConfig(**okw), params)
    JCK.save_checkpoint(str(tmp_path / "ref.msgpack"), step=3, params=jparams, opt_state=jopt)
    TCK.save_checkpoint(str(tmp_path / "port.msgpack"), step=3, params=params, opt_state=topt)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "ref.msgpack").read_bytes()
    back = TCK.restore_into(params, TCK.load_checkpoint(str(tmp_path / "ref.msgpack"))["params"])
    for key, leaf in _flat(back).items():
        assert leaf.dtype == torch.bfloat16 and torch.equal(leaf, _flat(params)[key]), key
