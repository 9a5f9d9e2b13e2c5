"""The port's shape configs, long-context variant and plain-path switches
against the JAX reference on the same inputs.

* ``SHAPES``, ``shape_applicable``, ``effective_decode_window``,
  ``decoder_seq_len``, ``input_specs`` and ``cache_specs`` equal the
  reference's (keys, shapes, dtypes) for all 10 published configs x 4
  shapes; ``init_cache`` fills those buffers; ``active_param_count``
  equals the reference's.
* ``forward_prefill(..., long_context=True)`` + 4 decode steps on reduced
  qwen2.5-3b, mixtral-8x7b and zamba2-7b, their windows reduced so that
  the prompt is longer than the window (the ring wraps at prefill),
  through the plain and the kernel route (the CPU runs the kernels' plain
  versions), against the reference's, logits and ring layout within the
  float32 TOL (2e-5 x max(|ref|, 1), tests/test_kernels.py:19).
* Each of the reference's plain-path switches, set in the reference,
  against the port's counterpart: ``set_gqa_mode("grouped")`` against
  ``sdpa_grouped``, ``set_decode_mode("split")`` against
  ``sdpa_decode_split``, ``set_attn_qtile`` against the port's own
  switch, ``set_moe_seq_chunks`` against ``moe_block_seq_chunked``
  (outputs, expert ids, the mean aux loss), each within the float32 TOL;
  at the model's level the port's one decode and GQA path against the
  reference with the switch set. ``set_remat_policy("dots")`` against the
  port's layers checkpointed under ``save_dots`` (gradients within
  tests/test_torch_training.py's 1e-4 x max |g_ref| per leaf), which keeps
  every 2-D matmul output for the backward pass (none is recomputed)
  where the default policy recomputes them all.
* ``ring_write`` equals the reference's under both of its ring modes.
* RoPE at positions up to 524287 within 1e-5 (its frequencies are
  bit-equal to the reference's).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import (  # noqa: E402
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import kv_cache as JKV  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import shared_fields  # noqa: E402
from repro_torch.models import kv_cache as TKV  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = 2e-5  # float32, x max(|ref|, 1)
GRAD_TOL = 1e-4  # per leaf, x max |g_ref| (tests/test_torch_training.py)
ROPE_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol * max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0), (what, err)


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.fixture
def switches():
    """Every switch back at its default after the test, in both packages."""
    yield
    JL.set_gqa_mode("repeat")
    TL.set_attn_qtile(0), JL.set_attn_qtile(0)
    JM.set_decode_mode("concat")
    JM.set_remat_policy("nothing")
    JMOE.set_moe_seq_chunks(1)


def _weights(cfg, jcfg, seed=0):
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             device="cpu"), jparams


def _reduced(arch, **changes):
    changes.setdefault("dtype", "float32")
    return (dataclasses.replace(TC.get_reduced_config(arch), **changes),
            dataclasses.replace(JC.get_reduced_config(arch), **changes))


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    assert [TC.TRAIN_4K, TC.PREFILL_32K, TC.DECODE_32K, TC.LONG_500K] == list(
        TC.SHAPES.values())
    assert set(TC.__all__) >= set(JC.__all__)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_shape_helpers_and_specs_equal_reference(arch):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    assert shared_fields(cfg) == dataclasses.asdict(jcfg)
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name, shape in TC.SHAPES.items():
        jshape = JC.SHAPES[name]
        assert TC.shape_applicable(cfg, shape) == JC.shape_applicable(jcfg, jshape)
        assert (TC.effective_decode_window(cfg, shape)
                == JC.effective_decode_window(jcfg, jshape))
        assert TC.decoder_seq_len(cfg, shape) == JC.decoder_seq_len(jcfg, jshape)

        def layout(tree):
            return {k: layout(v) if isinstance(v, dict) else
                    (tuple(v.shape), _dtype_name(v.dtype)) for k, v in tree.items()}

        got, want = TC.input_specs(cfg, shape), JC.input_specs(jcfg, jshape)
        assert all(t.device.type == "meta" for k, t in got.items() if k != "cache")
        assert layout(got) == layout(want), name
        assert layout(TC.cache_specs(cfg, shape)) == layout(JC.cache_specs(jcfg, jshape))


def test_init_cache_fills_the_reference_shapes():
    cfg = TC.get_reduced_config("zamba2-7b")
    shape = dataclasses.replace(TC.DECODE_32K, seq_len=40)
    zeros = TKV.init_cache(cfg, shape, batch=3, device="cpu")
    filled = TKV.init_cache(cfg, shape, batch=3, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    want = JKV.cache_shapes(JC.get_reduced_config("zamba2-7b"),
                            JC.ShapeConfig("decode_32k", 40, 3, "decode"))
    for name, (shp, dt) in want.items():
        for cache in (zeros, filled):
            assert tuple(cache[name].shape) == shp and _dtype_name(cache[name].dtype) == str(
                np.dtype(dt)), name
        assert float(zeros[name].abs().sum()) == 0.0
        if name != "pos":
            assert float(filled[name].float().std()) > 0.5, name
    assert int(filled["pos"].abs().sum()) == 0
    audio = TKV.init_cache(TC.get_reduced_config("whisper-tiny"), shape, batch=2, device="cpu")
    assert audio["cross_valid"].all() and audio["cross_q_pos"].tolist() == [63, 63]


# ---------------------------------------------------------------------------
# The long-context variant
# ---------------------------------------------------------------------------


LONG = {  # arch: (prompt, window); the prompt is longer than the window
    "qwen2.5-3b": (40, 16),
    "mixtral-8x7b": (40, 16),  # its native sliding window, reduced too
    "zamba2-7b": (128, 48),  # two SSD chunks; the shared block windowed
}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", sorted(LONG))
def test_long_context_prefill_and_decode_match_reference(arch, use_kernels):
    S, W = LONG[arch]
    changes = {"long_context_window": W}
    if arch.startswith("mixtral"):
        changes["sliding_window"] = W
    cfg, jcfg = _reduced(arch, **changes)
    assert TM._decoder_window(cfg, True) == W and TM._decoder_window(cfg, False) == (
        cfg.sliding_window)
    params, jparams = _weights(cfg, jcfg, seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, size=(2, S)).astype(np.int32)
    teacher = rng.integers(1, cfg.vocab_size, size=(4, 2)).astype(np.int32)
    with torch.no_grad():
        logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                           cache_window=W, long_context=True,
                                           use_kernels=use_kernels)
    jlogits, jcache = JM.forward_prefill(jparams, jcfg, jnp.asarray(toks), cache_window=W,
                                         long_context=True)
    _close(logits, jlogits, "prefill logits")
    for key in ("k", "v"):  # the ring after S > W writes: slot s holds position p % W == s
        _close(cache[key], jcache[key], f"ring {key}")
    if arch == "qwen2.5-3b":  # the window binds: the long-context logits differ from full
        full, _ = TM.forward_prefill(params, cfg, torch.from_numpy(toks), cache_window=W)
        assert float((full - logits).abs().max()) > 1e-3
    for t in teacher:
        with torch.no_grad():
            logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(t), cache,
                                              use_kernels=use_kernels)
        jlogits, jcache = JM.forward_decode(jparams, jcfg, jnp.asarray(t), jcache)
        _close(logits, jlogits, "decode logits")
    _close(cache["k"], jcache["k"], "ring after decode")
    assert cache["pos"].tolist() == [S + 4] * 2


# ---------------------------------------------------------------------------
# Plain-path switches
# ---------------------------------------------------------------------------


def _attn_inputs(seed, B, Sq, Skv, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


@pytest.mark.parametrize("causal,window,valid", [(True, None, False), (True, 5, True),
                                                 (False, None, True), (False, 7, False)])
def test_gqa_grouped_sdpa_matches_reference(switches, causal, window, valid):
    q, k, v = _attn_inputs(0, 2, 6, 9, 8, 2, 16)
    qpos = np.array([[3, 4, 5, 6, 7, 8]] * 2, np.int32)
    kpos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    kv_valid = np.ones((2, 9), bool)
    kv_valid[1, :4] = False
    kv_valid[0] = False if valid else True  # a row with no live key gives 0
    kw = dict(causal=causal, window=window)
    JL.set_gqa_mode("grouped")
    got = TL.sdpa_grouped(*map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(qpos),
                  kv_positions=torch.from_numpy(kpos),
                  kv_valid=torch.from_numpy(kv_valid) if valid else None, **kw)
    want = JL.sdpa(*map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
                   kv_positions=jnp.asarray(kpos),
                   kv_valid=jnp.asarray(kv_valid) if valid else None, **kw)
    _close(got, want, "grouped sdpa")
    repeat = TL.sdpa(*map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(qpos),
                     kv_positions=torch.from_numpy(kpos),
                     kv_valid=torch.from_numpy(kv_valid) if valid else None, **kw)
    _close(got, repeat, "grouped vs repeat")
    if valid:
        assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("pos", [[3, 5], [20, 41], [0, 16]])
def test_sdpa_decode_split_matches_reference(pos):
    B, W, H, Hkv, D = 2, 16, 8, 2, 16
    q, k_self, v_self = _attn_inputs(1, B, 1, 1, H, Hkv, D)
    _, k_buf, v_buf = _attn_inputs(2, B, 1, W, H, Hkv, D)
    p = np.array(pos, np.int32)
    kv_pos = np.array(JKV.ring_positions(jnp.asarray(p), W))
    kv_valid = kv_pos >= 0
    t = [torch.from_numpy(x) for x in (q, k_self, v_self, k_buf, v_buf)]
    got = TL.sdpa_decode_split(*t, kv_positions=torch.from_numpy(kv_pos),
                               kv_valid=torch.from_numpy(kv_valid), q_pos=torch.from_numpy(p))
    want = JL.sdpa_decode_split(*map(jnp.asarray, (q, k_self, v_self, k_buf, v_buf)),
                                kv_positions=jnp.asarray(kv_pos),
                                kv_valid=jnp.asarray(kv_valid), q_pos=jnp.asarray(p))
    _close(got, want, "split decode")
    # the same function as the concat form over W + 1 slots
    concat = TL.sdpa(t[0], torch.cat([t[3], t[1]], 1), torch.cat([t[4], t[2]], 1),
                     q_positions=torch.from_numpy(p)[:, None],
                     kv_positions=torch.cat([torch.from_numpy(kv_pos),
                                             torch.from_numpy(p)[:, None]], 1),
                     kv_valid=torch.cat([torch.from_numpy(kv_valid),
                                         torch.ones((B, 1), dtype=torch.bool)], 1))
    _close(got, concat, "split vs concat")


@pytest.mark.parametrize("S,q_tile,window", [(32, 8, None), (48, 32, 12), (40, 64, None)])
def test_sdpa_qtiled_matches_reference(S, q_tile, window):
    q, k, v = _attn_inputs(3, 2, S, S, 4, 2, 16)
    got = TL.sdpa_qtiled(*map(torch.from_numpy, (q, k, v)), window=window, q_tile=q_tile)
    want = JL.sdpa_qtiled(*map(jnp.asarray, (q, k, v)), window=window, q_tile=q_tile)
    _close(got, want, "q-tiled sdpa")
    whole = TL.sdpa(*map(torch.from_numpy, (q, k, v)), window=window,
                    q_positions=torch.arange(S, dtype=torch.int32)[None].expand(2, S),
                    kv_positions=torch.arange(S, dtype=torch.int32)[None].expand(2, S))
    assert torch.equal(got, whole)


@pytest.mark.parametrize("switch", ["gqa_grouped", "qtile", "decode_split"])
def test_model_switches_match_reference(switches, switch):
    """Reduced qwen (GQA 4 / 2) prefill + 3 decode steps with the switch set
    in the reference; the logits within the float32 TOL. The port sets the
    query tiling alike (its plain path); it has no GQA or decode-mode
    switch, and runs its one path, the kernel route (the kernels' plain
    versions on the CPU), against the reference's grouped / split form."""
    cfg, jcfg = _reduced("qwen2.5-3b")
    params, jparams = _weights(cfg, jcfg, seed=5)
    if switch == "gqa_grouped":
        JL.set_gqa_mode("grouped")
    elif switch == "qtile":
        TL.set_attn_qtile(8), JL.set_attn_qtile(8)
    else:
        JM.set_decode_mode("split")
    use_kernels = switch != "qtile"
    rng = np.random.default_rng(6)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    with torch.no_grad():
        logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                           cache_window=16, use_kernels=use_kernels)
        seq = [logits]
        for t in rng.integers(1, cfg.vocab_size, size=(3, 2)).astype(np.int32):
            logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(t), cache,
                                              use_kernels=use_kernels)
            seq.append(logits)
    rng = np.random.default_rng(6)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    jlogits, jcache = JM.forward_prefill(jparams, jcfg, jnp.asarray(toks), cache_window=16)
    jseq = [jlogits]
    for t in rng.integers(1, cfg.vocab_size, size=(3, 2)).astype(np.int32):
        jlogits, jcache = JM.forward_decode(jparams, jcfg, jnp.asarray(t), jcache)
        jseq.append(jlogits)
    for i, (a, b) in enumerate(zip(seq, jseq)):
        _close(a, b, f"{switch} step {i}")


@pytest.mark.parametrize("chunks", [2, 4])
def test_moe_seq_chunks_match_reference(switches, chunks, monkeypatch):
    """Chunked dispatch: each chunk its own capacity, the aux loss the mean
    of the chunks'. Expert ids, outputs and aux loss equal the reference's;
    the capacity the chunks give differs from the unchunked block's."""
    cfg, jcfg = _reduced("mixtral-8x7b")
    params, jparams = _weights(cfg, jcfg, seed=7)
    bp, jbp = TM._layer(params["blocks"], 0)["moe"], jax.tree_util.tree_map(
        lambda a: a[0], jparams["blocks"])["moe"]
    x = np.random.default_rng(8).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    seen, route = [], TMOE.route

    def record(p, c, xt):
        out = route(p, c, xt)
        seen.append(out[2].numpy().copy())
        return out

    monkeypatch.setattr(TMOE, "route", record)
    JMOE.set_moe_seq_chunks(chunks)
    y, aux = TMOE.moe_block_seq_chunked(bp, cfg, torch.from_numpy(x), chunks, aux=True)
    jy, jaux = JMOE.moe_block(jbp, jcfg, jnp.asarray(x))
    _close(y, jy, "chunked moe")
    _close(aux, jaux, "chunked aux")
    assert len(seen) == chunks
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model) @ jbp["router"], -1)
    np.testing.assert_array_equal(np.concatenate(seen),
                                  np.asarray(jax.lax.top_k(probs, cfg.experts_per_token)[1]))
    assert TMOE.moe_capacity(cfg, 64 // chunks) != TMOE.moe_capacity(cfg, 64)
    y1, aux1 = TMOE.moe_block(bp, cfg, torch.from_numpy(x), aux=True)
    assert not torch.equal(aux1, aux)


class _Matmuls(TorchDispatchMode):
    """Counts the 2-D matmuls (mm, addmm) that run while it is entered."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _dots_run(remat, fn, *args):
    """``model._run`` with the layers checkpointed under ``save_dots``."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   TM.save_dots))


def _grads(params, cfg, toks, remat):
    """Loss, per-leaf gradients, and the 2-D matmuls of the forward and of
    the backward pass."""
    leaves = {}

    def lift(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = lift(v, f"{prefix}{k}/")
            else:
                out[k] = leaves.setdefault(prefix + k, v.clone().requires_grad_())
        return out

    p = lift(params)
    # a recompute runs its layer whole, not only up to the last tensor
    # the backward pass needs, so that it counts every matmul it redoes
    with set_checkpoint_early_stop(False):
        with _Matmuls() as fwd:
            loss, _ = TM.forward_train(p, cfg, torch.from_numpy(toks[:, :-1]),
                                       torch.from_numpy(toks[:, 1:]), remat=remat)
        with _Matmuls() as bwd:
            loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}, fwd.n, bwd.n


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b"])
def test_remat_dots_gradients_match_reference(switches, arch, monkeypatch):
    cfg, jcfg = _reduced(arch)
    params, jparams = _weights(cfg, jcfg, seed=9)
    toks = np.random.default_rng(10).integers(1, cfg.vocab_size, size=(2, 33)).astype(
        np.int32)
    plain_loss, plain, plain_fwd, plain_bwd = _grads(params, cfg, toks, remat=False)
    _, _, _, nothing_bwd = _grads(params, cfg, toks, remat=True)  # the default policy
    JM.set_remat_policy("dots")
    monkeypatch.setattr(TM, "_run", _dots_run)
    loss, grads, _, dots_bwd = _grads(params, cfg, toks, remat=True)

    # what each policy keeps: the layers' forward matmuls are every one
    # but the lm_head's (at least q, k, v and o in each); "nothing" runs
    # them all again in the backward pass, "dots" none (its backward is
    # the un-remat'ed one)
    layer_mms = plain_fwd - 1
    assert layer_mms >= 4 * cfg.num_layers
    assert nothing_bwd == plain_bwd + layer_mms
    assert dots_bwd == plain_bwd

    def loss_fn(p):
        return JM.forward_train(p, jcfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]),
                                remat=True)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    _close(loss, jloss, "loss")
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): g
            for path, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert set(flat) == set(grads)
    for key, g in grads.items():
        want = _np(flat[key])
        assert np.max(np.abs(_np(g) - want)) <= GRAD_TOL * np.max(np.abs(want)), key
        assert np.max(np.abs(_np(g) - _np(plain[key]))) <= 1e-6 * max(
            np.max(np.abs(want)), 1e-30), key
    assert abs(float(loss) - float(plain_loss)) <= 1e-6


# ---------------------------------------------------------------------------
# Ring writes and RoPE at long positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["onehot", "scatter"])
def test_ring_write_equals_reference_in_both_ring_modes(mode):
    rng = np.random.default_rng(11)
    buf = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 4)).astype(np.float32)
    pos = np.array([0, 13, 524287], np.int32)
    try:
        JKV.set_ring_mode(mode)
        want = JKV.ring_write(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(pos))
    finally:
        JKV.set_ring_mode("onehot")
    got = TKV.ring_write(torch.from_numpy(buf.copy()), torch.from_numpy(new),
                         torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("theta,D", [(1e4, 64), (1e6, 128), (5e5, 128), (1e4, 96),
                                     (1e4, 112)])
def test_rope_matches_reference_at_long_positions(theta, D):
    x = np.random.default_rng(12).standard_normal((2, 8, 3, D)).astype(np.float32)
    pos = np.array([[0, 1, 8191, 32767, 524284, 524285, 524286, 524287]] * 2, np.int32)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, "rope", tol=ROPE_TOL)
    half = D // 2
    freq = theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    port = torch.pow(theta, (-torch.arange(0, half, dtype=torch.float32) / half).double())
    np.testing.assert_array_equal(port.float().numpy(), np.asarray(freq))
