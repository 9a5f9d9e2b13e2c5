"""The port's dense model against the JAX reference on the same weights.

The reference's ``init_params`` weights go through numpy into the port
(``params_from_numpy``); tokens come from a numpy seed. Logits of
``forward_seq`` / ``forward_prefill``, the ring cache after prefill, and
8 teacher-forced decode steps that wrap the ring (cache_window=16,
prompt 24) must agree: in float32 within the kernel tests' tolerance
(2e-5 scaled by max(|ref|, 1)), in bfloat16 within 0.02 relative. The
JAX side runs with ``use_pallas`` off and on (Pallas interpret mode on
the CPU).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

F32_TOL = 2e-5  # tests/test_kernels.py TOL[float32], scaled by max(|ref|, 1)
BF16_REL = 0.02  # tests/test_kernels.py:145 relative-logit bar
PROMPT, WINDOW, STEPS, BATCH = 24, 16, 8, 2


def _configs(dtype):
    cfg = get_reduced_config("qwen2.5-3b")
    jcfg = jax_reduced_config("qwen2.5-3b")
    return (dataclasses.replace(cfg, dtype=dtype),
            dataclasses.replace(jcfg, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _weights(dtype):
    """(port params, JAX params) holding identical values."""
    cfg, jcfg = _configs(dtype)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return params_from_numpy(tree, cfg, device="cpu"), jparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, ref, dtype, what):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, what
    err = float(np.max(np.abs(got - ref)))
    scale = float(np.max(np.abs(ref)))
    if dtype == "float32":
        assert err <= F32_TOL * max(scale, 1.0), (what, err)
    else:
        assert err <= BF16_REL * scale, (what, err / scale)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_seq_logits_match_jax(dtype, use_pallas):
    cfg, jcfg = _configs(dtype)
    params, jparams = _weights(dtype)
    toks = _tokens(1, (BATCH, 33), cfg.vocab_size)
    ref, _, _ = jax.jit(functools.partial(
        JM.forward_seq, cfg=jcfg, use_pallas=use_pallas))(jparams, tokens=toks)
    got, cache = TM.forward_seq(params, cfg, torch.from_numpy(toks))
    assert cache is None
    _check(got, ref, dtype, "forward_seq logits")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_teacher_forced_decode_match_jax(dtype, use_pallas):
    """Prefill a 24-token prompt into a 16-slot ring, then 8 decode steps
    fed the same teacher tokens on both sides: the ring wraps (positions
    24..31 overwrite slots 8..15)."""
    cfg, jcfg = _configs(dtype)
    params, jparams = _weights(dtype)
    toks = _tokens(2, (BATCH, PROMPT), cfg.vocab_size)
    teacher = _tokens(3, (STEPS, BATCH), cfg.vocab_size)

    prefill = jax.jit(functools.partial(
        JM.forward_prefill, cfg=jcfg, cache_window=WINDOW, use_pallas=use_pallas))
    decode = jax.jit(functools.partial(
        JM.forward_decode, cfg=jcfg, use_pallas=use_pallas))
    ref_logits, ref_cache = prefill(jparams, tokens=toks)
    logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                       cache_window=WINDOW)
    _check(logits, ref_logits, dtype, "prefill logits")
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == ref_cache[name].shape
        _check(cache[name], ref_cache[name], dtype, f"prefill cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))

    for step in range(STEPS):
        ref_logits, ref_cache = decode(jparams, token=teacher[step], cache=ref_cache)
        logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(teacher[step]),
                                          cache)
        _check(logits, ref_logits, dtype, f"decode step {step} logits")
    for name in ("k", "v"):
        _check(cache[name], ref_cache[name], dtype, f"decode cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))


def test_param_tree_matches_reference_layout():
    """init_params gives the reference's keys and shapes, and the analytic
    count matches the reference's."""
    cfg, jcfg = _configs("float32")
    port = TM.init_params(torch.Generator().manual_seed(0), cfg)
    _, jparams = _weights("float32")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(port) == shapes(jparams)
    assert TM.count_params(port) == JM.count_params(jparams)
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)
