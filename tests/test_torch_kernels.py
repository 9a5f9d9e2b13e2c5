"""The port's plain attention versions against the JAX reference.

``repro_torch.kernels.ref.flash_attention_ref`` / ``decode_attention_ref``
(what the CUDA kernels are held against on the card, and what ``ops``
runs for CPU tensors) against JAX's ``ref.*`` oracles and against the
JAX Pallas kernels in interpret mode, on inputs made from a numpy seed.
Grids follow tests/test_kernels.py:27-76 plus the serving path's shapes
(S = 8, 24, 48, 33; W = 129 = ring window 128 + the self slot; the
groups of nemotron (6), codeqwen and phi3 (1) and internvl2's 264-token
prefill) and the
edges the kernels must keep: S and W off the block size, windows, a
fully masked decode row, and every head dim the kernels take (64, 96,
112, 128). Tolerance is that file's TOL: f32 2e-5, bf16
3e-2, scaled by max(|ref|, 1). Also the flash wrapper's choice of kernel
body (mma.sync or warpgroup MMA by the packed rows of a kv head) against
the crossover its source documents.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models.kv_cache import ring_positions as jax_ring_positions  # noqa: E402
from repro.models.kv_cache import ring_valid as jax_ring_valid  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.kv_cache import ring_positions, ring_valid  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arr, dt):
    """The same values as a JAX array and a torch tensor of dtype dt."""
    return jnp.asarray(arr, JDT[dt]), torch.from_numpy(arr).to(TDT[dt])


def _assert_close(got, expected, dt, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        jnp.asarray(got, jnp.float32))
    expected = np.asarray(jnp.asarray(expected, jnp.float32))
    err = float(np.max(np.abs(got - expected)))
    tol = TOL[dt] * max(float(np.max(np.abs(expected))) + 1e-6, 1.0)
    assert err <= tol, (what, err, tol)


# (B, S, Hkv, group, D, causal, window, dtype)
FLASH_CASES = [
    (1, 8, 2, 8, 128, True, None, "bfloat16"),    # serving path shapes
    (1, 24, 2, 8, 128, True, None, "bfloat16"),
    (1, 48, 2, 8, 128, True, None, "float32"),
    (3, 33, 2, 8, 128, True, None, "bfloat16"),
    (2, 96, 1, 4, 64, True, 32, "float32"),       # S off the 64 block, window
    (1, 200, 2, 2, 64, True, 100, "bfloat16"),
    (2, 64, 4, 1, 128, False, None, "float32"),   # non-causal
    (1, 128, 2, 2, 64, False, 32, "float32"),     # non-causal window
    (1, 40, 2, 8, 96, True, None, "bfloat16"),    # head_dim 96 (phi3)
    (1, 64, 2, 2, 96, False, None, "float32"),
    (1, 33, 2, 8, 112, True, None, "bfloat16"),   # head_dim 112 (zamba2)
    (2, 72, 1, 4, 112, True, 32, "float32"),
    (1, 11, 2, 6, 128, True, None, "bfloat16"),   # G = 6 (nemotron)
    (2, 48, 1, 6, 128, True, None, "float32"),
    (1, 48, 4, 1, 96, True, None, "bfloat16"),    # G = 1 at D = 96 (phi3)
    (1, 264, 1, 8, 128, True, None, "bfloat16"),  # internvl2: 256 patches + 8 tokens
]


@pytest.mark.parametrize("B,S,hkv,group,D,causal,window,dt", FLASH_CASES)
def test_flash_attention_ref_matches_jax(B, S, hkv, group, D, causal, window, dt):
    rng = np.random.default_rng(B * 1000 + S + hkv * group)
    H = hkv * group
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dt)
        for shape in ((B, S, H, D), (B, S, hkv, D), (B, S, hkv, D)))
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _assert_close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window),
                  dt, "vs jax ref")
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=64,
                       block_kv=64, interpret=True)
    _assert_close(got, pallas, dt, "vs pallas interpret")
    # ops routes a CPU tensor to the plain version
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal, window=window), got)


# (B, W, Hkv, group, D, pos_ratio, dtype)
DECODE_CASES = [
    (1, 129, 2, 8, 128, 200 / 129, "bfloat16"),   # serving path: ring 128 + self
    (1, 129, 2, 8, 128, 40 / 129, "float32"),
    (3, 130, 2, 4, 64, 2.5, "bfloat16"),          # W off the 64 block, wrapped
    (2, 96, 8, 1, 128, 0.5, "float32"),           # half-filled ring
    (3, 64, 1, 4, 64, 1.0, "float32"),
    (1, 65, 2, 8, 96, 0.6, "bfloat16"),           # head_dim 96
    (2, 33, 2, 8, 96, 2.0, "float32"),
    (1, 65, 4, 2, 112, 0.5, "bfloat16"),          # head_dim 112
    (2, 129, 2, 4, 112, 1.5, "float32"),
    (2, 129, 2, 6, 128, 0.5, "bfloat16"),         # G = 6 (nemotron)
    (1, 129, 4, 1, 96, 2.4, "float32"),           # G = 1 at D = 96 (phi3)
]


@pytest.mark.parametrize("B,W,hkv,group,D,pos_ratio,dt", DECODE_CASES)
def test_decode_attention_ref_matches_jax(B, W, hkv, group, D, pos_ratio, dt):
    rng = np.random.default_rng(W + hkv * group)
    H = hkv * group
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dt)
        for shape in ((B, 1, H, D), (B, W, hkv, D), (B, W, hkv, D)))
    pos_np = np.full((B,), max(1, int(W * pos_ratio)), np.int32) + np.arange(B, dtype=np.int32)
    pos = torch.from_numpy(pos_np)
    kvp, kvv = ring_positions(pos, W), ring_valid(pos, W)
    jkvp, jkvv = jax_ring_positions(jnp.asarray(pos_np), W), jax_ring_valid(jnp.asarray(pos_np), W)
    assert np.array_equal(kvp.numpy(), np.asarray(jkvp))
    assert np.array_equal(kvv.numpy(), np.asarray(jkvv))
    got = ref.decode_attention_ref(q, k, v, kvp, kvv, pos)
    assert got.dtype == q.dtype and got.shape == q.shape
    _assert_close(got, jref.decode_attention_ref(jq, jk, jv, jkvp, jkvv, jnp.asarray(pos_np)),
                  dt, "vs jax ref")
    pallas = jax_decode(jq, jk, jv, jkvp, jkvv, jnp.asarray(pos_np), block_kv=64,
                        interpret=True)
    _assert_close(got, pallas, dt, "vs pallas interpret")
    assert torch.equal(ops.decode_attention(q, k, v, kvp, kvv, pos), got)


def test_fully_masked_decode_row_returns_zero():
    """A sequence with no live slot gets exactly 0, as in the reference."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 1, 4, 64), (2, 33, 2, 64), (2, 33, 2, 64)))
    pos = torch.tensor([40, 40], dtype=torch.int32)
    kvp = ring_positions(pos, 33)
    kvv = ring_valid(pos, 33)
    kvv[0] = False
    got = ops.decode_attention(q, k, v, kvp, kvv, pos)
    assert torch.count_nonzero(got[0]) == 0
    assert torch.count_nonzero(got[1]) > 0
    expected = jref.decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(kvp.numpy()), jnp.asarray(kvv.numpy()), jnp.asarray(pos.numpy()))
    _assert_close(got, expected, "float32")


def test_non_cpu_tensors_never_take_the_plain_version():
    """Only a CPU tensor reaches the plain version: any other device goes
    to the kernel wrapper, which refuses what is not CUDA."""
    q = torch.empty((1, 8, 4, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        ops.flash_attention(q, k, k)
    pos = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        ops.decode_attention(q[:, :1], k, k, torch.empty((1, 8), dtype=torch.int32,
                                                         device="meta"),
                             torch.empty((1, 8), dtype=torch.bool, device="meta"), pos)
    buf = torch.empty((2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="not CUDA"):
        ops.moe_gmm(buf, torch.empty((2, 64, 96), device="meta"))


# (dtype, S, G, body): the bf16 body turns from mma.sync to the warpgroup
# MMA above 512 packed rows of a kv head, whatever the group or head dim
FLASH_BODIES = [
    ("bfloat16", 1, 8, "BF16_MMA"),
    ("bfloat16", 64, 8, "BF16_MMA"),      # qwen (G = 8): 512 rows
    ("bfloat16", 65, 8, "BF16_WGMMA"),    # 520
    ("bfloat16", 128, 4, "BF16_MMA"),     # mixtral (G = 4): 512
    ("bfloat16", 129, 4, "BF16_WGMMA"),   # 516
    ("bfloat16", 85, 6, "BF16_MMA"),      # nemotron (G = 6): 510
    ("bfloat16", 86, 6, "BF16_WGMMA"),    # 516
    ("bfloat16", 512, 1, "BF16_MMA"),     # codeqwen, phi3, whisper (G = 1)
    ("bfloat16", 513, 1, "BF16_WGMMA"),
    ("bfloat16", 1500, 1, "BF16_WGMMA"),  # whisper's encoder
    ("bfloat16", 32768, 8, "BF16_WGMMA"),
    ("float32", 32768, 8, "FLOAT32"),
    ("float32", 8, 8, "FLOAT32"),
]


@pytest.mark.parametrize("dt,S,G,want", FLASH_BODIES)
def test_flash_attention_picks_its_body_by_packed_rows(dt, S, G, want):
    assert fa.body(TDT[dt], S, G) == getattr(fa, want)


def test_flash_attention_body_rule_is_the_source_notes():
    """The crossover the wrapper applies is the one the source documents,
    and the rule reads no head dim: every head dim the kernel takes has
    both bf16 bodies."""
    note = (_build.CSRC / "flash_attention.cu").read_text()
    assert f"S*G > {fa.TC_MAX_ROWS}: flash_attention_wgmma_kernel" in note
    assert f"S*G <= {fa.TC_MAX_ROWS}: flash_attention_tc_kernel" in note
    assert list(inspect.signature(fa.body).parameters) == ["dtype", "S", "G"]
    for D in fa.HEAD_DIMS:
        assert f"case {D}: e = launch_d<{D}>(body," in note


def _dispatch_args(entry, device):
    """Small inputs for an ``ops`` entry point on ``device``."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    return {
        "flash_attention": (t(1, 8, 4, 64), t(1, 8, 2, 64), t(1, 8, 2, 64)),
        "decode_attention": (t(1, 1, 4, 64), t(1, 9, 2, 64), t(1, 9, 2, 64),
                             t(1, 9, dtype=i32), t(1, 9, dtype=torch.bool), t(1, dtype=i32)),
        "ssd_scan": (t(1, 8, 2, 4), t(1, 8, 2), t(2), t(1, 8, 4), t(1, 8, 4), 8),
        "moe_gmm": (t(2, 8, 64), t(2, 64, 96)),
        "moe_gmm_grouped": (t(8, 64), t(2, 64, 96), t(3, dtype=i32)),
    }[entry]


# entry point -> (the module of its kernel wrapper, the wrapper's name)
WRAPPERS = {"flash_attention": ("flash_attention", "flash_attention"),
            "decode_attention": ("decode_attention", "decode_attention"),
            "ssd_scan": ("ssd_scan", "ssd_scan"),
            "moe_gmm": ("moe_gmm", "moe_gmm"),
            "moe_gmm_grouped": ("moe_gmm", "moe_gmm_grouped")}


@pytest.mark.parametrize("entry", list(WRAPPERS))
def test_ops_alone_picks_the_kernel_or_its_plain_version(monkeypatch, entry):
    """``ops`` takes the plain version for a CPU tensor and for
    ``use_kernels=False`` on any device (meta included); only a non-CPU
    tensor with ``use_kernels=True`` reaches the kernel's wrapper."""
    calls = []

    def recorder(side):
        def record(*args, **kwargs):
            calls.append(side)
            return side
        return record

    module, name = WRAPPERS[entry]
    monkeypatch.setattr(importlib.import_module(f"repro_torch.kernels.{module}"), name,
                        recorder("kernel"))
    monkeypatch.setattr(ref, f"{entry}_ref", recorder("plain"))
    for device, use_kernels, want in (("cpu", True, "plain"), ("cpu", False, "plain"),
                                      ("meta", False, "plain"), ("meta", True, "kernel")):
        calls.clear()
        got = getattr(ops, entry)(*_dispatch_args(entry, device), use_kernels=use_kernels)
        assert (got, calls) == (want, [want]), (device, use_kernels)


# one reduced configuration per family; mixtral at capacity and dropless
ROUTE_CASES = {"qwen2.5-3b": ("qwen2.5-3b", {}),
               "mixtral-8x7b-capacity": ("mixtral-8x7b", {}),
               "mixtral-8x7b-dropless": ("mixtral-8x7b", {"moe_capacity_factor": None}),
               "mamba2-1.3b": ("mamba2-1.3b", {}),
               "zamba2-7b": ("zamba2-7b", {}),
               "internvl2-76b": ("internvl2-76b", {}),
               "whisper-tiny": ("whisper-tiny", {}),
               "granite-4.0-h-small": ("granite-4.0-h-small", {})}


def _served(params, cfg, toks, steps, extra, use_kernels):
    """The prefill's logits and cache, then each decode step's logits, and
    the cache after the last step."""
    with torch.no_grad():
        logits, cache = M.forward_prefill(params, cfg, toks, cache_window=16,
                                          use_kernels=use_kernels, **extra)
        out = [logits, {k: v.clone() for k, v in cache.items()}]
        for t in steps:
            logits, cache = M.forward_decode(params, cfg, t, cache, use_kernels=use_kernels)
            out.append(logits)
    return out + [cache]


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_model_serves_the_same_bits_with_and_without_kernels_on_the_cpu(case):
    """On the CPU both settings of ``use_kernels`` reach the same plain
    versions through ``ops``: the prefill's logits and cache and two decode
    steps are bit-equal."""
    arch, changes = ROUTE_CASES[case]
    cfg = dataclasses.replace(get_reduced_config(arch), **changes)
    g = torch.Generator().manual_seed(0)
    params = M.init_params(g, cfg)
    S = cfg.ssm_chunk if cfg.uses_ssm else 24
    toks = torch.randint(1, cfg.vocab_size, (2, S), generator=g).int()
    steps = torch.randint(1, cfg.vocab_size, (2, 2), generator=g).int()
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                                            generator=g).to(cfg.torch_dtype)
    if cfg.is_encoder_decoder:
        extra["frame_embeds"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                            generator=g).to(cfg.torch_dtype)
    with_kernels, plain = (_served(params, cfg, toks, steps, extra, uk) for uk in (True, False))
    for i, (a, b) in enumerate(zip(with_kernels, plain)):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), i
            for name in a:
                assert torch.equal(a[name], b[name]), (i, name)
        else:
            assert torch.equal(a, b), i
