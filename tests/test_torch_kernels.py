"""The port's plain attention versions against the JAX reference.

``repro_torch.kernels.ref.flash_attention_ref`` / ``decode_attention_ref``
(what the CUDA kernels are held against on the card, and what ``ops``
runs for CPU tensors) against JAX's ``ref.*`` oracles and against the
JAX Pallas kernels in interpret mode, on inputs made from a numpy seed.
Grids follow tests/test_kernels.py:27-76 plus the serving path's shapes
(S = 8, 24, 48, 33; W = 129 = ring window 128 + the self slot) and the
edges the kernels must keep: S and W off the block size, windows, a
fully masked decode row. Tolerance is that file's TOL: f32 2e-5, bf16
3e-2, scaled by max(|ref|, 1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models.kv_cache import ring_positions as jax_ring_positions  # noqa: E402
from repro.models.kv_cache import ring_valid as jax_ring_valid  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
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
