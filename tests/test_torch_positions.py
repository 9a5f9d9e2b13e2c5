"""The tensors a forward builds once from its positions and every layer
reads: the RoPE table (``layers.rope_table`` + ``layers.apply_rope``), a
decode step's ring positions, valid mask and write slot
(``model.decode_tables``), the prefill's ring layout (``write_prefill``)
and the counter ``model.position_tables``; and the operations a layer
launches, counted with ``TorchDispatchMode`` (the kernels stubbed to one
operation each, as one launch on the card)."""

import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import kv_cache as KV  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

LONG = [0, 1, 2, 8191, 32767, 524284, 524285, 524286, 524287]


def _rope_by_halves(x, positions, theta):
    """The rotation as two half-width products per term, each table built
    for the call: the arithmetic the hoisted table must reproduce."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32) / half
    freq = torch.pow(theta, exponent.double()).float()
    angles = positions[..., None].float() * freq
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["prefill", "decode"])
@pytest.mark.parametrize("theta,D", [(1e6, 128), (1e4, 64), (5e5, 96)])
def test_rope_table_and_apply_equal_the_rotation_bit_for_bit(dtype, shape, theta, D):
    g = torch.Generator().manual_seed(3)
    if shape == "prefill":  # (B, S) positions up to 524287
        pos = torch.tensor([LONG, list(range(len(LONG)))], dtype=torch.int32)
    else:  # a decode step: (B, 1)
        pos = torch.tensor(LONG, dtype=torch.int32)[:, None]
    x = torch.randn(pos.shape + (5, D), generator=g).to(dtype)
    want = _rope_by_halves(x, pos, theta)
    cos, sin = L.rope_table(pos, D, theta)
    assert cos.shape == sin.shape == pos.shape + (1, D) and cos.dtype == torch.float32
    got = L.apply_rope(x, cos, sin)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(L.rope(x, pos, theta), want)


@pytest.mark.parametrize("W", [1, 7, 16])
def test_decode_tables_equal_the_ring_helpers(W):
    """pos below, at and past W in one batch."""
    cfg = get_reduced_config("qwen2.5-3b")
    pos = torch.tensor([0, 1, W - 1, W, W + 1, 3 * W + 2, 524287], dtype=torch.int32)
    t = M.decode_tables(cfg, pos, W)
    B = pos.shape[0]
    assert torch.equal(t.kv_pos, torch.cat([KV.ring_positions(pos, W), pos[:, None]], 1))
    assert t.kv_pos.dtype == torch.int32 and t.valid.dtype == torch.bool
    assert torch.equal(t.valid, torch.cat([KV.ring_valid(pos, W),
                                           torch.ones((B, 1), dtype=torch.bool)], 1))
    rows, slot = t.slot
    assert torch.equal(rows, torch.arange(B)) and torch.equal(slot, (pos % W).long())
    buf = torch.randn((B, W, 2, 4), generator=torch.Generator().manual_seed(1))
    new = torch.randn((B, 2, 4), generator=torch.Generator().manual_seed(2))
    want = KV.ring_write(buf.clone(), new, pos)
    assert torch.equal(KV.ring_write(buf.clone(), new, t.slot), want)
    assert torch.equal(t.rope[0], L.rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta)[0])
    assert M.decode_tables(get_reduced_config("whisper-tiny"), pos, W).rope is None


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (16, 8), (21, 8), (23, 1)])
def test_write_prefill_equals_sequential_ring_writes(S, W):
    new = torch.randn((2, S, 3), generator=torch.Generator().manual_seed(S))
    want = torch.zeros((2, W, 3))
    for p in range(S):
        KV.ring_write(want, new[:, p], torch.full((2,), p, dtype=torch.int32))
    got = KV.write_prefill(torch.zeros((2, W, 3)), new)
    assert torch.equal(got, want)


class _Count(TorchDispatchMode):
    """Operations that may launch on the device: each aten call whose
    result is not a view of its inputs (``_unsafe_view`` is one in effect),
    and every in-place call."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[1]
        returns = func._schema.returns
        aliases = any(r.alias_info is not None for r in returns)
        if name.endswith("_") or not aliases and name != "_unsafe_view":
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def _counts(arch, layers, which, monkeypatch):
    monkeypatch.setattr(ops, "decode_attention", lambda q, *a, **kw: torch.empty_like(q))
    monkeypatch.setattr(ops, "flash_attention", lambda q, *a, **kw: torch.empty_like(q))
    cfg = dataclasses.replace(get_reduced_config(arch), num_layers=layers, dtype="bfloat16")
    if cfg.family == "hybrid":  # the shared block before every layer
        cfg = dataclasses.replace(cfg, attn_every=1)
    S = cfg.ssm_chunk if cfg.uses_ssm else 24
    g = torch.Generator().manual_seed(0)
    params = M.init_params(g, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=g).int()
    with torch.no_grad():
        if which == "prefill":
            with _Count() as c:
                M.forward_prefill(params, cfg, toks, cache_window=16)
            return c.ops
        _, cache = M.forward_prefill(params, cfg, toks, cache_window=16)
        with _Count() as c:
            M.forward_decode(params, cfg, toks[:, -1], cache)
        return c.ops


# qwen2.5-3b's decode layer: 3 rms-norm-sized groups, QKV with bias, the
# rotation of q and k, K/V joined to the ring, o-proj, SwiGLU, 2 ring writes
QWEN_DECODE_LAYER = 49


@pytest.mark.parametrize("which", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b"])
def test_a_layer_builds_no_position_table(arch, which, monkeypatch):
    one, two = (_counts(arch, n, which, monkeypatch) for n in (1, 2))
    layer = two - one
    for name in ("pow", "cos", "sin", "arange", "remainder"):
        assert layer[name] == 0, (name, dict(layer))
    # the forward builds them once: a one-layer forward has them all
    built = {"pow", "cos", "sin"} | ({"arange", "remainder"} if which == "decode" else set())
    assert all(one[name] >= 1 for name in built), dict(one)
    if arch == "qwen2.5-3b" and which == "decode":
        assert sum(layer.values()) == QWEN_DECODE_LAYER, dict(layer)


@pytest.mark.parametrize("arch,prefill,decode", [
    ("qwen2.5-3b", 1, 1), ("zamba2-7b", 1, 1), ("whisper-tiny", 0, 1),
    ("mamba2-1.3b", 0, 0)])
def test_position_tables_counted_once_a_forward(arch, prefill, decode):
    cfg = get_reduced_config(arch)
    g = torch.Generator().manual_seed(0)
    params = M.init_params(g, cfg)
    S = cfg.ssm_chunk if cfg.uses_ssm else 8
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=g).int()
    extra = ({"frame_embeds": torch.zeros((2, cfg.encoder_seq, cfg.d_model))}
             if cfg.is_encoder_decoder else {})
    name = "model.position_tables"
    before = tracing.counters().get(name, 0)
    with torch.no_grad():
        _, cache = M.forward_prefill(params, cfg, toks, cache_window=16, **extra)
        assert tracing.counters().get(name, 0) - before == prefill
        for _ in range(3):
            M.forward_decode(params, cfg, toks[:, 0], cache)
    assert tracing.counters().get(name, 0) - before == prefill + 3 * decode
