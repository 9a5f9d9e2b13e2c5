"""Card-only checks of the port's CUDA kernels (skipped without a GPU).

On a machine with an H100:  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel against its plain version on the card at the serving path's
shapes and beyond them (attention: head dims 64-128, S = 2048, a sliding
window, groups of 1 and 16, the warpgroup-MMA body's tile edges past 512
packed rows (S = 4096 with and without a window, rows off the 128-row
tile at G = 8, 6 and 4, D = 96 and 112 against their zero-filled box;
whisper's non-causal encoder, D = 64, S = 1500, runs on it too; each
launch of it counted apart), W = 17 to 4097, a cluster block with no live
slot, a fully masked row that must be exactly 0; zamba2's shapes: the SSD
scan at H = 112, N = 64, attention at H = Hkv = 32, D = 112; granite's:
the SSD scan at H = 128, P = 64, N = 128 over lengths off its 256-row
chunk (the tail padded), flash and decode attention at its softmax scale
1/128; the attention
shapes of nemotron (G = 6, whose packed rows cross the tensor-core tiles),
codeqwen, phi3 and internvl2 (S = 264-304); whisper-tiny's (H = Hkv = 6,
D = 64): its decoder's prefill and ring, its encoder's non-causal
attention over 1500 frames and a decode step's cross-attention against
all 1500 frames, every slot live), in both
dtypes, within tests/test_kernels.py's TOL (the SSD scan
in float32 within 1e-4 of the chunked form and 5e-3 of the recurrence,
absolute up to Q = 64 and scaled by max(|ref|, 1) at Q = 256, where the
chunked form itself is farther than 1e-4 from the recurrence; the MoE
grouped matmul also on a strided scatter-buffer view, and with experts
that hold no token, whose rows must come out exactly 0; bf16 also row by
row, each output row within TOL x max(|its ref row|, 2^-6)); each launch
counts once; a CUDA tensor the kernel cannot take raises instead
of falling back. The serving engine's CUDA graph decode step (reduced
dense, moe, hybrid, hybrid_moe, ssm, audio and vlm configs, batch 1 and 4) against
the eager loop on the same prefills: the same tokens, the same launch
counts, bit-equal last logits, one capture a cache shape. The
grouped (ragged) MoE product of the dropless dispatch against its plain
version at R = 2, 16, 130, 2,048 and 16,384 rows (the warpgroup-MMA
body, partial tiles and edges), with an expert that holds no row and with every row on
one expert, in both dtypes; a reduced dropless Mixtral's decode graph
against its eager loop (its prefills on the grouped product, its steps
on the per-expert one), and its prefill and decode steps with no
synchronising call. Whether
a card is present is decided inside each test, so every worker collects
the same tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
import dataclasses  # noqa: E402

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import decode_attention as dec_kernel  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_kernel  # noqa: E402
from repro_torch.models.kv_cache import ring_positions, ring_valid  # noqa: E402
from repro_torch.models.model import forward_decode, forward_prefill  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * max(float(want.float().abs().max()), 1.0), err


def _close_attention(got, want, dtype):
    """TOL over the whole output and, in bf16, row by row: each output row
    (a q head at a position) within TOL of max(|its ref row|, 2^-6), so
    rows with small values (late rows of a long prefill) are held too."""
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        _close_rows(got, want)


def _close_rows(got, want):
    """Each row of the last axis within TOL[bf16] x max(|its ref row|, 2^-6)."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(2.0 ** -6)
    assert float((err / scale).max()) <= TOL[torch.bfloat16], float((err / scale).max())


def _assert_flash_body_counted(dtype, S, G):
    """The warpgroup-MMA body's launches count apart: once for bf16 past
    512 packed rows of a kv head (S * G), else not at all."""
    wgmma = tracing.counters().get("kernels.launches.flash_attention_wgmma", 0)
    assert wgmma == int(dtype == torch.bfloat16 and S * G > 512)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hkv,G,D,window", [
    (2, 8, 2, 8, 128, None),      # the serving path's prompts (qwen: H=16, Hkv=2)
    (2, 24, 2, 8, 128, None),
    (2, 33, 2, 8, 128, None),
    (2, 48, 2, 8, 128, None),
    (1, 2048, 2, 8, 128, None),   # long prefill: 32 kv tiles for the last row tile
    (1, 200, 2, 8, 128, 64),      # sliding window: tiles skipped at both ends
    (2, 40, 2, 8, 96, None),      # head_dim 96 (phi3)
    (2, 40, 2, 8, 112, None),     # head_dim 112 (zamba2)
    (2, 100, 4, 1, 64, None),     # G = 1: 64 positions a row tile
    (2, 37, 1, 16, 128, None),    # G = 16: 4 positions a row tile
    (1, 8, 8, 4, 128, 4096),      # mixtral's prefill (H=32, Hkv=8, sliding window 4096)
    (1, 24, 8, 4, 128, 4096),
    (1, 48, 8, 4, 128, 4096),
    (1, 256, 32, 1, 112, None),   # zamba2's shared block (H=Hkv=32, D=112): one SSD chunk
    (1, 512, 32, 1, 112, None),   # and two
    # nemotron (H=48, Hkv=8, G=6): a position's 6 packed rows cross a warp's
    # 16-row tile at S=3 (rows 12-17) and the block's 64-row tile at S=11
    # (position 10: rows 60-65); S=8 ends inside a warp, S=48 spans 4.5 blocks
    (1, 3, 8, 6, 128, None),
    (1, 8, 8, 6, 128, None),
    (2, 11, 8, 6, 128, None),
    (1, 48, 8, 6, 128, None),
    (1, 48, 32, 1, 128, None),    # codeqwen (H=Hkv=32, D=128)
    (1, 48, 32, 1, 96, None),     # phi3 (H=Hkv=32, D=96)
    (1, 264, 8, 8, 128, None),    # internvl2 (H=64, Hkv=8): 256 patches + prompts of 8
    (1, 304, 8, 8, 128, None),    # and 48 tokens, off the 64-row tile
    # past 512 packed rows of a kv head bf16 takes the warpgroup-MMA body:
    # its 128-row and 128-key tiles' edges
    (1, 100, 2, 8, 128, None),    # 800 packed rows: the last 128-row tile holds 32
    (2, 150, 8, 6, 128, None),    # G = 6: 900 rows, positions across the tiles
    (1, 300, 8, 4, 128, 4096),    # G = 4 (mixtral): 1200 rows, 1200 % 128 = 48
    (1, 4096, 2, 8, 128, None),   # the 2-stage K/V ring wraps 16 times
    (1, 4096, 2, 8, 128, 1024),   # and under a window: tiles skipped at both ends
    (1, 700, 4, 1, 96, None),     # D = 96 and 112: the last box zero-filled past D
    (1, 600, 2, 1, 112, None),
])
def test_flash_kernel_matches_plain(B, S, Hkv, G, D, window, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S + D + G)
    q = torch.randn((B, S, Hkv * G, D), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    _assert_flash_body_counted(dtype, S, G)
    assert got.dtype == dtype and got.shape == q.shape
    _close_attention(got, ref.flash_attention_ref(q, k, v, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,causal", [
    (1, 48, True),     # whisper-tiny's decoder prefill (H=Hkv=6, D=64), its longest prompt
    (1, 1500, False),  # its encoder: bidirectional over 1500 frames
    (2, 1500, False),
])
def test_flash_kernel_matches_plain_on_whisper_shapes(B, S, causal, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S + B)
    q, k, v = (torch.randn((B, S, 6, 64), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    _assert_flash_body_counted(dtype, S, 1)
    assert got.dtype == dtype and got.shape == q.shape
    _close_attention(got, ref.flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 2])
def test_decode_kernel_cross_attention_over_every_frame(B, dtype):
    """whisper-tiny's decode-step cross-attention as the model launches it:
    one query against the 1500 cached frames of one layer's slice of the
    cache, every frame valid at positions 0..1499 and the query at 1499, so
    every slot is live; equal to the plain unmasked attention."""
    _need_card()
    from repro_torch.models.layers import sdpa

    g = torch.Generator(device="cuda").manual_seed(1500 + B)
    q = torch.randn((B, 1, 6, 64), generator=g, device="cuda").to(dtype)
    xk, xv = (torch.randn((4, B, 1500, 6, 64), generator=g, device="cuda").to(dtype)
              for _ in range(2))
    kv_pos = torch.arange(1500, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    valid = torch.ones((B, 1500), dtype=torch.bool, device="cuda")
    q_pos = torch.full((B,), 1499, dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    got = ops.decode_attention(q, xk[2], xv[2], kv_pos, valid, q_pos)
    assert ops.launch_counts()["decode_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    _close_attention(got, sdpa(q, xk[2], xv[2], causal=False), dtype)
    _close_attention(got, ref.decode_attention_ref(q, xk[2], xv[2], kv_pos, valid, q_pos),
                     dtype)


def _decode_inputs(B, W, Hkv, G, D, dtype, pos, seed):
    """A ring of W-1 slots after ``pos`` writes plus the self slot, as the
    model's decode step builds them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, W, Hkv, D), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([ring_positions(p, W - 1), p[:, None]], 1).contiguous()
    valid = torch.cat([ring_valid(p, W - 1), torch.ones((B, 1), dtype=torch.bool,
                                                        device="cuda")], 1).contiguous()
    return q, k, v, kv_pos, valid, p


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("W,Hkv,G,D,pos", [
    (129, 2, 8, 128, [1]),             # the serving path (qwen): ring 128 + self slot
    (129, 2, 8, 128, [63]),
    (129, 2, 8, 128, [300]),           # wrapped ring
    (129, 2, 8, 128, [50]),            # half-filled ring: cluster blocks 3-6 hold no live slot
    (17, 2, 8, 128, [9]),              # a cluster of 2
    (400, 2, 8, 128, [350]),           # 50 slots a block: 2 slot groups (8 warps)
    (4097, 8, 4, 128, [5000]),         # mixtral's widths, a full 4096-slot window: 513 slots a
                                       # block, 4 slot groups in bf16 (2 in float32)
    (129, 8, 4, 128, [7, 90, 200, 129]),  # B * Hkv = 32 (mixtral's decode step: H=32, Hkv=8)
    (65, 2, 8, 96, [40]),              # head_dim 96
    (65, 2, 8, 112, [40]),             # head_dim 112
    (129, 32, 1, 112, [263]),          # zamba2's decode step (H=Hkv=32, D=112): ring full
    (129, 32, 1, 112, [50]),           # and half full
    (129, 8, 6, 128, [63]),            # nemotron's decode step (H=48, Hkv=8, G=6)
    (129, 8, 6, 128, [9, 300]),        # a young ring and a wrapped one
    (129, 32, 1, 128, [63]),           # codeqwen's (H=Hkv=32, D=128)
    (129, 32, 1, 96, [63]),            # phi3's (H=Hkv=32, D=96)
    (129, 8, 8, 128, [319]),           # internvl2's (H=64, Hkv=8), behind 256 patches
    (129, 6, 1, 64, [63]),             # whisper-tiny's decoder ring (H=Hkv=6, D=64)
    (129, 6, 1, 64, [9, 300]),
])
def test_decode_kernel_matches_plain(W, Hkv, G, D, pos, dtype):
    _need_card()
    q, k, v, kv_pos, valid, p = _decode_inputs(len(pos), W, Hkv, G, D, dtype, pos,
                                                seed=W + D + pos[0])
    ops.reset_launch_counts()
    got = ops.decode_attention(q, k, v, kv_pos, valid, p)
    assert ops.launch_counts()["decode_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    _close_attention(got, ref.decode_attention_ref(q, k, v, kv_pos, valid, p), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S", [(1, 64), (2, 300), (8, 1024)])
def test_attention_kernels_take_granites_scale(B, S, dtype):
    """Granite's attention (H=32, Hkv=8, D=128, no positions) scores at
    attention_multiplier 1/128, not 1/sqrt(128): flash over the prompt and
    a decode step over a 1032-slot ring, each against its plain version
    at the same scale; the default scale is still 1/sqrt(D)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S + B)
    q = torch.randn((B, S, 32, 128), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, S, 8, 128), generator=g, device="cuda").to(dtype) for _ in range(2))
    got = ops.flash_attention(q, k, v, scale=1 / 128)
    _close_attention(got, ref.flash_attention_ref(q, k, v, scale=1 / 128), dtype)
    assert torch.equal(ops.flash_attention(q, k, v), ops.flash_attention(q, k, v,
                                                                         scale=128 ** -0.5))
    q1, kd, vd, kv_pos, valid, p = _decode_inputs(B, 1033, 8, 4, 128, dtype, [S] * B, seed=S)
    got = ops.decode_attention(q1, kd, vd, kv_pos, valid, p, scale=1 / 128)
    _close_attention(got, ref.decode_attention_ref(q1, kd, vd, kv_pos, valid, p,
                                                   scale=1 / 128), dtype)


def test_decode_half_filled_ring_leaves_cluster_blocks_empty():
    """The half-filled case above does hold cluster blocks without a live
    slot: the kernel's split of W=129 is 8 blocks of 17 slots."""
    _need_card()
    assert dec_kernel.cluster_size(129) == 8
    assert [dec_kernel.cluster_size(w) for w in (1, 16, 17, 65, 4097)] == [1, 1, 2, 5, 8]
    _, _, _, kv_pos, valid, p = _decode_inputs(1, 129, 2, 8, 128, torch.float32, [50], 0)
    live = (valid & (kv_pos <= p[:, None]))[0].cpu()
    assert [int(live[r * 17:(r + 1) * 17].sum()) for r in range(8)] == [17, 17, 16, 0, 0, 0,
                                                                        0, 1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_fully_masked_row_is_exactly_zero(dtype):
    _need_card()
    q, k, v, kv_pos, valid, p = _decode_inputs(2, 129, 2, 8, 128, dtype, [70, 300], seed=3)
    valid[0] = False
    got = ops.decode_attention(q, k, v, kv_pos, valid, p)
    assert int(torch.count_nonzero(got[0])) == 0
    _close_attention(got, ref.decode_attention_ref(q, k, v, kv_pos, valid, p), dtype)


def test_unsupported_cuda_input_raises():
    _need_card()
    q = torch.zeros((1, 8, 4, 80), device="cuda")  # head_dim 80 has no kernel
    kv = torch.zeros((1, 8, 2, 80), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, kv, kv)
    pos = torch.ones((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q[:, :1].contiguous(), kv, kv,
                             torch.zeros((1, 8), dtype=torch.int32, device="cuda"),
                             torch.ones((1, 8), dtype=torch.bool, device="cuda"), pos)


def _ssd_inputs(B, S, H, P, N, dtype, with_init, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = (randn(B, S, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    A = -torch.exp(randn(H) * 0.3)
    B_, C_ = ((randn(B, S, N) * 0.5).to(dtype) for _ in range(2))
    init = randn(B, H, P, N) * 0.2 if with_init else None
    return x, dt, A, B_, C_, init


def _ssd_close(got, want, dtype, tol32, Q):
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32 and Q <= 64:
        assert err <= tol32, err
        return
    tol = tol32 if dtype == torch.float32 else TOL[dtype]
    assert err <= tol * max(float(want.float().abs().max()), 1.0), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,nc,Q,H,P,N,with_init", [
    (1, 1, 256, 64, 64, 128, False),  # the serving path's prefill
    (1, 1, 256, 112, 64, 64, False),  # zamba2's prefill: H=112 (56 head pairs), N=64
    (1, 2, 256, 112, 64, 64, True),
    (1, 2, 256, 8, 64, 128, True),
    (2, 3, 64, 4, 64, 32, False),
    (2, 4, 32, 2, 32, 64, True),
])
def test_ssd_kernel_matches_plain(B, nc, Q, H, P, N, with_init, dtype):
    _need_card()
    x, dt, A, B_, C_, init = _ssd_inputs(B, nc * Q, H, P, N, dtype, with_init,
                                         seed=nc * Q + H + N)
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(x, dt, A, B_, C_, Q, init)
    assert ops.launch_counts()["ssd_scan"] == 1
    assert y.dtype == dtype and st.dtype == torch.float32
    y_ref, st_ref = ref.ssd_scan_ref(x, dt, A, B_, C_, Q, init)
    _ssd_close(y, y_ref, dtype, 1e-4, Q)
    _ssd_close(st, st_ref, dtype, 1e-4, Q)
    y_seq, st_seq = ref.ssd_scan_sequential_ref(x, dt, A, B_, C_, init)
    _ssd_close(y, y_seq, dtype, 5e-3, Q)
    _ssd_close(st, st_seq, dtype, 5e-3, Q)


@pytest.mark.parametrize("B,nc,Q,H,P,N,with_init", [
    (1, 1, 256, 3, 32, 128, False),  # one chunk: independent blocks, an odd head count
    (1, 3, 256, 2, 32, 32, False),   # a state between chunks: a 4-block cluster
    (2, 2, 256, 5, 64, 64, True),    # the cluster with an initial state
    (1, 3, 64, 4, 64, 128, True),    # one 64-row tile a chunk
    (2, 2, 32, 7, 64, 128, True),    # 32-row tiles (Q = 32)
])
def test_ssd_tensor_core_tile_paths_match_plain(B, nc, Q, H, P, N, with_init):
    """The bf16 kernel's tile paths against the chunked form and the
    recurrence: within TOL and row by row (y over P, the state over N)."""
    _need_card()
    x, dt, A, B_, C_, init = _ssd_inputs(B, nc * Q, H, P, N, torch.bfloat16, with_init,
                                         seed=3 * nc + Q + H)
    y, st = ops.ssd_scan(x, dt, A, B_, C_, Q, init)
    y_ref, st_ref = ref.ssd_scan_ref(x, dt, A, B_, C_, Q, init)
    y_seq, st_seq = ref.ssd_scan_sequential_ref(x, dt, A, B_, C_, init)
    for got, want in ((y, y_ref), (st, st_ref), (y, y_seq), (st, st_seq)):
        _close(got, want, torch.bfloat16)
        _close_rows(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S", [(1, 256), (1, 70), (2, 300), (8, 1000)])
def test_ssd_kernel_at_granites_shape_pads_ragged_sequences(B, S, dtype):
    """Granite's Mamba2 (H=128, P=64, N=128, chunk 256) at prompt lengths
    off the chunk: ``ops.ssd_scan`` pads the tail with rows that leave the
    state as it was, launches once, and gives the plain version's y and
    final state, and the recurrence's."""
    _need_card()
    x, dt, A, B_, C_, _ = _ssd_inputs(B, S, 128, 64, 128, dtype, False, seed=S + B)
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(x, dt, A, B_, C_, 256)
    assert ops.launch_counts()["ssd_scan"] == 1
    assert y.shape == x.shape and st.shape == (B, 128, 64, 128)
    y_ref, st_ref = ops.ssd_scan(x, dt, A, B_, C_, 256, use_kernels=False)
    _ssd_close(y, y_ref, dtype, 1e-4, 256)
    _ssd_close(st, st_ref, dtype, 1e-4, 256)
    y_seq, st_seq = ref.ssd_scan_sequential_ref(x, dt, A, B_, C_)
    _ssd_close(y, y_seq, dtype, 5e-3, 256)
    _ssd_close(st, st_seq, dtype, 5e-3, 256)


def test_ssd_kernel_takes_strided_views():
    """x, B and C as the model passes them: slices of one conv output."""
    _need_card()
    H, P, N, S = 4, 64, 32, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    xbc = (torch.randn((2, S, H * P + 2 * N), generator=g, device="cuda") * 0.5)
    x = xbc[..., :H * P].reshape(2, S, H, P)
    B_, C_ = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not (x.is_contiguous() or B_.is_contiguous())
    dt = torch.nn.functional.softplus(torch.randn((2, S, H), generator=g, device="cuda"))
    A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.3)
    y, st = ops.ssd_scan(x, dt, A, B_, C_, 64)
    y_ref, st_ref = ref.ssd_scan_ref(x.contiguous(), dt, A, B_.contiguous(),
                                     C_.contiguous(), 64)
    _ssd_close(y, y_ref, torch.float32, 1e-4, 64)
    _ssd_close(st, st_ref, torch.float32, 1e-4, 64)


def test_ssd_unsupported_input_raises():
    _need_card()
    x, dt, A, B_, C_, _ = _ssd_inputs(1, 64, 2, 64, 16, torch.float32, False, seed=1)
    with pytest.raises(ValueError, match="state 16"):  # N = 16 has no kernel
        ops.ssd_scan(x, dt, A, B_, C_, 64)
    x, dt, A, B_, C_, _ = _ssd_inputs(1, 96, 2, 64, 32, torch.float32, False, seed=1)
    with pytest.raises(ValueError, match="seq 96"):  # the kernel takes whole chunks
        ssd_kernel.ssd_scan(x, dt, A, B_, C_, 64)   # (ops.ssd_scan pads the tail first)
    with pytest.raises(ValueError, match="not CUDA"):
        ssd_kernel.ssd_scan(x.cpu(), dt.cpu(), A.cpu(), B_.cpu(), C_.cpu(), 32)


def _gmm_inputs(E, C, D, F, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn((E, C, D), generator=g, device="cuda").to(dtype)
    w = (torch.randn((E, D, F), generator=g, device="cuda") * D ** -0.5).to(dtype)
    return buf, w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,C,D,F", [
    (8, 8, 4096, 14336),   # the serving path: gate / up at every decode step
    (8, 16, 14336, 4096),  # down, 48-token prefill
    (2, 13, 130, 72),      # C, D and F off the tiles
    (1, 100, 64, 96),
])
def test_moe_gmm_kernel_matches_plain(E, C, D, F, dtype):
    _need_card()
    buf, w = _gmm_inputs(E, C, D, F, dtype, seed=E + C + D + F)
    ops.reset_launch_counts()
    got = ops.moe_gmm(buf, w)
    assert ops.launch_counts()["moe_gmm"] == 1
    assert got.dtype == dtype and got.shape == (E, C, F)
    _close(got, ref.moe_gmm_ref(buf, w), dtype)


def _gmm_live(E, C, D, F, dtype, live, seed):
    """buf as the dispatch leaves it: [:, :C] of an (E, C+1, D) buffer in
    which only the experts of ``live`` (expert, rows) hold tokens."""
    full, w = _gmm_inputs(E, C + 1, D, F, dtype, seed)
    keep = torch.zeros((E, C + 1, 1), dtype=torch.bool, device="cuda")
    for e, rows in live:
        keep[e, :rows] = True
    return torch.where(keep, full, torch.zeros((), dtype=dtype, device="cuda"))[:, :C], w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,C,D,F,live", [
    (8, 8, 4096, 14336, [(1, 1), (5, 1)]),  # the served decode step: gate / up
    (8, 8, 14336, 4096, [(2, 1), (6, 1)]),  # and down
    (8, 8, 256, 320, []),                    # no expert holds a token
    (8, 16, 4096, 4096, [(7, 16)]),          # one expert, every row
    (2, 13, 130, 72, [(0, 3), (1, 1)]),      # some rows of two experts, off the tiles
])
def test_moe_gmm_kernel_skips_experts_without_tokens(E, C, D, F, live, dtype):
    """Experts that hold no token give exactly 0; the rest match the plain
    version within TOL and, in bf16, row by row."""
    _need_card()
    buf, w = _gmm_live(E, C, D, F, dtype, live, seed=E + C + D + F)
    ops.reset_launch_counts()
    got = ops.moe_gmm(buf, w)
    assert ops.launch_counts()["moe_gmm"] == 1
    want = ref.moe_gmm_ref(buf, w)
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        _close_rows(got, want)
    assert int(torch.count_nonzero(got[~(buf != 0).any(dim=-1)])) == 0


def test_moe_gmm_kernel_takes_the_strided_scatter_view():
    """buf as the MoE block passes it: [:, :C] of an (E, C+1, D) buffer."""
    _need_card()
    full, w = _gmm_inputs(8, 9, 256, 320, torch.bfloat16, seed=2)
    view = full[:, :8]
    assert not view.is_contiguous()
    _close(ops.moe_gmm(view, w), ref.moe_gmm_ref(view.contiguous(), w), torch.bfloat16)


def test_moe_gmm_unsupported_input_raises():
    _need_card()
    buf, w = _gmm_inputs(2, 8, 64, 96, torch.float32, seed=3)
    with pytest.raises(ValueError, match="dtypes"):  # buf and w must share a dtype
        ops.moe_gmm(buf, w.bfloat16())
    with pytest.raises(ValueError, match="not contiguous"):  # a weight is never copied
        ops.moe_gmm(buf, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous last axis"):
        ops.moe_gmm(buf.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="not CUDA"):
        gmm_kernel.moe_gmm(buf.cpu(), w.cpu())


GRAPH_ARCHS = ["qwen2.5-3b", "mixtral-8x7b", "zamba2-7b", "mamba2-1.3b", "whisper-tiny",
               "internvl2-76b", "granite-4.0-h-small"]


def _eager_generate(engine, prompts, max_new):
    """``engine.generate`` with its decode loop eager: (tokens, the last
    step's logits)."""
    cfg = engine.cfg
    tokens = engine._pad_batch(prompts)

    def zeros(n):
        return torch.zeros((len(prompts), n, cfg.d_model), dtype=cfg.torch_dtype, device="cuda")

    logits, cache = forward_prefill(
        engine.params, cfg, tokens, cache_window=engine.cache_window,
        frame_embeds=zeros(cfg.encoder_seq) if cfg.is_encoder_decoder else None,
        patch_embeds=zeros(cfg.frontend_tokens) if cfg.family == "vlm" else None)
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = [[] for _ in prompts]
    for _ in range(max_new):
        for row, t in zip(out, tok.tolist()):
            row.append(t)
        logits, cache = forward_decode(engine.params, cfg, tok, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return out, logits


def _served(engine, calls, max_new):
    """Each call's tokens through ``engine.generate``, its spans and the
    kernel launches counted."""
    ops.reset_launch_counts()
    tracing.drain()
    tracing.enable()
    try:
        tokens = [engine.generate(p, max_new_tokens=max_new).tokens for p in calls]
    finally:
        tracing.disable()
    return tokens, tracing.drain(), ops.launch_counts()


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_decode_graph_replays_the_eager_step(arch, B):
    """Two calls of other prompt lengths through one graph (the second
    only through the copy into its buffers): the eager loop's tokens, the
    eager loop's launch counts and its last logits bit for bit (the same
    kernels on the same inputs); the first step of the shape runs eagerly
    and is recorded, every later one replays."""
    _need_card()
    engine = ServingEngine(get_reduced_config(arch), seed=0, cache_window=64)
    rng = np.random.default_rng(B)
    calls = [[[int(t) for t in rng.integers(1, engine.cfg.vocab_size, size=n)]
              for n in lengths[:B]] for lengths in ((9, 4, 17, 6), (23, 11, 5, 30))]
    got, spans, counts = _served(engine, calls, 6)
    (graph,) = engine.graphs.values()
    launches = [s.attrs["graph"] for s in spans if s.name == "engine.decode.launch"]
    assert launches == [False] + [True] * 11
    assert sum(s.name == "engine.decode.capture" for s in spans) == 1
    ops.reset_launch_counts()
    with torch.inference_mode():
        want = [_eager_generate(engine, p, 6) for p in calls]
    assert got == [tokens for tokens, _ in want]
    assert ops.launch_counts() == counts
    assert torch.equal(graph.logits, want[-1][1])


def test_decode_graph_is_captured_once_a_cache_shape():
    """Batch 1 and 4 in turn: two graphs, each captured once, under a
    span that names its batch and ring window."""
    _need_card()
    engine = ServingEngine(get_reduced_config("qwen2.5-3b"), seed=0, cache_window=64)
    calls = [[[5, 6, 7]], [[8, 9]] * 4, [[10, 11, 12, 13]], [[14]] * 4]
    _, spans, _ = _served(engine, calls, 3)
    captures = [s.attrs for s in spans if s.name == "engine.decode.capture"]
    assert captures == [{"batch": 1, "window": 64}, {"batch": 4, "window": 64}]
    assert len(engine.graphs) == 2
    launches = [s.attrs["graph"] for s in spans if s.name == "engine.decode.launch"]
    assert launches == [False, True, True] * 2 + [True] * 6


def _grouped_inputs(R, E, D, F, dtype, seed, counts=None):
    """x (R, D) sorted by expert and its offsets: each row's expert drawn
    uniformly, or ``counts`` rows an expert."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if counts is None:
        experts = torch.randint(0, E, (R,), generator=g, device="cuda")
        counts = torch.bincount(experts, minlength=E).tolist()
    assert sum(counts) == R and len(counts) == E
    offsets = torch.tensor([0] + np.cumsum(counts).tolist(), dtype=torch.int32, device="cuda")
    x = torch.randn((R, D), generator=g, device="cuda").to(dtype)
    w = (torch.randn((E, D, F), generator=g, device="cuda") * D ** -0.5).to(dtype)
    return x, w, offsets


def _grouped_check(x, w, offsets, dtype):
    before = tracing.counters().get("kernels.launches.moe_gmm_grouped", 0)
    got = ops.moe_gmm_grouped(x, w, offsets)
    torch.cuda.synchronize()
    assert tracing.counters()["kernels.launches.moe_gmm_grouped"] == before + 1
    assert got.dtype == dtype and got.shape == (x.shape[0], w.shape[2])
    want = ref.moe_gmm_grouped_ref(x, w, offsets)
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        _close_rows(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,D,F", [
    (2, 4096, 14336),      # a batch-1 decode step's rows: gate / up, partial tiles
    (16, 14336, 4096),     # a batch-8 decode step's rows: down, partial tiles
    (130, 136, 72),        # the warpgroup body's edges: rows, D and F off its tiles
    (130, 4096, 14336),    # a 65-token prefill
    (2048, 14336, 4096),   # a 1024-token prefill: down
    (16384, 4096, 14336),  # batch 8 x 1024 tokens: gate / up
])
def test_moe_gmm_grouped_kernel_matches_plain(R, D, F, dtype):
    _need_card()
    _grouped_check(*_grouped_inputs(R, 8, D, F, dtype, seed=R + D + F), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("counts,D,F", [
    ((1, 0, 0, 0, 0, 1, 0, 0), 4096, 14336),   # a decode step at batch 1: 6 experts idle
    ((0, 0, 0, 16, 0, 0, 0, 0), 4096, 4096),   # every row on one expert, one partial tile
    ((0, 0, 2048, 0, 0, 0, 0, 0), 512, 1024),  # every row on one expert, tiled body
    ((300, 0, 5, 0, 129, 1, 0, 77), 256, 320),  # ragged groups, idle experts between them
])
def test_moe_gmm_grouped_kernel_idle_and_full_experts(counts, D, F, dtype):
    """An expert with no row reads no weight and owns no output row; the
    rows of the others match the plain version."""
    _need_card()
    x, w, offsets = _grouped_inputs(sum(counts), len(counts), D, F, dtype,
                                    seed=sum(counts) + D, counts=list(counts))
    _grouped_check(x, w, offsets, dtype)


def test_moe_gmm_grouped_unsupported_input_raises():
    _need_card()
    x, w, offsets = _grouped_inputs(8, 4, 64, 96, torch.bfloat16, seed=3)
    with pytest.raises(ValueError, match="int32"):
        ops.moe_gmm_grouped(x, w, offsets.long())
    with pytest.raises(ValueError, match="dtypes"):
        ops.moe_gmm_grouped(x, w.float(), offsets)
    with pytest.raises(ValueError, match="not contiguous"):  # a weight is never copied
        ops.moe_gmm_grouped(x, w.transpose(1, 2).contiguous().transpose(1, 2), offsets)
    with pytest.raises(ValueError, match="not CUDA"):
        ops.moe_gmm_grouped(x, w, offsets.cpu())
    x, w, offsets = _grouped_inputs(130, 4, 130, 96, torch.bfloat16, seed=4)
    with pytest.raises(ValueError, match="multiples of 8"):  # whole 16-byte chunks
        ops.moe_gmm_grouped(x, w, offsets)
    x, w, offsets = _grouped_inputs(130, 4, 130, 72, torch.float32, seed=4)
    _grouped_check(x, w, offsets, torch.float32)  # the CUDA-core body takes any width


def _dropless_engine():
    cfg = dataclasses.replace(get_reduced_config("mixtral-8x7b"), moe_capacity_factor=None)
    return ServingEngine(cfg, seed=0, cache_window=64)


@pytest.mark.parametrize("B", [1, 4])
def test_dropless_decode_graph_replays_the_eager_step(B):
    """The dropless dispatch records into the decode graph: the eager
    loop's tokens, launch counts (the grouped product's too) and last
    logits bit for bit; the first step records, every later one replays.
    The prefills (over 8 tokens) take the grouped product, the steps (B
    tokens) the per-expert one."""
    _need_card()
    engine = _dropless_engine()
    rng = np.random.default_rng(B)
    calls = [[[int(t) for t in rng.integers(1, engine.cfg.vocab_size, size=n)]
              for n in lengths[:B]] for lengths in ((9, 4, 17, 6), (23, 11, 5, 30))]
    got, spans, counts = _served(engine, calls, 6)  # the launch counters reset first
    grouped = tracing.counters().get("kernels.launches.moe_gmm_grouped", 0)
    (graph,) = engine.graphs.values()
    launches = [s.attrs["graph"] for s in spans if s.name == "engine.decode.launch"]
    assert launches == [False] + [True] * 11
    L = engine.cfg.num_layers
    assert grouped == 3 * L * 2  # a prefill a call, 2 calls
    assert counts["moe_gmm"] == 3 * L * 2 * 6  # 6 steps a call
    assert counts["moe_gmm_grouped"] == grouped
    ops.reset_launch_counts()
    with torch.inference_mode():
        want = [_eager_generate(engine, p, 6) for p in calls]
    assert got == [tokens for tokens, _ in want]
    assert ops.launch_counts() == counts
    assert tracing.counters().get("kernels.launches.moe_gmm_grouped", 0) == grouped
    assert torch.equal(graph.logits, want[-1][1])


def test_dropless_prefill_and_decode_never_synchronise():
    """No host read of the routing: a dropless prefill and decode steps run
    under PyTorch's sync debug mode set to raise on any synchronising call
    (after one warm call builds the kernels)."""
    _need_card()
    engine = _dropless_engine()
    tokens = engine._pad_batch([[5, 6, 7, 8] * 20, [9, 10, 11]])
    with torch.inference_mode():
        forward_prefill(engine.params, engine.cfg, tokens, cache_window=128)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, cache = forward_prefill(engine.params, engine.cfg, tokens, cache_window=128)
            for _ in range(3):
                tok = torch.argmax(logits, -1).to(torch.int32)
                logits, cache = forward_decode(engine.params, engine.cfg, tok, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
