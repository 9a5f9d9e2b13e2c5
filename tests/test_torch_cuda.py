"""Card-only checks of the port's CUDA kernels (skipped without a GPU).

On a machine with an H100:  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel against its plain version on the card at the serving path's
shapes, in both dtypes, within tests/test_kernels.py's TOL; each launch
counts once; a CUDA tensor the kernel cannot take raises instead of
falling back. Whether a card is present is decided inside each test, so
every worker collects the same tests.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.kv_cache import ring_positions, ring_valid  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * max(float(want.float().abs().max()), 1.0), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [8, 24, 33, 48])
def test_flash_kernel_matches_plain(S, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn((2, S, 16, 128), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((2, S, 2, 128), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 1
    _close(got, ref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [1, 63, 300])
def test_decode_kernel_matches_plain(pos, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(pos)
    q = torch.randn((1, 1, 16, 128), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((1, 129, 2, 128), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([ring_positions(p, 128), p[:, None]], 1).contiguous()
    valid = torch.cat([ring_valid(p, 128), torch.ones((1, 1), dtype=torch.bool,
                                                      device="cuda")], 1).contiguous()
    ops.reset_launch_counts()
    got = ops.decode_attention(q, k, v, kv_pos, valid, p)
    assert ops.launch_counts()["decode_attention"] == 1
    _close(got, ref.decode_attention_ref(q, k, v, kv_pos, valid, p), dtype)


def test_unsupported_cuda_input_raises():
    _need_card()
    q = torch.zeros((1, 8, 4, 96), device="cuda")  # head_dim 96 has no kernel
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
