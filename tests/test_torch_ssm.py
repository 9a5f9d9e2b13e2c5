"""The port's Mamba2 (ssm) path against the JAX reference on the same inputs.

Inputs come from a numpy seed and go to both packages; weights are the
reference's ``init_params`` carried over with ``params_from_numpy``.

* The SSD scan's plain versions (``ref.ssd_scan_ref``, the chunked form
  the CUDA kernel is held against, and ``ref.ssd_scan_sequential_ref``,
  the step-by-step ground truth) against the JAX Pallas kernel in
  interpret mode and JAX's two oracles, over tests/test_kernels.py's grid
  (B 1-2, 1-4 chunks of 32/64, H 2/4, P 32/64, N 32/128, with and without
  an initial state), at that file's bars: 1e-4 against the chunked form,
  5e-3 against the recurrence.
* The block's pieces (causal conv and its decode step, the SSD decode
  step, the gated norm, ``mamba_block``, ``mamba_decode``) on carried
  weights.
* Reduced mamba2 ``forward_seq`` logits, the prefill cache (``ssd``,
  ``conv``, ``pos``) and 8 teacher-forced decode steps: float32 within
  2e-5 x max(|ref|, 1), bfloat16 within 0.02 relative; the JAX side runs
  with ``use_pallas`` off and on.
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
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

CHUNKED_TOL, SEQUENTIAL_TOL = 1e-4, 5e-3  # tests/test_kernels.py:100-107
F32_TOL = 2e-5  # tests/test_kernels.py TOL[float32], scaled by max(|ref|, 1)
BF16_TOL = 3e-2  # tests/test_kernels.py TOL[bfloat16], scaled likewise
BF16_REL = 0.02  # tests/test_kernels.py:145 relative-logit bar
STEPS, BATCH = 8, 2
ARCH = "mamba2-1.3b"
F32_LEAVES = ("A_log", "dt_bias", "D")


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
def _weights(dtype):
    """(port params, JAX params) holding identical values."""
    cfg, jcfg = _configs(dtype)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return params_from_numpy(tree, cfg, device="cpu"), jparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


# ---------------------------------------------------------------- convert


def test_params_from_numpy_keeps_float32_leaves():
    """A bf16 model's A_log, dt_bias and D stay float32, as the reference
    keeps them; every other leaf is bf16; no value changes."""
    params, jparams = _weights("bfloat16")
    port = params["blocks"]["mamba"]
    for name, leaf in jparams["blocks"]["mamba"].items():
        want = torch.float32 if name in F32_LEAVES else torch.bfloat16
        assert port[name].dtype == want, name
        assert np.array_equal(_f32(port[name]), _f32(leaf)), name
    for name in ("embed", "final_norm", "lm_head"):
        assert params[name].dtype == torch.bfloat16
        assert np.array_equal(_f32(params[name]), _f32(jparams[name])), name
    assert params["blocks"]["norm"].dtype == torch.bfloat16


# ------------------------------------------------------------ the SSD scan


def _ssd_inputs(B, S, H, P, N, with_init, seed):
    """The value distribution of tests/test_kernels.py's SSD test."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    C_ = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    init = (rng.standard_normal((B, H, P, N)).astype(np.float32) * 0.2
            if with_init else None)
    return x, dt, A.astype(np.float32), B_, C_, init


# (B, chunks, Q, H, P, N, with_init)
SSD_CASES = [
    (1, 1, 32, 2, 32, 32, False),
    (2, 1, 64, 2, 64, 128, False),
    (1, 4, 32, 4, 32, 128, True),
    (2, 2, 64, 2, 32, 32, True),
    (1, 3, 64, 4, 64, 32, False),
    (2, 4, 32, 2, 64, 128, True),
    (1, 2, 64, 2, 64, 128, True),
]


@pytest.mark.parametrize("B,nc,Q,H,P,N,with_init", SSD_CASES)
def test_ssd_scan_plain_versions_match_jax(B, nc, Q, H, P, N, with_init):
    x, dt, A, B_, C_, init = _ssd_inputs(B, nc * Q, H, P, N, with_init,
                                         seed=nc * Q + H + N)
    j_in = [jnp.asarray(a) for a in (x, dt, A, B_, C_)]
    j_init = None if init is None else jnp.asarray(init)
    t_in = [torch.from_numpy(a) for a in (x, dt, A, B_, C_)]
    t_init = None if init is None else torch.from_numpy(init)

    y, st = ref.ssd_scan_ref(*t_in, Q, t_init)
    y_seq, st_seq = ref.ssd_scan_sequential_ref(*t_in, t_init)
    assert y.dtype == torch.float32 and st.shape == (B, H, P, N)
    for want in (jax_ssd_scan(*j_in, Q, j_init, interpret=True),
                 jref.ssd_scan_ref(*j_in, Q, j_init)):
        assert _err(y, want[0])[0] < CHUNKED_TOL
        assert _err(st, want[1])[0] < CHUNKED_TOL
    jy_seq, jst_seq = jref.ssd_scan_sequential_ref(*j_in, j_init)
    assert _err(y_seq, jy_seq)[0] < CHUNKED_TOL
    assert _err(st_seq, jst_seq)[0] < CHUNKED_TOL
    # and the chunked form equals the recurrence, as in the JAX test
    assert _err(y, y_seq)[0] < SEQUENTIAL_TOL
    assert _err(st, st_seq)[0] < SEQUENTIAL_TOL
    # ops takes the plain version for CPU tensors
    ops.reset_launch_counts()
    y_ops, st_ops = ops.ssd_scan(*t_in, Q, t_init)
    assert torch.equal(y_ops, y) and torch.equal(st_ops, st)
    assert ops.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_bf16_matches_jax(with_init):
    """x, B and C in bf16 (dt, A and the state f32), as the model calls it:
    y comes back in bf16, the state in f32."""
    x, dt, A, B_, C_, init = _ssd_inputs(2, 128, 2, 64, 32, with_init, seed=7)
    j_in = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B_, jnp.bfloat16), jnp.asarray(C_, jnp.bfloat16)]
    t_in = [torch.from_numpy(x).bfloat16(), torch.from_numpy(dt), torch.from_numpy(A),
            torch.from_numpy(B_).bfloat16(), torch.from_numpy(C_).bfloat16()]
    j_init = None if init is None else jnp.asarray(init)
    t_init = None if init is None else torch.from_numpy(init)
    y, st = ref.ssd_scan_ref(*t_in, 64, t_init)
    jy, jst = jref.ssd_scan_ref(*j_in, 64, j_init)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    for got, want in ((y, jy), (st, jst)):
        err, scale = _err(got, want)
        assert err <= BF16_TOL * max(scale, 1.0), err


def _ssd_tensor_core_emulation(x, dt, A, B_, C_, chunk, init=None):
    """The bf16 CUDA kernel's arithmetic (``csrc/ssd_scan.cu``,
    ``ssd_scan_tc_kernel``) in plain torch: C.B^T in fp32 from the bf16
    inputs (exact products); the decayed scores exp(cum_i - cum_j) dt_j,
    masked to j <= i, rounded to bf16 before they multiply x (an exact
    bf16 operand); the state update's x_j dt_j exp(cum_Q - cum_j) rounded to
    bf16 before it multiplies B; the C . state term and the carried state
    in fp32; y rounded to bf16 once."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    bf16 = torch.bfloat16
    state = (torch.zeros((Bsz, H, P, N)) if init is None else init.float())
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    ys = []
    for s0 in range(0, S, chunk):
        xc, dtc = x[:, s0:s0 + chunk].float(), dt[:, s0:s0 + chunk].float()
        Bc, Cc = B_[:, s0:s0 + chunk].float(), C_[:, s0:s0 + chunk].float()
        cum = torch.cumsum(dtc * A.float(), dim=1)  # (B, Q, H)
        total = cum[:, -1]  # (B, H)
        raw = torch.einsum("bin,bjn->bij", Cc, Bc)
        seg = (cum[:, :, None, :] - cum[:, None, :, :]).clamp(max=0.0)  # (B, i, j, H)
        scores = raw[..., None] * torch.exp(seg) * dtc[:, None, :, :]
        scores = torch.where(causal[None, :, :, None], scores, 0.0).to(bf16).float()
        y = torch.einsum("bijh,bjhp->bihp", scores, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum("bin,bhpn->bihp", Cc, state)
        w = dtc * torch.exp(total[:, None] - cum)  # (B, Q, H)
        xw = (xc * w[..., None]).to(bf16).float()
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bjhp,bjn->bhpn", xw, Bc)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


@pytest.mark.parametrize("nc,with_init", [(1, False), (2, True)])
def test_ssd_tensor_core_rounding_holds_the_bars(nc, with_init):
    """The bf16 kernel's rounding (bf16 scores with dt folded in, bf16 x
    times the state-update weight) at the served chunk (Q = 256, P = 64,
    N = 128, 4 heads), against the step-by-step recurrence and JAX's
    chunked oracle: within tests/test_kernels.py's bf16 bar (3e-2 x
    max(|ref|, 1)) and row by row (each y row over P and state row over N
    within 3e-2 x max(|its ref row|, 2^-6), the bar chip_smoke.py holds
    the kernel to on the card)."""
    x, dt, A, B_, C_, init = _ssd_inputs(1, nc * 256, 4, 64, 128, with_init, seed=nc + 20)
    t_in = [torch.from_numpy(x).bfloat16(), torch.from_numpy(dt), torch.from_numpy(A),
            torch.from_numpy(B_).bfloat16(), torch.from_numpy(C_).bfloat16()]
    t_init = None if init is None else torch.from_numpy(init)
    y, st = _ssd_tensor_core_emulation(*t_in, 256, t_init)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y_seq, st_seq = ref.ssd_scan_sequential_ref(*t_in, t_init)
    j_in = [jnp.asarray(a, jnp.float32) for a in (t_in[0].float(), dt, A, t_in[3].float(),
                                                  t_in[4].float())]
    jy, jst = jref.ssd_scan_ref(*j_in, 256, None if init is None else jnp.asarray(init))
    for got, want in ((y, y_seq), (st, st_seq), (y, jy), (st, jst)):
        err, scale = _err(got, want)
        assert err <= BF16_TOL * max(scale, 1.0), (err, scale)
        row_err = np.max(np.abs(_f32(got) - _f32(want)), axis=-1)
        row_scale = np.maximum(np.max(np.abs(_f32(want)), axis=-1), 2.0 ** -6)
        assert float(np.max(row_err / row_scale)) <= BF16_TOL, float(np.max(row_err / row_scale))


def test_ssd_chunked_rejects_ragged_sequence():
    x, dt, A, B_, C_, _ = _ssd_inputs(1, 40, 2, 32, 32, False, seed=1)
    with pytest.raises(ValueError, match="multiple"):
        ref.ssd_scan_ref(*(torch.from_numpy(a) for a in (x, dt, A, B_, C_)), 32)


# ------------------------------------------------------- the block's pieces


def _layer0(dtype):
    """Layer 0's mamba parameters on both sides, and the configs."""
    params, jparams = _weights(dtype)
    cfg, jcfg = _configs(dtype)
    port = {k: v[0] for k, v in params["blocks"]["mamba"].items()}
    jax_p = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["mamba"])
    return cfg, jcfg, port, jax_p


def _pair(arr, dtype):
    return jnp.asarray(arr, dtype), torch.from_numpy(arr).to(getattr(torch, dtype))


def _close(got, want, dtype, what):
    err, scale = _err(got, want)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert err <= tol * max(scale, 1.0), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_norm_and_decode_steps_match_jax(dtype):
    cfg, jcfg, p, jp = _layer0(dtype)
    rng = np.random.default_rng(11)
    C = TSSM.conv_dim(cfg)
    jx, tx = _pair(rng.standard_normal((BATCH, 24, C)).astype(np.float32), dtype)
    _close(TSSM.causal_conv(tx, p["conv_w"], p["conv_b"]),
           JSSM.causal_conv(jx, jp["conv_w"], jp["conv_b"]), dtype, "causal_conv")

    jxt, txt = _pair(rng.standard_normal((BATCH, C)).astype(np.float32), dtype)
    win = rng.standard_normal((BATCH, cfg.conv_width - 1, C)).astype(np.float32)
    jwin, twin = _pair(win, dtype)
    want, want_state = JSSM.conv_decode_step(jxt, jwin, jp["conv_w"], jp["conv_b"])
    got, got_state = TSSM.conv_decode_step(txt, twin, p["conv_w"], p["conv_b"])
    assert got_state is twin  # shifted in place
    _close(got, want, dtype, "conv_decode_step")
    assert np.array_equal(_f32(got_state), _f32(want_state))

    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    jxh, txh = _pair(rng.standard_normal((BATCH, H, P)).astype(np.float32), dtype)
    dt = np.log1p(np.exp(rng.standard_normal((BATCH, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    jb, tb = _pair(rng.standard_normal((BATCH, N)).astype(np.float32), dtype)
    jc, tc = _pair(rng.standard_normal((BATCH, N)).astype(np.float32), dtype)
    state = rng.standard_normal((BATCH, H, P, N)).astype(np.float32) * 0.2
    want, want_state = JSSM.ssd_decode_step(jxh, jnp.asarray(dt), jnp.asarray(A), jb, jc,
                                            jnp.asarray(state))
    t_state = torch.from_numpy(state.copy())
    got, got_state = TSSM.ssd_decode_step(txh, torch.from_numpy(dt), torch.from_numpy(A),
                                          tb, tc, t_state)
    assert got_state is t_state and got.dtype == txh.dtype
    _close(got, want, dtype, "ssd_decode_step y")
    _close(got_state, want_state, "float32", "ssd_decode_step state")

    jy, ty = _pair(rng.standard_normal((BATCH, 5, cfg.d_inner)).astype(np.float32), dtype)
    jz, tz = _pair(rng.standard_normal((BATCH, 5, cfg.d_inner)).astype(np.float32), dtype)
    got = TL.gated_rms_norm(ty, tz, p["norm_w"], cfg.norm_eps)
    assert got.dtype == ty.dtype
    _close(got, JL.gated_rms_norm(jy, jz, jp["norm_w"], jcfg.norm_eps), dtype,
           "gated_rms_norm")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_and_decode_match_jax(dtype, use_pallas):
    """One block over a 2-chunk sequence (output, final SSD state, raw conv
    tail), then 3 decode steps carried from that state."""
    cfg, jcfg, p, jp = _layer0(dtype)
    rng = np.random.default_rng(12)
    ju, tu = _pair(rng.standard_normal((BATCH, 2 * cfg.ssm_chunk, cfg.d_model))
                   .astype(np.float32), dtype)
    want, want_ssd, want_conv = JSSM.mamba_block(jp, jcfg, ju, use_pallas=use_pallas)
    got, ssd, conv = TSSM.mamba_block(p, cfg, tu)
    _close(got, want, dtype, "mamba_block out")
    assert ssd.dtype == torch.float32
    _close(ssd, want_ssd, dtype, "mamba_block ssd")
    _close(conv, want_conv, dtype, "mamba_block conv tail")

    conv, ssd = conv.clone(), ssd.clone()
    for step in range(3):
        ju, tu = _pair(rng.standard_normal((BATCH, cfg.d_model)).astype(np.float32), dtype)
        want, want_conv, want_ssd = JSSM.mamba_decode(jp, jcfg, ju, want_conv, want_ssd)
        got, conv, ssd = TSSM.mamba_decode(p, cfg, tu, conv, ssd)
        _close(got, want, dtype, f"mamba_decode step {step}")
        _close(ssd, want_ssd, dtype, f"mamba_decode ssd step {step}")
        _close(conv, want_conv, dtype, f"mamba_decode conv step {step}")


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_seq_logits_match_jax(dtype, use_pallas):
    cfg, jcfg = _configs(dtype)
    params, jparams = _weights(dtype)
    toks = _tokens(1, (BATCH, 2 * cfg.ssm_chunk), cfg.vocab_size)
    want, _, _ = jax.jit(functools.partial(
        JM.forward_seq, cfg=jcfg, use_pallas=use_pallas))(jparams, tokens=toks)
    got, cache = TM.forward_seq(params, cfg, torch.from_numpy(toks))
    assert cache is None
    _check(got, want, dtype, "forward_seq logits")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_teacher_forced_decode_match_jax(dtype, use_pallas):
    """Prefill one 64-token chunk, then 8 decode steps fed the same
    teacher tokens on both sides."""
    cfg, jcfg = _configs(dtype)
    params, jparams = _weights(dtype)
    toks = _tokens(2, (BATCH, cfg.ssm_chunk), cfg.vocab_size)
    teacher = _tokens(3, (STEPS, BATCH), cfg.vocab_size)

    prefill = jax.jit(functools.partial(JM.forward_prefill, cfg=jcfg, cache_window=16,
                                        use_pallas=use_pallas))
    decode = jax.jit(functools.partial(JM.forward_decode, cfg=jcfg, use_pallas=use_pallas))
    ref_logits, ref_cache = prefill(jparams, tokens=toks)
    logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks), cache_window=16)
    _check(logits, ref_logits, dtype, "prefill logits")
    assert set(cache) == set(ref_cache) == {"ssd", "conv", "pos"}
    assert cache["ssd"].dtype == torch.float32
    assert cache["conv"].dtype == cfg.torch_dtype
    for name in ("ssd", "conv"):
        assert tuple(cache[name].shape) == ref_cache[name].shape, name
        _check(cache[name], ref_cache[name], dtype, f"prefill cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))

    for step in range(STEPS):
        ref_logits, ref_cache = decode(jparams, token=teacher[step], cache=ref_cache)
        logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(teacher[step]),
                                          cache)
        _check(logits, ref_logits, dtype, f"decode step {step} logits")
    for name in ("ssd", "conv"):
        _check(cache[name], ref_cache[name], dtype, f"decode cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))


def test_param_tree_matches_reference_layout():
    """init_params gives the reference's keys, shapes and leaf types."""
    cfg, _ = _configs("bfloat16")
    port = TM.init_params(torch.Generator().manual_seed(0), cfg)
    _, jparams = _weights("bfloat16")

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tree.items()}

    assert layout(port) == layout(jparams)
    assert TM.count_params(port) == JM.count_params(jparams)


@pytest.mark.parametrize("reduced", [True, False])
def test_count_params_analytic_matches_jax(reduced):
    cfg = (get_reduced_config if reduced else get_config)(ARCH)
    jcfg = (jax_reduced_config if reduced else jax_config)(ARCH)
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)
    assert cfg.param_count() == JM.count_params_analytic(jcfg)


def test_unported_family_is_refused(monkeypatch):
    """A family the port does not know raises before anything is built
    (every family of the reference is ported: audio in
    tests/test_torch_audio.py)."""
    cfg = dataclasses.replace(get_reduced_config(ARCH), family="retrieval")

    def no_alloc(*args, **kwargs):
        raise AssertionError("nothing may be built before the check")

    monkeypatch.setattr(TM.L, "_normal", no_alloc)
    monkeypatch.setattr(TM.SSM, "init_mamba_block", no_alloc)
    tokens = torch.ones((1, 4), dtype=torch.int32)
    for fn in (TM.count_params_analytic,
               lambda c: TM.init_params(torch.Generator().manual_seed(0), c),
               lambda c: TM.forward_seq({}, c, tokens),
               lambda c: TM.forward_decode({}, c, tokens[:, 0], {"pos": tokens[:, 0]})):
        with pytest.raises(NotImplementedError, match="unknown family 'retrieval'"):
            fn(cfg)
