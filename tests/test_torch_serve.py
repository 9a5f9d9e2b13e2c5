"""The port's serving engine and launcher against the JAX engine.

Same weights on both sides; greedy tokens must be equal, for the dense
(qwen2.5-3b), the ssm (mamba2-1.3b) and the moe (mixtral-8x7b, and
arctic-480b with its dense residual) paths. A model too large for the
card is refused before anything is allocated. ``launch/serve.py
--reduced --device cpu`` is driven through its ``main``; its weights come
from its seed, so the test rebuilds them and hands them to JAX. A
CPU-tensor run never touches the CUDA build.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def _to_jax(params, dtype):
    """The port's parameters as JAX arrays: float32 leaves stay float32
    (Mamba2's A_log, dt_bias, D), the others take ``dtype``."""
    if isinstance(params, dict):
        return {k: _to_jax(v, dtype) for k, v in params.items()}
    keep = params.dtype == torch.float32
    return jnp.asarray(params.float().numpy(), jnp.float32 if keep else dtype)


def test_engine_generates_the_jax_engine_tokens():
    """Quickstart-shaped batch (prompts of 8, 19 and 33 tokens,
    left-padded together) on the reference's own init weights."""
    jcfg = jax_reduced_config("qwen2.5-3b")
    cfg = get_reduced_config("qwen2.5-3b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)]
               for n in (8, 19, 33)]
    ref = JaxEngine(jcfg, jparams, cache_window=128).generate(prompts, max_new_tokens=8)
    got = ServingEngine(cfg, params, cache_window=128, device="cpu").generate(
        prompts, max_new_tokens=8)
    assert got.tokens == ref.tokens
    assert got.prefill_s > 0 and got.decode_s > 0 and got.tokens_per_s > 0


def test_serve_cli_reduced_cpu_matches_jax_engine(monkeypatch, capsys):
    """The launcher's loop on the CPU: every served request's greedy
    tokens equal the JAX engine's on the same (seeded) weights, and the
    CPU run neither builds nor launches a CUDA kernel."""
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU run must not touch the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    ops.reset_launch_counts()
    served = serve_mod.main(["--reduced", "--device", "cpu", "--requests", "3",
                             "--max-new", "6", "--seed", "0"])
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "moe_gmm": 0, "moe_gmm_grouped": 0}
    out = capsys.readouterr().out
    assert "serving qwen2.5-3b-reduced (reduced" in out and out.count("req ") == 3
    assert len(served) == 3

    cfg = get_reduced_config("qwen2.5-3b")
    params = ServingEngine(cfg, seed=0, device="cpu").params
    jax_engine = JaxEngine(jax_reduced_config("qwen2.5-3b"),
                           _to_jax(params, jnp.bfloat16),
                           cache_window=serve_mod.CACHE_WINDOW)
    for rec in served:
        assert len(rec.prompt) in (8, 24, 48)
        assert rec.allocation.vcpus >= 1 and rec.allocation.mem_mb >= 128
        ref = jax_engine.generate([rec.prompt], max_new_tokens=6)
        assert rec.result.tokens == ref.tokens


def test_engine_defaults_to_cuda_and_kernels():
    """Entry points run on the card unless the caller asks for the CPU."""
    import inspect

    sig = inspect.signature(ServingEngine.__init__).parameters
    assert sig["device"].default == "cuda" and sig["use_kernels"].default is True
    assert inspect.signature(serve_mod.serve).parameters["device"].default == "cuda"


def test_engine_pads_ssm_prompts_to_a_chunk_multiple():
    """Every batch, an ssm or hybrid one too, is left-padded only to its
    longest prompt: the SSD scan pads its own tail to a whole chunk with
    rows that leave the state as it was (``kernels/ops.py``). The JAX
    engine pads an ssm or hybrid batch to a multiple of the chunk; the
    port's batch is that batch's last columns, and its logits over them
    are exact: the JAX model's at a chunk that divides the length, in
    float32 within 2e-5 x max(|ref|, 1)."""
    prompts = [[5] * 10, [7] * 70]
    for arch, jax_width in (("mamba2-1.3b", 128), ("zamba2-7b", 128), ("qwen2.5-3b", 70)):
        cfg = get_reduced_config(arch)
        jcfg = jax_reduced_config(arch)
        engine = ServingEngine(cfg, {}, device="cpu")
        got = engine._pad_batch(prompts)
        # the JAX engine's padding reads only its config: no model is built
        want, _ = JaxEngine._pad_batch(SimpleNamespace(cfg=jcfg), prompts)
        assert got.shape == (2, 70) and np.asarray(want).shape == (2, jax_width)
        assert np.array_equal(got.numpy(), np.asarray(want)[:, -70:])
        if cfg.family == "dense":
            continue
        import dataclasses

        from repro.models.model import forward_seq as jax_forward_seq
        from repro_torch.models.model import forward_seq

        cfg32 = dataclasses.replace(cfg, dtype="float32")
        jcfg32 = dataclasses.replace(jcfg, dtype="float32", ssm_chunk=10)  # 10 divides 70
        jparams = jax_init_params(jax.random.PRNGKey(0), jcfg32)
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg32,
                                   device="cpu")
        logits, _ = forward_seq(params, cfg32, got.long())
        ref_logits = jax_forward_seq(jparams, jcfg32, jnp.asarray(got.numpy()))[0]
        ref_logits = np.asarray(ref_logits)
        err = float(np.abs(logits.numpy() - ref_logits).max())
        assert err <= 2e-5 * max(float(np.abs(ref_logits).max()), 1.0), (arch, err)


def test_serve_cli_mamba2_reduced_cpu_matches_jax_engine(monkeypatch, capsys):
    """``--arch mamba2-1.3b --reduced --device cpu``: the ssm path through
    the launcher's loop, no CUDA kernel touched, greedy tokens equal to the
    JAX engine's on the same weights."""
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU run must not touch the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    ops.reset_launch_counts()
    served = serve_mod.main(["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "6", "--seed", "0"])
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "moe_gmm": 0, "moe_gmm_grouped": 0}
    out = capsys.readouterr().out
    assert "serving mamba2-1.3b-reduced (reduced, ssm, bfloat16)" in out
    assert out.count("req ") == 3 and len(served) == 3

    cfg = get_reduced_config("mamba2-1.3b")
    params = ServingEngine(cfg, seed=0, device="cpu").params
    assert params["blocks"]["mamba"]["A_log"].dtype == torch.float32
    # the port pads the prompts (8, 24 or 48 tokens) to their own length;
    # the JAX engine pads to a multiple of its chunk, here 8 (the SSD's
    # result at any chunk is the same recurrence), so both prefill the
    # same unpadded prompt
    import dataclasses

    jax_engine = JaxEngine(dataclasses.replace(jax_reduced_config("mamba2-1.3b"), ssm_chunk=8),
                           _to_jax(params, jnp.bfloat16),
                           cache_window=serve_mod.CACHE_WINDOW)
    for rec in served:
        assert len(rec.prompt) in (8, 24, 48)
        ref = jax_engine.generate([rec.prompt], max_new_tokens=6)
        assert rec.result.tokens == ref.tokens


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_serve_cli_moe_reduced_cpu_matches_jax_engine(arch, monkeypatch, capsys):
    """``--arch <moe> --reduced --device cpu``: the moe path through the
    launcher's loop, no CUDA kernel touched; each request's bf16 tokens are
    the engine's on the seeded weights, and on those weights widened to
    float32 the engine's greedy tokens equal the JAX engine's. (In bf16
    the two frameworks round the router's input differently, and reduced
    Arctic's top-2 order flips at a near-tie in its first layer, so bf16
    tokens are no parity test of the moe path; the block is held to JAX
    in bf16 on identical inputs in tests/test_torch_moe.py.)"""
    import dataclasses

    def no_build(*args, **kwargs):
        raise AssertionError("a CPU run must not touch the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    ops.reset_launch_counts()
    served = serve_mod.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "6", "--seed", "0"])
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "moe_gmm": 0, "moe_gmm_grouped": 0}
    out = capsys.readouterr().out
    assert f"serving {arch}-reduced (reduced, moe, bfloat16)" in out
    assert out.count("req ") == 3 and len(served) == 3

    cfg = get_reduced_config(arch)
    engine = ServingEngine(cfg, seed=0, cache_window=serve_mod.CACHE_WINDOW, device="cpu")
    assert engine.params["blocks"]["moe"]["router"].dtype == torch.float32
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


def test_model_larger_than_the_card_is_refused_before_allocating(monkeypatch):
    """``--arch mixtral-8x7b`` on CUDA: 93.4 GB of bf16 weights against an
    80 GB card (a fake device, so no card is needed) raises and names the
    one-card cut; the 16-layer cut (47.0 GB) passes the same check."""
    card = SimpleNamespace(total_memory=80 * 10 ** 9)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: card)

    def no_alloc(*args, **kwargs):
        raise AssertionError("nothing may be allocated before the check")

    monkeypatch.setattr(engine_mod, "init_params", no_alloc)
    with pytest.raises(ValueError, match="93.4 GB.*80.0 GB.*mixtral-8x7b-16l"):
        serve_mod.main(["--arch", "mixtral-8x7b", "--requests", "1"])
    engine_mod._check_fits(get_config("mixtral-8x7b-16l"), torch.device("cuda"))


def _prefill(engine, prompts):
    """The engine's prefill as ``generate`` runs it: (greedy token, cache)."""
    from repro_torch.models.model import forward_prefill

    cfg = engine.cfg
    tokens = engine._pad_batch(prompts)

    def zeros(n):
        return torch.zeros((len(prompts), n, cfg.d_model), dtype=cfg.torch_dtype)

    logits, cache = forward_prefill(
        engine.params, cfg, tokens, cache_window=engine.cache_window,
        frame_embeds=zeros(cfg.encoder_seq) if cfg.is_encoder_decoder else None,
        patch_embeds=zeros(cfg.frontend_tokens) if cfg.family == "vlm" else None)
    return torch.argmax(logits, -1).to(torch.int32), cache


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b", "zamba2-7b", "whisper-tiny"])
def test_decode_graph_body_equals_the_eager_loop(arch):
    """The step a CUDA graph records, run eagerly on the CPU: on buffers
    that still hold an earlier call's token, cache and positions, a call
    of other prompt lengths copied in gives the eager loop's tokens, cache
    and positions, tensor for tensor."""
    from repro_torch.models.model import forward_decode

    engine = ServingEngine(get_reduced_config(arch), seed=0, cache_window=32, device="cpu")
    rng = np.random.default_rng(1)

    def prompts(*lengths):
        return [[int(t) for t in rng.integers(1, engine.cfg.vocab_size, size=n)]
                for n in lengths]

    with torch.inference_mode():
        tok_a, cache_a = _prefill(engine, prompts(5, 9))
        graph = engine_mod.DecodeGraph(engine.params, engine.cfg, True, tok_a, cache_a)
        graph.load(tok_a, cache_a)
        for _ in range(3):
            graph.step()
        tok_b, cache_b = _prefill(engine, prompts(14, 3))
        assert engine_mod.cache_key(cache_b) == engine_mod.cache_key(cache_a)
        assert not torch.equal(graph.cache["pos"], cache_b["pos"])

        tok, cache, want = tok_b, {k: v.clone() for k, v in cache_b.items()}, []
        for _ in range(5):
            logits, cache = forward_decode(engine.params, engine.cfg, tok, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)
            want.append(tok.tolist())
        graph.load(tok_b, cache_b)
        got = []
        for _ in range(5):
            graph.step()
            got.append(graph.tok.tolist())
    assert got == want
    assert graph.tok.dtype == torch.int32 and torch.equal(graph.logits, logits)
    assert graph.cache.keys() == cache.keys()
    for k, v in cache.items():
        assert torch.equal(graph.cache[k], v), k
    assert torch.equal(graph.cache["pos"], cache_b["pos"] + 5)
