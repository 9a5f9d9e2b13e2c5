"""The port's serving engine and launcher against the JAX engine.

Same weights on both sides; greedy tokens must be equal. ``launch/serve.py
--reduced --device cpu`` is driven through its ``main``; its weights come
from its seed, so the test rebuilds them and hands them to JAX. A
CPU-tensor run never touches the CUDA build.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def _to_jax(params, dtype):
    if isinstance(params, dict):
        return {k: _to_jax(v, dtype) for k, v in params.items()}
    return jnp.asarray(params.float().numpy(), dtype)


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
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0}
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
