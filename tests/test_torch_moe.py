"""The port's MoE (moe family) against the JAX reference on the same inputs.

Inputs come from a numpy seed and go to both packages; weights are the
reference's ``init_moe`` / ``init_params`` carried over with
``params_from_numpy``.

* ``ref.moe_gmm_ref`` (what the CUDA kernel is held against, and what
  ``ops.moe_gmm`` runs for CPU tensors) against the JAX Pallas kernel in
  interpret mode and JAX's oracle, over tests/test_kernels.py's grid
  (E 2/4/8, C 16/100/128, D 64/130, F 64/96, f32 and bf16) at that
  file's tolerance: 2e-5 (f32) or 3e-2 (bf16) times max(|ref|, 1).
* ``moe_block`` and ``moe_decode`` on identical inputs in f32 and bf16:
  expert ids equal, slots and keeps equal to a plain loop that ranks the
  assignments choice-major, output within the same tolerance, aux loss
  within the f32 one (the router is f32 on both sides). One case drops
  assignments (capacity 8 for 32 tokens), one routes identical tokens.
* Reduced Mixtral and reduced Arctic (dense residual) in float32:
  ``forward_seq`` logits, the prefill cache and 8 teacher-forced decode
  steps that wrap a 16-slot ring, within 2e-5 x max(|ref|, 1), with every
  layer's expert ids equal on both sides; the JAX side runs with
  ``use_pallas`` off and on.
* Configs, parameter layout and counts against the reference's,
  including the full 32-layer Mixtral, computed without allocating.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.base import shared_fields  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels.py:19, x max(|ref|, 1)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ("mixtral-8x7b", "arctic-480b")
PROMPT, WINDOW, STEPS, BATCH = 24, 16, 8, 2


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    tol = TOL[dtype] * max(float(np.max(np.abs(want))), 1.0)
    assert err <= tol, (what, err, tol)


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(arr, JDT[dtype]), torch.from_numpy(arr).to(TDT[dtype])


def _gap(probs, k):
    """Smallest margin between the k-th and (k+1)-th router probability."""
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return float(np.min(top[:, k - 1] - top[:, k]))


# ------------------------------------------------------------ the kernel


GMM_GRID = list(itertools.product((2, 4, 8), (16, 100, 128), (64, 130), (64, 96),
                                  ("float32", "bfloat16")))


@pytest.mark.parametrize("E,C,D,F,dt", GMM_GRID)
def test_moe_gmm_ref_matches_jax(E, C, D, F, dt):
    rng = np.random.default_rng(E * C + D + F)
    jbuf, buf = _pair(rng.standard_normal((E, C, D)).astype(np.float32), dt)
    jw, w = _pair((rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32), dt)
    got = ref.moe_gmm_ref(buf, w)
    assert got.dtype == TDT[dt] and got.shape == (E, C, F)
    _close(got, jref.moe_gmm_ref(jbuf, jw), dt, "vs jax ref")
    pallas = jax_moe_gmm(jbuf, jw, block_c=32, block_d=64, block_f=64, interpret=True)
    _close(got, pallas, dt, "vs pallas interpret")
    # ops takes the plain version for CPU tensors, and counts no launch
    ops.reset_launch_counts()
    assert torch.equal(ops.moe_gmm(buf, w), got)
    assert ops.launch_counts()["moe_gmm"] == 0


def test_moe_gmm_ref_takes_the_strided_scatter_view():
    """buf as the block passes it: [:, :C] of an (E, C+1, D) buffer."""
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.standard_normal((4, 9, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 64, 96)).astype(np.float32))
    view = full[:, :8]
    assert not view.is_contiguous()
    assert torch.equal(ref.moe_gmm_ref(view, w), ref.moe_gmm_ref(view.contiguous(), w))


# ------------------------------------------------------------- the block


def _block_setup(dtype):
    cfg = dataclasses.replace(get_reduced_config("mixtral-8x7b"), dtype=dtype)
    jcfg = dataclasses.replace(jax_reduced_config("mixtral-8x7b"), dtype=dtype)
    jp = JMOE.init_moe(jax.random.PRNGKey(0), jcfg)
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, p, jp


def _jax_route(jp, jcfg, jxt):
    """The reference's router, as ``_moe_tokens`` computes it."""
    logits = (jxt.astype(jnp.float32) @ jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    return probs, jax.lax.top_k(probs, jcfg.experts_per_token)[1]


def _loop_slots(expert_ids, capacity):
    """Slot of every assignment, choice-major: all top-1 choices in token
    order, then all top-2 choices; each takes the next free slot of its
    expert."""
    T, K = expert_ids.shape
    used, slots = {}, []
    for j in range(K):
        for t in range(T):
            e = int(expert_ids[t, j])
            slots.append(used.get(e, 0))
            used[e] = slots[-1] + 1
    slots = np.asarray(slots)
    return slots, slots < capacity


# (name, tokens (B, S), capacity): free = the default capacity; drop = 8
# slots for 64 assignments over 4 experts; same = one token repeated, so
# every top-1 choice meets the same expert
BLOCK_CASES = [("free", (2, 8), None), ("drop", (2, 16), 8), ("same", (1, 32), 8)]


@pytest.mark.parametrize("name,shape,capacity", BLOCK_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(dtype, name, shape, capacity):
    cfg, jcfg, p, jp = _block_setup(dtype)
    rng = np.random.default_rng(len(name) + shape[1])
    x = rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    if name == "same":
        x[:] = x[:, :1]
    jx, tx = _pair(x, dtype)
    T = shape[0] * shape[1]
    C = capacity if capacity is not None else TMOE.moe_capacity(cfg, T)
    assert C == JMOE.moe_capacity(jcfg, T) or capacity is not None

    probs, _, ids = TMOE.route(p, cfg, tx.reshape(T, -1))
    jprobs, jids = _jax_route(jp, jcfg, jx.reshape(T, -1))
    assert np.array_equal(ids.numpy(), np.asarray(jids)), _gap(jprobs, cfg.experts_per_token)
    _close(probs, jprobs, "float32", "router probs")
    flat, slot, keep = TMOE.dispatch(ids, cfg.num_experts, C)
    want_slot, want_keep = _loop_slots(np.asarray(jids), C)
    assert np.array_equal(flat.numpy(), np.asarray(jids).T.reshape(-1))
    assert np.array_equal(slot.numpy(), want_slot)
    assert np.array_equal(keep.numpy(), want_keep)
    assert bool(keep.all()) == (name == "free")

    y, aux = TMOE.moe_block(p, cfg, tx, capacity, aux=True)
    jy, jaux = JMOE.moe_block(jp, jcfg, jx, capacity)
    assert y.dtype == TDT[dtype] and aux.dtype == torch.float32
    # the aux loss is computed only where it is asked for; the output is the same
    y_serve, none = TMOE.moe_block(p, cfg, tx, capacity)
    assert none is None and torch.equal(y_serve, y)
    _close(y, jy, dtype, "moe_block out")
    _close(aux, jaux, "float32", "aux loss")
    if name != "free":
        # a token whose every choice was dropped gets exactly 0
        dropped = ~keep.reshape(cfg.experts_per_token, T).any(0)
        assert torch.count_nonzero(y.reshape(T, -1)[dropped]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_matches_jax(dtype):
    cfg, jcfg, p, jp = _block_setup(dtype)
    x = np.random.default_rng(5).standard_normal((4, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = TMOE.moe_decode(p, cfg, tx)
    assert got.shape == (4, cfg.d_model) and got.dtype == TDT[dtype]
    _close(got, JMOE.moe_decode(jp, jcfg, jx), dtype, "moe_decode")
    assert torch.equal(got, TMOE.moe_block(p, cfg, tx[:, None])[0][:, 0])


# ------------------------------------------- what the kernel's skip needs
# The CUDA kernel skips a block whose slice of buf is all zero (an expert
# no token routes to) and writes 0 for it. These tests hold the property
# it relies on, on reduced Mixtral beside the JAX reference.


class _CaptureEinsum:
    """``jnp`` for the reference's MoE module, recording the first operand
    of its expert products (buf for gate and up, h for down)."""

    def __init__(self, seen):
        self._seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kwargs):
        if spec in ("ecd,edf->ecf", "ecf,efd->ecd"):
            self._seen.append(_f32(operands[0]))
        return jnp.einsum(spec, *operands, **kwargs)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_token_leaves_k_live_experts_in_each_buffer(dtype, seed, monkeypatch):
    """At T = 1 each (E, C, D) buffer passed to the expert products holds
    exactly K non-zero experts, each in slot 0 only (rows past its kept
    count of 1 are exactly 0), for gate, up and down (silu(0) * 0 = 0), and
    the JAX dispatch fills the same slots."""
    cfg, jcfg, p, jp = _block_setup(dtype)
    x = np.random.default_rng(seed).standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    seen, jseen = [], []

    def capture(buf, w, **kw):
        seen.append(buf.clone())
        return ref.moe_gmm_ref(buf, w)

    monkeypatch.setattr(ops, "moe_gmm", capture)
    monkeypatch.setattr(JMOE, "jnp", _CaptureEinsum(jseen))
    y, _ = TMOE.moe_block(p, cfg, tx)
    jy, _ = JMOE.moe_block(jp, jcfg, jx)
    _close(y, jy, dtype, "moe_block out")
    E, K = cfg.num_experts, cfg.experts_per_token
    C = TMOE.moe_capacity(cfg, 1)
    assert len(seen) == len(jseen) == 3
    _, _, ids = TMOE.route(p, cfg, tx.reshape(1, -1))
    for buf, jbuf in zip(seen, jseen):
        assert buf.shape[:2] == (E, C) and jbuf.shape[:2] == (E, C)
        live = (buf != 0).any(dim=-1)  # (E, C): rows holding a token
        assert int(live.any(dim=-1).sum()) == K
        assert sorted(int(e) for e in live.any(dim=-1).nonzero()) == sorted(ids[0].tolist())
        assert bool(live[:, 0].sum() == K) and not bool(live[:, 1:].any())
        assert np.array_equal(live.numpy(), np.any(jbuf != 0, axis=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_ref_gives_exact_zeros_for_zero_rows(dtype):
    """The plain version (the kernel's oracle) returns exactly 0 for a row
    of +0 or -0, as the JAX reference does, so the kernel's skip is held
    to exact zeros."""
    rng = np.random.default_rng(11)
    buf = rng.standard_normal((4, 8, 64)).astype(np.float32)
    buf[1] = 0.0   # an expert with no token
    buf[2, 3:] = -0.0  # an expert with 3 tokens
    jbuf, tbuf = _pair(buf, dtype)
    jw, w = _pair((rng.standard_normal((4, 64, 96)) * 64 ** -0.5).astype(np.float32), dtype)
    got = ref.moe_gmm_ref(tbuf, w)
    want = jref.moe_gmm_ref(jbuf, jw)
    for out in (_f32(got), _f32(want)):
        assert not np.any(out[1]) and not np.any(out[2, 3:])
        assert np.all(np.any(out[2, :3] != 0, axis=-1))
    _close(got, want, dtype, "vs jax ref")


# ------------------------------------------------------------- the model


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(get_reduced_config(arch), dtype=dtype),
            dataclasses.replace(jax_reduced_config(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype="float32"):
    """(port params, JAX params) holding identical values."""
    cfg, jcfg = _configs(arch, dtype)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return params_from_numpy(tree, cfg, device="cpu"), jparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, size=shape).astype(np.int32)


@pytest.fixture
def routing(monkeypatch):
    """Every MoE layer call's expert ids, in call order, on both sides:
    the port's from its router, the reference's recomputed from the
    router input inside the traced code and sent out by a debug callback."""
    seen = {"port": [], "jax": []}
    port_route, jax_tokens = TMOE.route, JMOE._moe_tokens

    def record_port(p, cfg, xt):
        probs, gates, ids = port_route(p, cfg, xt)
        seen["port"].append((ids.numpy().copy(), probs.numpy().copy()))
        return probs, gates, ids

    def record_jax(p, cfg, xt, capacity=None, constrain=None):
        probs, ids = _jax_route(p, cfg, xt)
        jax.debug.callback(lambda i, q: seen["jax"].append((np.asarray(i), np.asarray(q))),
                           ids, probs, ordered=True)
        return jax_tokens(p, cfg, xt, capacity, constrain)

    monkeypatch.setattr(TMOE, "route", record_port)
    monkeypatch.setattr(JMOE, "_moe_tokens", record_jax)
    return seen


def _same_routing(seen, k):
    jax.effects_barrier()
    assert len(seen["port"]) == len(seen["jax"]) > 0
    gaps = []
    for n, ((ids, probs), (jids, _)) in enumerate(zip(seen["port"], seen["jax"])):
        gaps.append(_gap(probs, k))
        assert np.array_equal(ids, jids), (f"layer call {n}: expert ids differ", gaps[-1])
    print(f"{len(gaps)} MoE layer calls, expert ids equal; smallest top-{k} router gap "
          f"{min(gaps):.3g}")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_logits_match_jax(arch, use_pallas, routing):
    cfg, jcfg = _configs(arch)
    params, jparams = _weights(arch)
    toks = _tokens(1, (BATCH, 33), cfg.vocab_size)
    want, _, _ = jax.jit(functools.partial(
        JM.forward_seq, cfg=jcfg, use_pallas=use_pallas))(jparams, tokens=toks)
    got, cache = TM.forward_seq(params, cfg, torch.from_numpy(toks))
    assert cache is None
    _close(got, want, "float32", "forward_seq logits")
    _same_routing(routing, cfg.experts_per_token)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_teacher_forced_decode_match_jax(arch, use_pallas, routing):
    """Prefill a 24-token prompt into a 16-slot ring, then 8 decode steps
    fed the same teacher tokens on both sides: the ring wraps."""
    cfg, jcfg = _configs(arch)
    params, jparams = _weights(arch)
    toks = _tokens(2, (BATCH, PROMPT), cfg.vocab_size)
    teacher = _tokens(3, (STEPS, BATCH), cfg.vocab_size)

    prefill = jax.jit(functools.partial(
        JM.forward_prefill, cfg=jcfg, cache_window=WINDOW, use_pallas=use_pallas))
    decode = jax.jit(functools.partial(JM.forward_decode, cfg=jcfg, use_pallas=use_pallas))
    ref_logits, ref_cache = prefill(jparams, tokens=toks)
    logits, cache = TM.forward_prefill(params, cfg, torch.from_numpy(toks),
                                       cache_window=WINDOW)
    _close(logits, ref_logits, "float32", "prefill logits")
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name], "float32", f"prefill cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))

    for step in range(STEPS):
        ref_logits, ref_cache = decode(jparams, token=teacher[step], cache=ref_cache)
        logits, cache = TM.forward_decode(params, cfg, torch.from_numpy(teacher[step]),
                                          cache)
        _close(logits, ref_logits, "float32", f"decode step {step} logits")
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name], "float32", f"decode cache {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    # one call per layer for the prefill and for each decode step
    assert len(routing["port"]) == cfg.num_layers * (1 + STEPS)
    _same_routing(routing, cfg.experts_per_token)


# ------------------------------------------------- configs, layout, counts


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_keeps_the_router_float32(arch):
    """In a bf16 tree the router stays float32, as the reference keeps it;
    every other leaf is bf16; no value changes."""
    params, jparams = _weights(arch, "bfloat16")
    for name, leaf in jparams["blocks"]["moe"].items():
        want = torch.float32 if name == "router" else torch.bfloat16
        assert params["blocks"]["moe"][name].dtype == want, name
        assert np.array_equal(_f32(params["blocks"]["moe"][name]), _f32(leaf)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference_layout(arch):
    """init_params gives the reference's keys, shapes and leaf types
    (``dense_mlp`` beside ``moe`` for Arctic)."""
    cfg, _ = _configs(arch, "bfloat16")
    port = TM.init_params(torch.Generator().manual_seed(0), cfg)
    _, jparams = _weights(arch, "bfloat16")

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tree.items()}

    assert layout(port) == layout(jparams)
    assert ("dense_mlp" in port["blocks"]) == cfg.dense_residual
    assert TM.count_params(port) == JM.count_params(jparams)
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jax_reduced_config(arch))


def test_configs_match_the_reference():
    """Field for field: the published and reduced Mixtral, the published
    and reduced Arctic; the one-card cut differs from the published config
    in name and depth only. The port's own field keeps the reference's
    capacity in every config of the port."""
    def fields(cfg):
        return dataclasses.asdict(cfg)

    assert shared_fields(get_config("mixtral-8x7b")) == fields(jax_config("mixtral-8x7b"))
    for arch in ARCHS:
        assert shared_fields(get_reduced_config(arch)) == fields(jax_reduced_config(arch))
    cut = get_config("mixtral-8x7b-16l")
    assert shared_fields(cut) == {**fields(jax_config("mixtral-8x7b")),
                                  "name": "mixtral-8x7b-16l", "num_layers": 16}
    assert shared_fields(get_config("arctic-480b")) == fields(jax_config("arctic-480b"))
    assert {get_config(a).moe_capacity_factor for a in ARCHS + ("mixtral-8x7b-16l",)} == {
        JMOE.CAPACITY_FACTOR}


@pytest.mark.parametrize("arch,layers,count", [
    ("mixtral-8x7b", 32, 46_702_792_704),
    ("mixtral-8x7b-16l", 16, 23_482_470_400),
])
def test_count_params_analytic_matches_jax_at_full_width(arch, layers, count):
    """Counted from the config alone, nothing allocated."""
    cfg = get_config(arch)
    jcfg = dataclasses.replace(jax_config("mixtral-8x7b"), num_layers=layers)
    assert TM.count_params_analytic(cfg) == JM.count_params_analytic(jcfg) == count
    assert cfg.param_count() == count
    assert TMOE.moe_param_count(cfg) == JMOE.moe_param_count(jcfg)
