"""The port's training path against the JAX reference on the same inputs.

Inputs come from a numpy seed and go to both packages; model weights are
the reference's ``init_params`` carried over with ``params_from_numpy``,
or, for whole training runs, a step-0 checkpoint the reference writes.

* ``SyntheticTokenPipeline.batch_at`` equals the reference's, array for
  array, over several steps, seeds and shapes.
* ``lr_schedule`` over warmup and decay and ``global_norm`` within 1e-6
  relative; one ``adamw_update`` on the same params, grads and state
  (clipping active, mixed ranks, bf16 and float32 params) within 1e-6 of
  each leaf's largest value, with float32 moments, and with bf16 moments
  within one bf16 ulp of the reference element by element; the update
  run in small slices equals the update run whole, bit for bit.
* ``cross_entropy``, and ``forward_train``'s loss and every gradient leaf
  in float32 against ``jax.value_and_grad`` of the reference's
  ``forward_train`` for reduced qwen2.5-3b, mixtral-8x7b (its aux loss
  included, every layer's expert ids equal), mamba2-1.3b and zamba2-7b
  (S = 256) and internvl2-76b (zero patch embeddings): per leaf,
  max |dg| <= 1e-4 x max |g_ref|. ``remat`` changes neither the loss nor
  a gradient by more than 1e-6 of its scale.
* Whole runs: the reference writes a step-0 checkpoint; both ``train``s
  resume from it for 4 float32 steps on reduced qwen2.5-3b and mixtral.
  Losses and grad norms agree within 1e-5 relative at every step, and the
  final params within 0.1 x lr per element (Adam turns the sign of a
  gradient that is rounding noise into a step of up to lr), with each
  leaf's median difference within 1e-4 x lr. Each package restores the
  other's final checkpoint exactly.
* Checkpoints: the port writes a file byte-equal to the reference's for
  the same bf16 and float32 params and opt state, and reads the
  reference's (bfloat16 leaves included), in a process where ``msgpack``
  and ``ml_dtypes`` cannot be imported. The MessagePack subset packs as
  ``msgpack`` does at every header size.
* Resume equals an uninterrupted run; the CLI trains on the CPU with a
  falling loss, caps whisper-tiny's sequence at 448 behind zero frame
  embeddings, and refuses an unknown arch.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training import data as JDATA  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro.training import train_loop as JLOOP  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import _msgpack  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training import data as TDATA  # noqa: E402
from repro_torch.training import optimizer as TOPT  # noqa: E402
from repro_torch.training import train_loop as TLOOP  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-4  # per leaf, x max |g_ref|
OPT_TOL = 1e-6  # float32 optimizer arithmetic, relative
LOOP_REL = 1e-5  # whole-run losses and grad norms, relative
REMAT_TOL = 1e-6
# final params of a 4-step run, per element in units of lr: Adam moves an
# element whose gradient is rounding noise (qwen's k bias: softmax ignores
# it) by up to lr a step in either framework; measured 0.027 x lr at worst
# and a median of at most 2.1e-5 x lr in a leaf
PARAM_MAX_LR, PARAM_MEDIAN_LR = 0.1, 1e-4
GRAD_ARCHS = {"qwen2.5-3b": 64, "mixtral-8x7b": 64, "mamba2-1.3b": 256, "zamba2-7b": 256,
              "internvl2-76b": 64}


def _configs(arch, dtype="float32"):
    cfg = dataclasses.replace(get_reduced_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype=dtype)
    return cfg, jcfg


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 16, 4, 9), (1024, 64, 2, 0),
                                                  (32_000, 33, 3, 5)])
def test_batch_at_equals_reference(vocab, seq, batch, seed):
    cfg = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed)
    mine = TDATA.SyntheticTokenPipeline(TDATA.DataConfig(**cfg))
    ref = JDATA.SyntheticTokenPipeline(JDATA.DataConfig(**cfg))
    for step in (0, 1, 2, 7, 100):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (step, k)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    cfg = dict(lr=6e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    mine, ref = TOPT.AdamWConfig(**cfg), JOPT.AdamWConfig(**cfg)
    for step in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 150):
        got = float(TOPT.lr_schedule(mine, torch.tensor(step, dtype=torch.int32)))
        want = float(JOPT.lr_schedule(ref, jnp.array(step, jnp.int32)))
        assert got == pytest.approx(want, rel=OPT_TOL, abs=1e-12), step
    assert float(TOPT.lr_schedule(mine, 5)) == pytest.approx(3e-4)
    assert float(TOPT.lr_schedule(mine, 100)) == pytest.approx(6e-5, rel=1e-5)


# leaf path -> shape; "embed" is a bf16 parameter, the rest float32
OPT_LEAVES = {"blocks/w": (3, 8, 16), "blocks/norm": (3, 8), "embed": (32, 8), "bias": (16,)}


def _unflat(flat):
    out = {}
    for key, leaf in flat.items():
        *parents, last = key.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _opt_inputs(seed, moment_dtype):
    """Params, grads and moments (p, g, m, v) as (port, reference) trees:
    the grads' global norm is well above grad_clip = 1, the moments live."""
    rng = np.random.default_rng(seed)
    vals = {k: {"p": rng.standard_normal(shape), "g": 3 * rng.standard_normal(shape),
                "m": rng.standard_normal(shape), "v": 0.1 * rng.random(shape)}
            for k, shape in OPT_LEAVES.items()}

    def dtype(name, key):
        if name in "mv":
            return moment_dtype
        return "bfloat16" if key == "embed" else "float32"

    def side(name, conv):
        return _unflat({k: conv(v[name].astype(np.float32), dtype(name, k))
                        for k, v in vals.items()})

    port = {n: side(n, lambda a, d: torch.from_numpy(a).to(getattr(torch, d))) for n in "pgmv"}
    ref = {n: side(n, lambda a, d: jnp.asarray(a, getattr(jnp, d))) for n in "pgmv"}
    return port, ref


def _ulp_bf16(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    kw = dict(lr=1e-2, warmup_steps=4, total_steps=20, moment_dtype=moment_dtype)
    mine, ref = TOPT.AdamWConfig(**kw), JOPT.AdamWConfig(**kw)
    port, jx = _opt_inputs(3, moment_dtype)
    gn_ref = float(JOPT.global_norm(jx["g"]))
    assert float(TOPT.global_norm(port["g"])) == pytest.approx(gn_ref, rel=OPT_TOL)
    assert gn_ref > mine.grad_clip
    jstate = {"step": jnp.array(7, jnp.int32), "m": jx["m"], "v": jx["v"]}
    tstate = {"step": torch.tensor(7, dtype=torch.int32), "m": port["m"], "v": port["v"]}
    jp, js, jm = JOPT.adamw_update(ref, jx["p"], jx["g"], jstate)
    tp, ts, tm = TOPT.adamw_update(mine, port["p"], port["g"], tstate)
    assert tp is port["p"] and ts["m"] is port["m"]  # written in place
    assert int(ts["step"]) == 8 and ts["step"].dtype == torch.int32
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=OPT_TOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=OPT_TOL)
    for name, got, want in (("p", tp, jp), ("m", ts["m"], js["m"]), ("v", ts["v"], js["v"])):
        got = _flat(got)
        for key, w in _flat(want).items():
            assert str(got[key].dtype) == f"torch.{w.dtype}", (name, key)
            gv, wv = _np(got[key]), _np(w)
            if got[key].dtype == torch.bfloat16:
                assert np.all(np.abs(gv - wv) <= _ulp_bf16(wv)), (name, key)
            else:
                err = np.max(np.abs(gv - wv))
                assert err <= OPT_TOL * np.max(np.abs(wv)), (name, key, err)


def test_adamw_update_in_slices_equals_whole_leaves(monkeypatch):
    cfg = TOPT.AdamWConfig(lr=1e-2, warmup_steps=0, moment_dtype="bfloat16")
    outs = []
    for slice_elements in (TOPT.SLICE_ELEMENTS, 7):
        monkeypatch.setattr(TOPT, "SLICE_ELEMENTS", slice_elements)
        port, _ = _opt_inputs(4, "bfloat16")
        state = {"step": torch.tensor(2, dtype=torch.int32), "m": port["m"], "v": port["v"]}
        p, st, _ = TOPT.adamw_update(cfg, port["p"], port["g"], state)
        outs.append(_flat({"p": p, "m": st["m"], "v": st["v"]}))
    for key, leaf in outs[0].items():
        assert torch.equal(leaf, outs[1][key]), key


def test_init_opt_state_mirrors_params():
    params = {"a": torch.ones(2, 3), "n": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    st = TOPT.init_opt_state(TOPT.AdamWConfig(moment_dtype="bfloat16"), params)
    assert sorted(st) == ["m", "step", "v"] and st["step"].dtype == torch.int32
    assert st["m"]["n"]["b"].dtype == torch.bfloat16 and st["v"]["a"].shape == (2, 3)
    assert float(st["m"]["a"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    want = np.asarray(JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = TM.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _grad_inputs(arch, seq):
    cfg, jcfg = _configs(arch)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, size=(2, seq + 1)).astype(np.int32)
    patches = (np.zeros((2, cfg.frontend_tokens, cfg.d_model), np.float32)
               if cfg.family == "vlm" else None)
    return cfg, jcfg, params, jparams, toks[:, :-1], toks[:, 1:], patches


def _port_grads(params, cfg, tokens, labels, patches, remat):
    leaves = {k: v.clone().requires_grad_() for k, v in _flat(params).items()}

    def unflat(prefix, node):
        return {k: unflat(f"{prefix}{k}/", v) if isinstance(v, dict) else leaves[prefix + k]
                for k, v in node.items()}

    p = unflat("", params)
    loss, metrics = TM.forward_train(
        p, cfg, torch.from_numpy(tokens), torch.from_numpy(labels),
        patch_embeds=None if patches is None else torch.from_numpy(patches), remat=remat)
    loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            {k: v.grad for k, v in leaves.items()})


def _port_expert_ids(monkeypatch):
    """Every port MoE layer call's expert ids, in call order, from now on."""
    seen, route = [], TMOE.route

    def record(p, cfg, xt):
        probs, gates, ids = route(p, cfg, xt)
        seen.append(ids.detach().numpy().copy())
        return probs, gates, ids

    monkeypatch.setattr(TMOE, "route", record)
    return seen


def _jax_expert_ids(monkeypatch, jparams, jcfg, tokens):
    """Every reference MoE layer call's expert ids in one forward pass,
    recomputed from the router input and sent out by a debug callback."""
    seen, moe_tokens = [], JMOE._moe_tokens

    def record(p, cfg, xt, capacity=None, constrain=None):
        probs = jax.nn.softmax((xt.astype(jnp.float32) @ p["router"]).astype(jnp.float32), -1)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)),
                           jax.lax.top_k(probs, cfg.experts_per_token)[1], ordered=True)
        return moe_tokens(p, cfg, xt, capacity, constrain)

    monkeypatch.setattr(JMOE, "_moe_tokens", record)
    jax.jit(functools.partial(JM.forward_seq, cfg=jcfg))(jparams, tokens=jnp.asarray(tokens))
    jax.effects_barrier()
    return seen


@pytest.mark.parametrize("arch", sorted(GRAD_ARCHS))
def test_forward_train_gradients_match_reference(arch, monkeypatch):
    cfg, jcfg, params, jparams, tokens, labels, patches = _grad_inputs(arch, GRAD_ARCHS[arch])

    def loss_fn(p):
        return JM.forward_train(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels),
                                patch_embeds=None if patches is None else jnp.asarray(patches),
                                remat=False)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    port_ids = _port_expert_ids(monkeypatch)
    loss, metrics, grads = _port_grads(params, cfg, tokens, labels, patches, remat=False)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    assert float(metrics["ce_loss"]) == pytest.approx(float(jmetrics["ce_loss"]), rel=1e-6)
    assert float(metrics["aux_loss"]) == pytest.approx(float(jmetrics["aux_loss"]), rel=1e-5,
                                                       abs=1e-7)
    if cfg.family == "moe":
        assert float(jmetrics["aux_loss"]) > 1.0  # the aux term reaches the total
        jax_ids = _jax_expert_ids(monkeypatch, jparams, jcfg, tokens)
        assert len(port_ids) == len(jax_ids) == cfg.num_layers
        for got, want in zip(port_ids, jax_ids):
            assert np.array_equal(got, want)
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(grads) == sorted(jflat)
    for key, want in jflat.items():
        got = _np(grads[key])
        err = float(np.max(np.abs(got - want)))
        scale = float(np.max(np.abs(want)))
        assert err <= GRAD_TOL * scale, (key, err, scale)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-7b"])
def test_remat_gives_the_same_loss_and_gradients(arch, monkeypatch):
    cfg, _, params, _, tokens, labels, patches = _grad_inputs(arch, 64 if arch != "zamba2-7b"
                                                              else 128)
    plain = _port_grads(params, cfg, tokens, labels, patches, remat=False)
    calls, checkpoint = [], TM.checkpoint
    monkeypatch.setattr(TM, "checkpoint", lambda *a, **kw: calls.append(kw) or checkpoint(*a, **kw))
    remat = _port_grads(params, cfg, tokens, labels, patches, remat=True)
    assert calls == [{"use_reentrant": False}] * cfg.num_layers
    assert float(remat[0]) == pytest.approx(float(plain[0]), rel=REMAT_TOL)
    for key, g in plain[2].items():
        err = float((remat[2][key] - g).abs().max())
        assert err <= REMAT_TOL * max(float(g.abs().max()), 1e-30), key


def test_forward_seq_is_unchanged_by_the_aux_loss():
    """Serving keeps its return value and computes no aux loss (no MoE
    call asks for one); the aux losses reach only the loss."""
    cfg, _, params, _, tokens, labels, _ = _grad_inputs("mixtral-8x7b", 16)
    logits, auxes, cache = TM._forward(params, cfg, torch.from_numpy(tokens), use_kernels=False)
    assert auxes == [] and cache is None
    logits, cache = TM.forward_seq(params, cfg, torch.from_numpy(tokens), use_kernels=False)
    assert cache is None and logits.shape == (2, 16, cfg.vocab_size)
    total, m = TM.forward_train(params, cfg, torch.from_numpy(tokens), torch.from_numpy(labels))
    assert float(total) == pytest.approx(float(m["ce_loss"] + cfg.router_aux_weight
                                               * m["aux_loss"]), rel=1e-7)


# ---------------------------------------------------------------------------
# Whole training runs
# ---------------------------------------------------------------------------


def _step0_checkpoint(jcfg, opt_cfg, path):
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    JCK.save_checkpoint(str(path), step=0, params=params,
                        opt_state=JOPT.init_opt_state(opt_cfg, params))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b"])
def test_train_matches_reference_from_the_same_checkpoint(arch, tmp_path, capsys):
    steps, lr = 4, 1e-3
    cfg, jcfg = _configs(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, batch_size=2, seed=3)
    okw = dict(lr=lr, warmup_steps=2, total_steps=steps)
    start = tmp_path / "step0.msgpack"
    _step0_checkpoint(jcfg, JOPT.AdamWConfig(**okw), start)
    runs = {}
    for name, mod, c in (("jax", JLOOP, jcfg), ("port", TLOOP, cfg)):
        loop = mod.TrainLoopConfig(steps=steps, log_every=1, ckpt_every=steps,
                                   ckpt_dir=str(tmp_path / name))
        extra = {} if name == "jax" else {"device": "cpu"}
        data = (JDATA if name == "jax" else TDATA).DataConfig(**kw)
        opt = (JOPT if name == "jax" else TOPT).AdamWConfig(**okw)
        runs[name] = mod.train(c, data_cfg=data, opt_cfg=opt, loop=loop,
                               resume_from=str(start), **extra)
    out = capsys.readouterr().out
    assert out.count(f"step {steps:5d} loss=") == 2
    ref, got = runs["jax"], runs["port"]
    assert got["step"] == ref["step"] == list(range(1, steps + 1))
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOOP_REL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=LOOP_REL)
    jfinal = _flat(jax.tree_util.tree_map(np.asarray, ref["final_params"]))
    tfinal = _flat(got["final_params"])
    for key, want in jfinal.items():
        diff = np.abs(_np(tfinal[key]) - want)
        assert diff.max() <= PARAM_MAX_LR * lr, (key, diff.max() / lr)
        assert np.median(diff) <= PARAM_MEDIAN_LR * lr, (key, np.median(diff) / lr)
    # each package restores the other's final checkpoint exactly
    name = f"ckpt_{steps:06d}.msgpack"
    jb = JCK.load_checkpoint(str(tmp_path / "port" / name))
    assert jb["step"] == steps
    jp = JCK.restore_into(ref["final_params"], jb["params"])
    for key, leaf in _flat(jax.tree_util.tree_map(np.asarray, jp)).items():
        assert np.array_equal(leaf, _np(tfinal[key])), key
    tb = TCK.load_checkpoint(str(tmp_path / "jax" / name))
    tp = TCK.restore_into(got["final_params"], tb["params"])
    topt = TCK.restore_into(TOPT.init_opt_state(TOPT.AdamWConfig(), got["final_params"]),
                            tb["opt_state"])
    assert int(topt["step"]) == steps
    for key, leaf in _flat(tp).items():
        assert np.array_equal(_np(leaf), jfinal[key]), key


def test_resume_equals_an_uninterrupted_run(tmp_path):
    cfg = dataclasses.replace(get_reduced_config("mixtral-8x7b"), dtype="float32")
    data = TDATA.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
    opt = TOPT.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)

    def run(resume=None):
        loop = TLOOP.TrainLoopConfig(steps=6, log_every=1, ckpt_every=3,
                                     ckpt_dir=str(tmp_path / ("b" if resume else "a")))
        return TLOOP.train(cfg, data_cfg=data, opt_cfg=opt, loop=loop, resume_from=resume,
                           device="cpu")

    whole = run()
    resumed = run(str(tmp_path / "a" / "ckpt_000003.msgpack"))
    assert resumed["step"] == whole["step"][3:] == [4, 5, 6]
    assert resumed["loss"] == whole["loss"][3:]
    assert resumed["grad_norm"] == whole["grad_norm"][3:]
    for key, leaf in _flat(whole["final_params"]).items():
        assert torch.equal(leaf, _flat(resumed["final_params"])[key]), key


def test_train_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_reduced_config("qwen2.5-3b")
    with pytest.raises(RuntimeError):
        TLOOP.train(cfg, data_cfg=TDATA.DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                                   batch_size=1),
                    loop=TLOOP.TrainLoopConfig(steps=1))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _ckpt_values(seed):
    """float32 values for a bf16 params tree and a float32 opt state."""
    rng = np.random.default_rng(seed)
    params = {"embed": rng.standard_normal((40, 8)), "final_norm": rng.standard_normal(8),
              "blocks": {"attn": {"wq": rng.standard_normal((2, 8, 24)),
                                  "bq": rng.standard_normal((2, 24))},
                         "norm1": rng.standard_normal((2, 8))},
              "lm_head": rng.standard_normal((8, 40))}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    moments = jax.tree_util.tree_map(lambda a: np.abs(a) * 0.5, params)
    return params, moments


_SUBPROCESS = r"""
import sys
sys.modules["msgpack"] = None
sys.modules["ml_dtypes"] = None
sys.modules["jax"] = None
import json
import numpy as np
import torch
from repro_torch.training import checkpoint as C

mode, path, values = sys.argv[1], sys.argv[2], sys.argv[3]
if mode == "save":
    raw = np.load(values)
    flat = {k: torch.from_numpy(raw[k]) for k in raw.files}
    def tree(prefix, dtype):
        out = {}
        for k, t in flat.items():
            if k.startswith(prefix):
                node = out
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = t.to(dtype)
        return out
    params = tree("p/", torch.bfloat16)
    opt = {"step": torch.tensor(5, dtype=torch.int32), "m": tree("m/", torch.float32),
           "v": tree("v/", torch.float32)}
    C.save_checkpoint(path, step=5, params=params, opt_state=opt, extra={"note": "x"})
else:
    b = C.load_checkpoint(path)
    out = {f"{bn}/{k}": t.float().numpy() for bn in ("params", "opt_state")
           for k, t in b[bn].items()}
    out["dtypes"] = np.array(json.dumps({f"{bn}/{k}": str(t.dtype) for bn in ("params", "opt_state")
                                         for k, t in b[bn].items()}))
    np.savez(values, **out)
bad = [m for m in ("msgpack", "ml_dtypes", "jax") if sys.modules.get(m) is not None]
assert not bad, bad
print("ok")
"""


def _run_isolated(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _SUBPROCESS, *map(str, args)], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _reference_bundle(params, moments):
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jm = jax.tree_util.tree_map(jnp.asarray, moments)
    return jp, {"step": jnp.array(5, jnp.int32), "m": jm, "v": jm}


def test_checkpoint_bytes_equal_reference_without_msgpack_or_ml_dtypes(tmp_path):
    params, moments = _ckpt_values(0)
    vals = {f"p/{k}": v for k, v in _flat(params).items()}
    vals.update({f"{n}/{k}": v for n in ("m", "v") for k, v in _flat(moments).items()})
    np.savez(tmp_path / "vals.npz", **vals)
    _run_isolated("save", tmp_path / "port.msgpack", tmp_path / "vals.npz")
    jp, jopt = _reference_bundle(params, moments)
    JCK.save_checkpoint(str(tmp_path / "ref.msgpack"), step=5, params=jp, opt_state=jopt,
                        extra={"note": "x"})
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "ref.msgpack").read_bytes()


def test_port_reads_a_reference_checkpoint_without_msgpack_or_ml_dtypes(tmp_path):
    params, moments = _ckpt_values(1)
    jp, jopt = _reference_bundle(params, moments)
    JCK.save_checkpoint(str(tmp_path / "ref.msgpack"), step=5, params=jp, opt_state=jopt)
    _run_isolated("load", tmp_path / "ref.msgpack", tmp_path / "out.npz")
    got = np.load(tmp_path / "out.npz")
    dtypes = json.loads(str(got["dtypes"]))
    want = JCK.load_checkpoint(str(tmp_path / "ref.msgpack"))
    n = 0
    for bn in ("params", "opt_state"):
        for k, arr in want[bn].items():
            assert dtypes[f"{bn}/{k}"] == f"torch.{arr.dtype}", k
            assert np.array_equal(got[f"{bn}/{k}"], np.asarray(arr, np.float32)), k
            n += 1
    assert n == len(dtypes) and dtypes["params/embed"] == "torch.bfloat16"


def test_checkpoint_roundtrip_and_restore(tmp_path):
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.ones(3, dtype=torch.bfloat16)},
              "empty": torch.zeros((0, 4))}
    opt = {"step": torch.tensor(7, dtype=torch.int32),
           "m": TOPT.tree_map(torch.zeros_like, params)}
    path = TCK.save_checkpoint(str(tmp_path / "sub" / "ckpt.msgpack"), step=7, params=params,
                               opt_state=opt, extra={"note": "x"})
    assert [p.name for p in (tmp_path / "sub").iterdir()] == ["ckpt.msgpack"]
    bundle = TCK.load_checkpoint(path)
    assert bundle["step"] == 7 and bundle["extra"] == {"note": "x"}
    restored = TCK.restore_into(params, bundle["params"])
    for key, leaf in _flat(params).items():
        got = _flat(restored)[key]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), key
    assert int(TCK.restore_into(opt, bundle["opt_state"])["step"]) == 7
    with pytest.raises(ValueError, match="nested/b"):
        TCK.restore_into({**params, "nested": {"b": torch.ones(4)}}, bundle["params"])


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65_535, 65_536])
def test_msgpack_subset_packs_as_msgpack(n):
    text = "s" * n
    obj = {"manifest": text, "data": {f"k{i}": bytes(range(i % 7)) * n
                                      for i in range(min(n, 17) + 1)},
           "ints": {"a": n, "b": n * 65_537, "c": 2 ** 40 + n}}
    blob = _msgpack.packb(obj)
    assert blob == msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.unpackb(blob) == msgpack.unpackb(blob, raw=False) == obj


def test_msgpack_subset_refuses_what_it_does_not_carry():
    for bad in (1.5, -1, None, [1], True):
        with pytest.raises(TypeError):
            _msgpack.packb({"x": bad})
    with pytest.raises(ValueError, match="unsupported"):
        _msgpack.unpackb(msgpack.packb([1, 2]))
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(_msgpack.packb("a") + b"\x00")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_train_cli_on_the_cpu_lowers_the_loss():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "12",
                           "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    first, last = proc.stdout.strip().splitlines()[-1].removeprefix("loss ").split(" -> ")
    assert float(last) < float(first)


def test_train_cli_refuses_whisper(monkeypatch, capsys):
    """The CLI trains whisper-tiny as the reference's launcher does: --seq
    capped at max_target_positions (448), zero frame embeddings of shape
    (batch, encoder_seq, d_model) in each batch. An unknown arch exits 2."""
    seen = []
    monkeypatch.setattr(train_cli, "train", lambda cfg, **kw: seen.append((cfg, kw)) or
                        {"loss": [1.0, 0.5]})
    train_cli.main(["--arch", "whisper-tiny", "--seq", "1000", "--batch", "3",
                    "--device", "cpu"])
    train_cli.main(["--arch", "whisper-tiny", "--seq", "64", "--device", "cpu"])
    (cfg, kw), (_, kw64) = seen
    assert cfg.family == "audio" and cfg.max_target_positions == 448
    assert kw["data_cfg"].seq_len == 448 and kw64["data_cfg"].seq_len == 64
    extra = kw["extra_batch_fn"](0)
    assert sorted(extra) == ["frame_embeds"]
    fe = extra["frame_embeds"]
    assert fe.shape == (3, cfg.encoder_seq, cfg.d_model) and fe.dtype == cfg.torch_dtype
    assert float(fe.abs().sum()) == 0.0
    assert "training whisper-tiny-reduced (reduced, audio) seq=448" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--arch", "whisper-huge", "--device", "cpu"])
    assert exc.value.code == 2
    assert "'whisper-huge' is not ported" in capsys.readouterr().err


def test_train_cli_rounds_ssm_sequences_and_feeds_vlm_patches(monkeypatch):
    seen = []
    monkeypatch.setattr(train_cli, "train", lambda cfg, **kw: seen.append((cfg, kw)) or
                        {"loss": [1.0, 0.5]})
    train_cli.main(["--arch", "mamba2-1.3b", "--seq", "200", "--device", "cpu"])
    train_cli.main(["--arch", "internvl2-76b", "--batch", "3", "--device", "cpu"])
    (ssm_cfg, ssm_kw), (vlm_cfg, vlm_kw) = seen
    assert ssm_kw["data_cfg"].seq_len == 192 and ssm_kw["extra_batch_fn"] is None
    assert ssm_kw["device"] == "cpu"
    patches = vlm_kw["extra_batch_fn"](0)["patch_embeds"]
    assert patches.shape == (3, vlm_cfg.frontend_tokens, vlm_cfg.d_model)
    assert float(patches.abs().sum()) == 0.0
