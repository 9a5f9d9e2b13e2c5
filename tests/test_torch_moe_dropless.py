"""The port's dropless MoE dispatch (``moe_capacity_factor`` None, as
Mixtral's published block routes) on the CPU, seeded, in float32 unless
a test names bfloat16:

* ``moe_block`` and ``moe_decode`` against a plain loop over every
  (token, choice), including a router skewed so that one expert takes
  every token's first choice, which capacity 1.25 drops;
* dropless equal to the capacity dispatch wherever the capacity holds
  every expert's load: this ties the new path to the one that
  tests/test_torch_moe.py holds to the JAX reference;
* the sort: by expert, then token, with device offsets, and no host
  read anywhere in the dispatch;
* the ragged plain product (``ref.moe_gmm_grouped_ref``, what the CUDA
  kernel is held against) against the padded one on the same rows;
* the Switch aux loss computed only where asked, equal on both dispatches.

Tolerances are tests/test_kernels.py's: 2e-5 (float32) or 3e-2 (bf16)
times max(|ref|, 1).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(dtype="float32", factor=None):
    return dataclasses.replace(get_reduced_config("mixtral-8x7b"), dtype=dtype,
                               moe_capacity_factor=factor)


def _params(cfg, seed=0):
    return TMOE.init_moe(torch.Generator().manual_seed(seed), cfg)


def _close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * max(float(want.float().abs().max()), 1.0), err


def _loop(p, cfg, xt):
    """Every (token, choice) through its expert one at a time, in float32,
    weighted by the renormalised gates: no dispatch at all."""
    _, gates, ids = TMOE.route(p, cfg, xt)
    w = {n: p[n].float() for n in ("wg", "wu", "wd")}
    y = torch.zeros(xt.shape, dtype=torch.float32)
    for t in range(xt.shape[0]):
        x = xt[t].float()
        for j in range(cfg.experts_per_token):
            e = int(ids[t, j])
            h = F.silu(x @ w["wg"][e]) * (x @ w["wu"][e])
            y[t] += gates[t, j] * (h @ w["wd"][e])
    return y


def _inputs(cfg, shape, seed, skew):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32))
    p = _params(cfg)
    if skew:  # feature 0 pulls every token's first choice to expert 0
        x[..., 0] = 10.0
        p["router"][0, 0] = 100.0
    return p, x.to(cfg.torch_dtype)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropless_block_matches_a_per_expert_loop(dtype, skew):
    cfg = _cfg(dtype)
    p, x = _inputs(cfg, (2, 16), 1, skew)
    T = 32
    y, aux = TMOE.moe_block(p, cfg, x)
    assert aux is None and y.dtype == cfg.torch_dtype and y.shape == x.shape
    want = _loop(p, cfg, x.reshape(T, -1))
    _close(y.reshape(T, -1), want, dtype)
    _, _, ids = TMOE.route(p, cfg, x.reshape(T, -1))
    if skew:
        assert bool((ids[:, 0] == 0).all())
        # the capacity dispatch drops past 1.25 x T x k / E = 24 of expert 0's 32
        assert TMOE.moe_capacity(_cfg(dtype, 1.25), T) < T
        capped, _ = TMOE.moe_block(p, _cfg(dtype, 1.25), x)
        err = (capped.reshape(T, -1).float() - want).abs().amax(-1)
        assert int((err > TOL[dtype] * max(float(want.abs().max()), 1.0)).sum()) >= T - 24


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 4])
def test_dropless_decode_matches_the_block_and_the_loop(dtype, batch):
    cfg = _cfg(dtype)
    p, x = _inputs(cfg, (batch,), 5, False)
    got = TMOE.moe_decode(p, cfg, x)
    assert got.shape == x.shape and got.dtype == cfg.torch_dtype
    assert torch.equal(got, TMOE.moe_block(p, cfg, x[:, None])[0][:, 0])
    _close(got, _loop(p, cfg, x), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 16), (1, 33)])
def test_dropless_equals_capacity_where_nothing_is_dropped(dtype, shape):
    """A capacity factor of E / k gives every expert T slots, its most
    possible load (a token takes an expert once): nothing is dropped, and
    the two dispatches agree within the tolerance (they round and sum the
    k terms differently in bf16)."""
    cfg = _cfg(dtype)
    E, K = cfg.num_experts, cfg.experts_per_token
    capped = _cfg(dtype, E / K)
    p, x = _inputs(cfg, shape, 2, False)
    T = shape[0] * shape[1]
    assert TMOE.moe_capacity(capped, T) >= T
    want, want_aux = TMOE.moe_block(p, capped, x, aux=True)
    got, got_aux = TMOE.moe_block(p, cfg, x, aux=True)
    _close(got, want, dtype)
    assert torch.equal(got_aux, want_aux)  # the aux loss reads the router alone
    # a capacity given takes the capacity dispatch whatever the config says
    _close(TMOE.moe_block(p, cfg, x, capacity=T)[0], want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [1, 5, 8])
def test_padded_dropless_equals_the_sorted_rows(monkeypatch, dtype, tokens):
    """Up to 8 tokens (a decode step) take the per-expert buffers at 8
    slots, where nothing can be dropped: the same result as the sorted
    rows, whose path a threshold of 0 forces."""
    cfg = _cfg(dtype)
    p, x = _inputs(cfg, (tokens, 1), 6, False)
    got = TMOE.moe_block(p, cfg, x)[0]
    monkeypatch.setattr(TMOE, "PADDED_DROPLESS_TOKENS", 0)
    _close(got, TMOE.moe_block(p, cfg, x)[0], dtype)
    _close(got[:, 0], _loop(p, cfg, x[:, 0]), dtype)


@pytest.mark.parametrize("tokens,padded", [(1, True), (8, True), (9, False), (64, False)])
def test_dropless_takes_the_sorted_rows_past_8_tokens(monkeypatch, tokens, padded):
    calls = []

    def per_expert(a, w, **kw):
        calls.append("moe_gmm")
        return ref.moe_gmm_ref(a, w)

    def grouped(a, w, off, **kw):
        calls.append("grouped")
        return ref.moe_gmm_grouped_ref(a, w, off)

    monkeypatch.setattr(ops, "moe_gmm", per_expert)
    monkeypatch.setattr(ops, "moe_gmm_grouped", grouped)
    cfg = _cfg()
    p, x = _inputs(cfg, (1, tokens), 7, False)
    TMOE.moe_block(p, cfg, x)
    assert calls == ["moe_gmm" if padded else "grouped"] * 3


def test_sort_by_expert_orders_by_expert_then_token():
    rng = np.random.default_rng(3)
    E, K, T = 6, 2, 40
    ids = np.stack([rng.choice(E - 1, K, replace=False) for _ in range(T)])  # expert 5 idle
    order, offsets = TMOE.sort_by_expert(torch.from_numpy(ids), E)
    flat = ids.reshape(-1)
    assert order.tolist() == np.argsort(flat, kind="stable").tolist()
    assert offsets.dtype == torch.int32 and offsets.shape == (E + 1,)
    assert offsets.tolist() == [0] + np.cumsum(np.bincount(flat, minlength=E)).tolist()
    assert offsets[-2] == offsets[-1] == T * K
    # within an expert the rows go by token
    for e in range(E):
        toks = order[offsets[e]:offsets[e + 1]] // K
        assert bool((toks[1:] > toks[:-1]).all())


@pytest.mark.parametrize("batch,seq", [(1, 1), (4, 1), (2, 24)])
def test_dropless_dispatch_reads_nothing_back(monkeypatch, batch, seq):
    """Routing, sort, offsets, gather, scatter back and the gate sum run on
    meta tensors, which hold no data: so the dispatch reads no value on the
    host (``.item()``, ``.tolist()``) and takes no shape from the data
    (``nonzero``, boolean masks), all of which raise there. So a decode
    step records into a CUDA graph and a prefill never waits on the host.
    The expert products are stubbed by their shapes (their CUDA wrappers
    read nothing either; the plain grouped version reads the offsets).
    Up to 8 tokens take the per-expert buffers, more the sorted rows."""
    cfg = _cfg("bfloat16")
    p, x = _inputs(cfg, (batch, seq), 4, False)
    monkeypatch.setattr(ops, "moe_gmm_grouped",
                        lambda a, w, off, **kw: a.new_zeros((a.shape[0], w.shape[2])))
    monkeypatch.setattr(ops, "moe_gmm",
                        lambda a, w, **kw: a.new_zeros((a.shape[0], a.shape[1], w.shape[2])))
    y, _ = TMOE.moe_block({k: v.to("meta") for k, v in p.items()}, cfg, x.to("meta"))
    assert y.device.type == "meta" and y.shape == x.shape and y.dtype == x.dtype
    with pytest.raises(NotImplementedError):  # what a host read does on meta
        torch.zeros(3, device="meta").tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", [(3, 0, 5, 1), (0, 0, 9, 0), (1, 1, 1, 1)])
def test_grouped_ref_matches_the_padded_product_on_the_same_rows(dtype, counts):
    rng = np.random.default_rng(sum(counts))
    E, D, Fd = len(counts), 64, 96
    R, C = sum(counts), max(counts)
    x = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32)).to(DT[dtype])
    w = torch.from_numpy((rng.standard_normal((E, D, Fd)) * D ** -0.5).astype(np.float32)
                         ).to(DT[dtype])
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)
    buf = torch.zeros((E, C, D), dtype=x.dtype)
    for e in range(E):
        buf[e, :counts[e]] = x[offsets[e]:offsets[e + 1]]
    padded = ref.moe_gmm_ref(buf, w)
    got = ref.moe_gmm_grouped_ref(x, w, offsets)
    assert got.shape == (R, Fd) and got.dtype == x.dtype
    want = torch.cat([padded[e, :counts[e]] for e in range(E)])
    _close(got, want, dtype)
    # ops takes the plain version for CPU tensors, and counts no launch
    before = tracing.counters().get("kernels.launches.moe_gmm_grouped", 0)
    assert torch.equal(ops.moe_gmm_grouped(x, w, offsets), got)
    assert tracing.counters().get("kernels.launches.moe_gmm_grouped", 0) == before


def test_training_asks_for_the_aux_loss_on_either_dispatch():
    """``forward_train`` asks every MoE layer for its aux loss; the dropless
    and capacity configs read the same router, so the same aux loss."""
    cfg = _cfg()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 12)))
    labels = torch.roll(toks, -1, 1)
    _, m = TM.forward_train(params, cfg, toks, labels, remat=False)
    _, m_cap = TM.forward_train(params, _cfg(factor=1.25), toks, labels, remat=False)
    assert float(m["aux_loss"]) > 0
    assert float(m["aux_loss"]) == pytest.approx(float(m_cap["aux_loss"]), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropless_prefill_then_decode_matches_the_full_forward(dtype):
    """A dropless model's cache is its full forward's: the decode steps'
    logits equal forward_seq's at the same positions (teacher-forced), as
    no group's size changes what an expert keeps."""
    cfg = _cfg(dtype)
    params = TM.init_params(torch.Generator().manual_seed(1), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 20)))
    full, _ = TM.forward_seq(params, cfg, toks)
    logits, cache = TM.forward_prefill(params, cfg, toks[:, :16], cache_window=64)
    _close(logits, full[:, 15], dtype)
    for t in range(16, 20):
        logits, cache = TM.forward_decode(params, cfg, toks[:, t].to(torch.int32), cache)
        _close(logits, full[:, t], dtype)
