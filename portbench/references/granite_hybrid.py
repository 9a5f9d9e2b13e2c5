"""Plain PyTorch reference of IBM Granite 4.0-H (``granitemoehybrid``):
Mamba2 and attention layers, each followed by sparse experts and a shared
expert; and the benchmark's weights for it.

``make_weights`` draws the weights from the seed on the device, one call
per stacked tensor, in the types they are served in (bfloat16; the
router and Mamba2's ``A_log``, ``dt_bias`` and ``D`` float32). The tree
has the keys and layout the served engine takes: the norms and the
experts of every layer under ``blocks``, the Mamba2 layers' weights
stacked under ``mamba`` and the attention layers' under ``attention``
(each kind in layer order), the output head a view of the embedding.
The reference reads the same tensors and derives nothing from the
program; it reads the published keys of the configuration file alone.

``logits`` runs the reference in float32 (TF32 off) over whole
sequences, layer by layer, so that one layer's float32 copy sits beside
the bfloat16 weights:

    x = embed[tokens] * embedding_multiplier
    layer i:  h = rms_norm(x)
              h = mamba2(h) if layer_types[i] == "mamba" else attn(h)
              x = x + residual_multiplier * h
              g = rms_norm(x)
              x = x + residual_multiplier * (moe(g) + shared(g))
    logits = rms_norm(x) @ embed^T / logits_scaling

mamba2 is ``in_proj`` into z, xBC and dt; a causal depthwise conv with
bias and SiLU over xBC; dt = softplus(dt + dt_bias), A = -exp(A_log); the
SSD recurrence S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, y_t = C_t S_t,
computed here in its chunked dual form over blocks of ``SSD_BLOCK``
positions (within a block the decayed C.B^T products, across blocks the
state); y + D x; RMSNorm of y * silu(z) over every channel (n_groups 1);
``out_proj``. attn is grouped-query attention without biases or
positions, softmax scale ``attention_multiplier``. moe: softmax over
the float32 router logits, the top ``num_experts_per_tok``, gates
renormalised over them (the published gating's softmax over the top-k
logits is the same number), every assignment kept; SwiGLU experts of
``intermediate_size``; shared: a SwiGLU of ``shared_intermediate_size``
on the same g.

It follows the served semantics where they differ from the published
model, each kept on purpose, as ``decoder.py`` does: rows are left-padded
with token 0 to the invocation's longest prompt, the pads are not
masked, so they enter the Mamba2 layers' state, and positions start at 0
on every row; a generated position attends the ring of ``cache_window``
entries and itself, as the decode step does.

``routes`` is the routed mode (see ``decoder.py``): each layer takes the
experts the program chose at each position; the gates are the
reference's own float32 router probabilities of them, renormalised; and
beside the logits it returns, for each (token, layer), the reference's
k-th largest router logit less its smallest among the given experts.

``quant="fp8"`` is the control: every bfloat16 weight's product (the
projections, the experts, the shared expert, the head) runs on weights
quantized per output channel and activations per token to float8 e4m3
(scale amax / 448), dequantized to float32; the conv, the SSD, the
attention and the float32 router stay in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
SSD_BLOCK = 64  # positions a block of the reference's chunked SSD


def _dims(cfg: Dict) -> Dict[str, int]:
    H = cfg["mamba_n_heads"]
    d_in = H * cfg["mamba_d_head"]
    N = cfg["mamba_d_state"]
    return {"H": H, "P": cfg["mamba_d_head"], "N": N, "d_in": d_in, "conv": d_in + 2 * N,
            "proj": 2 * d_in + 2 * N + H, "K": cfg["mamba_d_conv"],
            "hd": cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]}


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """Random weights from ``seed``: normal, scaled by fan-in ** -0.5,
    norm scales 1 + 0.1 N(0, 1), the conv bias 0.1 N(0, 1). The embedding
    is drawn at 0.02 / embedding_multiplier, so that the scaled embedding
    has the 0.02 of the other references' (at 0.02 itself, the tied head
    reads the last token back: with random layers, every greedy token
    would repeat the prompt's last). Mamba2's draws are its published
    initialisation: A = -U[1, 16], dt log-uniform in [0.001, 0.1] held as
    its inverse softplus in ``dt_bias``, D = 1."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    kinds = cfg["layer_types"]
    La, Lm = kinds.count("attention"), kinds.count("mamba")
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Fd, Fs, V = cfg["intermediate_size"], cfg["shared_intermediate_size"], cfg["vocab_size"]
    E = cfg["num_local_experts"]
    d = _dims(cfg)
    bf, f32 = torch.bfloat16, torch.float32

    def normal(shape, std, mean=0.0, dtype=bf):
        return torch.empty(shape, dtype=dtype, device=dev).normal_(mean, std, generator=gen)

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=f32, device=dev).uniform_(lo, hi, generator=gen)

    dt = torch.exp(uniform((Lm, d["H"]), math.log(1e-3), math.log(0.1)))
    mamba = {"in_proj": normal((Lm, D, d["proj"]), D ** -0.5),
             "conv_w": normal((Lm, d["K"], d["conv"]), d["K"] ** -0.5),
             "conv_b": normal((Lm, d["conv"]), 0.1),
             "A_log": torch.log(uniform((Lm, d["H"]), 1.0, 16.0)),
             "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # softplus(dt_bias) = dt
             "D": torch.ones((Lm, d["H"]), dtype=f32, device=dev),
             "norm_w": normal((Lm, d["d_in"]), 0.1, 1.0),
             "out_proj": normal((Lm, d["d_in"], D), d["d_in"] ** -0.5)}
    attention = {"wq": normal((La, D, Hq * d["hd"]), D ** -0.5),
                 "wk": normal((La, D, Hkv * d["hd"]), D ** -0.5),
                 "wv": normal((La, D, Hkv * d["hd"]), D ** -0.5),
                 "wo": normal((La, Hq * d["hd"], D), (Hq * d["hd"]) ** -0.5)}
    moe = {"router": normal((L, D, E), D ** -0.5, dtype=f32),
           "wg": normal((L, E, D, Fd), D ** -0.5),
           "wu": normal((L, E, D, Fd), D ** -0.5),
           "wd": normal((L, E, Fd, D), Fd ** -0.5),
           "shared": {"wg": normal((L, D, Fs), D ** -0.5), "wu": normal((L, D, Fs), D ** -0.5),
                      "wd": normal((L, Fs, D), Fs ** -0.5)}}
    blocks = {"norm1": normal((L, D), 0.1, 1.0), "norm2": normal((L, D), 0.1, 1.0), "moe": moe}
    embed = normal((V, D), 0.02 / cfg["embedding_multiplier"])
    return {"embed": embed, "blocks": blocks, "final_norm": normal((D,), 0.1, 1.0),
            "lm_head": embed.t(), "mamba": mamba, "attention": attention}


# ---------------------------------------------------------------------------
# float32 building blocks
# ---------------------------------------------------------------------------


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round ``x`` to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Lin:
    """A bfloat16 weight (in, out) taken to float32, or through float8."""

    def __init__(self, w: torch.Tensor, quant: Optional[str]):
        self.quant = quant
        w = w.float()
        self.w = _fp8(w, 0) if quant == "fp8" else w

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            x = _fp8(x, -1)
        return x @ self.w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _swiglu(p: Dict, i: int, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    wg, wu, wd = (_Lin(p[n][i], quant) for n in ("wg", "wu", "wd"))
    return wd(F.silu(wg(x)) * wu(x))


def _ssd(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The SSD recurrence from a zero state, in float32, block by block.
    x (B, T, H, P), dt (B, T, H), A (H,), Bm / Cm (B, T, N); returns y
    (B, T, H, P)."""
    Bsz, T, H, P = x.shape
    state = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for a in range(0, T, SSD_BLOCK):
        b = min(T, a + SSD_BLOCK)
        xw = x[:, a:b] * dt[:, a:b, :, None]  # (B, q, H, P): the input dt x
        cum = torch.cumsum(dt[:, a:b] * A, dim=1)  # (B, q, H): log decay from the block's start
        q = b - a
        later = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        seg = (cum[:, :, None] - cum[:, None]).masked_fill(~later[None, :, :, None], -math.inf)
        w = torch.exp(seg) * (Cm[:, a:b] @ Bm[:, a:b].transpose(1, 2))[..., None]  # (B,t,s,H)
        y[:, a:b] = (torch.einsum("btsh,bshp->bthp", w, xw)
                     + torch.einsum("btn,bhpn->bthp", Cm[:, a:b], state)
                     * torch.exp(cum)[..., None])
        to_end = torch.exp(cum[:, -1:] - cum)  # (B, q, H)
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bsn,bshp->bhpn", Bm[:, a:b], xw * to_end[..., None]))
    return y


def _mamba(m: Dict, j: int, h: torch.Tensor, cfg: Dict, quant: Optional[str]) -> torch.Tensor:
    """Mamba2 layer ``j`` (of the Mamba2 layers) over h (B, T, D)."""
    d = _dims(cfg)
    Bsz, T, _ = h.shape
    zxbcdt = _Lin(m["in_proj"][j], quant)(h)
    z, xbc = zxbcdt[..., :d["d_in"]], zxbcdt[..., d["d_in"]:d["d_in"] + d["conv"]]
    dt_raw = zxbcdt[..., d["d_in"] + d["conv"]:]
    w, K = m["conv_w"][j].float(), d["K"]
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[:, k:k + T] * w[k] for k in range(K)) + m["conv_b"][j].float()
    xbc = F.silu(conv)
    x = xbc[..., :d["d_in"]].reshape(Bsz, T, d["H"], d["P"])
    Bm = xbc[..., d["d_in"]:d["d_in"] + d["N"]]
    Cm = xbc[..., d["d_in"] + d["N"]:]
    dt = F.softplus(dt_raw + m["dt_bias"][j])
    y = _ssd(x, dt, -torch.exp(m["A_log"][j]), Bm, Cm) + x * m["D"][j][:, None]
    y = y.reshape(Bsz, T, d["d_in"]) * F.silu(z)
    return _Lin(m["out_proj"][j], quant)(_rms(y, m["norm_w"][j], cfg["rms_norm_eps"]))


def _attention(at: Dict, j: int, h: torch.Tensor, S: int, cfg: Dict, cache_window: int,
               quant: Optional[str], q_tile: int = 512) -> torch.Tensor:
    """Attention layer ``j`` (of the attention layers) over h (B, T, D):
    no positions, causal; a generated position (at or after S) attends
    the ring's ``cache_window`` entries and itself."""
    d = _dims(cfg)
    B, T, _ = h.shape
    H, Hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], d["hd"]
    G = H // Hkv
    q = _Lin(at["wq"][j], quant)(h).view(B, T, H, hd)
    kt = _Lin(at["wk"][j], quant)(h).view(B, T, Hkv, hd).permute(0, 2, 3, 1)
    vt = _Lin(at["wv"][j], quant)(h).view(B, T, Hkv, hd).permute(0, 2, 1, 3)
    out = torch.empty_like(q)
    kp = torch.arange(T, device=h.device)
    for a in range(0, T, q_tile):
        b = min(T, a + q_tile)
        qp = kp[a:b, None]
        live = (kp[None, :b] <= qp) & ((qp < S) | (qp - kp[None, :b] <= cache_window))
        qb = q[:, a:b].reshape(B, b - a, Hkv, G, hd).permute(0, 2, 3, 1, 4)
        s = (qb @ kt[:, :, None, :, :b]) * cfg["attention_multiplier"]
        p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
        out[:, a:b] = (p @ vt[:, :, None, :b]).permute(0, 3, 1, 2, 4).reshape(B, b - a, H, hd)
    return _Lin(at["wo"][j], quant)(out.reshape(B, T, H * hd))


def _experts(moe: Dict, i: int, h: torch.Tensor, k: int, quant: Optional[str],
             given: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``i``'s routed experts over tokens h (N, D), every assignment
    kept, at the top-k or the ``given`` experts (N, k). Returns (y, the
    given choices' deficits (N,) or None)."""
    scores = h @ moe["router"][i].float()
    probs = torch.softmax(scores, dim=-1)
    deficit = None
    if given is None:
        gates, ids = torch.topk(probs, k, dim=-1)
    else:
        ids = given.long()
        gates = probs.gather(-1, ids)
        deficit = (torch.topk(scores, k, dim=-1).values[:, -1]
                   - scores.gather(-1, ids).min(-1).values)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(scores.shape[-1]):
        tok, choice = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        wg, wu, wd = (_Lin(moe[n][i, e], quant) for n in ("wg", "wu", "wd"))
        x = h[tok]
        y.index_add_(0, tok, wd(F.silu(wg(x)) * wu(x)) * gates[tok, choice][:, None])
    return y, deficit


@torch.no_grad()
def logits(w: Dict, cfg: Dict, seqs: Sequence[Tuple[torch.Tensor, int]], cache_window: int,
           quant: Optional[str] = None, routes: Optional[Sequence[Sequence[torch.Tensor]]] = None):
    """Float32 logits at every generated position of each sequence.

    ``seqs`` holds (tokens (B, T) int64 on the device, S): the left-padded
    prompts of one invocation (S positions) followed by all but the last
    of its served tokens, so T = S + max_new - 1. Returns, per sequence,
    (B, max_new, V): the logits that chose served token j sit at position
    S - 1 + j.

    ``routes`` (routed mode): per sequence, per layer, the experts chosen
    at each position, (B, T, k). Then returns (logits, deficits), the
    deficits per sequence (L, B, T)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out, deficits = _logits(w, cfg, seqs, cache_window, quant, routes)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out if routes is None else (out, deficits)


def _logits(w, cfg, seqs, cache_window, quant, routes):
    eps, k, r = cfg["rms_norm_eps"], cfg["num_experts_per_tok"], cfg["residual_multiplier"]
    blocks, moe = w["blocks"], w["blocks"]["moe"]
    xs = [w["embed"][tok].float() * cfg["embedding_multiplier"] for tok, _ in seqs]
    deficits: List[List[torch.Tensor]] = [[] for _ in seqs]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"]):
        j = seen[kind]
        seen[kind] += 1
        gs = []
        for n, (tok, S) in enumerate(seqs):
            h = _rms(xs[n], blocks["norm1"][i], eps)
            if kind == "mamba":
                h = _mamba(w["mamba"], j, h, cfg, quant)
            else:
                h = _attention(w["attention"], j, h, S, cfg, cache_window, quant)
            xs[n] = xs[n] + r * h
            gs.append(_rms(xs[n], blocks["norm2"][i], eps).reshape(-1, xs[n].shape[-1]))
        g = torch.cat(gs)
        given = None if routes is None else torch.cat([rt[i].reshape(-1, k) for rt in routes])
        y, deficit = _experts(moe, i, g, k, quant, given)
        y = y + _swiglu(moe["shared"], i, g, quant)
        at = 0
        for n, x in enumerate(xs):
            B, T = x.shape[:2]
            xs[n] = x + r * y[at:at + B * T].view(x.shape)
            if deficit is not None:
                deficits[n].append(deficit[at:at + B * T].view(B, T))
            at += B * T
    head = _Lin(w["embed"].t(), quant)
    out = [head(_rms(x[:, S - 1:], w["final_norm"], eps)) / cfg["logits_scaling"]
           for x, (tok, S) in zip(xs, seqs)]
    return out, [torch.stack(d) if d else None for d in deficits]
