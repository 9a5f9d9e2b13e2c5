"""Plain PyTorch reference of a decoder-only transformer, dense or with
sparse experts (Qwen2.5, Mixtral), and the benchmark's weights for it.

``make_weights`` draws the weights from the seed on the device, one call
per stacked tensor, in the types they are served in (bfloat16; the
router float32). The tree has the keys and layout the served engine
takes; the reference reads the same tensors and derives nothing from the
program.

``logits`` runs the reference in float32 (TF32 off) over whole
sequences, layer by layer, so that it fits beside the weights: RMSNorm,
rotary embeddings (half split, base ``rope_theta``), grouped-query
attention with biases on q, k and v where the configuration has them,
SwiGLU MLP or top-k experts with renormalised gates. It follows the
served semantics, which differ from the published model in three
places, each kept on purpose:

* rows are left-padded with token 0 to the invocation's longest prompt;
  pads are attended and positions start at 0 on every row;
* a prompt position attends keys within the sliding window (if any); a
  generated position attends the ring of ``cache_window`` entries and
  itself, as the decode step does;
* the experts take the prompt's tokens (all rows, row-major) as one
  group and each decode step's tokens as another, with the capacity
  ``max(8, ceil8(int(1.25 * tokens * k / E)))``: assignments ranked
  choice-major (every first choice before any second) past the capacity
  are dropped, their gate 0.

``routes`` is the routed mode, for a check of the program's tokens
through top-k routing: rounding in a lower precision flips near-tied
choices, and one flip changes what the capacity drops, so the reference
takes the experts the program chose. Each MoE group then takes the given
ids in place of its own top-k; the gates are the reference's own float32
router probabilities of those experts, renormalised, and the capacity
ranks are taken over the given ids as above. Beside the logits it
returns, for each (token, layer), the deficit of the given choice: the
reference's k-th largest router logit less its smallest logit among the
given experts, 0 where they are its own top-k. The deficit is what a
separate check holds: a sound program chooses the reference's top-k or
one of its near-ties.

``quant="fp8"`` is the control: every bfloat16 weight's product runs on
weights quantized per output channel and activations per token to
float8 e4m3 (scale amax / 448), dequantized to float32; attention and
the float32 router stay in float32. Given ``routes``, the control routes
as given too, so it differs from the program in precision only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """Random weights from ``seed``: normal, scaled by fan-in ** -0.5
    (the embedding by 0.02), norm scales 1 + 0.1 N(0, 1), biases
    0.1 N(0, 1). Where the configuration ties the word embeddings, the
    output head is a view of the embedding, (D, V)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    Fd, V = cfg["intermediate_size"], cfg["vocab_size"]
    E = cfg.get("num_local_experts", 0)
    bf = torch.bfloat16

    def normal(shape, std, mean=0.0, dtype=bf):
        return torch.empty(shape, dtype=dtype, device=dev).normal_(mean, std, generator=gen)

    attn = {"wq": normal((L, D, H * hd), D ** -0.5),
            "wk": normal((L, D, Hkv * hd), D ** -0.5),
            "wv": normal((L, D, Hkv * hd), D ** -0.5),
            "wo": normal((L, H * hd, D), (H * hd) ** -0.5)}
    if cfg.get("attention_bias"):
        attn.update(bq=normal((L, H * hd), 0.1), bk=normal((L, Hkv * hd), 0.1),
                    bv=normal((L, Hkv * hd), 0.1))
    blocks = {"norm1": normal((L, D), 0.1, 1.0), "attn": attn, "norm2": normal((L, D), 0.1, 1.0)}
    if E:
        blocks["moe"] = {"router": normal((L, D, E), D ** -0.5, dtype=torch.float32),
                         "wg": normal((L, E, D, Fd), D ** -0.5),
                         "wu": normal((L, E, D, Fd), D ** -0.5),
                         "wd": normal((L, E, Fd, D), Fd ** -0.5)}
    else:
        blocks["mlp"] = {"wg": normal((L, D, Fd), D ** -0.5), "wu": normal((L, D, Fd), D ** -0.5),
                         "wd": normal((L, Fd, D), Fd ** -0.5)}
    embed = normal((V, D), 0.02)
    out = {"embed": embed, "blocks": blocks, "final_norm": normal((D,), 0.1, 1.0)}
    out["lm_head"] = embed.t() if cfg.get("tie_word_embeddings") else normal((D, V), D ** -0.5)
    return out


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


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd) at positions 0..T-1, half-split rotation."""
    T, half = x.shape[1], x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freq
    cos, sin = ang.cos().float()[None, :, None], ang.sin().float()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, S: int, window: Optional[int], cache_window: int,
               q_tile: int = 512) -> torch.Tensor:
    """q (B, T, H, hd); k, v (B, T, Hkv, hd); returns (B, T, H, hd). Query
    tiles bound the float32 scores."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    kt = k.permute(0, 2, 3, 1)  # (B, Hkv, hd, T)
    vt = v.permute(0, 2, 1, 3)  # (B, Hkv, T, hd)
    out = torch.empty_like(q)
    kp = torch.arange(T, device=q.device)
    for a in range(0, T, q_tile):
        b = min(T, a + q_tile)
        qp = kp[a:b, None]
        live = kp[None, :b] <= qp
        prompt = qp < S
        if window is not None:
            live &= ~prompt | (qp - kp[None, :b] < window)
        live &= prompt | (qp - kp[None, :b] <= cache_window)
        qb = q[:, a:b].reshape(B, b - a, Hkv, G, hd).permute(0, 2, 3, 1, 4)
        s = (qb @ kt[:, :, None, :, :b]) * hd ** -0.5  # (B, Hkv, G, tile, b)
        p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
        o = p @ vt[:, :, None, :b]  # (B, Hkv, G, tile, hd)
        out[:, a:b] = o.permute(0, 3, 1, 2, 4).reshape(B, b - a, H, hd)
    return out


def moe_capacity(tokens: int, k: int, experts: int) -> int:
    cap = int(1.25 * tokens * k / experts)
    return max(8, -(-cap // 8) * 8)


def _experts(moe: Dict, i: int, h: torch.Tensor, k: int, quant: Optional[str],
             groups: Sequence[torch.Tensor], given: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Top-k experts of layer ``i`` over tokens h (N, D), dispatched
    group by group (each a tensor of token indices in dispatch order), or
    the ``given`` experts (N, k). Returns (y (N, D), the given choices'
    deficits (N,) or None)."""
    router = moe["router"][i].float()
    E = router.shape[-1]
    scores = h @ router
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
    # (token, choice, gate) assignments that fit, per expert
    kept: List[List[Tuple[torch.Tensor, torch.Tensor]]] = [[] for _ in range(E)]
    for g in groups:
        flat = ids[g].T.reshape(-1)  # choice-major
        onehot = F.one_hot(flat, E)
        rank = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
        keep = rank < moe_capacity(len(g), k, E)
        tok = g.repeat(k)
        gate = gates[g].T.reshape(-1)
        for e in range(E):
            sel = keep & (flat == e)
            kept[e].append((tok[sel], gate[sel]))
    for e in range(E):
        tok = torch.cat([t for t, _ in kept[e]])
        if tok.numel() == 0:
            continue
        gate = torch.cat([g for _, g in kept[e]])
        wg, wu, wd = (_Lin(moe[n][i, e], quant) for n in ("wg", "wu", "wd"))
        x = h[tok]
        y.index_add_(0, tok, wd(F.silu(wg(x)) * wu(x)) * gate[:, None])
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

    ``routes`` (routed mode, expert configurations): per sequence, per
    layer, the experts chosen at each position, (B, T, k). Then returns
    (logits, deficits), the deficits per sequence (L, B, T)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out, deficits = _logits(w, cfg, seqs, cache_window, quant, routes)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out if routes is None else (out, deficits)


def _logits(w, cfg, seqs, cache_window, quant, routes):
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or D // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    window, k = cfg.get("sliding_window"), cfg.get("num_experts_per_tok", 0)
    blocks = w["blocks"]
    xs = [w["embed"][tok].float() for tok, _ in seqs]
    deficits = [[] for _ in seqs]
    for i in range(L):
        at = blocks["attn"]
        lin = {n: _Lin(at[n][i], quant) for n in ("wq", "wk", "wv", "wo")}
        bias = {n: at[n][i].float() if n in at else 0.0 for n in ("bq", "bk", "bv")}
        mlp = None if "moe" in blocks else {n: _Lin(blocks["mlp"][n][i], quant)
                                            for n in ("wg", "wu", "wd")}
        h2s, groups, at_row = [], [], 0
        for j, (tok, S) in enumerate(seqs):
            x = xs[j]
            B, T, _ = x.shape
            h = _rms(x, blocks["norm1"][i], eps)
            q = (lin["wq"](h) + bias["bq"]).view(B, T, H, hd)
            kk = (lin["wk"](h) + bias["bk"]).view(B, T, Hkv, hd)
            v = (lin["wv"](h) + bias["bv"]).view(B, T, Hkv, hd)
            o = _attention(_rope(q, theta), _rope(kk, theta), v, S, window, cache_window)
            xs[j] = x = x + lin["wo"](o.reshape(B, T, H * hd))
            h2 = _rms(x, blocks["norm2"][i], eps)
            if mlp is not None:
                xs[j] = x + mlp["wd"](F.silu(mlp["wg"](h2)) * mlp["wu"](h2))
                continue
            # prompt tokens of every row, row-major; then each decode step's rows
            idx = at_row + torch.arange(B * T, device=x.device).view(B, T)
            groups += [idx[:, :S].reshape(-1)] + [idx[:, t] for t in range(S, T)]
            h2s.append(h2.reshape(B * T, D))
            at_row += B * T
        if mlp is None:
            given = None if routes is None else torch.cat(
                [r[i].reshape(-1, k) for r in routes])
            y, deficit = _experts(blocks["moe"], i, torch.cat(h2s), k, quant, groups, given)
            at_row = 0
            for j, x in enumerate(xs):
                n = x.shape[0] * x.shape[1]
                xs[j] = x + y[at_row:at_row + n].view(x.shape)
                if deficit is not None:
                    deficits[j].append(deficit[at_row:at_row + n].view(x.shape[:2]))
                at_row += n
    head = _Lin(w["embed"].t() if cfg.get("tie_word_embeddings") else w["lm_head"], quant)
    out = []
    for x, (tok, S) in zip(xs, seqs):
        hN = _rms(x[:, S - 1:], w["final_norm"], eps)
        out.append(head(hN))
    return out, [torch.stack(d) if d else None for d in deficits]
