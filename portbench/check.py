"""The comparison that decides ``correct``.

Two layers are judged against plain references under ``references/``,
once the window has closed and the program's state is freed:

* the allocator: every allocation served in the window against the
  NumPy replay of the same features and observations (exact; the limit
  is 0 mismatches);
* the engine and model with their kernels: a sample, drawn from the
  seed, of the invocations served in the window, the longest among them.
  The reference runs once over each invocation's padded prompts and
  served tokens; for every served token, the gap by which the reference's
  logit of that token lies below the reference's best at its position.
  The widest gap over the sample is compared with the cell's limit.
  (The share of served tokens that are not the reference's first is
  read beside it by ``calibrate.py``.)
  Greedy tokens are the argmax of the program's own logits, so a sound
  program's gap is rounding; a wrong token reads the spread of the
  logits.

Every served row must also hold exactly ``max_new`` tokens in the
vocabulary; an invocation that failed, or a row that is missing, is not
correct whatever the gaps read.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def sample(records, seed: int, served_tokens: int) -> List:
    """Completed invocations drawn from the seed, the one with the most
    padded prompt tokens first, until ``served_tokens`` tokens are in."""
    done = [r for r in records if not r.failed]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.batch * r.padded_len, r.max_new))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 3])
    rng.shuffle(rest)
    out, n = [longest], longest.batch * longest.max_new
    for r in rest:
        if n >= served_tokens:
            break
        out.append(r)
        n += r.batch * r.max_new
    return out


def well_formed(records, vocab: int) -> int:
    """Invocations whose served tokens are not max_new ids in the vocabulary
    on every row."""
    bad = 0
    for r in records:
        if r.failed:
            continue
        toks = r.tokens
        if len(toks) != r.batch or any(len(t) != r.max_new for t in toks) or any(
                not (0 <= x < vocab) for t in toks for x in t):
            bad += 1
    return bad


def sequences(recs, device) -> List:
    """(tokens (B, S + max_new - 1), S) per invocation: left-padded prompts
    (pad 0) and all but the last served token."""
    seqs = []
    for r in recs:
        S = r.padded_len
        arr = np.zeros((r.batch, S + r.max_new - 1), np.int64)
        for i, (p, t) in enumerate(zip(r.prompts, r.tokens)):
            arr[i, S - len(p):S] = p
            arr[i, S:] = t[:-1]
        seqs.append((torch.from_numpy(arr).to(device), S))
    return seqs


def gaps(ref_logits: Sequence[torch.Tensor], chosen: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per chosen token (B, max_new) of each sequence: the reference's best
    logit at its position less the reference's logit of the token."""
    out = []
    for lg, ch in zip(ref_logits, chosen):
        best = lg.max(-1).values
        out.append((best - lg.gather(-1, ch[..., None])[..., 0]).reshape(-1))
    return torch.cat(out)


def numbers(g: torch.Tensor) -> Dict[str, float]:
    """The numbers read from the gaps of the compared tokens: the widest
    gap, and the share of tokens that are not the reference's first."""
    return {"logit_gap": float(g.max()),
            "token_mismatch_pct": float((g > 0).double().mean() * 100), "tokens": int(g.numel())}


def served_numbers(ref_module, weights, cfg: Dict, recs, cache_window: int, device,
                   control: bool = False):
    """The numbers of the served tokens; with ``control`` also those of the
    control on the same sequences (the tokens the float8 reference puts
    first, read against the float32 reference)."""
    seqs = sequences(recs, device)
    ref = ref_module.logits(weights, cfg, seqs, cache_window)
    chosen = [torch.as_tensor(np.asarray(r.tokens, np.int64), device=device) for r in recs]
    out = numbers(gaps(ref, chosen))
    if control:
        low = ref_module.logits(weights, cfg, seqs, cache_window, quant="fp8")
        out["control"] = numbers(gaps(ref, [lg.argmax(-1) for lg in low]))
    return out
