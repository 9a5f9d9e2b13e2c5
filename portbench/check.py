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

For a configuration with sparse experts the tokens alone do not decide:
rounding in bfloat16 flips near-tied top-k choices, and a flip changes
which assignments the capacity drops, so a reference that routes on its
own float32 state departs from a sound program by more than a lower
precision does. There the sample is served again through the program's
eager loop (``harness.serve_again``), its router's choices recorded, and:

* ``reserve_mismatches``: invocations whose tokens served again differ
  from the window's (limit 0; the decode step's graph replays the eager
  step's operations);
* ``logit_gap``: as above, against the reference routed as the program
  routed (:func:`routes`);
* ``route_deficit``: over the sample's tokens and layers, the widest
  deficit of the program's choice, the reference's k-th largest router
  logit less its smallest among the chosen experts: 0 where the program
  chose the reference's own top-k, small at a near-tie.

Every served row must also hold exactly ``max_new`` tokens in the
vocabulary; an invocation that failed, or a row that is missing, is not
correct whatever the gaps read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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


def routes(calls: Sequence[torch.Tensor], layers: int, k: int, rec) -> List[torch.Tensor]:
    """The program's routing of one invocation as the reference takes it:
    per layer, the experts (B, T, k) at each position of the invocation's
    sequence (T = S + max_new - 1). ``calls`` holds the expert ids of each
    router call in call order: ``layers`` calls over the prefill's B x S
    positions (row-major), then ``layers`` for each of the ``max_new``
    decode steps over the B rows. The last step's token is never served,
    so its calls are dropped. A record of another count or shape raises:
    it is a fault of the recording, not a pass."""
    B, S, m = rec.batch, rec.padded_len, rec.max_new
    if len(calls) != layers * (1 + m):
        raise ValueError(f"route record: {len(calls)} router calls where {layers} layers x "
                         f"(1 + {m} steps) = {layers * (1 + m)} were due")
    for n, c in enumerate(calls):
        want = (B * S, k) if n < layers else (B, k)
        if tuple(c.shape) != want:
            raise ValueError(f"route record: call {n} holds {tuple(c.shape)}, not {want}")
    return [torch.cat([calls[i].view(B, S, k)]
                      + [calls[layers * (1 + t) + i].view(B, 1, k) for t in range(m - 1)], 1)
            for i in range(layers)]


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
                   control: bool = False, routed: Optional[Sequence] = None):
    """The numbers of the served tokens; with ``control`` also those of the
    control on the same sequences (the tokens the float8 reference puts
    first, read against the float32 reference). ``routed`` (expert
    configurations) gives each invocation's routing (:func:`routes`): both
    references then route as the program did, and the numbers add the
    widest deficit of its choices and the share of (token, layer) choices
    that are not the reference's own top-k."""
    seqs = sequences(recs, device)
    kw = {} if routed is None else {"routes": routed}
    ref = ref_module.logits(weights, cfg, seqs, cache_window, **kw)
    if routed is not None:
        ref, deficits = ref
    chosen = [torch.as_tensor(np.asarray(r.tokens, np.int64), device=device) for r in recs]
    out = numbers(gaps(ref, chosen))
    if routed is not None:
        d = torch.cat([x.reshape(-1) for x in deficits])
        out.update(route_deficit=float(d.max()),
                   route_flip_pct=float((d > 0).double().mean() * 100), choices=int(d.numel()))
    if control:
        low = ref_module.logits(weights, cfg, seqs, cache_window, quant="fp8", **kw)
        if routed is not None:
            low = low[0]
        out["control"] = numbers(gaps(ref, [lg.argmax(-1) for lg in low]))
    return out
