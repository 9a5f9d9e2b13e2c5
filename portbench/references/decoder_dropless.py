"""Plain PyTorch reference of a decoder with sparse experts that drops no
assignment (Mixtral's published block), and the benchmark's weights for it.

Everything is ``decoder.py``'s (its weights from the seed, float32 with
TF32 off, RMSNorm, rotary embeddings, grouped-query attention, the
served semantics of left pads and the ring, the routed mode and the
float8 control) but the expert step: here every token's top-k
assignments are all kept, with no capacity, as transformers'
``MixtralSparseMoeBlock`` keeps them. So which tokens share a group
(the prompt, a decode step) no longer changes the result.

Where it departs from the published block, as ``decoder.py`` does: the
router's logits are float32 (the published block computes them in the
model's bfloat16; the routed mode takes the program's own choices, so
near-ties that bfloat16 flips do not count against it), and pads are
attended, with positions from 0 on every row.

The module loads its own copy of ``decoder.py`` (by path: the references
import nothing of the benchmark or the program) and gives that copy a
capacity of every token of a group: a token takes an expert at most once,
so no assignment falls past it. ``decoder.py`` itself, and every other
cell's reference, are untouched.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path


def _load_decoder():
    path = Path(__file__).resolve().with_name("decoder.py")
    spec = importlib.util.spec_from_file_location("decoder_dropless_base", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_base = _load_decoder()
_base.moe_capacity = lambda tokens, k, experts: tokens
make_weights = _base.make_weights
logits = _base.logits
