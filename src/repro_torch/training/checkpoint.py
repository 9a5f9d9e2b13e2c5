"""Checkpoints in the reference's bundle format (port of
``repro/training/checkpoint.py``).

A checkpoint is one MessagePack map ``{"manifest": <json str>, "data":
{"<bundle>:<path>": <bytes>}}``: each leaf's raw bytes keyed by its
bundle (``params``, ``opt_state``) and its path, the dict keys joined
with ``/`` in sorted order (the order in which ``jax.tree_util``
flattens a dict); the JSON manifest holds the step, ``extra``, and each
leaf's shape and NumPy dtype name (``bfloat16``, ``float32``, ``int32``).
The file is written under a temporary name and renamed into place, so a
killed run never leaves half a checkpoint. Files written by either
package load in the other, and for the same values they are equal byte
for byte.

The port needs neither ``msgpack`` nor ``ml_dtypes`` (the GPU machine has
neither): it packs with :mod:`repro_torch.training._msgpack`, and moves
bfloat16 leaves as bytes through ``torch``, never through NumPy.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.training import _msgpack

DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int32: "int32"}
DTYPES = {name: dt for dt, name in DTYPE_NAMES.items()}


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _leaf_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)  # numpy has no bfloat16: move its bits
    return t.numpy().tobytes()


def _leaf_from_bytes(data: bytes, info: Dict[str, Any]) -> torch.Tensor:
    dtype = DTYPES[info["dtype"]]
    if not data:
        return torch.empty(info["shape"], dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(info["shape"])


def save_checkpoint(path: str, *, step: int, params, opt_state=None,
                    extra: Dict[str, Any] = None) -> str:
    """Write an atomic checkpoint bundle; returns the final path."""
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    bundles = {"params": _flatten(params)}
    if opt_state is not None:
        bundles["opt_state"] = _flatten(opt_state)
    manifest = {"step": step, "extra": extra or {}, "bundles": {}}
    payload: Dict[str, bytes] = {}
    for bname, flat in bundles.items():
        man = {}
        for key, t in flat.items():
            payload[f"{bname}:{key}"] = _leaf_bytes(t)
            man[key] = {"shape": list(t.shape), "dtype": DTYPE_NAMES[t.dtype]}
        manifest["bundles"][bname] = man
    blob = _msgpack.packb({"manifest": json.dumps(manifest), "data": payload})
    with tempfile.NamedTemporaryFile(dir=out.parent, delete=False, suffix=".tmp") as f:
        f.write(blob)
        tmp = f.name
    os.replace(tmp, out)  # atomic commit
    return str(out)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Returns {step, extra, params, opt_state?} with CPU tensors keyed by
    tree path (use :func:`restore_into` to rebuild a dict tree)."""
    blob = _msgpack.unpackb(Path(path).read_bytes())
    manifest = json.loads(blob["manifest"])
    out: Dict[str, Any] = {"step": manifest["step"], "extra": manifest["extra"]}
    for bname, man in manifest["bundles"].items():
        out[bname] = {key: _leaf_from_bytes(blob["data"][f"{bname}:{key}"], info)
                      for key, info in man.items()}
    return out


def restore_into(template, flat: Dict[str, torch.Tensor]):
    """Rebuild a dict tree with ``template``'s structure from flat leaves,
    each placed on its template leaf's device and dtype."""

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        key = prefix[:-1]
        t = torch.as_tensor(flat[key])
        if tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {tuple(t.shape)}, "
                             f"expected {tuple(node.shape)}")
        return t.to(device=node.device, dtype=node.dtype)

    return rebuild(template, "")
