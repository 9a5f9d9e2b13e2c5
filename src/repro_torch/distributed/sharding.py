"""Sharding rules: parameter, optimizer, cache and input specs per arch
(port of ``repro/distributed/sharding.py``).

A spec is a tuple with one entry per tensor dim: an axis name, a tuple
of axis names, or None (unsharded); it equals the reference's
``PartitionSpec`` as a tuple. The rules are the reference's:

* Tensor parallelism over the ``model`` axis follows Megatron pairing:
  column-parallel in-projections (wq/wk/wv/wg/wu/in_proj), row-parallel
  out-projections (wo/wd/out_proj), so each block needs one reduction.
* FSDP: in training every matrix also shards one remaining dim over the
  data axes (("pod", "data") on the multi-pod mesh). Serving keeps the
  weights model-sharded only, unless the config is too big to replicate
  across data rows (``FSDP_SERVE_ARCHS``).
* MoE experts shard over ``model`` when E divides the axis; otherwise
  (mixtral's 8 experts on a 16-wide axis) the expert FFN dim shards.
* Every rule is guarded by divisibility: a dim that does not divide the
  axis stays unsharded.

The meshes are ``launch.mesh.AbstractMesh``es (anything with
``axis_names`` and a ``shape`` mapping of sizes will do), so the rules
plan a production mesh without its devices. :func:`to_placements` maps a
spec onto ``torch.distributed.tensor`` placements (the counterpart of the
reference's ``named``); applying them across GPUs waits for a machine
with more than one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

Spec = Tuple[Any, ...]

# Archs whose bf16 weights cannot be replicated across data rows at serve time.
FSDP_SERVE_ARCHS = {"internvl2-76b", "arctic-480b"}


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    mesh: Any
    data_axes: Tuple[str, ...]  # ("pod", "data") or ("data",)
    model_axis: str = "model"

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis]

    @property
    def data_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.data_axes)


def mesh_info(mesh) -> MeshInfo:
    return MeshInfo(mesh=mesh, data_axes=tuple(a for a in mesh.axis_names if a != "model"))


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


class _Ruler:
    """Builds guarded specs for one (config, mesh, mode)."""

    def __init__(self, cfg, mi: MeshInfo, mode: str):
        if mode not in ("train", "serve"):
            raise ValueError(f"mode {mode!r}")
        self.cfg = cfg
        self.mi = mi
        self.mode = mode
        self.m = mi.model_axis
        self.dp = mi.data_axes if len(mi.data_axes) > 1 else mi.data_axes[0]
        self.msize = mi.model_size
        self.dsize = mi.data_size
        self.fsdp = mode == "train" or cfg.name in FSDP_SERVE_ARCHS

    def _axis(self, dim: int, axis_name, size: int):
        return axis_name if _div(dim, size) else None

    def matrix(self, shape: Tuple[int, ...], model_dim: int, fsdp_dim) -> Spec:
        """Spec for a (possibly layer-stacked) matrix; ``model_dim`` and
        ``fsdp_dim`` index the trailing dims of the logical weight (negative
        from the end)."""
        nd = len(shape)
        spec: list = [None] * nd
        mdim = nd + model_dim if model_dim < 0 else model_dim
        spec[mdim] = self._axis(shape[mdim], self.m, self.msize)
        if self.fsdp and fsdp_dim is not None:
            fdim = nd + fsdp_dim if fsdp_dim < 0 else fsdp_dim
            if fdim != mdim:
                spec[fdim] = self._axis(shape[fdim], self.dp, self.dsize)
        return tuple(spec)

    def replicated(self, shape) -> Spec:
        return (None,) * len(shape)

    def fsdp_only(self, shape: Tuple[int, ...], fsdp_dim: int) -> Spec:
        """No tensor parallelism; one dim over the data axes under FSDP."""
        nd = len(shape)
        spec: list = [None] * nd
        if self.fsdp:
            fdim = nd + fsdp_dim if fsdp_dim < 0 else fsdp_dim
            spec[fdim] = self._axis(shape[fdim], self.dp, self.dsize)
        return tuple(spec)


def _leaf_spec(r: _Ruler, name: str, arr) -> Spec:
    """Spec for one parameter leaf by name; a stacked layer axis (leading)
    is left to the rules on the trailing dims."""
    cfg, shape, nd = r.cfg, tuple(arr.shape), arr.ndim

    if name == "wq":  # (.., D, out) column-parallel: whole heads only
        if _div(cfg.num_heads, r.msize):
            return r.matrix(shape, model_dim=-1, fsdp_dim=-2)
        return r.fsdp_only(shape, fsdp_dim=-2)
    if name in ("wk", "wv"):
        # GQA: shard only when kv heads split evenly over the model axis
        if _div(cfg.num_kv_heads, r.msize):
            return r.matrix(shape, model_dim=-1, fsdp_dim=-2)
        return r.fsdp_only(shape, fsdp_dim=-2)
    if name == "wo":  # (.., q_dim, D) row-parallel
        if _div(cfg.num_heads, r.msize):
            return r.matrix(shape, model_dim=-2, fsdp_dim=-1)
        return r.fsdp_only(shape, fsdp_dim=-2)
    if name in ("wg", "wu"):
        if nd >= 3 and shape[-3] == cfg.num_experts and cfg.num_experts > 1:
            # MoE experts (.., E, D, F)
            if _div(cfg.num_experts, r.msize):
                return r.matrix(shape, model_dim=-3, fsdp_dim=-1)
            return r.matrix(shape, model_dim=-1, fsdp_dim=-2)
        return r.matrix(shape, model_dim=-1, fsdp_dim=-2)
    if name == "wd":
        if nd >= 3 and shape[-3] == cfg.num_experts and cfg.num_experts > 1:
            if _div(cfg.num_experts, r.msize):
                return r.matrix(shape, model_dim=-3, fsdp_dim=-2)
            return r.matrix(shape, model_dim=-2, fsdp_dim=-1)
        return r.matrix(shape, model_dim=-2, fsdp_dim=-1)
    if name == "bq":  # (.., out)
        if _div(cfg.num_heads, r.msize):
            return r.matrix(shape, model_dim=-1, fsdp_dim=None)
        return r.replicated(shape)
    if name in ("bk", "bv"):
        if _div(cfg.num_kv_heads, r.msize):
            return r.matrix(shape, model_dim=-1, fsdp_dim=None)
        return r.replicated(shape)
    if name == "router":
        return r.replicated(shape)
    if name == "in_proj":  # (.., D, Z) column-parallel
        return r.matrix(shape, model_dim=-1, fsdp_dim=-2)
    if name == "out_proj":  # (.., d_in, D) row-parallel
        return r.matrix(shape, model_dim=-2, fsdp_dim=-1)
    if name in ("conv_w", "conv_b"):  # (.., K, C) / (.., C)
        return r.matrix(shape, model_dim=-1, fsdp_dim=None)
    if name == "embed":  # (V, D)
        if _div(shape[-2], r.msize):
            return r.matrix(shape, model_dim=-2, fsdp_dim=-1)
        return r.matrix(shape, model_dim=-1, fsdp_dim=-2)
    if name == "lm_head":  # (D, V)
        if _div(shape[-1], r.msize):
            return r.matrix(shape, model_dim=-1, fsdp_dim=-2)
        return r.matrix(shape, model_dim=-2, fsdp_dim=-1)
    # norms, positions, A_log, dt_bias, D, scalars
    return r.replicated(shape)


def param_spec_tree(cfg, mesh, mode: str, params_shape) -> Dict[str, Any]:
    """The rules applied to a params tree (tensors, meta tensors or
    anything with ``shape`` and ``ndim``), keyed as the tree."""
    r = _Ruler(cfg, mesh_info(mesh), mode)

    def walk(tree, name="param"):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _leaf_spec(r, name, tree)

    return walk(params_shape)


def cache_spec_tree(cfg, mesh, cache_shape) -> Dict[str, Spec]:
    """Specs for the decode cache (stacked layer leading axis), under the
    reference's keys (``configs.cache_specs``)."""
    r = _Ruler(cfg, mesh_info(mesh), "serve")
    dp = r.dp
    out: Dict[str, Spec] = {}
    for name, leaf in cache_shape.items():
        shape = tuple(leaf.shape)
        if name == "pos":
            out[name] = (dp if _div(shape[0], r.dsize) else None,)
        elif name in ("k", "v", "xk", "xv"):
            # (L, B, W, Hkv, hd): batch over data; kv heads over model when
            # divisible, else the window carries the model axis. An
            # unshardable batch (long_500k, B = 1) puts the data axes on the
            # window instead.
            b = dp if _div(shape[1], r.dsize) else None
            w = None if b is not None else (dp if _div(shape[2], r.dsize) else None)
            if _div(shape[3], r.msize):
                out[name] = (None, b, w, r.m, None)
            elif w is None and _div(shape[2], r.msize):
                out[name] = (None, b, r.m, None, None)
            else:
                out[name] = (None, b, w, None, None)
        elif name == "conv":  # (L, B, K-1, C)
            b = dp if _div(shape[1], r.dsize) else None
            out[name] = (None, b, None, r.m if _div(shape[3], r.msize) else None)
        elif name == "ssd":  # (L, B, H, P, N)
            b = dp if _div(shape[1], r.dsize) else None
            out[name] = (None, b, r.m if _div(shape[2], r.msize) else None, None, None)
        else:
            raise ValueError(f"unknown cache entry {name!r}")
    return out


def input_spec_tree(cfg, mesh, shape, specs) -> Dict[str, Any]:
    """Specs for the step inputs of ``configs.input_specs``: batch over the
    data axes where it divides them."""
    r = _Ruler(cfg, mesh_info(mesh), "serve")
    out: Dict[str, Any] = {}
    for name, leaf in specs.items():
        if name == "cache":
            out[name] = cache_spec_tree(cfg, mesh, leaf)
            continue
        b = r.dp if _div(leaf.shape[0], r.dsize) else None
        out[name] = (b,) + (None,) * (len(leaf.shape) - 1)
    return out


def opt_state_specs(param_specs_tree) -> Dict[str, Any]:
    """Optimizer state mirrors the parameter sharding."""
    return {"step": (), "m": param_specs_tree, "v": param_specs_tree}


def shard_count(spec: Spec, mesh) -> int:
    """Into how many pieces ``spec`` cuts a tensor on ``mesh``."""
    n = 1
    for entry in spec:
        for axis in (entry,) if isinstance(entry, str) else (entry or ()):
            n *= mesh.shape[axis]
    return n


def to_placements(spec: Spec, mesh) -> list:
    """One ``torch.distributed.tensor`` placement per mesh axis, in the
    mesh's axis order: ``Shard(d)`` where tensor dim d names the axis
    (alone or in a tuple of axes), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for d, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else (entry or ()):
            dims[axis] = d
    return [Shard(dims[a]) if a in dims else Replicate() for a in mesh.axis_names]
