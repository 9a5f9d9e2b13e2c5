"""Carry reference parameters into the port.

``params_from_numpy`` takes the reference's ``init_params`` pytree after
it has been turned into numpy arrays (``numpy.asarray`` per leaf) and
returns the port's parameter dict: the same nested keys, the same
shapes, tensors on ``device``. Each leaf keeps its own floating type: a
float32 leaf stays float32 (Mamba2's ``A_log``, ``dt_bias`` and ``D``
are float32 even in a bfloat16 model), and any other leaf takes the
config's dtype. Every leaf goes through float32, which holds bfloat16
values exactly, so the conversion changes no value.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    dt = cfg.torch_dtype

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        keep_f32 = np.asarray(node).dtype == np.float32
        arr = np.array(node, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=device,
                                        dtype=torch.float32 if keep_f32 else dt)

    return conv(tree)
