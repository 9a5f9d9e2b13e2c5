"""Carry reference parameters into the port.

``params_from_numpy`` takes the reference's ``init_params`` pytree after
it has been turned into numpy arrays (``numpy.asarray`` per leaf) and
returns the port's parameter dict: the same nested keys, the same
shapes, tensors in the config's dtype on ``device``. Every leaf goes
through float32, which holds bfloat16 values exactly, so the conversion
changes no value.
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
        arr = np.array(node, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    return conv(tree)
