"""Where the port runs: the device its entry points default to.

The default is the CUDA card.  The CPU is used only when a caller asks
for it (``device="cpu"``, as the tests do); nothing here picks it by
itself, and asking for CUDA on a machine without a card raises.
"""

from __future__ import annotations

import re
from typing import Union

import torch

__all__ = ["device", "backend_key"]

DeviceLike = Union[str, torch.device, None]


def device(dev: DeviceLike = None) -> torch.device:
    """Resolve a device request; ``None`` means the CUDA card."""
    d = torch.device("cuda" if dev is None else dev)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d} (have cuda, cpu)")
    return d


def backend_key(dev: DeviceLike = None) -> str:
    """A short name for the hardware behind a device: ``"cpu"``, or
    ``"cuda:"`` and the card's model, e.g. ``"cuda:h100"``."""
    d = device(dev)
    if d.type == "cpu":
        return "cpu"
    name = torch.cuda.get_device_name(d).lower()
    m = re.search(r"\b([a-z]+\d+[a-z]*)\b", name.replace("nvidia", ""))
    return f"cuda:{m.group(1) if m else name.replace(' ', '_')}"
