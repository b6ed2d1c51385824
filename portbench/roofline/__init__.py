"""The least work each window kernel's algorithm needs, and the card's
peaks to hold it against (one file per kernel, `<kernel>.py`, whose
`KERNEL` is the name the device trace prints and whose `per_window(net)`
counts a window's work). A kernel's file is found by its name: adding a
kernel adds a file."""
from __future__ import annotations

import importlib
import pkgutil


def kernels() -> dict:
    """{module name: module} of every kernel's file in this folder."""
    out = {}
    for m in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{m.name}")
        if hasattr(mod, "KERNEL"):
            out[m.name] = mod
    return out
