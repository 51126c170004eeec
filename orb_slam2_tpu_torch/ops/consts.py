"""Constant tensors, made once per device and reused.

A constant built from a host value on every call (`torch.tensor(v,
device=cuda)`) is a blocking host-to-device copy each time, and such a
copy is illegal while a CUDA graph is being captured.  These helpers make
each constant once, on its first use, and hand back the same tensor
after; a step that is warmed up eagerly before its capture therefore
captures no copy at all.
"""

from __future__ import annotations

import numpy as np
import torch

_scalars = {}   # (value, dtype, device) -> 0-dim tensor
_tables = {}    # (id(array), dtype, device) -> (array, tensor)


def scalar(value, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A 0-dim `dtype` tensor of `value` on `device`; a tensor is passed
    through as it is.  (Dividing a CUDA tensor by a Python scalar
    multiplies by its reciprocal, so divisors go to the device too.)"""
    if torch.is_tensor(value):
        return value
    device = torch.device(device)
    key = (float(value), dtype, device)
    t = _scalars.get(key)
    if t is None:
        t = _scalars[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def table(array: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """`array` as a `dtype` tensor on `device`, copied once.  Keyed by the
    array object: a module that replaces its table (brief.set_pattern)
    gets a fresh copy, and the cache holds the array so its id stays
    unique."""
    device = torch.device(device)
    key = (id(array), dtype, device)
    hit = _tables.get(key)
    if hit is None or hit[0] is not array:
        hit = _tables[key] = (array, torch.as_tensor(array, dtype=dtype,
                                                     device=device))
    return hit[1]
