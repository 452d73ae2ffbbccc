"""Device selection for the port's entry points: the card unless the caller
asks for the CPU.  With no card and no request for the CPU, they raise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(DTYPES)}")
    return DTYPES[name]
