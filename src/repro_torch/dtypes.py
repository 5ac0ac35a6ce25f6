"""numpy-style dtype names and canonical tensor bytes.

Content identity in the reference (`repro.core.hashing.tensor_digest`)
hashes `str(numpy_dtype)` ("float32", "bfloat16", "int8"), the shape
as a Python tuple, and the little-endian row-major bytes. `str` of a
`torch.dtype` or `torch.Size` would hash something else and change
every element id, so the port hashes these names and bytes instead.
bf16 has no numpy dtype without ml_dtypes; its bytes are read through
an int16 view (same bits).
"""
from __future__ import annotations

from typing import Dict

import torch

NUMPY_NAME: Dict[torch.dtype, str] = {
    torch.float64: "float64",
    torch.float32: "float32",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.int64: "int64",
    torch.int32: "int32",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
}

BY_NAME: Dict[str, torch.dtype] = {v: k for k, v in NUMPY_NAME.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype ("float32", "bfloat16", ...)."""
    try:
        return NUMPY_NAME[dtype]
    except KeyError:
        raise TypeError(f"dtype {dtype} has no canonical name") from None
