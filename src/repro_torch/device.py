"""Device resolution and the card's (storage -> accumulator) dtype table.

Every entry point of the port takes ``device=``. Without one it runs on
CUDA, and raises when there is no card: a caller who wants the plain
PyTorch versions on the CPU (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "faking", "accum_dtype", "card_dtype_code",
           "CARD_DTYPES"]

# storage dtype -> accumulator dtype of the CUDA kernels. bf16 tables
# accumulate in f32 and are rounded once, at the store; no other dtype runs
# on the card (the JAX package's compiled-pair table, ema/ops.py).
CARD_DTYPES = {torch.float32: torch.float32, torch.bfloat16: torch.float32}
# the dtype code the kernels' C entry points take (0 = f32, 1 = bf16)
_CODES = {dt: code for code, dt in enumerate(CARD_DTYPES)}


def faking() -> bool:
    """True while nothing real runs: a ``FakeTensorMode`` is active, or
    the default process group is the ``"fake"`` backend (the dry run's,
    ``launch/dryrun``). A CUDA device then needs no card."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from torch._subclasses.fake_tensor import FakeTensorMode
    if any(isinstance(m, FakeTensorMode)
           for m in _get_current_dispatch_mode_stack()):
        return True
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "fake")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` for a CUDA device when
    no card is present, unless nothing real runs (:func:`faking`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available() \
            and not faking():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sub-f32 storage accumulates in f32; wider dtypes pass through."""
    return torch.float32 if dtype.itemsize < 4 else dtype


def card_dtype_code(dtype: torch.dtype) -> int:
    """The kernels' code for a storage dtype; raises for one the card's
    table does not hold (never a silent downcast)."""
    if dtype not in _CODES:
        raise TypeError(f"the CUDA kernels take "
                        f"{sorted(map(str, CARD_DTYPES))} storage, got {dtype}")
    return _CODES[dtype]
