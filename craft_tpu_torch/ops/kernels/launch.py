"""What every kernel wrapper shares: the ctypes call into a built library,
input checks, and the launch counts.

Each wrapper that launches a hand-written kernel is registered with
``counted``; it adds one to its ``launches`` attribute where it launches the
kernel and nowhere else (never on the plain path of a CPU tensor), so a run
can show which kernels a path went through.
"""

from __future__ import annotations

import ctypes

import torch

from craft_tpu_torch.ops.kernels import build

P, I, F, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
L = ctypes.c_longlong
MAX_MODE_DIM = 64

_COUNTED: list = []


def counted(fn):
    """Register a kernel wrapper for launch_counts()."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    """{wrapper name: kernel launches} for every registered wrapper."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


def call(lib: str, fn_name: str, argtypes, *args) -> None:
    """Call `fn_name` of csrc/<lib>.cu (built on first use); raise when it
    returns a CUDA error."""
    fn = getattr(build.load(lib), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    build.check(fn(*args), fn_name)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(*tensors) -> None:
    for t in tensors:
        if not t.is_cuda or t.device != tensors[0].device:
            raise ValueError("kernel inputs must lie on one CUDA device")


def prep(*tensors):
    """Kernel inputs: one CUDA device, one dtype (bf16 or fp32), contiguous,
    mode dim <= MAX_MODE_DIM.  Returns (contiguous tensors, in_bf16 flag)."""
    check_cuda(*tensors)
    dt = tensors[0].dtype
    for t in tensors:
        if t.dtype != dt or dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"kernel inputs must share bf16 or fp32, got "
                             f"{[x.dtype for x in tensors]}")
    if tensors[0].shape[-1] > MAX_MODE_DIM:
        raise ValueError(f"mode dim {tensors[0].shape[-1]} > {MAX_MODE_DIM}")
    return [t.contiguous() for t in tensors], int(dt == torch.bfloat16)


def f32(x, like: torch.Tensor) -> torch.Tensor:
    """x as a flat contiguous fp32 tensor on like's device."""
    return torch.as_tensor(x, dtype=torch.float32,
                           device=like.device).reshape(-1).contiguous()
