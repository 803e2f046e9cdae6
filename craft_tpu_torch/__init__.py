"""CRAFT optical flow in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA counterpart of the JAX package ``craft_tpu``: the same
modules, parameter names and public layouts (NHWC images in [0, 255]), run on
an NVIDIA GPU.  Nothing here imports JAX, flax or ``craft_tpu``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else CUDA.

    With no device given, or a CUDA device asked for, and no CUDA present
    this raises: the port does not quietly carry on on the CPU (pass
    ``device="cpu"`` to ask for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
