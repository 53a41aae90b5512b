"""ELANA on PyTorch and CUDA: the port of the ``repro`` package to an NVIDIA
H100.  It imports nothing of JAX or of ``repro``; the tests hold it against
the reference on the same parameters and inputs.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; asking for
    it on a machine with no GPU raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but no GPU is "
                               "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
