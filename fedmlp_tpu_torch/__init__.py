"""fedmlp_tpu_torch — the FedMLP federated-learning simulator in PyTorch and
CUDA, a port of the JAX package ``fedmlp_tpu`` beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no such request they raise instead of falling back to the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else cuda."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "on the CPU")
    return dev
