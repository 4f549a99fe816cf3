"""fedmlp_tpu_torch — the FedMLP federated-learning simulator in PyTorch and
CUDA, a port of the JAX package ``fedmlp_tpu`` beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no such request they raise instead of falling back to the CPU.
"""

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else cuda. A
    card without an index is, in a process that a launcher started with a
    LOCAL_RANK, card LOCAL_RANK modulo the cards (ranks may share one)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return dev
