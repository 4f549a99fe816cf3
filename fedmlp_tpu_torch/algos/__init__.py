"""Federated algorithm registry (FedMLP only in this slice of the port)."""

from fedmlp_tpu_torch.algos import fedmlp

_REGISTRY = {"fedmlp": fedmlp}


def get_algorithm(name: str):
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"algorithm {name!r} not ported; have {sorted(_REGISTRY)}")
