"""Federated algorithm registry (FedMLP and FedAVG so far)."""

from fedmlp_tpu_torch.algos import fedavg, fedmlp

_REGISTRY = {"fedavg": fedavg, "fedmlp": fedmlp}


def registered() -> list[str]:
    return sorted(_REGISTRY)


def get_algorithm(name: str):
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"algorithm {name!r} not ported; have {registered()}")
