"""Federated algorithm registry (FedMLP, FedAVG, FedNoRo, FixMatch and CBAFed
so far)."""

from fedmlp_tpu_torch.algos import cbafed, fedavg, fedmlp, fednoro, fixmatch

_REGISTRY = {"cbafed": cbafed, "fedavg": fedavg, "fedmlp": fedmlp,
             "fednoro": fednoro, "fixmatch": fixmatch}


def registered() -> list[str]:
    return sorted(_REGISTRY)


def get_algorithm(name: str):
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"algorithm {name!r} not ported; have {registered()}")
