"""Federated algorithm registry: every name of the JAX package's."""

from fedmlp_tpu_torch.algos import (
    cbafed,
    fedavg,
    fedirm,
    fedlsr,
    fedmlp,
    fednoro,
    fixmatch,
    rofl,
    rscfed,
)

_REGISTRY = {"cbafed": cbafed, "centralized": fedavg, "fedavg": fedavg,
             "fedirm": fedirm, "fedlsr": fedlsr, "fedmlp": fedmlp,
             "fednoro": fednoro, "fixmatch": fixmatch, "rofl": rofl,
             "rscfed": rscfed}


def registered() -> list[str]:
    return sorted(_REGISTRY)


def get_algorithm(name: str):
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"algorithm {name!r} not ported; have {registered()}")
