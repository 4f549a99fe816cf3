from fedmlp_tpu_torch.parallel.mesh import (
    Mesh,
    launch,
    make_mesh,
    pad_clients,
    pick_backend,
)

__all__ = ["Mesh", "launch", "make_mesh", "pad_clients", "pick_backend"]
