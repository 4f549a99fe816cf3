from fedmlp_tpu_torch.fl.aggregate import fedavg, fedavg_proto, fedavg_tao

__all__ = ["fedavg", "fedavg_tao", "fedavg_proto"]
