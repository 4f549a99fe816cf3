from fedmlp_tpu_torch.fl.aggregate import (
    daagg,
    daagg_weights,
    fedavg,
    fedavg_proto,
    fedavg_tao,
    model_dist,
    weighted_sum,
)

__all__ = ["daagg", "daagg_weights", "fedavg", "fedavg_tao", "fedavg_proto", "model_dist",
           "weighted_sum"]
