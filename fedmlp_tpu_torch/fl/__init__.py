from fedmlp_tpu_torch.fl.aggregate import (
    daagg,
    daagg_weights,
    fed_w,
    fedavg,
    fedavg_proto,
    fedavg_rela,
    fedavg_tao,
    model_dist,
    rscfed,
    weighted_sum,
)

__all__ = ["daagg", "daagg_weights", "fed_w", "fedavg", "fedavg_proto", "fedavg_rela",
           "fedavg_tao", "model_dist", "rscfed", "weighted_sum"]
