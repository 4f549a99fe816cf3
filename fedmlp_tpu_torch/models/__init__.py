from fedmlp_tpu_torch.models.factory import (MODEL_REGISTRY, build_model,
                                             feature_dim_of, init_model,
                                             load_pretrained)

__all__ = ["build_model", "MODEL_REGISTRY", "feature_dim_of", "init_model",
           "load_pretrained"]
