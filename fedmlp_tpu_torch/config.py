"""Typed configuration, field for field the same as ``fedmlp_tpu/config.py``.

The same frozen dataclasses with the same fields and defaults, so one set of
settings drives either package. Fields that select engines of the JAX
package which the port does not have yet (mesh, lockstep, stacked clients,
view concatenation, host streaming, remat, weight streaming, pre-augment)
are kept for that parity and not read by the port; ``ROADMAP.md`` lists
them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

ALGORITHMS = (
    "fedavg",
    "fedmlp",
    "fednoro",
    "cbafed",
    "fixmatch",  # reference name: 'FedAVG+FixMatch'
    "fedlsr",
    "rscfed",
    "fedirm",
    "rofl",
    "centralized",  # single-client sanity config
)

# ImageNet normalization used by every reference transform
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class DataConfig:
    """Dataset geometry + pipeline knobs."""

    name: str = "ChestXray14"  # ChestXray14 | ICH | synthetic
    image_size: int = 224
    channels: int = 3
    n_classes: int = 8
    root: Optional[str] = None
    synthetic_train_size: int = 512
    synthetic_test_size: int = 128
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    # weak-view backend: 'auto' (= 'fused' in the port), 'fused' (the
    # three-shear warp kernel, ops/warp.py), 'normonly' (normalize only, no
    # warp or flip: deterministic views for parity tests and probes)
    augment_backend: str = "auto"
    host_stream: bool = False  # JAX-package engine knob, not read by the port
    stream_window: int = 0  # JAX-package engine knob, not read by the port


@dataclass(frozen=True)
class FedMLPConfig:
    """FedMLP-specific hyperparameters (reference: utils/options.py:46-49,59-64)."""

    rounds_stage1: int = 50
    U: float = 0.7  # tao upper bound
    L: float = 0.3  # tao lower bound
    clean_threshold: float = 0.005
    noise_threshold: float = 0.01
    # τ-scaled tag selection (the variant the reference ships commented
    # out); tao_min floors τ. Default 0 = released fixed-threshold behavior.
    difficulty_estimate: int = 0
    tao_min: float = 0.1
    mixup: int = 0  # stage-2 in-batch mixup ablation; not ported yet
    miss_client_difficulty: int = 1  # parsed by the reference, read nowhere
    # the released reference disables the stage-2 distillation term
    stage2_distill: bool = False


@dataclass(frozen=True)
class RoFLConfig:
    forget_rate: float = 0.2
    num_gradual: int = 10
    T_pl: int = 100
    lambda_cen: float = 1.0
    lambda_e: float = 0.8


@dataclass(frozen=True)
class FedLSRConfig:
    t_w: int = 40


@dataclass(frozen=True)
class FedIRMConfig:
    rounds_sup: int = 20
    consistency: float = 1.0
    consistency_rampup: float = 30.0
    ema_decay: float = 0.99


@dataclass(frozen=True)
class FedNoRoConfig:
    rounds_warmup: int = 500
    begin: int = 10
    end: int = 499
    a: float = 0.8


@dataclass(frozen=True)
class CBAFedConfig:
    rounds_warmup: int = 50


@dataclass(frozen=True)
class MeshConfig:
    client_axis: int = -1
    data_axis: int = 1


@dataclass(frozen=True)
class Config:
    """Top-level config (reference: utils/options.py:4-81)."""

    # system
    deterministic: int = 1
    seed: int = 1037
    # basic
    algorithm: str = "fedmlp"
    model: str = "resnet18"
    batch_size: int = 32
    feature_dim: int = 512
    base_lr: float = 3e-5
    pretrained: int = 0
    pretrained_path: Optional[str] = None
    train: int = 1
    # PSL
    annotation_num: int = 1  # classes annotated per client
    # FL
    n_clients: int = 8
    iid: int = 1
    alpha_dirichlet: float = 0.5
    local_ep: int = 1
    rounds_warmup: int = 500  # total federated rounds
    rounds_corr: int = 200
    rounds_distillation: int = 200
    rounds_finetune: int = 50
    runs: int = 1
    # label hiding: fraction of positives KEPT visible for non-active classes
    p_pos: float = 0.0
    eval_every: int = 10
    checkpoint_every: int = 10
    # numerics: params and Adam state stay f32; 'bfloat16' computes under
    # torch.autocast on the card
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # JAX-package engine knobs, kept for field parity, not read by the port
    scan_unroll: int = 1
    view_concat: str = "auto"
    view_precat: str = "auto"
    client_unroll: int = 0
    small_pack: int = 0
    remat: int = 0
    remat_stages: str = ""
    dw_backend: str = ""
    client_stacking: str = "auto"
    batched_global: str = "auto"
    hoist_augment: int = 0
    pre_augment: int = -1
    weight_stream: int = 0
    # sub-configs
    data: DataConfig = field(default_factory=DataConfig)
    fedmlp: FedMLPConfig = field(default_factory=FedMLPConfig)
    rofl: RoFLConfig = field(default_factory=RoFLConfig)
    fedlsr: FedLSRConfig = field(default_factory=FedLSRConfig)
    fedirm: FedIRMConfig = field(default_factory=FedIRMConfig)
    fednoro: FedNoRoConfig = field(default_factory=FedNoRoConfig)
    cbafed: CBAFedConfig = field(default_factory=CBAFedConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # output
    output_dir: str = "outputs"
    exp_tag: str = ""

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; expected one of {ALGORITHMS}"
            )

    @property
    def n_classes(self) -> int:
        return self.data.n_classes

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def preset(dataset: str, **overrides) -> "Config":
        """Per-dataset presets (reference: dataset/dataset.py:14-17,88-91)."""
        dataset_canon = {
            "chestxray14": "ChestXray14",
            "ich": "ICH",
            "synthetic": "synthetic",
        }.get(dataset.lower())
        if dataset_canon is None:
            raise ValueError(f"unknown dataset {dataset!r}")
        if dataset_canon == "ChestXray14":
            data = DataConfig(name="ChestXray14", n_classes=8)
            base = dict(n_clients=8, base_lr=3e-6, data=data)
        elif dataset_canon == "ICH":
            data = DataConfig(name="ICH", n_classes=5)
            base = dict(n_clients=5, base_lr=3e-5, data=data)
        else:
            data = DataConfig(name="synthetic", n_classes=5, image_size=64)
            base = dict(n_clients=5, base_lr=3e-4, data=data)
        base.update(overrides)
        return Config(**base)


def active_class_lists(cfg: Config) -> list[list[int]]:
    """Client i annotates classes [i*k ... i*k+k-1] mod n_classes
    (reference: main.py:76, active_class_list=[i])."""
    k = cfg.annotation_num
    C = cfg.n_classes
    return [[(i * k + j) % C for j in range(k)] for i in range(cfg.n_clients)]
