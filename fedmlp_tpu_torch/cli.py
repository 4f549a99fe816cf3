"""CLI — the flags of ``fedmlp_tpu/cli.py`` under the same names and defaults
(a flag-for-flag superset of the reference's argparse surface,
utils/options.py:4-81), plus ``--device``.

Usage:
    python -m fedmlp_tpu_torch.cli --exp FedMLP --dataset synthetic --rounds 20
    python -m fedmlp_tpu_torch.cli --exp FedMLP --model Resnet18 --data_root <shard>

``--data_root`` names a directory with a packed ``train/`` and ``test/``
(``data/datasets.py::save_packed_dataset``, or ``tools/ingest.py``). Runs
on the card unless ``--device cpu`` is given; without a card and without
that flag it raises. An ``--exp``, ``--model`` or engine value that the
port has not got exits with a message that says so.

Under ``torchrun --nproc_per_node N -m fedmlp_tpu_torch.cli ...`` the N
processes form one group and the run shards over them (the JAX CLI shards
over every device): the clients split over N client shards, each rank
takes card LOCAL_RANK modulo the cards, and only rank 0 writes logs,
metrics and checkpoints. A rank that raises ends the group with a non-zero
exit.
"""

from __future__ import annotations

import argparse
import logging
import os

from fedmlp_tpu_torch import resolve_device
from fedmlp_tpu_torch.config import (
    CBAFedConfig,
    Config,
    DataConfig,
    FedIRMConfig,
    FedLSRConfig,
    FedMLPConfig,
    FedNoRoConfig,
    RoFLConfig,
)

# reference --exp spellings → canonical algorithm names
EXP_ALIASES = {
    "fedavg": "fedavg",
    "fedmlp": "fedmlp",
    "femlp": "fedmlp",  # reference name-skew normalization (SURVEY.md §0)
    "fednoro": "fednoro",
    "cbafed": "cbafed",
    "fedavg+fixmatch": "fixmatch",
    "fixmatch": "fixmatch",
    "fedlsr": "fedlsr",
    "rscfed": "rscfed",
    "fedirm": "fedirm",
    "rofl": "rofl",
    "centralized": "centralized",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("fedmlp_tpu_torch")
    # system (reference: utils/options.py:8-11)
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--seed", type=int, default=1037)
    # basic (:14-27)
    p.add_argument("--exp", type=str, default="FedMLP")
    p.add_argument("--dataset", type=str, default="ChestXray14")
    p.add_argument("--model", type=str, default="Resnet18")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--feature_dim", type=int, default=512)
    p.add_argument("--base_lr", type=float, default=None,
                   help="default: per-dataset preset (ICH 3e-5, CXR 3e-6)")
    p.add_argument("--pretrained", type=int, default=0)
    p.add_argument("--pretrained_path", type=str, default=None,
                   help="converted backbone weights (not ported yet)")
    p.add_argument("--train", type=int, default=1)
    # PSL (:30-31)
    p.add_argument("--annotation_num", type=int, default=1)
    # FL (:34-50)
    p.add_argument("--n_clients", type=int, default=None)
    p.add_argument("--n_classes", type=int, default=None)
    p.add_argument("--iid", type=int, default=1)
    p.add_argument("--alpha_dirichlet", type=float, default=0.5)
    p.add_argument("--local_ep", type=int, default=1)
    p.add_argument("--rounds_warmup", "--rounds", type=int, default=500)
    p.add_argument("--rounds_corr", type=int, default=200)
    p.add_argument("--rounds_distillation", type=int, default=200)
    p.add_argument("--rounds_finetune", type=int, default=50)
    p.add_argument("--rounds_FedMLP_stage1", type=int, default=50)
    p.add_argument("--U", type=float, default=0.7)
    p.add_argument("--L", type=float, default=0.3)
    p.add_argument("--tao_min", type=float, default=0.1)
    p.add_argument("--runs", type=int, default=1)
    # RoFL (:53-57)
    p.add_argument("--forget_rate", type=float, default=0.2)
    p.add_argument("--num_gradual", type=int, default=10)
    p.add_argument("--T_pl", type=int, default=100)
    p.add_argument("--lambda_cen", type=float, default=1.0)
    p.add_argument("--lambda_e", type=float, default=0.8)
    # FedMLP ablation (:60-64)
    # defaults 0 = released reference behavior (it parses 1 for both but
    # never reads them from main.py); 1 enables the wired implementations
    p.add_argument("--difficulty_estimate", type=int, default=0,
                   help="τ-scaled stage-2 tag selection (the reference's "
                        "commented-out variant, local_training.py:1072-1073)")
    p.add_argument("--mixup", type=int, default=0,
                   help="in-batch mixup in FedMLP stage 2 "
                        "(DatasetSplit_Mixup equivalent)")
    p.add_argument("--miss_client_difficulty", type=int, default=1)
    p.add_argument("--clean_threshold", type=float, default=0.005)
    p.add_argument("--noise_threshold", type=float, default=0.01)
    p.add_argument("--stage2_distill", type=int, default=0,
                   help="enable the paper-form stage-2 distillation term")
    # FedLSR (:67)
    p.add_argument("--t_w", type=int, default=40)
    # FedIRM (:69-72)
    p.add_argument("--rounds_FedIRM_sup", type=int, default=20)
    p.add_argument("--consistency", type=float, default=1.0)
    p.add_argument("--consistency_rampup", type=float, default=30.0)
    p.add_argument("--ema_decay", type=float, default=0.99)
    # FedNoRo (:74-77)
    p.add_argument("--rounds_FedNoRo_warmup", type=int, default=500)
    p.add_argument("--begin", type=int, default=10)
    p.add_argument("--end", type=int, default=499)
    p.add_argument("--a", type=float, default=0.8)
    # CBAFed (:79)
    p.add_argument("--rounds_CBAFed_warmup", type=int, default=50)
    # extensions beyond the reference's flags
    p.add_argument("--p_pos", type=float, default=0.0,
                   help="fraction of non-active positives kept visible")
    p.add_argument("--data_root", type=str, default=None,
                   help="packed dataset dir (images.npy/targets.npy/meta.json)")
    p.add_argument("--image_size", type=int, default=None,
                   help="override dataset image size (must match the packed "
                        "shard when --data_root is set)")
    p.add_argument("--host_stream", type=int, default=0,
                   help="stream training batches from the packed shard "
                        "(not ported yet)")
    p.add_argument("--stream_window", type=int, default=0,
                   help="with --host_stream: run each round in W-step "
                        "windows (not ported yet)")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--exp_tag", type=str, default="")
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--checkpoint_every", type=int, default=10)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--augment_backend", type=str, default="auto",
                   choices=["auto", "gather", "paeth", "pallas", "fused",
                            "normonly"])
    # engine knobs of the JAX package: same names and defaults; a value the
    # port has no engine for exits with a message (train.py::check_ported)
    p.add_argument("--scan_unroll", type=int, default=1)
    p.add_argument("--view_concat", type=str, default="auto",
                   choices=["auto", "off", "on"],
                   help="dual-view losses as one 2B forward (auto = off)")
    p.add_argument("--view_precat", type=str, default="auto",
                   choices=["auto", "off", "on"],
                   help="lockstep engine with --view_concat on: concatenate "
                        "the two views once a step (auto = off)")
    p.add_argument("--remat", type=int, default=0,
                   help="rematerialize backbone blocks in the backward "
                        "pass (EfficientNet, ResNet, SE-ResNet)")
    p.add_argument("--remat_stages", type=str, default="",
                   help="selective remat: comma list of EfficientNet "
                        "stage indices")
    p.add_argument("--client_unroll", type=int, default=0,
                   help="shapes the JAX package's XLA program; the identity here")
    p.add_argument("--small_pack", type=int, default=0,
                   help="shapes the JAX package's XLA program; the identity here")
    p.add_argument("--dw_backend", type=str, default="",
                   choices=["", "conv", "taps", "pallas", "dense"],
                   help="EfficientNet depthwise-conv implementation (models/"
                        "efficientnet.py::MBConv): '' and 'conv' are the "
                        "grouped conv, 'pallas' adds the hand-written "
                        "backward kernels, 'taps' sums k*k shifted products, "
                        "'dense' runs a diagonal dense conv in the layers of "
                        "at most FEDMLP_DW_DENSE_MAXCH (192) depthwise "
                        "channels; wider layers stay grouped")
    p.add_argument("--client_stacking", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="channel-stacked lockstep clients (auto = off)")
    p.add_argument("--hoist_augment", type=int, default=0)
    p.add_argument("--pre_augment", type=int, default=-1,
                   help="make each round's views before it, N images at a "
                        "time (-1 auto and 0 are off)")
    p.add_argument("--weight_stream", type=int, default=0,
                   help="per-client loop with bfloat16 compute: each step "
                        "reads the parameters rounded to bfloat16")
    p.add_argument("--batched_global", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="lockstep loop order (auto = off)")
    p.add_argument("--synthetic_train_size", type=int, default=512)
    p.add_argument("--synthetic_test_size", type=int, default=128)
    # the one flag the port adds: its entry points name their device
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    return p


def args_parser(argv=None):
    return build_parser().parse_args(argv)


def config_from_args(a) -> Config:
    algo = EXP_ALIASES.get(a.exp.lower())
    if algo is None:
        raise SystemExit(f"unknown --exp {a.exp!r}")
    cfg = Config.preset(a.dataset, algorithm=algo)
    data = cfg.data
    if a.n_classes:
        data = DataConfig(**{**data.__dict__, "n_classes": a.n_classes})
    if a.data_root:
        data = DataConfig(**{**data.__dict__, "root": a.data_root})
    if a.image_size:
        data = DataConfig(**{**data.__dict__, "image_size": a.image_size})
    if a.augment_backend != "auto":
        data = DataConfig(**{**data.__dict__, "augment_backend": a.augment_backend})
    if a.host_stream:
        if not a.data_root:
            raise SystemExit("--host_stream requires --data_root (packed shard)")
        data = DataConfig(**{**data.__dict__, "host_stream": True})
    if a.stream_window:
        if not a.host_stream:
            raise SystemExit("--stream_window requires --host_stream")
        data = DataConfig(**{**data.__dict__, "stream_window": a.stream_window})
    if a.dataset.lower() == "synthetic":
        data = DataConfig(**{
            **data.__dict__,
            "synthetic_train_size": a.synthetic_train_size,
            "synthetic_test_size": a.synthetic_test_size,
        })
    cfg = cfg.replace(
        deterministic=a.deterministic,
        seed=a.seed,
        model=a.model,
        batch_size=a.batch_size,
        base_lr=a.base_lr if a.base_lr is not None else cfg.base_lr,
        pretrained=a.pretrained,
        pretrained_path=a.pretrained_path,
        train=a.train,
        annotation_num=a.annotation_num,
        n_clients=a.n_clients if a.n_clients else cfg.n_clients,
        iid=a.iid,
        alpha_dirichlet=a.alpha_dirichlet,
        local_ep=a.local_ep,
        rounds_warmup=a.rounds_warmup,
        rounds_corr=a.rounds_corr,
        rounds_distillation=a.rounds_distillation,
        rounds_finetune=a.rounds_finetune,
        runs=a.runs,
        p_pos=a.p_pos,
        eval_every=a.eval_every,
        checkpoint_every=a.checkpoint_every,
        compute_dtype=a.compute_dtype,
        scan_unroll=a.scan_unroll,
        client_unroll=a.client_unroll,
        small_pack=a.small_pack,
        dw_backend=a.dw_backend,
        remat=a.remat,
        remat_stages=a.remat_stages,
        view_concat=a.view_concat,
        view_precat=a.view_precat,
        client_stacking=a.client_stacking,
        hoist_augment=a.hoist_augment,
        pre_augment=a.pre_augment,
        weight_stream=a.weight_stream,
        batched_global=a.batched_global,
        output_dir=a.output_dir,
        exp_tag=a.exp_tag or f"{a.exp}_{a.dataset}",
        data=data,
        fedmlp=FedMLPConfig(
            rounds_stage1=a.rounds_FedMLP_stage1, U=a.U, L=a.L,
            tao_min=a.tao_min, clean_threshold=a.clean_threshold,
            noise_threshold=a.noise_threshold,
            difficulty_estimate=a.difficulty_estimate,
            miss_client_difficulty=a.miss_client_difficulty, mixup=a.mixup,
            stage2_distill=bool(a.stage2_distill),
        ),
        rofl=RoFLConfig(
            forget_rate=a.forget_rate, num_gradual=a.num_gradual,
            T_pl=a.T_pl, lambda_cen=a.lambda_cen, lambda_e=a.lambda_e,
        ),
        fedlsr=FedLSRConfig(t_w=a.t_w),
        fedirm=FedIRMConfig(
            rounds_sup=a.rounds_FedIRM_sup, consistency=a.consistency,
            consistency_rampup=a.consistency_rampup, ema_decay=a.ema_decay,
        ),
        fednoro=FedNoRoConfig(
            rounds_warmup=a.rounds_FedNoRo_warmup, begin=a.begin,
            end=a.end, a=a.a,
        ),
        cbafed=CBAFedConfig(rounds_warmup=a.rounds_CBAFed_warmup),
    )
    return cfg


def main(argv=None):
    from fedmlp_tpu_torch.parallel import mesh
    from fedmlp_tpu_torch.train import UnportedConfigError, check_ported

    a = args_parser(argv)
    cfg = config_from_args(a)
    try:  # the world a launcher names, before any group starts
        check_ported(cfg, int(os.environ.get("WORLD_SIZE", "1")))
    except UnportedConfigError as e:
        raise SystemExit(f"fedmlp_tpu_torch: {e}") from e
    device = resolve_device(a.device)
    with mesh.rank_guard():
        mesh.init_from_env(device)
        _run(a, cfg, device)


def _run(a, cfg, device):
    from fedmlp_tpu_torch.data.datasets import load_packed_dataset
    from fedmlp_tpu_torch.eval.evaluate import class_test
    from fedmlp_tpu_torch.train import Trainer
    from fedmlp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from fedmlp_tpu_torch.utils.logging import set_output_files, set_seed

    train_ds = test_ds = None
    if cfg.data.root:  # <data_root>/{train,test}, packed (tools/ingest.py)
        train_ds = load_packed_dataset(os.path.join(cfg.data.root, "train"))
        test_ds = load_packed_dataset(os.path.join(cfg.data.root, "test"))
    writer, models_dir = set_output_files(cfg.output_dir, cfg.exp_tag)
    try:
        if cfg.deterministic:
            set_seed(cfg.seed)

        if not cfg.train:
            # test-only branch (reference: main.py:365-377): per-class metrics
            trainer = Trainer(cfg, train_ds=train_ds, test_ds=test_ds, device=device)
            if a.resume:
                load_checkpoint(a.resume, trainer)
            for classid in range(cfg.n_classes):
                r = class_test(trainer, classid)
                logging.info(
                    "class %d -----> BACC: %.2f, R: %.2f, F1: %.2f, P: %.2f",
                    classid, r["BACC"] * 100, r["R"] * 100, r["F1"] * 100,
                    r["P"] * 100,
                )
            return

        # multi-run loop with reseeding (reference: main.py:85-86)
        for run in range(cfg.runs):
            if cfg.runs > 1:
                set_seed(run)
                logging.info("=====> begin run %d <=====", run)
            trainer = Trainer(cfg if cfg.runs == 1 else cfg.replace(seed=run),
                              train_ds=train_ds, test_ds=test_ds, device=device)
            start = 0
            if a.resume and run == 0:
                start = load_checkpoint(a.resume, trainer)
                logging.info("resumed from %s at round %d", a.resume, start)

            for rnd in range(start, cfg.rounds_warmup):
                rec = trainer.run_round(rnd)
                for k, loss in enumerate(rec.client_losses):
                    writer.add_scalar(
                        f"train_run{run}/warm-up-loss/client{k}", loss, rnd
                    )
                if rec.metrics:
                    for name, v in rec.metrics.items():
                        writer.add_scalar(f"test_run{run}/{name}", v, rnd)
                # periodic + the reference's rounds_corr milestone (main.py:360)
                if ((rnd + 1) % cfg.checkpoint_every == 0
                        or (rnd + 1) == cfg.rounds_corr):
                    save_checkpoint(models_dir, trainer, rnd)
    finally:
        writer.close()


if __name__ == "__main__":
    main()
