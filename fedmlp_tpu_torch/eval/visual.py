"""Feature and ROC figures and a label-noise diagnostic (port of
``fedmlp_tpu/eval/visual.py``), all on the host.

scikit-learn and matplotlib are imported inside the functions: neither is
needed to train, and the card's machine has no scikit-learn.
"""

from __future__ import annotations

import os

import numpy as np

from fedmlp_tpu_torch.eval.metrics import _binary_clf_curve, roc_auc


def tsne_visual(features: np.ndarray, labels: np.ndarray, rnd: int,
                name: str, out_dir: str = "proto_fig") -> str:
    """A t-SNE (PCA init, perplexity 5, or less for a few points) scatter of
    penultimate features, each point drawn as its label, saved as
    ``<out_dir>/round<rnd>_<name>.png`` (reference:
    utils/feature_visual.py:12-38). Returns the path."""
    from sklearn.manifold import TSNE

    os.makedirs(out_dir, exist_ok=True)
    perplexity = min(5, max(2, len(features) - 1))
    ts = TSNE(n_components=2, init="pca", random_state=0, perplexity=perplexity)
    emb = ts.fit_transform(np.asarray(features, np.float64))
    emb = (emb - emb.min(0)) / np.maximum(emb.max(0) - emb.min(0), 1e-12)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    for i in range(len(emb)):
        plt.text(emb[i, 0], emb[i, 1], str(int(labels[i])),
                 color=plt.cm.Set1(int(labels[i])), fontdict={"size": 8})
    plt.xticks([])
    plt.yticks([])
    plt.title(f"round {rnd}: {name}")
    path = os.path.join(out_dir, f"round{rnd}_{name}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def roc_curves(y_true, probs) -> list:
    """Per class (fpr, tpr, AUC) of multi-label ``probs`` [N, C] against
    ``y_true`` [N, C]; a class without positives or negatives counts one."""
    y_true, probs = np.asarray(y_true), np.asarray(probs)
    out = []
    for c in range(y_true.shape[1]):
        fps, tps, _ = _binary_clf_curve(y_true[:, c].astype(float), probs[:, c])
        n_pos = max(y_true[:, c].sum(), 1)
        n_neg = max((1 - y_true[:, c]).sum(), 1)
        out.append((np.r_[0.0, fps] / n_neg, np.r_[0.0, tps] / n_pos,
                    roc_auc(y_true[:, c], probs[:, c])))
    return out


def roc_print(y_true, probs, out_path: str = "multi_models_roc.png",
              class_names=None) -> str:
    """The per-class ROC curves in one figure, each labelled with its AUC
    (reference ROCprint, utils/evaluations.py:76-86). Returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    for c, (fpr, tpr, auc_c) in enumerate(roc_curves(y_true, probs)):
        name = class_names[c] if class_names else str(c)
        plt.plot(fpr, tpr, lw=1, label=f"{name} (AUC={auc_c:.3f})")
    plt.plot([0, 1], [0, 1], "--", lw=1, color="grey")
    plt.xlim([0, 1])
    plt.ylim([0, 1])
    plt.xlabel("False Positive Rate")
    plt.ylabel("True Positive Rate")
    plt.title("ROC Curve")
    plt.legend(loc="lower right", fontsize=8)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def fn_tn_loss_separation(trainer, client: int) -> dict:
    """Per missing class of ``client``: the global model's mean loss of
    label 0 on its hidden positives (false negatives) and on its true
    negatives, {class: {'fn_loss', 'tn_loss'}}, nan where a group is empty
    (reference LocalUpdate.test_loss, utils/local_training.py:830-899)."""
    fd = trainer.fd
    if fd.images is None:
        raise ValueError("fn_tn_loss_separation reads the training table, which "
                         "data.host_stream=True keeps on disk")
    idx = fd.idx[client]
    valid = fd.valid[client].cpu().numpy()
    probs = trainer.eval_probs(trainer.global_vars, fd.images[idx].cpu().numpy())
    idx = idx.cpu().numpy()
    true_t = fd.targets.cpu().numpy()[idx]
    hidden = np.asarray(trainer.hidden)[idx]
    active = fd.active[client].cpu().numpy()
    bce0 = -np.log(np.clip(1 - probs, 1e-7, None))  # the loss of label 0
    out = {}
    for c in range(fd.n_classes):
        if active[c]:
            continue
        fn_mask = valid & hidden[:, c] & (true_t[:, c] == 1)
        tn_mask = valid & (true_t[:, c] == 0)
        out[c] = {
            "fn_loss": float(bce0[fn_mask, c].mean()) if fn_mask.any() else np.nan,
            "tn_loss": float(bce0[tn_mask, c].mean()) if tn_mask.any() else np.nan,
        }
    return out
