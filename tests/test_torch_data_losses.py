"""Host data, losses, similarity, aggregation and metrics of the port against
the JAX package, on the same numpy inputs.

The numpy-only modules (data, batch plans, metrics) must agree bit for bit;
the tensor functions within float32 rounding of the same expression
(tolerances stated per test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedmlp_tpu.data import datasets as JD, masking as JM, partition as JP
from fedmlp_tpu.eval import metrics as JMet
from fedmlp_tpu.fl import aggregate as JA
from fedmlp_tpu.ops import augment as JAug, losses as JL, similarity as JS
from fedmlp_tpu.parallel import fl_runtime as jrt
from fedmlp_tpu_torch.data import datasets as TD, masking as TM, partition as TP
from fedmlp_tpu_torch.eval import metrics as TMet
from fedmlp_tpu_torch.fl import aggregate as TA
from fedmlp_tpu_torch.ops import augment as TAug, losses as TL, similarity as TS
from fedmlp_tpu_torch.parallel import fl_runtime as trt


def _fixture():
    ds = JD.make_synthetic_dataset(60, 5, 16, seed=4)
    users = JP.iid_sampling(len(ds), 4, seed=4)
    hidden = JM.build_hidden_mask(ds.targets, 0.25, np.random.RandomState(4))
    return ds, users, hidden, [[0], [1], [2], [3]]


def test_synthetic_dataset_bitwise():
    a = JD.make_synthetic_dataset(40, 6, 24, seed=7)
    b = TD.make_synthetic_dataset(40, 6, 24, seed=7)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert a.class_names == b.class_names


def test_partitions_bitwise():
    ds = JD.make_synthetic_dataset(80, 5, 8, seed=1)
    assert JP.iid_sampling(80, 6, 3) == TP.iid_sampling(80, 6, 3)
    for faithful in (True, False):
        a = JP.non_iid_dirichlet_sampling(ds.targets, 5, 0.6, 4, 3, 0.5, faithful)
        b = TP.non_iid_dirichlet_sampling(ds.targets, 5, 0.6, 4, 3, 0.5, faithful)
        assert a == b


def test_masks_bitwise():
    ds, users, _, active_lists = _fixture()
    for p_pos in (0.0, 0.5):
        np.testing.assert_array_equal(
            JM.build_hidden_mask(ds.targets, p_pos, np.random.RandomState(2)),
            TM.build_hidden_mask(ds.targets, p_pos, np.random.RandomState(2)))
    for pad in (1, 8):
        for a, b in zip(JM.build_client_index_table(users, 4, pad),
                        TM.build_client_index_table(users, 4, pad)):
            np.testing.assert_array_equal(a, b)
    act = JM.build_active_matrix(active_lists, 5)
    np.testing.assert_array_equal(act, TM.build_active_matrix(active_lists, 5))
    hidden = JM.build_hidden_mask(ds.targets, 0.0, np.random.RandomState(2))
    np.testing.assert_array_equal(JM.observed_targets(ds.targets, hidden, act[1]),
                                  TM.observed_targets(ds.targets, hidden, act[1]))
    assert JM.class_client_lists(act) == TM.class_client_lists(act)


def test_federated_data_and_batch_plan_bitwise():
    ds, users, hidden, active_lists = _fixture()
    # a ragged client table: client 3 keeps only 7 samples
    users = dict(users)
    users[3] = users[3][:7]
    a = jrt.build_federated_data(ds.images, ds.targets, users, hidden, active_lists)
    b = trt.build_federated_data(ds.images, ds.targets, users, hidden, active_lists,
                                 device="cpu")
    for name in ("images", "targets", "obs_targets", "idx", "valid", "active",
                 "loss_w", "class_num", "n_local"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy(), err_msg=name)
    valid = np.asarray(a.valid)
    for bs, ep in ((4, 1), (6, 2)):
        pa = jrt.make_batch_plan(np.random.RandomState(9), valid, bs, ep)
        pb = trt.make_batch_plan(np.random.RandomState(9), valid, bs, ep)
        for x, y in zip(pa[:2], pb[:2]):
            np.testing.assert_array_equal(x, y)
        assert pa[2] == pb[2]


def test_bce_on_probs_value_and_grad_at_saturation():
    """Value and gradient, including p ∈ {0, 1} where the −100 log clamp
    binds and the backward must stay finite. rtol 1e-6 in value; the
    gradient (p − y)/max(p(1 − p), 1e-12) to rtol 1e-5."""
    rng = np.random.RandomState(0)
    p = rng.rand(6, 5).astype(np.float32)
    p[0, :3] = [0.0, 1.0, 0.0]
    p[1, :3] = [1.0, 0.0, 1.0]
    y = (rng.rand(6, 5) > 0.5).astype(np.float32)
    y[0, :3] = [0.0, 1.0, 1.0]
    y[1, :3] = [1.0, 0.0, 0.0]
    want = np.asarray(JL.bce_on_probs(jnp.asarray(p), jnp.asarray(y)))
    want_g = np.asarray(jax.grad(lambda q: JL.bce_on_probs(q, jnp.asarray(y)).sum())(
        jnp.asarray(p)))
    pt = torch.from_numpy(p).requires_grad_(True)
    got = TL.bce_on_probs(pt, torch.from_numpy(y))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.all(np.isfinite(pt.grad.numpy()))
    np.testing.assert_allclose(pt.grad.numpy(), want_g, rtol=1e-5, atol=1e-6)
    assert got[0, 2].item() == pytest.approx(100.0)  # clamp at p=0, y=1


def test_similarity_functions_match():
    """float32 matmuls and norms: rtol 1e-5."""
    rng = np.random.RandomState(1)
    f = rng.randn(20, 16).astype(np.float32)
    protos = rng.randn(8, 16).astype(np.float32)
    labels = (rng.rand(20, 4) > 0.5).astype(np.float32)
    mask = (rng.rand(20) > 0.2).astype(np.float32)
    probs = rng.rand(20, 4).astype(np.float32)
    ft, pt = torch.from_numpy(f), torch.from_numpy(protos)
    np.testing.assert_allclose(TS.cosine_similarity_matrix(ft, pt).numpy(),
                               np.asarray(JS.cosine_similarity_matrix(f, protos)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TS.fedmlp_similarity_scores(ft, pt).numpy(),
                               np.asarray(JS.fedmlp_similarity_scores(f, protos)),
                               rtol=1e-5, atol=1e-6)
    labels[:, 3] = 0.0  # a class without positives keeps a zero prototype
    pj, cj = JS.masked_binary_prototypes(f, labels, mask, 4)
    pt2, ct = TS.masked_binary_prototypes(ft, torch.from_numpy(labels),
                                          torch.from_numpy(mask), 4)
    np.testing.assert_allclose(pt2.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(
        TS.confidence_fraction(torch.from_numpy(probs), torch.from_numpy(mask), 0.3, 0.7).numpy(),
        np.asarray(JS.confidence_fraction(probs, mask, 0.3, 0.7)), rtol=1e-6)


def test_aggregation_rules_match():
    """fedavg over every variable (BN running stats included), fedavg_tao
    over the NEGATIVE-client mask (a class nobody misses → 1.0), and
    fedavg_proto: float32 weighted sums, rtol 1e-6."""
    rng = np.random.RandomState(2)
    K, C, D = 4, 3, 5
    stacked = {"conv.weight": rng.randn(K, 2, 3, 3, 3).astype(np.float32),
               "bn.running_var": rng.rand(K, 2).astype(np.float32)}
    w = np.array([10, 3, 7, 1], np.int32)
    want = JA.fedavg(stacked, w)
    got = TA.fedavg({k: torch.from_numpy(v) for k, v in stacked.items()}, w)
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    active = np.array([[1, 0, 0], [0, 1, 0], [1, 0, 0], [1, 1, 0]], bool)
    active[:, 2] = True  # every client annotates class 2: nobody misses it
    taos = rng.rand(K, C).astype(np.float32)
    np.testing.assert_allclose(TA.fedavg_tao(torch.from_numpy(taos), w, (~active).T).numpy(),
                               np.asarray(JA.fedavg_tao(taos, w, (~active).T)), rtol=1e-6)
    assert TA.fedavg_tao(torch.from_numpy(taos), w, (~active).T)[2] == 1.0
    protos = rng.randn(K, 2 * C, D).astype(np.float32)
    np.testing.assert_allclose(TA.fedavg_proto(torch.from_numpy(protos), w, active.T).numpy(),
                               np.asarray(JA.fedavg_proto(protos, w, active.T)),
                               rtol=1e-6, atol=1e-7)


def test_multilabel_report_bitwise():
    rng = np.random.RandomState(3)
    y = (rng.rand(50, 6) > 0.6).astype(np.float32)
    probs = rng.rand(50, 6).astype(np.float32)
    probs[:10] = np.round(probs[:10], 1)  # ties
    assert TMet.multilabel_report(y, probs) == JMet.multilabel_report(y, probs)


def test_eval_batch_matches_jax():
    """The test transform (normalize only), NHWC → NCHW: rtol 1e-6."""
    imgs = np.random.RandomState(4).randint(0, 256, (3, 8, 8, 3), np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = np.asarray(JAug.eval_batch(jnp.asarray(imgs), mean, std)).transpose(0, 3, 1, 2)
    got = TAug.eval_batch(torch.from_numpy(imgs), mean, std).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
