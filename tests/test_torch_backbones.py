"""The port's backbone zoo (fedmlp_tpu_torch/models: ResNet, SE-ResNet,
SENet-154, VGG, DenseNet, the cosine head, the factory, load_pretrained)
against the JAX package's flax models, with the same weights carried over
by fedmlp_tpu_torch/weights.py and the same numpy inputs (NHWC for flax,
NCHW for the port).

The weights start in the port (its own init, then random batch-norm scales,
biases and running statistics, so that eval mode tests them too) and go to
flax through ``to_jax_variables``. Tolerance atol 1e-4 in float32, as tests/test_torch_models.py:
the frameworks order their sums differently, a few ulps a layer.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from functools import partial

from fedmlp_tpu.models import factory as JF
from fedmlp_tpu.models import heads as JH
from fedmlp_tpu.models import senet as JSE
from fedmlp_tpu_torch.models import factory as TF
from fedmlp_tpu_torch.models import heads as TH
from fedmlp_tpu_torch.models import senet as TSE
from fedmlp_tpu_torch.weights import (from_jax_variables, leaf_from_jax,
                                      to_jax_variables)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_variables import SHAPE_KEY, flax_shapes, numpy_variables

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_weights import _STAGES, convert_resnet, flatten  # noqa: E402
from test_pretrained import fake_torch_resnet18_state  # noqa: E402

ATOL = 1e-4
C = 5


def _perturb(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Batch-norm scales, biases and running statistics away from their
    init, and nonzero conv biases, so that every leaf matters."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var") or (t.dim() == 1 and name.endswith("weight")):
                t.copy_(torch.from_numpy(0.5 + rng.rand(*t.shape).astype(np.float32)))
            elif name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(torch.from_numpy(0.2 * rng.randn(*t.shape).astype(np.float32)))
    return model


@functools.lru_cache(maxsize=None)
def _port_weights(name, image_size):
    tm = TF.init_model(TF.build_model(name, C, image_size=image_size), seed=3)
    return {k: t.clone() for k, t in _perturb(tm, seed=4).state_dict().items()}


def _port_and_jax(name, image_size):
    """The port's module (built on the meta device, then given the cached
    weights) and the weights as flax variables."""
    with torch.device("meta"):
        tm = TF.build_model(name, C, image_size=image_size)
    tm = tm.to_empty(device="cpu")
    tm.load_state_dict(_port_weights(name, image_size), strict=True)
    return tm, to_jax_variables(tm.state_dict())


@functools.lru_cache(maxsize=None)
def _flax(name, dtype="float32", normed_head=False):
    return JF.build_model(name, C, compute_dtype=jnp.dtype(dtype), normed_head=normed_head)


@functools.lru_cache(maxsize=None)
def _jitted(name, train, dtype="float32"):
    """flax's forward of ``name``, jitted once a process: one compile of the
    whole graph costs less than an eager forward, which compiles each op at
    each new shape."""
    jm = _flax(name, dtype)
    if train:
        return jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))


def _model_apply(name, dtype="float32"):
    return lambda v, x, train: _jitted(name, train, dtype)(v, x)


def _check(tm, apply_jax, v, x, train, atol=ATOL):
    """(feature, logits), and after a train-mode forward the running
    statistics, of the port against flax's ``apply_jax(v, x, train)``."""
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    tm.train(train)
    with torch.no_grad():
        out_t = tm(xt)
    if train:
        out_j, mut = apply_jax(v, x, True)
        want = from_jax_variables(jax.tree_util.tree_map(np.asarray, mut))
        sd = tm.state_dict()
        for k, w in want.items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=atol,
                                       err_msg=k)
    else:
        out_j = apply_jax(v, x, False)
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        if b.ndim == 4:
            b = b.transpose(0, 3, 1, 2)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol)


@pytest.mark.parametrize("name,size", [("resnet18", 32), ("resnet50", 32),
                                       ("senet50", 32), ("dense121", 32),
                                       ("vgg11", 64)])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(name, size, train):
    """Full-width backbones. VGG-11 at 64 px ends at 2x2, so the (h, w, c)
    flatten order before fc1 is exercised; DenseNet's transitions and
    ResNet's projection shortcuts at every stage; the SE gates.

    Eval mode: batch 2, float32. Train mode runs in float64 on both sides
    (the heads in float32 on both, as the models cast the feature), batch 4:
    flax's batch norm takes the variance as E[x²] − E[x]², which in float32
    loses digits where a channel holds few values (the last stage at 32 px),
    so there both frameworks' float32 features depart from float64 by more
    than 1e-4 and no float32 comparison can hold it. In float64 the
    features agree to a few float32 ulps, and the float32 heads' sums
    differ in order: held to 1e-5. At batch 2 (2 values a channel) the
    stacked train-mode batch norms amplify even float64's rounding."""
    tm, v = _port_and_jax(name, size)
    x = np.random.RandomState(2).randn(4 if train else 2, size, size, 3).astype(np.float32)
    if not train:
        _check(tm, _model_apply(name), v, x, False)
        return
    tm.double().head.float()
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: a.astype(np.float64), v)
        _check(tm, _model_apply(name, "float64"), v64, x.astype(np.float64), True,
               atol=1e-5)


def _senet_parts(train):
    conv = partial(fnn.Conv, dtype=jnp.float32)
    norm = partial(fnn.BatchNorm, use_running_average=not train, momentum=0.9,
                   epsilon=1e-5, dtype=jnp.float32)
    return conv, norm


@pytest.mark.parametrize("stride,dk", [(2, 3), (1, 1), (1, 0)])
@pytest.mark.parametrize("train", [False, True])
def test_senet154_bottleneck_matches_jax(stride, dk, train):
    """SEBottleneck154 on its own at 32 planes (64 channels into the
    64-group 3x3): the 3x3 stride-2 projection of layers 2-4, layer 1's
    1x1 projection, and the identity shortcut (planes*4 channels in)."""
    in_ch = 128 if dk == 0 else 64
    tm = _perturb(TF.init_model(TSE.SEBottleneck154(in_ch, 32, stride,
                                                    downsample_kernel=dk), 5), 6)
    conv, norm = _senet_parts(train)
    jm = JSE.SEBottleneck154(planes=32, conv=conv, norm=norm, strides=stride,
                             downsample_kernel=dk)

    def apply(v, x, train):
        return jm.apply(v, x, mutable=["batch_stats"]) if train else jm.apply(v, x)

    x = np.random.RandomState(7).randn(2, 9, 9, in_ch).astype(np.float32)
    _check(tm, apply, to_jax_variables(tm.state_dict()), x, train)


class _StopAtLayer1(Exception):
    pass


def _interceptor(next_fun, args, kwargs, context):
    if context.module.name == "layer1_0" and context.method_name == "__call__":
        raise _StopAtLayer1(args[0])
    return next_fun(*args, **kwargs)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("train", [False, True])
def test_senet154_stem_matches_jax(size, train):
    """SENet-154's three-conv stem and its ceil-mode pool (bottom/right −inf
    padding) on their own, at an even and an odd side. Flax's forward is
    stopped where it enters layer1_0, whose input is the stem's output;
    only the stem's variables are given to either side."""
    with torch.device("meta"):
        tm = TF.build_model("senet154", C)
    tm = tm.to_empty(device="cpu")
    stem = {k: t for k, t in tm.state_dict().items() if k.startswith("stem_")}
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for k, t in stem.items():
            if "conv" in k:
                t.copy_(torch.randn(t.shape, generator=g) * (1.0 / t[0].numel()) ** 0.5)
            else:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    jm = JF.build_model("senet154", C, compute_dtype=jnp.float32)
    x = np.random.RandomState(9).randn(2, size, size, 3).astype(np.float32)
    tm.train(train)
    with torch.no_grad():
        got = tm.forward_stem(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    with fnn.intercept_methods(_interceptor):
        with pytest.raises(_StopAtLayer1) as stop:
            jm.apply(to_jax_variables(stem), x, train=train,
                     mutable=["batch_stats"] if train else False)
    want = np.asarray(stop.value.args[0]).transpose(0, 3, 1, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _shapes(name, normed_head=False):
    """flax's variables of ``name`` at 32 px, traced by shape only (once a
    process: the layout and round-trip tests share them)."""
    return flax_shapes(_flax(name, normed_head=normed_head), 32, train=False)


@pytest.mark.parametrize("name", sorted(JF.MODEL_REGISTRY))
def test_layout_matches_jax(name):
    """Every name of the JAX registry at 32 px (VGG's fc1 follows the size;
    the others do not): each flax variable maps onto a port variable of the
    same shape and back, the parameter counts agree, and so do the feature
    widths. Flax is traced by shape only; the port is built on the meta
    device."""
    shapes = _shapes(name)
    with torch.device("meta"):
        tm = TF.build_model(name, C, image_size=32)
    sd = tm.state_dict()
    mapped = {}
    for coll, tree in shapes.items():
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key, a = leaf_from_jax(coll, tuple(p.key for p in path),
                                   np.broadcast_to(np.float32(0), s.shape))
            mapped[key] = a.shape
    assert set(mapped) == set(sd)
    for k, t in sd.items():
        assert mapped[k] == tuple(t.shape), k
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert TF.MODEL_REGISTRY[name][1] == JF.MODEL_REGISTRY[name][1] == sd["head.fc.weight"].shape[1]


def test_aliases_and_reference_spellings_build():
    """The JAX aliases and the reference's spellings resolve to the same
    architecture as their canonical names; an unknown name raises."""
    assert TF._ALIASES == JF._ALIASES
    for alias, canon in JF._ALIASES.items():
        assert TF._canon(alias) == canon
    for spelled, canon in {"Resnet18": "resnet18", "Dense121": "dense121",
                           "SENet50": "senet50", "Vgg11": "vgg11",
                           "Efficient_b0": "efficient_b0",
                           "se_resnet101": "senet101"}.items():
        assert TF.is_ported(spelled)
        with torch.device("meta"):
            a = TF.build_model(spelled, C, image_size=32)
            b = TF.build_model(canon, C, image_size=32)
        assert type(a) is type(b)
        assert {k: v.shape for k, v in a.state_dict().items()} == {
            k: v.shape for k, v in b.state_dict().items()}, spelled
    with pytest.raises(ValueError, match="unknown"):
        TF.build_model("resnet9", C)
    assert not TF.is_ported("resnet9")


def _jax_block():
    conv, norm = _senet_parts(False)
    return JSE.SEBottleneck154(planes=64, conv=conv, norm=norm, strides=2,
                               downsample_kernel=3)


_ROUND_TRIP = {
    # name: (flax variables' shapes, port module (built on the meta device))
    "resnet18_cosine_head": (lambda: _shapes("resnet18", normed_head=True),
                             lambda: TF.build_model("resnet18", C, normed_head=True)),
    "senet50": (lambda: _shapes("senet50"), lambda: TF.build_model("senet50", C)),
    "vgg11": (lambda: _shapes("vgg11"), lambda: TF.build_model("vgg11", C, image_size=32)),
    "dense121": (lambda: _shapes("dense121"), lambda: TF.build_model("dense121", C)),
    "senet154_block": (
        lambda: jax.eval_shape(lambda: _jax_block().init(SHAPE_KEY(),
                                                         jnp.zeros((1, 8, 8, 128)))),
        lambda: TSE.SEBottleneck154(128, 64, 2, downsample_kernel=3)),
}


@pytest.mark.parametrize("name", sorted(_ROUND_TRIP))
def test_weights_round_trip_is_bit_exact(name):
    """Random flax variables of one model of each family (the cosine head,
    SE-ResNet's biased gates, VGG's biased convs and Dense layers, DenseNet,
    SENet-154's grouped 3x3 and 3x3 projection) → the port's state_dict →
    flax again: the same tree, bit for bit, and a state_dict the port's
    module loads strictly."""
    shapes_of, tmod = _ROUND_TRIP[name]
    shapes = shapes_of()
    rng = np.random.RandomState(11)
    v = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    sd = from_jax_variables(v)
    with torch.device("meta"):
        tm = tmod()
    tm = tm.to_empty(device="cpu")
    tm.load_state_dict(sd, strict=True)
    back = to_jax_variables(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    if name == "resnet18_cosine_head":  # [in, num_classes], not transposed
        np.testing.assert_array_equal(tm.head.weight.detach().numpy(),
                                      v["params"]["head"]["weight"])


def test_cosine_head_matches_jax():
    """FCNormHead: s · cos between the feature and each class column, with
    the stored U(0, 2) parameter shifted by −1; a zero feature row gives
    zero logits through the 1e-12 floor on both sides."""
    x = np.random.RandomState(12).randn(4, 16).astype(np.float32)
    x[2] = 0.0
    jh = JH.FCNormHead(C)
    v = jax.tree_util.tree_map(np.asarray, jh.init(jax.random.PRNGKey(1), x))
    th = TH.FCNormHead(16, C)
    with torch.no_grad():
        th.weight.copy_(torch.tensor(np.asarray(v["params"]["weight"])))
        got = th(torch.from_numpy(x)).numpy()
    want = np.asarray(jh.apply(v, x))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got).max() <= 30.0 + 1e-4 and not got[2].any()


def test_init_draws_from_flax_default_distributions_for_new_layers():
    """The cosine head's parameter U(0, 2) as flax's (mean and std within
    5%), the grouped 3x3 of SENet-154's bottleneck lecun-normal with the
    per-group fan-in (std within 10% of flax's), biased convs (the SE
    gates) zero-biased."""
    th = TF.init_model(TH.FCNormHead(512, 8), seed=0)
    w = th.weight.detach()
    assert 0.0 <= float(w.min()) and float(w.max()) <= 2.0
    jw = np.asarray(JH.FCNormHead(8).init(jax.random.PRNGKey(0),
                                          np.zeros((1, 512), np.float32))["params"]["weight"])
    assert abs(float(w.mean()) / jw.mean() - 1) < 0.05
    assert abs(float(w.std()) / jw.std() - 1) < 0.05

    tm = TF.init_model(TSE.SEBottleneck154(128, 64, 2, downsample_kernel=3), seed=0)
    jv = jax.jit(_jax_block().init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 128)))
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jv))
    sd = tm.state_dict()
    assert sd["conv2.weight"].shape == (256, 2, 3, 3)
    for k in ("conv2.weight", "conv1.weight", "downsample_conv.weight"):
        assert abs(float(sd[k].std()) / float(want[k].std()) - 1) < 0.1, k
    for k in ("se_module.fc1.bias", "se_module.fc2.bias"):
        assert not sd[k].any() and not want[k].any(), k


def test_load_pretrained_matches_jax(tmp_path):
    """A fabricated torchvision ResNet-18 state, converted by
    tools/convert_torch_weights.py, loads into both packages: the same count
    and the same missing keys (the head's, which both keep fresh), the
    port's variables equal to flax's merged ones bit for bit, and the two
    eval-mode forwards equal once the heads are made equal."""
    st = fake_torch_resnet18_state(np.random.RandomState(13))
    npz = tmp_path / "w.npz"
    np.savez(npz, **flatten(convert_resnet(st, _STAGES["resnet18"])))

    tm = TF.init_model(TF.build_model("Resnet18", C), seed=0)
    # the flax tree it loads into, drawn with numpy in flax's shapes; the
    # head it keeps is copied into the port below
    jv = numpy_variables(_shapes("resnet18"), 0)
    merged, j_loaded, j_missing = JF.load_pretrained(jv, str(npz))
    t_loaded, t_missing = TF.load_pretrained(tm, str(npz))
    assert t_loaded == j_loaded >= 100
    assert t_missing == j_missing == ["params/head/fc/bias", "params/head/fc/kernel"]

    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, merged))
    sd = tm.state_dict()
    for k, w in want.items():
        if not k.startswith("head."):
            np.testing.assert_array_equal(sd[k].numpy(), w.numpy(), err_msg=k)
    with torch.no_grad():
        tm.head.fc.weight.copy_(want["head.fc.weight"])
        tm.head.fc.bias.copy_(want["head.fc.bias"])
    # the fabricated weights are U(0, 1), all positive (tests/test_pretrained.py),
    # so activations grow to 1e37: relative tolerance
    x = np.random.RandomState(14).rand(2, 32, 32, 3).astype(np.float32)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    want_out = _model_apply("resnet18")(merged, x, False)
    for a, b in zip(got, want_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=0)
    # a shape that does not fit is listed, not loaded
    np.savez(npz, **{"params/stem_conv/kernel": np.zeros((3, 3, 3, 64), np.float32)})
    n, missing = TF.load_pretrained(tm, str(npz))
    assert n == 0 and "params/stem_conv/kernel" in missing
