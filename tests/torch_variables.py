"""Flax variables drawn with numpy from a seed, for the tests that hold the
port to the JAX package: neither package's initializer feeds both sides of
a comparison, and no flax init has to be compiled (the shapes come from
``jax.eval_shape`` of flax's init, a trace only)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

# a key of the 'rbg' generator: one primitive a draw to trace where
# threefry's is tens, and draws of the same shapes
SHAPE_KEY = functools.partial(jax.random.key, 0, impl="rbg")


def flax_shapes(module, image_size: int, **init_kw):
    """The variables of the flax ``module`` at ``image_size`` px, by shape
    only."""
    return jax.eval_shape(lambda: module.init(
        SHAPE_KEY(), jnp.zeros((1, image_size, image_size, 3)), **init_kw))


def numpy_variables(shapes, seed: int, perturb: bool = False) -> dict:
    """Float32 values of the tree ``shapes``: each weight of two axes or more
    normal with variance 1/fan-in (its axes but the last, flax's
    lecun-normal fan-in, the grouped convs' per group); batch-norm scales and
    running variances 1, biases and running means 0, as flax's init makes
    them, or with ``perturb`` drawn away from these (scale and variance
    0.5 + U(0, 1), bias and mean 0.2·N(0, 1)), so that every leaf matters."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            a = 0.5 + rs.rand(*s.shape) if perturb else np.ones(s.shape)
        elif name in ("bias", "mean"):
            a = 0.2 * rs.randn(*s.shape) if perturb else np.zeros(s.shape)
        else:
            a = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
