"""The port's initializer families (``hetu_tpu_torch.initializers``) and
the graph factories over them (``hetu_tpu_torch.graph.init``) against the
JAX package's, on the CPU.  The bits differ (``torch.Generator`` is not
threefry); each family's distribution is held to JAX's: the bounds
exactly (uniform families inside [low, high) or +-limit, truncated
normal inside mean +- 2 stddev), and the sample mean and standard
deviation of 120,000 draws within 0.02 of JAX's sample (the two samples'
standard error is ~0.004 of the scale) and of the formula's."""

import math

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

import jax

from hetu_tpu import initializers as jinit
from hetu_tpu_torch import initializers as tinit
import hetu_tpu_torch.graph as tm

SHAPE = (400, 300)
FAN_IN, FAN_OUT = SHAPE


def _uniform_std(limit):
    return limit / math.sqrt(3)


# family -> (JAX spec, port spec, (low, high) bound or None, formula
# (mean, std))
FAMILIES = {
    "uniform": (jinit.UniformInit(-0.3, 0.5, SHAPE),
                tinit.UniformInit(-0.3, 0.5, SHAPE), (-0.3, 0.5),
                (0.1, 0.8 / math.sqrt(12))),
    "normal": (jinit.NormalInit(0.2, 0.7, SHAPE),
               tinit.NormalInit(0.2, 0.7, SHAPE), None, (0.2, 0.7)),
    # a standard normal cut at +-2 has std 0.87962566
    "truncated_normal": (jinit.TruncatedNormalInit(0.1, 0.5, SHAPE),
                         tinit.TruncatedNormalInit(0.1, 0.5, SHAPE),
                         (0.1 - 1.0, 0.1 + 1.0), (0.1, 0.5 * 0.87962566)),
    "reversed_truncated_normal": (
        jinit.ReversedTruncatedNormalInit(0.0, 1.0, SHAPE),
        tinit.ReversedTruncatedNormalInit(0.0, 1.0, SHAPE), (-2.0, 2.0),
        (0.0, 0.87962566)),
    "xavier_normal": (jinit.XavierNormalInit(SHAPE, 2.0),
                      tinit.XavierNormalInit(SHAPE, 2.0), None,
                      (0.0, 2.0 * math.sqrt(2.0 / (FAN_IN + FAN_OUT)))),
    "xavier_uniform": (jinit.XavierUniformInit(SHAPE),
                       tinit.XavierUniformInit(SHAPE),
                       (-math.sqrt(6.0 / (FAN_IN + FAN_OUT)),
                        math.sqrt(6.0 / (FAN_IN + FAN_OUT))),
                       (0.0, _uniform_std(math.sqrt(6.0 / (FAN_IN
                                                           + FAN_OUT))))),
    "he_normal": (jinit.HeNormalInit(SHAPE), tinit.HeNormalInit(SHAPE), None,
                  (0.0, math.sqrt(2.0 / FAN_IN))),
    "he_uniform": (jinit.HeUniformInit(SHAPE), tinit.HeUniformInit(SHAPE),
                   (-math.sqrt(6.0 / FAN_IN), math.sqrt(6.0 / FAN_IN)),
                   (0.0, _uniform_std(math.sqrt(6.0 / FAN_IN)))),
    "lecun_normal": (jinit.LecunNormalInit(SHAPE),
                     tinit.LecunNormalInit(SHAPE), None,
                     (0.0, math.sqrt(1.0 / FAN_IN))),
    "lecun_uniform": (jinit.LecunUniformInit(SHAPE),
                      tinit.LecunUniformInit(SHAPE),
                      (-math.sqrt(3.0 / FAN_IN), math.sqrt(3.0 / FAN_IN)),
                      (0.0, _uniform_std(math.sqrt(3.0 / FAN_IN)))),
    # a conv OIHW shape: fan_in = I * kh * kw
    "he_normal_conv": (jinit.HeNormalInit((64, 32, 5, 5)),
                       tinit.HeNormalInit((64, 32, 5, 5)), None,
                       (0.0, math.sqrt(2.0 / (32 * 25)))),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax_distribution(family):
    jspec, tspec, bound, (mean, std) = FAMILIES[family]
    want = np.asarray(jspec.generate(jax.random.PRNGKey(0)), np.float64)
    gen = torch.Generator()
    gen.manual_seed(0)
    got = tspec.generate(gen).double().numpy()
    assert got.shape == want.shape
    assert tspec.generate(gen).dtype == torch.float32
    scale = max(std, 1e-3)
    for sample in (got, want):
        assert abs(sample.mean() - mean) <= 0.02 * scale, family
        assert abs(sample.std() - std) <= 0.02 * scale, family
    assert abs(got.mean() - want.mean()) <= 0.02 * scale
    assert abs(got.std() - want.std()) <= 0.02 * scale
    if bound is not None:
        lo, hi = bound
        assert got.min() >= lo - 1e-6 and got.max() <= hi + 1e-6
        assert want.min() >= lo - 1e-6 and want.max() <= hi + 1e-6


@pytest.mark.parametrize("factory", [
    "constant", "zeros", "ones", "random_uniform", "random_normal",
    "truncated_normal", "xavier_normal", "xavier_uniform", "he_normal",
    "he_uniform", "lecun_normal", "lecun_uniform"])
def test_graph_factory_is_a_named_variable(factory):
    node = getattr(tm.init, factory)((6, 5), name=f"v_{factory}")
    assert isinstance(node, tm.PlaceholderOp) and node.is_variable
    assert node.trainable and node.shape == (6, 5)
    a = node.init_value(0)
    # keyed by the name: a second build draws the same value, another
    # seed another one
    again = getattr(tm.init, factory)((6, 5), name=f"v_{factory}")
    assert torch.equal(again.init_value(0), a)
    if factory not in ("constant", "zeros", "ones"):
        assert not torch.equal(node.init_value(1), a)
    if factory == "ones":
        assert torch.equal(a, torch.ones(6, 5))
