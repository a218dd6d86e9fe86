"""Initializer factories that return variable nodes (``ht.init``): the
graph half of the JAX package's ``initializers.py``.  The value specs
are ``hetu_tpu_torch.initializers``'; a variable's value is drawn when an
``Executor`` is built, from a generator seeded by the executor's seed
and the variable's name."""

from __future__ import annotations

import torch

from ..initializers import (  # noqa: F401  (re-exported value specs)
    BaseInit, ConstantInit, HeNormalInit, HeUniformInit, LecunNormalInit,
    LecunUniformInit, NormalInit, OnesInit, ReversedTruncatedNormalInit,
    TruncatedNormalInit, UniformInit, XavierNormalInit, XavierUniformInit,
    ZerosInit,
)
from .ops_misc import PlaceholderOp


def _var(init, name, trainable=True, ctx=None, dtype=torch.float32):
    return PlaceholderOp(name, initializer=init, trainable=trainable,
                         ctx=ctx, dtype=dtype)


def constant(shape, fill_value=0.0, name="constant_init", trainable=True,
             ctx=None, dtype=torch.float32):
    return _var(ConstantInit(fill_value, shape), name, trainable, ctx, dtype)


def zeros(shape, name="zeros_init", trainable=True, ctx=None,
          dtype=torch.float32):
    return _var(ZerosInit(shape), name, trainable, ctx, dtype)


def ones(shape, name="ones_init", trainable=True, ctx=None,
         dtype=torch.float32):
    return _var(OnesInit(shape), name, trainable, ctx, dtype)


def random_uniform(shape, minval=-0.05, maxval=0.05, name="uniform_init",
                   trainable=True, ctx=None, dtype=torch.float32):
    return _var(UniformInit(minval, maxval, shape), name, trainable, ctx,
                dtype)


def random_normal(shape, mean=0.0, stddev=0.05, name="normal_init",
                  trainable=True, ctx=None, dtype=torch.float32):
    return _var(NormalInit(mean, stddev, shape), name, trainable, ctx, dtype)


def truncated_normal(shape, mean=0.0, stddev=0.05,
                     name="truncated_normal_init", trainable=True, ctx=None,
                     dtype=torch.float32):
    return _var(TruncatedNormalInit(mean, stddev, shape), name, trainable,
                ctx, dtype)


def xavier_normal(shape, gain=1.0, name="xavier_normal_init", trainable=True,
                  ctx=None, dtype=torch.float32):
    return _var(XavierNormalInit(shape, gain), name, trainable, ctx, dtype)


def xavier_uniform(shape, gain=1.0, name="xavier_uniform_init",
                   trainable=True, ctx=None, dtype=torch.float32):
    return _var(XavierUniformInit(shape, gain), name, trainable, ctx, dtype)


def he_normal(shape, name="he_normal_init", trainable=True, ctx=None,
              dtype=torch.float32):
    return _var(HeNormalInit(shape), name, trainable, ctx, dtype)


def he_uniform(shape, name="he_uniform_init", trainable=True, ctx=None,
               dtype=torch.float32):
    return _var(HeUniformInit(shape), name, trainable, ctx, dtype)


def lecun_normal(shape, name="lecun_normal_init", trainable=True, ctx=None,
                 dtype=torch.float32):
    return _var(LecunNormalInit(shape), name, trainable, ctx, dtype)


def lecun_uniform(shape, name="lecun_uniform_init", trainable=True, ctx=None,
                  dtype=torch.float32):
    return _var(LecunUniformInit(shape), name, trainable, ctx, dtype)


# --------------------------------------------------------------------- #
# Gen* generator factories: a callable(shape=..., name=...) -> variable
# node, used by the layer classes
# --------------------------------------------------------------------- #

def _gen(make_init):
    def generator(shape=None, name="init", trainable=True, ctx=None,
                  dtype=torch.float32):
        return _var(make_init(shape), name, trainable, ctx, dtype)
    return generator


def GenZeros():
    return _gen(lambda s: ZerosInit(s))


def GenOnes():
    return _gen(lambda s: OnesInit(s))


def GenConstant(fill_value=0.0):
    return _gen(lambda s: ConstantInit(fill_value, s))


def GenTruncatedNormal(mean=0.0, stddev=1.0):
    return _gen(lambda s: TruncatedNormalInit(mean, stddev, s))


def GenNormal(mean=0.0, stddev=1.0):
    return _gen(lambda s: NormalInit(mean, stddev, s))


def GenUniform(minval=-1.0, maxval=1.0):
    return _gen(lambda s: UniformInit(minval, maxval, s))


def GenXavierNormal(gain=1.0):
    return _gen(lambda s: XavierNormalInit(s, gain))


def GenXavierUniform(gain=1.0):
    return _gen(lambda s: XavierUniformInit(s, gain))


GenGeneralXavierNormal = GenXavierNormal
GenGeneralXavierUniform = GenXavierUniform


def GenHeNormal():
    return _gen(lambda s: HeNormalInit(s))


def GenHeUniform():
    return _gen(lambda s: HeUniformInit(s))


def GenLecunNormal():
    return _gen(lambda s: LecunNormalInit(s))


def GenLecunUniform():
    return _gen(lambda s: LecunUniformInit(s))


nulls = zeros
