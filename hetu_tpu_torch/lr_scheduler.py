"""LR schedulers: Fixed/Step/MultiStep/Exponential/LinearWarmup/Cosine and
ReduceOnPlateau, the port of the JAX package's ``lr_scheduler.py``
(reference python/hetu/lr_scheduler.py).

``value(step)`` is a numpy f32 scalar equal bit for bit to the JAX
scheduler's ``get(step)`` (its ``value`` run op by op): each operation
rounds to f32 as XLA's CPU backend does (Python-number operands enter as
f32, subnormal results flush to zero), and ``pow``/``cos`` are the C
library's ``powf``/``cosf``, which XLA's f32 ``pow`` and ``cos`` equal.
(Inside JAX's jitted step XLA fuses the chain and may land one ulp
away.)  The optimizer reads it once a step (``Optimizer.lr_value``) and
puts it on the device as a 0-d f32 tensor.  ``step`` is the number of
optimizer steps taken before the current one.  ReduceOnPlateau is
host-driven: ``step_metric(value)`` after each evaluation.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

_F32 = np.float32
_TINY = np.finfo(np.float32).tiny


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for fn, nargs in (("powf", 2), ("cosf", 1)):
        f = getattr(lib, fn)
        f.restype = ctypes.c_float
        f.argtypes = [ctypes.c_float] * nargs
    return lib


def _ftz(x):
    """x as f32 with a subnormal flushed to zero (XLA's CPU mode)."""
    x = _F32(x)
    return _F32(0.0) if 0 < abs(x) < _TINY else x


def _powf(a, b):
    return _ftz(_libm().powf(float(_F32(a)), float(_F32(b))))


def _cosf(x):
    return _ftz(_libm().cosf(float(_F32(x))))


def _mul(a, b):
    return _ftz(_F32(a) * _F32(b))


def _div(a, b):
    return _ftz(_F32(a) / _F32(b))


def _add(a, b):
    return _ftz(_F32(a) + _F32(b))


def _sub(a, b):
    return _ftz(_F32(a) - _F32(b))


def _clip01(x):
    return _F32(min(max(x, _F32(0.0)), _F32(1.0)))


class LRScheduler:
    def value(self, step):
        raise NotImplementedError

    def get(self, step=0):
        return float(self.value(step))


class FixedScheduler(LRScheduler):
    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def value(self, step):
        return _F32(self.learning_rate)


class StepScheduler(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1):
        self.learning_rate = learning_rate
        self.step_size = step_size
        self.gamma = gamma

    def value(self, step):
        k = _F32(int(step) // self.step_size)
        return _mul(self.learning_rate, _powf(self.gamma, k))


class MultiStepScheduler(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1):
        self.learning_rate = learning_rate
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def value(self, step):
        k = _F32(0.0)
        for m in self.milestones:
            k = _add(k, _F32(int(step) >= m))
        return _mul(self.learning_rate, _powf(self.gamma, k))


class ExponentialScheduler(LRScheduler):
    def __init__(self, learning_rate, gamma=0.99, step_size=1):
        self.learning_rate = learning_rate
        self.gamma = gamma
        self.step_size = step_size

    def value(self, step):
        k = _F32(int(step) // self.step_size)
        return _mul(self.learning_rate, _powf(self.gamma, k))


class LinearWarmupScheduler(LRScheduler):
    """Linear warmup then linear/constant decay (BERT pretraining)."""

    def __init__(self, learning_rate, warmup_steps, total_steps=None,
                 end_lr=0.0):
        self.learning_rate = learning_rate
        self.warmup_steps = max(1, warmup_steps)
        self.total_steps = total_steps
        self.end_lr = end_lr

    def value(self, step):
        step = _F32(step)
        warm = _div(_mul(self.learning_rate, step), self.warmup_steps)
        if self.total_steps is None:
            after = _F32(self.learning_rate)
        else:
            frac = _clip01(_div(_sub(step, self.warmup_steps),
                                max(1, self.total_steps - self.warmup_steps)))
            after = _add(self.learning_rate,
                         _mul(frac, self.end_lr - self.learning_rate))
        return warm if step < self.warmup_steps else after


class CosineScheduler(LRScheduler):
    def __init__(self, learning_rate, total_steps, warmup_steps=0, end_lr=0.0):
        self.learning_rate = learning_rate
        self.total_steps = total_steps
        self.warmup_steps = warmup_steps
        self.end_lr = end_lr

    def value(self, step):
        step = _F32(step)
        warm = _div(_mul(self.learning_rate, step), max(1, self.warmup_steps))
        frac = _clip01(_div(_sub(step, self.warmup_steps),
                            max(1, self.total_steps - self.warmup_steps)))
        cos = _add(self.end_lr, _mul(
            0.5 * (self.learning_rate - self.end_lr),
            _add(1, _cosf(_mul(np.pi, frac)))))
        if self.warmup_steps == 0:
            return cos
        return warm if step < self.warmup_steps else cos


class ReduceOnPlateauScheduler(LRScheduler):
    """Host-driven: call ``step_metric(value)`` each eval; ``value`` reads
    the current lr (reference lr_scheduler.py ReduceOnPlateau)."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, min_lr=0.0):
        self.lr = learning_rate
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.bad = 0

    def step_metric(self, metric):
        metric = float(metric)
        better = (self.best is None
                  or (self.mode == "min" and metric < self.best - self.threshold)
                  or (self.mode == "max" and metric > self.best + self.threshold))
        if better:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.min_lr, self.lr * self.factor)
                self.bad = 0
        return self.lr

    def value(self, step):
        return _F32(self.lr)
