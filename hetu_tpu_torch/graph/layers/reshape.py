"""Reshape layer and small shape helpers."""

import torch

from ..node import SimpleOp
from ..ops_attention import NEG_INF
from ..ops_shape import array_reshape_op
from .base import BaseLayer


class Reshape(BaseLayer):
    def __init__(self, shape):
        self.shape = shape

    def __call__(self, x):
        return array_reshape_op(x, self.shape)


def lens_to_additive_mask(kv_lens, seq_len):
    """[B] int lengths -> additive f32 (B, 1, 1, S) mask (0 where live,
    NEG_INF where padded) for the unfused attention path."""
    def fn(lens):
        live = torch.arange(seq_len, device=lens.device)[None, :] \
            < lens[:, None]
        return torch.where(live, 0.0, NEG_INF).to(torch.float32)[
            :, None, None, :]

    return SimpleOp(fn, kv_lens, name="LensMask")


def zero_empty_rows(ctxv, kv_lens, seq_len):
    """Zero the attention context of fully-padded sequences (kv_lens 0):
    an all-masked softmax is uniform, while the flash kernel emits 0
    there, and both paths must agree."""
    def fn(c, lens):
        live = torch.repeat_interleave(lens > 0, seq_len).to(c.dtype)
        return c * live[:, None]

    return SimpleOp(fn, ctxv, kv_lens, name="ZeroEmptyRows")
