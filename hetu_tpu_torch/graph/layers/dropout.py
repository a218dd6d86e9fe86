"""Dropout layer."""

from ..ops_conv import dropout_op
from .base import BaseLayer


class DropOut(BaseLayer):
    def __init__(self, p=0.5):
        self.keep_prob = 1.0 - p

    def __call__(self, x):
        return dropout_op(x, self.keep_prob)
