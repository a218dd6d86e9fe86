"""Embedding layer."""

from .. import init
from ..ops_embed import embedding_lookup_op
from ..ops_misc import PlaceholderOp
from .base import BaseLayer


class Embedding(BaseLayer):
    def __init__(self, num_embeddings, embedding_dim, initializer=None,
                 name="embedding", ctx=None):
        self.embedding_table = PlaceholderOp(
            name + "_table",
            initializer=initializer or init.XavierNormalInit(
                (num_embeddings, embedding_dim)),
            trainable=True, ctx=ctx)
        self.embedding_table.is_embed = True

    def __call__(self, x):
        return embedding_lookup_op(self.embedding_table, x)
