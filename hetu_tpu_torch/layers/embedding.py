"""Embedding (``hetu_tpu/layers/embedding.py``): ``<name>_table``
``[num_embeddings, dim]``, Xavier normal."""

from __future__ import annotations

from .. import functional as Fn
from .. import initializers as init
from .base import BaseLayer


class Embedding(BaseLayer):
    def __init__(self, num_embeddings, embedding_dim, name="embedding",
                 generator=None):
        super().__init__(name)
        self.add_var("embedding_table", name + "_table",
                     init.XavierNormalInit((num_embeddings, embedding_dim)),
                     generator)

    def forward(self, ids):
        return Fn.embedding_lookup(self.embedding_table, ids)
