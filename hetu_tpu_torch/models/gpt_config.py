"""``GPTConfig``: the GPT-2 topology's shape, copied from the JAX
package's ``models/gpt.py`` so the port needs nothing of it.  The graph
model beside it there waits for the training slice (ROADMAP A8)."""

from __future__ import annotations


class GPTConfig:
    def __init__(self, vocab_size=50257, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 ffn_mult=4, max_position_embeddings=1024,
                 dropout_rate=0.1, batch_size=8, seq_len=1024,
                 use_flash=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.ffn_size = ffn_mult * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.dropout_rate = dropout_rate
        self.batch_size = batch_size
        if seq_len > max_position_embeddings:
            raise ValueError(
                f"seq_len={seq_len} exceeds max_position_embeddings="
                f"{max_position_embeddings}: the learned position table "
                f"has no rows past that, and the slice would otherwise "
                f"surface as an opaque broadcast error when adding "
                f"positions")
        self.seq_len = seq_len
        # None: flash from seq 1024 up, and only with dropout off (the
        # fused kernel has no attention-probs dropout)
        if use_flash is None:
            self.use_flash = seq_len >= 1024 and dropout_rate == 0.0
        else:
            if use_flash and dropout_rate > 0.0:
                raise ValueError(
                    "use_flash=True requires dropout_rate=0: the flash "
                    "kernel has no attention-probs dropout and the "
                    "layer would silently fall back to unfused "
                    "attention")
            self.use_flash = use_flash

    @classmethod
    def small(cls, **kw):
        return cls(**kw)

    @classmethod
    def medium(cls, **kw):
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("num_hidden_layers", 24)
        kw.setdefault("num_attention_heads", 16)
        return cls(**kw)
