"""Decoder-only transformer LM: the port of
``flexflow_tpu/models/transformer.py::build_transformer_lm``.

Pre-LN GPT-style blocks on the dense-MLP path, with the same op names
(``embed``, ``pos``, ``blk{i}_*``, ``ln_f``, ``lm_head``, ``softmax``)
and parameter shapes as the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel


def build_transformer_lm(
    batch_size: int = 8,
    seq_len: int = 2048,
    vocab_size: int = 32 * 1024,
    d_model: int = 512,
    num_heads: int = 8,
    num_layers: int = 6,
    d_ff: Optional[int] = None,
    moe_experts: int = 0,
    moe_capacity_factor: float = 1.25,
    config: Optional[FFConfig] = None,
) -> FFModel:
    if moe_experts:
        raise NotImplementedError(
            "moe_experts > 0: the mixture-of-experts FFN (ops/moe.py) is "
            "not ported yet (ROADMAP.md queue 1, item 5)"
        )
    d_ff = d_ff or 4 * d_model
    ff = FFModel(config or FFConfig(batch_size=batch_size))
    tok = ff.create_tensor((batch_size, seq_len), dtype=torch.int32,
                           name="tokens", dim_axes=("n", "s"))
    lbl = ff.create_tensor((batch_size, seq_len), dtype=torch.int32,
                           name="label", dim_axes=("n", "s"))
    x = ff.word_embedding(tok, vocab_size, d_model, name="embed")
    x = ff.position_embedding(x, name="pos")
    for i in range(num_layers):
        a = ff.layer_norm(x, name=f"blk{i}_ln1")
        a = ff.multihead_attention(a, num_heads, causal=True,
                                   name=f"blk{i}_attn")
        x = ff.add(x, a, name=f"blk{i}_res1")
        m = ff.layer_norm(x, name=f"blk{i}_ln2")
        m = ff.dense(m, d_ff, activation="gelu", name=f"blk{i}_mlp_up")
        m = ff.dense(m, d_model, name=f"blk{i}_mlp_down")
        x = ff.add(x, m, name=f"blk{i}_res2")
    x = ff.layer_norm(x, name="ln_f")
    logits = ff.dense(x, vocab_size, name="lm_head")
    ff.softmax(logits, lbl, name="softmax")
    return ff
