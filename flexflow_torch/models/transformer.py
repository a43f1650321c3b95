"""Decoder-only transformer LM: the port of
``flexflow_tpu/models/transformer.py::build_transformer_lm``.

Pre-LN GPT-style blocks, with the same op names (``embed``, ``pos``,
``blk{i}_*``, ``ln_f``, ``lm_head``, ``softmax``) and parameter shapes as
the JAX package.  ``moe_experts > 0`` swaps every block's dense MLP for
a mixture-of-experts FFN (``ops/moe.py``, ``blk{i}_moe``).
``transformer_strategy`` is the JAX function's table on one device
(every degree 1); more devices, expert parallelism among them, are
ROADMAP.md queue 1, item 9.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore


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
        if moe_experts:
            m = ff.moe(m, moe_experts, d_ff,
                       capacity_factor=moe_capacity_factor,
                       name=f"blk{i}_moe")
        else:
            m = ff.dense(m, d_ff, activation="gelu", name=f"blk{i}_mlp_up")
            m = ff.dense(m, d_model, name=f"blk{i}_mlp_down")
        x = ff.add(x, m, name=f"blk{i}_res2")
    x = ff.layer_norm(x, name="ln_f")
    logits = ff.dense(x, vocab_size, name="lm_head")
    ff.softmax(logits, lbl, name="softmax")
    return ff


def transformer_strategy(num_devices: int = 1, num_layers: int = 6,
                         dp: int = 1, sp: int = 1, tp: int = 1,
                         moe: bool = False) -> StrategyStore:
    """The JAX function's table (``dp x sp`` on the token ops, ``dp x tp``
    on the MLPs, the MoE ops and ``lm_head``) for one device: every
    degree 1.  More devices (``tp`` sharding the experts among them) are
    ROADMAP.md queue 1, item 9."""
    if num_devices != 1 or dp * sp * tp != 1:
        raise ValueError(
            f"transformer_strategy({num_devices}, dp={dp}, sp={sp}, "
            f"tp={tp}): the port places the LM on one device; multi-device "
            f"strategies are ROADMAP.md queue 1, item 9")
    one = ParallelConfig()
    names = ["embed", "pos"]
    for i in range(num_layers):
        names += [f"blk{i}_ln1", f"blk{i}_attn", f"blk{i}_res1",
                  f"blk{i}_ln2"]
        names += ([f"blk{i}_moe"] if moe
                  else [f"blk{i}_mlp_up", f"blk{i}_mlp_down"])
        names.append(f"blk{i}_res2")
    names += ["ln_f", "lm_head", "softmax"]
    return StrategyStore(1, {name: one for name in names})
