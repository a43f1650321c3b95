"""Decoder-only transformer LM: the port of
``flexflow_tpu/models/transformer.py::build_transformer_lm``.

Pre-LN GPT-style blocks, with the same op names (``embed``, ``pos``,
``blk{i}_*``, ``ln_f``, ``lm_head``, ``softmax``) and parameter shapes as
the JAX package.  ``moe_experts > 0`` swaps every block's dense MLP for
a mixture-of-experts FFN (``ops/moe.py``, ``blk{i}_moe``).
``transformer_strategy`` is the JAX function's table: data parallelism
on the token ops, ``dp x tp`` on the MLPs' up projection and ``lm_head``.
Sequence parallelism (``sp > 1``, ring attention) and the experts split
over devices are ROADMAP.md queue 1, item 9d.
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
    """The JAX function's table (``flexflow_tpu/models/transformer.py:
    65-97``): attention and the token-level ops get ``(n=dp, s=sp)``, the
    MLPs' up projection and ``lm_head`` ``(n=dp, c=tp)``, the down
    projection ``(n=dp, s=sp)``; with ``moe`` each block's MoE op gets
    ``(n=dp, c=tp)``."""
    if sp > 1:
        raise ValueError(f"transformer_strategy(sp={sp}): ring attention is "
                         f"ROADMAP.md queue 1, item 9d")
    if moe and (num_devices > 1 or tp > 1):
        raise ValueError(f"transformer_strategy(moe=True, tp={tp}) on "
                         f"{num_devices} devices: expert-parallel MoE is "
                         f"ROADMAP.md queue 1, item 9d")
    if dp * tp > num_devices:
        raise ValueError(f"transformer_strategy({num_devices}, dp={dp}, "
                         f"tp={tp}): {dp * tp} parts on {num_devices} "
                         f"devices (-ll:gpu {dp * tp})")
    store = StrategyStore(num_devices)
    seq_pc = ParallelConfig(n=dp, s=sp)
    tp_pc = ParallelConfig(n=dp, c=tp)
    store.set("embed", seq_pc)
    store.set("pos", seq_pc)
    for i in range(num_layers):
        for name in ("ln1", "attn", "res1", "ln2"):
            store.set(f"blk{i}_{name}", seq_pc)
        if moe:
            store.set(f"blk{i}_moe", tp_pc)
        else:
            store.set(f"blk{i}_mlp_up", tp_pc)
            store.set(f"blk{i}_mlp_down", seq_pc)
        store.set(f"blk{i}_res2", seq_pc)
    store.set("ln_f", seq_pc)
    store.set("lm_head", tp_pc)
    store.set("softmax", seq_pc)
    return store
