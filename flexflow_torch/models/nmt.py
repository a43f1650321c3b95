"""NMT: the seq2seq encoder-decoder LSTM stack of
``flexflow_tpu/models/nmt.py`` (reference ``nmt/nmt.cc`` +
``nmt/rnn.cu``), with the same graph, op names and parameter keys.

Per side a word embedding and ``num_layers`` LSTMs, Dropout between
stacked layers (cuDNN RNN semantics, rate 0.2 in the reference,
``nmt/lstm.cu:152``); the encoder's final ``(hT, cT)`` of each layer
seed the decoder's layer of the same index; a vocabulary projection and
the fused softmax cross-entropy (K3 on the card) close the graph.

``nmt_strategy`` is the JAX function's table: the LSTMs and the
dropouts between them over (batch, sequence chunk) at ``(n=dp, s=sp)``
(the sequence pipeline of ``ops/rnn.py``), the vocabulary projection
tensor-parallel over the vocabulary at ``(n=dp, c=sp)``, the loss over
``n = dp x sp`` rows.  ``nmt_pipeline_strategy`` is the reference's
layer-wise placement (encoder on the first half of the devices, decoder
on the second), which the pipeline executor runs
(``runtime/pipeline.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore


def build_nmt(
    batch_size: int = 64,
    src_len: int = 20,
    tgt_len: int = 20,
    vocab_size: int = 32 * 1024,
    embed_dim: int = 1024,
    hidden_size: int = 1024,
    num_layers: int = 2,
    dropout: float = 0.2,
    config: Optional[FFConfig] = None,
) -> FFModel:
    """``dropout`` applies between stacked LSTM layers."""
    ff = FFModel(config or FFConfig(batch_size=batch_size))
    src = ff.create_tensor((batch_size, src_len), dtype=torch.int32,
                           name="src", dim_axes=("n", "s"))
    tgt = ff.create_tensor((batch_size, tgt_len), dtype=torch.int32,
                           name="tgt", dim_axes=("n", "s"))
    lbl = ff.create_tensor((batch_size, tgt_len), dtype=torch.int32,
                           name="label", dim_axes=("n", "s"))

    x = ff.word_embedding(src, vocab_size, embed_dim, name="src_embed")
    enc_states = []
    for i in range(num_layers):
        x, hT, cT = ff.lstm(x, hidden_size, name=f"enc_lstm{i}")
        enc_states.append((hT, cT))
        if dropout and i < num_layers - 1:
            x = ff.dropout(x, dropout, name=f"enc_drop{i}")

    y = ff.word_embedding(tgt, vocab_size, embed_dim, name="tgt_embed")
    for i in range(num_layers):
        y, _, _ = ff.lstm(y, hidden_size, initial_state=enc_states[i],
                          name=f"dec_lstm{i}")
        if dropout and i < num_layers - 1:
            y = ff.dropout(y, dropout, name=f"dec_drop{i}")

    logits = ff.dense(y, vocab_size, name="vocab_proj")
    ff.softmax(logits, lbl, name="softmax")
    return ff


def nmt_strategy(num_devices: int = 1, dp: Optional[int] = None,
                 sp: Optional[int] = None,
                 num_layers: int = 2) -> StrategyStore:
    """The reference's GlobalConfig placement (``nmt.cc:269-308``) as the
    JAX function gives it (``flexflow_tpu/models/nmt.py:72-100``): with
    neither degree given, ``sp`` doubles while ``dp`` halves and stays
    above it (2 devices: dp 1 x sp 2; 4: 2 x 2; 8: 2 x 4)."""
    if dp is None and sp is None:
        sp, dp = 1, num_devices
        while dp > sp and dp % 2 == 0:
            dp //= 2
            sp *= 2
    elif dp is None:
        dp = max(1, num_devices // sp)
    elif sp is None:
        sp = max(1, num_devices // dp)
    if dp * sp > num_devices:
        raise ValueError(f"nmt_strategy({num_devices}, dp={dp}, sp={sp}): "
                         f"{dp * sp} parts on {num_devices} devices")
    store = StrategyStore(num_devices)
    for side in ("enc", "dec"):
        for i in range(num_layers):
            store.set(f"{side}_lstm{i}", ParallelConfig(n=dp, s=sp))
            if i < num_layers - 1:
                # The dropout between stacked layers keeps the LSTMs'
                # placement: no reshard between them.
                store.set(f"{side}_drop{i}", ParallelConfig(n=dp, s=sp))
    store.set("vocab_proj", ParallelConfig(n=dp, c=sp))
    store.set("softmax", ParallelConfig(n=dp * sp))
    return store


def nmt_pipeline_strategy(num_devices: int,
                          num_layers: int = 2) -> StrategyStore:
    """The reference's layer-wise NMT placement (``nmt.cc:269-308``), as
    the JAX function gives it (``flexflow_tpu/models/nmt.py:103-126``):
    the encoder stack (embedding and LSTMs) on the first half of the
    devices, the decoder stack (embedding, LSTMs, vocabulary projection
    and loss) on the second, data-parallel within each; the dropouts
    between the layers inherit their LSTM's placement.  Runs on
    ``runtime/pipeline.py``'s ``PipelineExecutor``."""
    if num_devices % 2 != 0:
        raise ValueError(
            f"pipeline placement splits the devices into encoder and "
            f"decoder halves and needs an even device count, got "
            f"{num_devices}")
    enc = tuple(range(num_devices // 2))
    dec = tuple(range(num_devices // 2, num_devices))
    store = StrategyStore(num_devices)
    store.set("src_embed", ParallelConfig(n=len(enc), device_ids=enc))
    store.set("tgt_embed", ParallelConfig(n=len(dec), device_ids=dec))
    for i in range(num_layers):
        store.set(f"enc_lstm{i}", ParallelConfig(n=len(enc), device_ids=enc))
        store.set(f"dec_lstm{i}", ParallelConfig(n=len(dec), device_ids=dec))
    store.set("vocab_proj", ParallelConfig(n=len(dec), device_ids=dec))
    store.set("softmax", ParallelConfig(n=len(dec), device_ids=dec))
    return store
