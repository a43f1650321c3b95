"""DLRM: the port of ``flexflow_tpu/models/dlrm.py``.

A bottom MLP over the dense features, one embedding per sparse feature,
a "cat" (or pairwise "dot") interaction, a top MLP with sigmoid last and
an MSE loss (reference ``examples/DLRM/dlrm.cc``), with the same op
names, parameter keys and shapes as the JAX package.  MLP layers draw
N(0, sqrt(2/(in+out))) weights and N(0, sqrt(2/out)) biases, with sigmoid
at ``sigmoid_layer`` and relu elsewhere (``dlrm.cc:26-39``); tables draw
U(-1/sqrt(V), 1/sqrt(V)) (``dlrm.cc:41-47``).  When every table has one
vocabulary (``run_random.sh``: 8 x 1M x 64) the tables are stacked into
one ``MultiEmbedding``; otherwise each is an ``Embedding`` of its own.
``dlrm_strategy`` is the reference's table-parallel placement over a
world of ranks (``ops/embedding.py``'s row-sharded tables).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch

from flexflow_torch.config import FFConfig
from flexflow_torch.graph import FFModel
from flexflow_torch.initializers import NormInitializer, UniformInitializer
from flexflow_torch.ops.base import TensorSpec
from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore


@dataclasses.dataclass
class DLRMConfig:
    """Defaults mirror ``dlrm.h:23-32``; flags mirror
    ``parse_input_args`` (``dlrm.cc:169-224``)."""

    sparse_feature_size: int = 2
    embedding_size: List[int] = dataclasses.field(default_factory=lambda: [4])
    mlp_bot: List[int] = dataclasses.field(default_factory=lambda: [4, 2])
    mlp_top: List[int] = dataclasses.field(default_factory=lambda: [8, 2])
    sigmoid_bot: int = -1
    sigmoid_top: int = -1
    arch_interaction_op: str = "cat"
    loss_threshold: float = 0.0
    dataset_path: Optional[str] = None

    @staticmethod
    def parse_args(argv: Sequence[str]) -> "DLRMConfig":
        cfg = DLRMConfig()
        argv = list(argv)
        i = 0

        def ints(s: str) -> List[int]:
            return [int(w) for w in s.split("-")]

        def nxt(flag: str) -> str:
            nonlocal i
            i += 1
            if i >= len(argv):
                raise ValueError(f"flag {flag} expects a value")
            return argv[i]

        while i < len(argv):
            a = argv[i]
            if a == "--arch-sparse-feature-size":
                cfg.sparse_feature_size = int(nxt(a))
            elif a == "--arch-embedding-size":
                cfg.embedding_size = ints(nxt(a))
            elif a == "--arch-mlp-bot":
                cfg.mlp_bot = ints(nxt(a))
            elif a == "--arch-mlp-top":
                cfg.mlp_top = ints(nxt(a))
            elif a == "--sigmoid-bot":
                cfg.sigmoid_bot = int(nxt(a))
            elif a == "--sigmoid-top":
                cfg.sigmoid_top = int(nxt(a))
            elif a == "--arch-interaction-op":
                cfg.arch_interaction_op = nxt(a)
            elif a == "--loss-threshold":
                cfg.loss_threshold = float(nxt(a))
            elif a == "--dataset":
                cfg.dataset_path = nxt(a)
            i += 1
        return cfg


def _create_mlp(ff: FFModel, x: TensorSpec, ln: Sequence[int],
                sigmoid_layer: int, tag: str) -> TensorSpec:
    """Reference ``create_mlp`` (``dlrm.cc:26-39``)."""
    t = x
    for i in range(len(ln) - 1):
        std = math.sqrt(2.0 / (ln[i + 1] + ln[i]))
        w_init = NormInitializer(0.0, std)
        b_init = NormInitializer(0.0, math.sqrt(2.0 / ln[i + 1]))
        act = "sigmoid" if i == sigmoid_layer else "relu"
        t = ff.dense(t, ln[i + 1], activation=act, name=f"{tag}_linear{i}",
                     kernel_initializer=w_init, bias_initializer=b_init)
    return t


def build_dlrm(
    batch_size: int = 64,
    dlrm: Optional[DLRMConfig] = None,
    config: Optional[FFConfig] = None,
) -> FFModel:
    dlrm = dlrm or DLRMConfig()
    ff = FFModel(config or FFConfig(batch_size=batch_size))
    if dlrm.mlp_bot[-1] != dlrm.sparse_feature_size:
        raise ValueError("the bottom MLP must project the dense features to "
                         "sparse_feature_size")

    dense_input = ff.create_tensor((batch_size, dlrm.mlp_bot[0]),
                                   name="dense_input")
    label = ff.create_tensor((batch_size, 1), name="label")

    x = _create_mlp(ff, dense_input, dlrm.mlp_bot, dlrm.sigmoid_bot, "bot")

    num_tables = len(dlrm.embedding_size)
    uniform_vocab = len(set(dlrm.embedding_size)) == 1
    if uniform_vocab:
        vocab = dlrm.embedding_size[0]
        sparse_input = ff.create_tensor((batch_size, num_tables),
                                        dtype=torch.int32, name="sparse_input")
        rng = 1.0 / math.sqrt(vocab)
        emb = ff.multi_embedding(
            sparse_input, num_tables, vocab, dlrm.sparse_feature_size,
            name="embeddings", kernel_initializer=UniformInitializer(-rng, rng),
        )
        towers = None  # built per interaction branch (no dead ops)
    else:
        towers = []
        for i, vocab in enumerate(dlrm.embedding_size):
            sp = ff.create_tensor((batch_size, 1), dtype=torch.int32,
                                  name=f"sparse_{i}")
            rng = 1.0 / math.sqrt(vocab)
            towers.append(ff.embedding(
                sp, vocab, dlrm.sparse_feature_size, aggr="sum",
                name=f"embedding{i}",
                kernel_initializer=UniformInitializer(-rng, rng)))

    if dlrm.arch_interaction_op == "cat":
        if towers is None:
            towers = [ff.reshape(
                emb, (batch_size, num_tables * dlrm.sparse_feature_size),
                name="emb_flat")]
        z = ff.concat([x] + towers, axis=1, name="concat")
    elif dlrm.arch_interaction_op == "dot":
        if not uniform_vocab:
            raise ValueError("the 'dot' interaction needs tables of one "
                             "vocabulary (the stacked embedding)")
        z = ff.dot_interaction(x, emb, name="interact")
    else:
        raise ValueError(f"unknown arch_interaction_op "
                         f"{dlrm.arch_interaction_op!r}")
    if z.shape[1] != dlrm.mlp_top[0]:
        raise ValueError(f"top MLP input {dlrm.mlp_top[0]} != interaction "
                         f"width {z.shape[1]}")

    # The reference passes sigmoid_layer = len(mlp_top) - 2, the last
    # layer, so the model emits probabilities for the MSE loss.
    p = _create_mlp(ff, z, dlrm.mlp_top, len(dlrm.mlp_top) - 2, "top")
    ff.mse_loss(p, label, reduction="mean", name="mse_loss")
    return ff


def dlrm_random_benchmark_config(num_tables: int = 8) -> DLRMConfig:
    """The ``run_random.sh`` benchmark shape: 8 x 1M-row tables, 64-dim
    features, 64-512-512-64 bottom and 576-1024-1024-1024-1 top MLP."""
    return DLRMConfig(
        sparse_feature_size=64,
        embedding_size=[1000000] * num_tables,
        mlp_bot=[64, 512, 512, 64],
        mlp_top=[64 + 64 * num_tables, 1024, 1024, 1024, 1],
    )


def dlrm_strategy(num_devices: int, dlrm: DLRMConfig,
                  shard_embeddings: bool = False) -> StrategyStore:
    """The reference's DLRM strategy (``dlrm_strategy.cc:5-36``), as the
    JAX package's: the tables spread over the devices (table
    parallelism), every MLP, concat and loss op data-parallel (the
    fallback).  Tables of one vocabulary are the stacked
    ``embeddings`` at ``c = gcd(T, num_devices)``: its stacked dim is the
    leading dim of the flat view, so each rank holds ``T / c`` whole
    tables.  With ``shard_embeddings`` (``--shard-embeddings``) and mixed
    vocabularies each ``embedding{i}`` gets ``c = gcd(vocab_i,
    num_devices)``, its ``shard_rows`` table range-sharded over them."""
    store = StrategyStore(num_devices)
    num_tables = len(dlrm.embedding_size)
    uniform = len(set(dlrm.embedding_size)) == 1
    ep = math.gcd(num_tables, num_devices)
    if uniform and ep > 1:
        store.set("embeddings", ParallelConfig(c=ep))
    if shard_embeddings and not uniform:
        for i, vocab in enumerate(dlrm.embedding_size):
            c = math.gcd(vocab, num_devices)
            if c > 1:
                store.set(f"embedding{i}", ParallelConfig(c=c))
    return store
