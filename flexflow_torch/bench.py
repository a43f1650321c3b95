"""Headline benchmarks of the port on one NVIDIA GPU: the counterpart of
the repo's ``bench.py``.

Run from the root of a checkout on a machine with a CUDA GPU::

    python -m flexflow_torch.bench

Prints ONE JSON line on stdout (everything else goes to stderr), with
``bench.py``'s metric names, formulas and protocols: the primary metric
is AlexNet images/s/chip (batch 2048, 229 x 229 x 3, 1000 classes,
bf16, SGD lr 0.01 momentum 0.9 wd 1e-4, 3 warmup + 20 timed steps);
``extra`` carries the DLRM leg (the ``run_random.sh`` shape on the
row-sparse path, 2 + 10 steps) and the LM legs at 2k (2 + 10), 8k (2 + 5) and 32k (2 +
3), each with its MFU against the H100's dense bf16 peak, and the card's
name and power limit.  Throughput is ``iterations x batch / elapsed``
with one fence at the end (``Trainer.fit``); the flops come from
``search/cost_model.py::train_flops``.  A leg that fails becomes
``<leg>_error`` and does not sink the headline.  Without a CUDA device
the line carries ``"value": null`` and the error; nothing is measured
on the CPU.

``bench.py``'s other legs (NMT, Candle-Uno, superstep, pipeline,
telemetry, data plane, serving, search, op-parallel) wait for their
slices of the port (ROADMAP.md queue 1).  The leg functions take the
device and their sizes as arguments, so a test can run them small on
the CPU.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import traceback

#: 4xV100 AlexNet target, per chip: the ICML'18-era 1500 img/s total
#: that the repo's BASELINE.json names (the reference publishes no
#: absolute number).  Measured neither on a TPU nor on an H100.
BASELINE_IMGS_PER_SEC_PER_CHIP = 1500.0 / 4.0

#: H100 SXM dense bf16 peak (NVIDIA data sheet).
H100_BF16_PEAK_FLOPS = 989e12

#: The LM legs: (metric prefix, batch, seq, timed iterations), 6 layers
#: (``bench.py:251-308``).
LM_LEGS = (("transformer", 16, 2048, 10), ("transformer_8k", 4, 8192, 5),
           ("transformer_32k", 1, 32768, 3))


def _mfu(ff, samples_per_s: float, batch: int) -> float:
    from flexflow_torch.search.cost_model import train_flops

    return train_flops(ff) / batch * samples_per_s / H100_BF16_PEAK_FLOPS


def bench_alexnet(device="cuda", batch_size: int = 2048,
                  image_size: int = 229, num_classes: int = 1000,
                  iters: int = 20, warmup: int = 3,
                  stats_out: dict | None = None):
    """Returns (images/s per chip, mfu, batch size); ``stats_out``, when
    given, receives the fit stats.  On the GPU cuDNN times its plans
    (``ops.conv.time_conv_plans``) in the warmup steps."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.ops.conv import time_conv_plans
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    time_conv_plans(device)
    cfg = FFConfig(batch_size=batch_size, compute_dtype="bfloat16")
    ff = build_alexnet(batch_size=batch_size, image_size=image_size,
                       num_classes=num_classes, config=cfg)
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(
        lr=0.01, momentum=0.9, weight_decay=1e-4), device=device)
    stats = Trainer(ex).fit(iterations=iters, warmup=warmup)
    if stats_out is not None:
        stats_out.update(stats)
    sps = stats["samples_per_s"]
    return sps, _mfu(ff, sps, batch_size), batch_size


def bench_dlrm(device="cuda", vocab: int = 1_000_000, batch: int = 256,
               iters: int = 10, warmup: int = 2):
    """The ``run_random.sh`` shape (8 x ``vocab`` x 64 tables), plain
    SGD lr 0.01, the tables on the row-sparse path (K4 and K5).  Returns
    (samples/s, mfu).  A failure raises: ``bench.py``'s dense fallback
    would stand a path without K5 in for the one that failed."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.dlrm import build_dlrm, dlrm_random_benchmark_config
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    dlrm = dlrm_random_benchmark_config(num_tables=8)
    dlrm.embedding_size = [vocab] * 8

    cfg = FFConfig(batch_size=batch, compute_dtype="bfloat16",
                   sparse_embedding_updates=True)
    ff = build_dlrm(batch, dlrm, config=cfg)
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(lr=0.01), device=device)
    if not ex._sparse_ops:
        raise RuntimeError("the DLRM tables are not on the row-sparse path")
    stats = Trainer(ex).fit(iterations=iters, warmup=warmup)
    return stats["samples_per_s"], _mfu(ff, stats["samples_per_s"], batch)


def _bench_lm(batch: int, seq: int, iters: int, device="cuda",
              layers: int = 6, vocab: int = 32768, d_model: int = 512,
              heads: int = 8, warmup: int = 2):
    """One GPT-style LM measurement, Adam lr 1e-4.  Returns (tokens/s,
    mfu)."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.optim import AdamOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    cfg = FFConfig(batch_size=batch, compute_dtype="bfloat16")
    ff = build_transformer_lm(batch_size=batch, seq_len=seq, vocab_size=vocab,
                              d_model=d_model, num_heads=heads,
                              num_layers=layers, config=cfg)
    ex = Executor(ff, cfg, optimizer=AdamOptimizer(lr=1e-4), device=device)
    stats = Trainer(ex).fit(iterations=iters, warmup=warmup)
    return stats["samples_per_s"] * seq, _mfu(ff, stats["samples_per_s"], batch)


def _card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"gpu_name": name.strip(), "gpu_power_limit": limit.strip()}


def _run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's bench measures on the "
                           "GPU only")
    extra = {"platform": "gpu", "n_chips": 1}
    try:
        extra.update(_card())
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        extra["nvidia_smi_error"] = f"{type(e).__name__}: {e}"
    # The apps' report lines go to stderr: stdout carries one JSON line.
    with contextlib.redirect_stdout(sys.stderr):
        per_chip, mfu, batch_size = bench_alexnet()
    extra["batch_size"] = batch_size
    extra["alexnet_mfu"] = round(mfu, 4)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            sps, dlrm_mfu = bench_dlrm()
        extra["dlrm_samples_per_s"] = round(sps, 2)
        extra["dlrm_mfu"] = round(dlrm_mfu, 4)
    except Exception as e:  # DLRM failure must not sink the headline
        extra["dlrm_error"] = f"{type(e).__name__}: {e}"
    for leg, batch, seq, iters in LM_LEGS:
        try:
            with contextlib.redirect_stdout(sys.stderr):
                tps, lm_mfu = _bench_lm(batch, seq, iters)
            extra[f"{leg}_tokens_per_s"] = round(tps, 1)
            extra[f"{leg}_mfu"] = round(lm_mfu, 4)
        except Exception as e:
            extra[f"{leg}_error"] = f"{type(e).__name__}: {e}"
    return {
        "metric": "alexnet_imgs_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "images/s/chip",
        "vs_baseline": round(per_chip / BASELINE_IMGS_PER_SEC_PER_CHIP, 3),
        "extra": extra,
    }


def main() -> int:
    """Print the one JSON line; on a failure of the headline leg (or no
    GPU), ``bench.py``'s error line with ``"value": null``."""
    try:
        result = _run()
    except Exception as e:
        result = {
            "metric": "alexnet_imgs_per_sec_per_chip",
            "value": None,
            "unit": "images/s/chip",
            "vs_baseline": None,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-1500:],
        }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
