"""The port's ``--profiling`` and ``--trace`` (``flexflow_torch/runtime/
profiler.py``, ``obs/trace.py``) on the CPU.

- ``profile_ops`` gives one row per op with the JAX package's names and
  output shapes.
- A ``torch.profiler`` trace recorded here summarises into ``top_ops``
  and the trainer's ``train`` / ``superstep`` windows; a hand-made trace
  of the card's shape (kernel events, the profiler's device copies of the
  step ranges) is attributed exactly.
- ``--trace`` with telemetry folds the summary into ``run_end``;
  ``--profiling`` prints the per-op table.
"""

import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch.profiler import record_function

from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.transformer import build_transformer_lm as jbuild
from flexflow_tpu.runtime.executor import Executor as JExecutor
from flexflow_tpu.runtime.profiler import profile_ops as jprofile_ops
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.models.transformer import build_transformer_lm as tbuild
from flexflow_torch.obs.trace import summarize_trace, summarize_trace_dir
from flexflow_torch.optim import AdamOptimizer
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.runtime.profiler import (
    OpProfile,
    profile_ops,
    report,
    trace,
)
from flexflow_torch.runtime.telemetry import Telemetry
from flexflow_torch.runtime.trainer import Trainer

KW = dict(batch_size=2, seq_len=16, vocab_size=64, d_model=32, num_heads=2,
          num_layers=2)


def _tex(**cfg):
    lm = tbuild(config=TConfig(batch_size=2, seed=0, **cfg), **KW)
    return TExecutor(lm, config=lm.config, optimizer=AdamOptimizer(lr=1e-3),
                     device="cpu")


def test_profile_ops_rows_match_jax():
    ex = _tex()
    params, _, state = ex.init()
    batch = Trainer(ex).synthetic_batch()
    rows = profile_ops(ex, params, state, batch, reps=1, warmup=0)
    jlm = jbuild(config=JConfig(batch_size=2, seed=0), **KW)
    jex = JExecutor(jlm, config=jlm.config, devices=jax.devices()[:1])
    jp, _, js = jex.init()
    host = {k: np.asarray(v) for k, v in batch.items()}
    want = jprofile_ops(jex, jp, js, host, reps=1, warmup=0)
    assert [(r.name, r.output_shapes) for r in rows] == \
        [(r.name, r.output_shapes) for r in want]
    assert all(isinstance(r, OpProfile) and r.time_us > 0 for r in rows)
    text = report(rows)
    assert text.splitlines()[-1].startswith("TOTAL (unfused sum)")
    assert len(text.splitlines()) == len(rows) + 1


def test_trace_of_a_cpu_run_summarises(tmp_path):
    ex = _tex()
    p, o, s = ex.init()
    batch = Trainer(ex).synthetic_batch()
    with trace(str(tmp_path)):
        for _ in range(2):
            with record_function("train"):
                p, o, s, _ = ex.train_step(p, o, s, batch)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    out = summarize_trace_dir(str(tmp_path), "cpu")
    assert out["lane"] == "host"
    assert out["annotations"]["train"]["count"] == 2
    assert out["annotations"]["train"]["host_ms"] > 0
    assert out["top_ops"] and all(o["device_ms"] >= 0 for o in out["top_ops"])
    assert out["device_ms_total"] > 0
    assert summarize_trace_dir(str(tmp_path / "none"), "cpu") is None


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def test_a_card_trace_is_attributed_by_device_windows(tmp_path):
    """Host windows run ahead of the card: device time belongs to the
    step whose device-side window (``gpu_user_annotation``) it starts in."""
    events = [
        _x("train", "user_annotation", 0, 100),
        _x("train", "user_annotation", 100, 100),
        _x("train", "gpu_user_annotation", 150, 300, tid=7),
        _x("train", "gpu_user_annotation", 450, 300, tid=7),
        _x("cpu side", "cpu_op", 10, 50),
        _x("wg_fwd_kernel", "kernel", 160, 100, tid=7),
        _x("nvjet_gemm", "kernel", 300, 140, tid=7),
        _x("Memcpy HtoD", "gpu_memcpy", 460, 20, tid=7),
        _x("wg_fwd_kernel", "kernel", 500, 120, tid=7),
        _x("late", "kernel", 800, 10, tid=7),
    ]
    path = str(tmp_path / "h_1.0.pt.trace.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events + [{"ph": "M", "name": "x"}]}, f)
    out = summarize_trace(path, "cuda", top_n=2)
    assert out["lane"] == "device"
    assert out["device_ms_total"] == 0.39
    assert out["top_ops"] == [
        {"op": "wg_fwd_kernel", "device_ms": 0.22, "count": 2},
        {"op": "nvjet_gemm", "device_ms": 0.14, "count": 1}]
    assert out["annotations"] == {
        "train": {"count": 2, "host_ms": 0.2, "device_ms": 0.38}}
    assert summarize_trace_dir(str(tmp_path), "cuda")["trace_file"] == path


def test_a_card_trace_without_device_lane_is_not_summarised(tmp_path):
    """A CUDA run whose profiler recorded no kernel activity: its host ops
    are never reported as device time."""
    events = [_x("train", "user_annotation", 0, 100),
              _x("aten::mm", "cpu_op", 10, 50)]
    path = str(tmp_path / "h_1.0.pt.trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    with pytest.raises(ValueError, match="no device event"):
        summarize_trace(path, "cuda")
    assert summarize_trace_dir(str(tmp_path), "cuda") is None
    assert summarize_trace(path, "cpu")["top_ops"][0]["op"] == "aten::mm"


@pytest.mark.parametrize("k", [1, 2])
def test_trace_flag_folds_into_run_end(tmp_path, k):
    ex = _tex(trace_dir=str(tmp_path / "tr"))
    with Telemetry(str(tmp_path / "tel")) as tel:
        Trainer(ex).fit(iterations=2, warmup=k, steps_per_call=k)
    with open(tel.path) as f:
        end = [json.loads(ln) for ln in f][-1]
    window = "train" if k == 1 else "superstep"
    assert end["trace_summary"]["lane"] == "host"
    assert end["trace_summary"]["annotations"][window]["count"] == 2 // k
    assert end["trace_summary"]["top_ops"]


def test_profiling_flag_prints_the_breakdown(capsys):
    Trainer(_tex(profiling=True)).fit(iterations=1, warmup=1)
    out = capsys.readouterr().out
    assert "TOTAL (unfused sum)" in out and "blk0_attn" in out
