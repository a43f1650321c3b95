"""The port's bench entry (``flexflow_torch/bench.py``), its flops
(``flexflow_torch/search/cost_model.py``) and its strategy files
(``flexflow_torch/parallel/strategy.py``), held against the JAX package
and the repo's ``bench.py`` on the CPU.

- ``train_flops`` equals the JAX ``op_cost`` sum exactly (the same
  float64 sums) for AlexNet at ``bench.py``'s shape, the 2k/8k/32k LM
  legs and the DLRM leg; the LM and DLRM values equal
  ``chip_smoke.train_flops`` / ``dlrm_flops``.
- A ``StrategyStore`` JSON written by JAX loads and saves byte for byte.
- The legs run small on the CPU, and ``main`` (with the card and the
  legs stood in for) prints one JSON line with ``bench.py``'s keys;
  without a GPU it prints ``bench.py``'s error line with ``"value":
  null``.
- The new modules run with ``jax`` and ``flexflow_tpu`` made
  unimportable.
"""

import functools
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from flexflow_tpu.config import FFConfig as JConfig
from flexflow_tpu.models.alexnet import build_alexnet as jalexnet
from flexflow_tpu.models.dlrm import build_dlrm as jdlrm
from flexflow_tpu.models.dlrm import dlrm_random_benchmark_config as jdlrm_cfg
from flexflow_tpu.models.transformer import build_transformer_lm as jlm
from flexflow_tpu.parallel.strategy import ParallelConfig as JPC
from flexflow_tpu.parallel.strategy import StrategyStore as JStore
from flexflow_tpu.search.cost_model import FWD_BWD_FACTOR as J_FACTOR
from flexflow_tpu.search.cost_model import op_cost as jop_cost
from flexflow_torch import bench
from flexflow_torch.apps.common import load_strategy
from flexflow_torch.config import FFConfig as TConfig
from flexflow_torch.models.alexnet import build_alexnet as talexnet
from flexflow_torch.models.dlrm import build_dlrm as tdlrm
from flexflow_torch.models.dlrm import dlrm_random_benchmark_config as tdlrm_cfg
from flexflow_torch.models.transformer import build_transformer_lm as tlm
from flexflow_torch.parallel.strategy import ParallelConfig, StrategyStore
from flexflow_torch.runtime.executor import Executor as TExecutor
from flexflow_torch.search.cost_model import FWD_BWD_FACTOR, op_cost, train_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jflops(ff):
    return J_FACTOR * sum(jop_cost(op).flops for op in ff.layers)


def test_alexnet_flops_match_jax():
    """bench.py's AlexNet: batch 2048 at 229 x 229 x 3, 1000 classes:
    1.4335 GFLOP per image forward, 8.8076e12 per train step."""
    t, j = talexnet(batch_size=2048), jalexnet(batch_size=2048)
    assert FWD_BWD_FACTOR == J_FACTOR == 3.0
    for top, jop in zip(t.layers, j.layers):
        assert op_cost(top).flops == jop_cost(jop).flops, top.name
    assert train_flops(t) == _jflops(j) == 8_807_635_746_816.0
    conv1 = next(op for op in t.layers if op.name == "conv1")
    assert op_cost(conv1).flops == 2.0 * 2048 * 56 * 56 * 11 * 11 * 3 * 64


@pytest.mark.parametrize("batch,seq", [(16, 2048), (4, 8192), (1, 32768)])
def test_lm_flops_match_jax_and_chip_smoke(batch, seq):
    kw = dict(batch_size=batch, seq_len=seq, vocab_size=32768, d_model=512,
              num_heads=8, num_layers=6)
    t = tlm(config=TConfig(batch_size=batch), **kw)
    j = jlm(config=JConfig(batch_size=batch), **kw)
    c = dict(chip_smoke.TRAIN, batch=batch, seq=seq)
    assert train_flops(t) == _jflops(j) == chip_smoke.train_flops(c)


def test_dlrm_flops_match_jax_and_chip_smoke():
    t = tdlrm(256, tdlrm_cfg(8), config=TConfig(batch_size=256))
    j = jdlrm(256, jdlrm_cfg(8), config=JConfig(batch_size=256))
    assert train_flops(t) == _jflops(j) == chip_smoke.dlrm_flops(t)
    assert train_flops(t) == 4_632_084_480.0


def test_strategy_json_from_jax_round_trips_byte_for_byte(tmp_path):
    store = JStore(8)
    store.set("conv1", JPC(n=4, c=2))
    store.set("linear1", JPC(n=2, c=4, device_ids=(0, 2, 4, 6, 1, 3, 5, 7)))
    store.set("attn", JPC(s=2, h=1, w=1))
    src = tmp_path / "jax.json"
    store.save(str(src))
    got = StrategyStore.load(str(src))
    assert got.num_devices == 8
    assert got.table["conv1"] == ParallelConfig(n=4, c=2)
    assert got.table["linear1"].device_ids == (0, 2, 4, 6, 1, 3, 5, 7)
    assert got.table["attn"] == ParallelConfig(s=2)
    out = tmp_path / "port.json"
    got.save(str(out))
    assert out.read_bytes() == src.read_bytes()
    back = JStore.load(str(out))
    assert back.table == {k: JPC(**vars(v)) for k, v in got.table.items()}


def test_strategy_refusals(tmp_path):
    with pytest.raises(ValueError, match="protobuf"):
        StrategyStore.load(str(tmp_path / "s.pb"))
    StrategyStore(2, {"x": ParallelConfig(c=2)}).save(str(tmp_path / "s.json"))
    cfg = TConfig(batch_size=2, strategy_file=str(tmp_path / "s.json"))
    with pytest.raises(SystemExit, match="'x'.*-ll:gpu 2"):
        load_strategy(cfg)


_SMALL_ALEXNET = dict(device="cpu", batch_size=2, image_size=67,
                      num_classes=10, iters=1, warmup=1)


def test_alexnet_leg_runs_small_on_cpu():
    stats = {}
    sps, mfu, batch = bench.bench_alexnet(stats_out=stats, **_SMALL_ALEXNET)
    assert batch == 2 and sps > 0 and mfu > 0
    assert len(stats["step_losses"]) == 2
    ff = talexnet(batch_size=2, image_size=67, num_classes=10)
    assert mfu == pytest.approx(
        train_flops(ff) / 2 * sps / bench.H100_BF16_PEAK_FLOPS, rel=1e-12)


def test_dlrm_leg_falls_back_to_dense(monkeypatch):
    """It does not: the leg runs the row-sparse path (K4, K5) or raises.
    ``bench.py``'s dense fallback would report a path without K5 as the
    DLRM number when the sparse one fails."""
    small = dict(device="cpu", vocab=50, batch=8, iters=1, warmup=1)
    calls = []
    step = TExecutor._sparse_train_step

    def counted(self, *a, **k):
        calls.append(1)
        return step(self, *a, **k)

    monkeypatch.setattr(TExecutor, "_sparse_train_step", counted)
    sps, mfu = bench.bench_dlrm(**small)
    assert sps > 0 and mfu > 0 and len(calls) == 2

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(TExecutor, "_sparse_train_step", broken)
    dense = []
    monkeypatch.setattr(TExecutor, "loss_and_grads",
                        lambda *a, **k: dense.append(1))
    with pytest.raises(RuntimeError, match="planted"):
        bench.bench_dlrm(**small)
    assert not dense


_SMALL_SERVING = dict(device="cpu", vocab=64, d_model=32, heads=2, layers=2,
                      max_seq=32, max_batch=4, n_req=6, max_new=12,
                      kv_block=8, dtype="float32")
#: The serving leg's columns: bench.py's (``bench_serving``) that the port
#: computes.
SERVING_KEYS = {
    "max_batch", "max_seq", "requests", "k1_tokens_per_s",
    "k1_decode_ms_per_token", "k8_tokens_per_s", "k8_decode_ms_per_token",
    "fused_speedup_k8_vs_k1", "request_latency_ms_p50",
    "request_latency_ms_p95", "programs_per_decode_superstep",
    "hbm_per_slot_bytes", "paged_hbm_per_slot_bytes",
    "padded_max_admitted_batch", "paged_max_admitted_batch",
    "paged_tokens_per_s", "sharded_mesh", "sharded_tokens_per_s",
    "sharded_vs_single_mesh_tokens_per_s", "speculate", "spec_tokens_per_s",
    "spec_acceptance_rate", "spec_tokens_per_dispatch",
    "plain_tokens_per_dispatch", "spec_vs_plain_tokens_per_dispatch",
    "spec_match", "queue_wait_ms_p50", "queue_wait_ms_p95",
    "queue_wait_ms_p99", "e2e_ms_p99", "slo_attainment", "request_sheds",
    "request_preempts", "fifo_queue_wait_ms_p99", "fifo_slo_attainment",
    "fifo_vs_slo_queue_wait_p99", "slo_missed", "slo_dominant_phase",
    "request_retries", "request_expiries", "engine_restarts", "prefix_hits",
    "prefix_hit_rate", "prefill_tokens_saved", "prefix_kv_cows",
    "prefix_prefills", "prefix_off_prefills", "prefix_match",
    "fleet_replicas", "fleet_router", "fleet_queue_wait_ms_p99",
    "fleet_slo_attainment", "fleet_vs_single_attainment",
    "fleet_dead_replicas", "fleet_redistributed",
    "fleet_loss_slo_attainment"}


def _small_candle():
    """``tests/test_models.py``'s small Candle-Uno widths."""
    from flexflow_torch.models.candle_uno import CandleConfig

    return CandleConfig(dense_layers=[32, 32], dense_feature_layers=[16],
                        feature_shapes={"dose": 1, "cell.rnaseq": 24,
                                        "drug.descriptors": 40,
                                        "drug.fingerprints": 16})


def _stand_in_card(monkeypatch, dlrm=None, superstep=None, serving=None,
                   nmt=None, candle=None):
    """``main`` on the CPU: a card that is said to exist, and every leg
    at a small size on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "_card", lambda: {
        "gpu_name": "stand-in", "gpu_power_limit": "700.00 W"})
    monkeypatch.setattr(bench, "bench_alexnet", functools.partial(
        bench.bench_alexnet, **_SMALL_ALEXNET))
    monkeypatch.setattr(bench, "bench_dlrm", dlrm or functools.partial(
        bench.bench_dlrm, device="cpu", vocab=50, batch=8, iters=1,
        warmup=1))
    lm = bench._bench_lm
    monkeypatch.setattr(bench, "_bench_lm", lambda b, s, i: lm(
        1, 32, 1, device="cpu", layers=1, vocab=64, d_model=32, heads=2,
        warmup=1))
    monkeypatch.setattr(bench, "bench_superstep", superstep or functools.partial(
        bench.bench_superstep, device="cpu", batch=8, width=16, iters=16))
    monkeypatch.setattr(bench, "bench_serving", serving or functools.partial(
        bench.bench_serving, **_SMALL_SERVING))
    monkeypatch.setattr(bench, "bench_nmt", nmt or functools.partial(
        bench.bench_nmt, device="cpu", batch=4, hidden=32, vocab=128, seq=6,
        iters=2, warmup=1))
    monkeypatch.setattr(bench, "bench_candle", candle or functools.partial(
        bench.bench_candle, device="cpu", batch=8, iters=2, warmup=1,
        candle=_small_candle()))
    monkeypatch.setattr(bench, "bench_telemetry", functools.partial(
        bench.bench_telemetry, device="cpu", batch=8, width=16, iters=4))


def _one_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_main_prints_one_line_with_bench_py_keys(monkeypatch, capsys):
    _stand_in_card(monkeypatch)
    assert bench.main() == 0
    line = _one_line(capsys)
    assert line["metric"] == "alexnet_imgs_per_sec_per_chip"
    assert line["unit"] == "images/s/chip" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 375.0, 3)
    keys = {"platform", "n_chips", "gpu_name", "gpu_power_limit",
            "batch_size", "alexnet_mfu", "dlrm_samples_per_s", "dlrm_mfu"}
    for leg in ("transformer", "transformer_8k", "transformer_32k"):
        keys |= {f"{leg}_tokens_per_s", f"{leg}_mfu"}
    keys |= {"superstep", "serving", "nmt_pairs_per_s", "nmt_10iter_time_s",
             "candle_samples_per_s", "telemetry"}
    assert set(line["extra"]) == keys
    assert set(line["extra"]["serving"]) == SERVING_KEYS
    assert line["extra"]["platform"] == "gpu" and line["extra"]["n_chips"] == 1
    sweep = line["extra"]["superstep"]
    assert set(sweep) == {"batch_size", "iterations", "k1_ms_per_step",
                          "k4_ms_per_step", "k8_ms_per_step",
                          "k16_ms_per_step", "amortization_k8_vs_k1"}
    assert sweep["batch_size"] == 8 and sweep["iterations"] == 16


def test_superstep_leg_runs_small_on_cpu(monkeypatch):
    """``bench.py``'s sweep: k = 1 on the per-step loop, k = 4, 8, 16 as
    supersteps (a loop on the CPU), 16 steps each with no tail."""
    from flexflow_torch.runtime.trainer import Trainer

    seen = []
    fit = Trainer.fit

    def spy(self, **kw):
        stats = fit(self, **kw)
        seen.append((kw["steps_per_call"], stats["iterations"],
                     stats.get("supersteps")))
        return stats

    monkeypatch.setattr(Trainer, "fit", spy)
    out = bench.bench_superstep(device="cpu", batch=8, width=16, iters=16)
    assert seen == [(1, 16, None), (4, 16, 4), (8, 16, 2), (16, 16, 1)]
    assert all(out[f"k{k}_ms_per_step"] > 0 for k in (1, 4, 8, 16))
    assert out["amortization_k8_vs_k1"] == round(
        out["k1_ms_per_step"] / out["k8_ms_per_step"], 3)


def test_a_failing_superstep_leg_becomes_its_error(monkeypatch, capsys):
    def broken(**kw):
        raise RuntimeError("planted")

    _stand_in_card(monkeypatch, superstep=broken)
    bench.main()
    line = _one_line(capsys)
    assert line["value"] > 0
    assert line["extra"]["superstep_error"] == "RuntimeError: planted"
    assert "superstep" not in line["extra"]


def test_a_failing_serving_leg_becomes_its_error(monkeypatch, capsys):
    def broken(**kw):
        raise RuntimeError("planted")

    _stand_in_card(monkeypatch, serving=broken)
    bench.main()
    line = _one_line(capsys)
    assert line["value"] > 0
    assert line["extra"]["serving_error"] == "RuntimeError: planted"
    assert "serving" not in line["extra"]


def test_a_failing_nmt_leg_becomes_its_error(monkeypatch, capsys):
    def broken(**kw):
        raise RuntimeError("planted")

    _stand_in_card(monkeypatch, nmt=broken)
    bench.main()
    line = _one_line(capsys)
    assert line["value"] > 0
    assert line["extra"]["nmt_error"] == "RuntimeError: planted"
    assert "nmt_pairs_per_s" not in line["extra"]


def test_a_failing_candle_leg_becomes_its_error(monkeypatch, capsys):
    def broken(**kw):
        raise RuntimeError("planted")

    _stand_in_card(monkeypatch, candle=broken)
    bench.main()
    line = _one_line(capsys)
    assert line["value"] > 0
    assert line["extra"]["candle_error"] == "RuntimeError: planted"
    assert "candle_samples_per_s" not in line["extra"]
    assert line["extra"]["nmt_pairs_per_s"] > 0


def test_candle_leg_runs_small_on_cpu():
    """``bench.py``'s Candle-Uno leg: bf16, SGD lr 0.01, warmup + timed
    steps; samples/s from the fit's stats."""
    stats = {}
    sps = bench.bench_candle(device="cpu", batch=8, iters=2, warmup=2,
                             candle=_small_candle(), stats_out=stats)
    assert sps == stats["samples_per_s"] > 0
    assert stats["iterations"] == 2 and len(stats["step_losses"]) == 4
    assert all(math.isfinite(x) for x in stats["step_losses"])
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    leg = src[src.index("def bench_candle"):]
    leg = leg[:leg.index("\ndef ")]
    assert "batch = 512 if on_tpu" in leg and "SGDOptimizer(lr=0.01)" in leg
    assert 'compute_dtype="bfloat16"' in leg and "warmup=2" in leg
    assert '"candle_samples_per_s"' in src and '"candle_error"' in src


def test_serving_leg_runs_small_on_cpu():
    """bench.py's serving columns on the CPU at a small size: every key
    is one that ``bench.py::bench_serving`` writes, the speculative run
    matches plain decode, and the full self-draft accepts every token."""
    import re

    out = bench.bench_serving(**_SMALL_SERVING)
    assert set(out) == SERVING_KEYS
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    leg = src[src.index("def bench_serving"):]
    leg = leg[:leg.index("\ndef ")]
    jax_keys = set(re.findall(r'out\["(\w+)"\]', leg)) | {
        f"k{k}_{c}" for k in (1, 8)
        for c in ("tokens_per_s", "decode_ms_per_token")}
    assert SERVING_KEYS <= jax_keys | {"max_batch", "max_seq", "requests"}
    assert out["spec_match"] is True and out["spec_acceptance_rate"] == 1.0
    assert out["speculate"] == 12 and out["programs_per_decode_superstep"] == 1
    assert out["fused_speedup_k8_vs_k1"] == round(
        out["k1_decode_ms_per_token"] / out["k8_decode_ms_per_token"], 3)
    assert out["paged_max_admitted_batch"] > out["padded_max_admitted_batch"]
    assert out["paged_hbm_per_slot_bytes"] < out["hbm_per_slot_bytes"]
    # One process: the sharded engine takes JAX's single-mesh fallback,
    # the K = 8 run's engine, whose stats stand for it.
    assert out["sharded_mesh"] is None
    assert out["sharded_tokens_per_s"] == out["k8_tokens_per_s"] > 0
    assert out["sharded_vs_single_mesh_tokens_per_s"] == 1.0
    # The scheduler's columns: the injected faults were absorbed, the
    # shared prefix was hit without changing a token.
    assert out["request_retries"] == out["engine_restarts"] == 1
    assert out["prefix_match"] is True and out["prefix_hits"] > 0
    assert out["prefix_prefills"] < out["prefix_off_prefills"]
    assert out["fifo_vs_slo_queue_wait_p99"] == round(
        out["fifo_queue_wait_ms_p99"] / max(out["queue_wait_ms_p99"], 1e-9),
        3)
    # The fleet's columns: two replicas, one of them lost and its work
    # redistributed in the second run.
    assert (out["fleet_replicas"], out["fleet_router"]) == (2, "least-loaded")
    assert out["fleet_dead_replicas"] == 1 and out["fleet_redistributed"] > 0
    assert out["fleet_vs_single_attainment"] == round(
        out["fleet_slo_attainment"] / max(out["slo_attainment"], 1e-9), 3)


def test_a_failing_leg_does_not_sink_the_headline(monkeypatch, capsys):
    def broken(**kw):
        raise RuntimeError("planted")

    _stand_in_card(monkeypatch, dlrm=broken)
    bench.main()
    line = _one_line(capsys)
    assert line["value"] > 0
    assert line["extra"]["dlrm_error"] == "RuntimeError: planted"
    assert "dlrm_samples_per_s" not in line["extra"]


def test_main_without_a_gpu_prints_the_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 0
    line = _one_line(capsys)
    assert line["value"] is None and line["vs_baseline"] is None
    assert "no CUDA device" in line["error"]
    assert line["metric"] == "alexnet_imgs_per_sec_per_chip"


def test_new_modules_run_without_jax():
    """The bench leg, the app, the strategy file and the flops in a fresh
    process where ``jax`` and ``flexflow_tpu`` cannot be imported: a
    lazy import inside a function would fail here, where an import scan
    of the sources does not look."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flexflow_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from flexflow_torch import bench\n"
        "from flexflow_torch.apps import alexnet\n"
        "from flexflow_torch.parallel.strategy import StrategyStore\n"
        "bench.bench_alexnet(device='cpu', batch_size=2, image_size=67,\n"
        "                    num_classes=10, iters=1, warmup=1)\n"
        "alexnet.main(['-b', '2', '--image-size', '67', '-i', '1',\n"
        "              '--eval-iters', '1'], device='cpu')\n"
        "bench.main()\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "EVAL loss" in r.stdout
    assert json.loads(r.stdout.strip().splitlines()[-1])["value"] is None
