"""On-GPU smoke test of the PyTorch/CUDA port (``flexflow_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (built
for Hopper, sm_90a)::

    python3 chip_smoke.py

Three phases, in order; any failure raises and exits non-zero:

1. **Kernels.**  Builds every CUDA kernel of the serving path from
   ``flexflow_torch/csrc`` and holds each against its plain PyTorch
   version on the card (f32: ``o`` within 1e-4; bf16: ``o`` within 2e-2,
   the bf16 rounding of ``p`` and of the output; ``lse`` within 1e-3),
   with each kernel's median device time over 20 runs beside its plain
   version's and ``F.scaled_dot_product_attention``'s (a yardstick the
   port never calls).
2. **Serve.**  Runs the full-width bf16 LM (vocab 32768, d_model 512,
   8 heads, 6 layers, max_seq 128, 8 slots, buckets 64/128, 16 requests
   of 4-32 prompt tokens and 32 new tokens, decode K=8) through
   ``flexflow_torch.apps.serve.main`` and checks that every request
   completes with finite logits and that the kernels' launch counters
   equal ``layers x prefills`` (flash prefill) and ``layers x K x
   supersteps`` (flash decode).
3. **Parity.**  Serves the same requests in f32 with the decode kernel
   and with the plain einsum decode: the greedy tokens must be identical.

Then it prints a ``kernels`` JSON line, the card's name and power limit
from ``nvidia-smi``, and as its last line the JSON object
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2
and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: FLOP/s by operand type (f32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

#: The serving configuration of phase 2 and 3 (the shapes bench.py's
#: serving leg uses for this model).
SERVE = dict(vocab=32768, d_model=512, heads=8, layers=6, max_seq=128,
             max_batch=8, buckets=(64, 128), requests=16, prompt=(4, 32),
             max_new=32, decode_steps=8, seed=0)

TOL_O = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LSE = 1e-3


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _device_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA
    events.  Each run first parks the GPU in a ~1 ms spin so that the
    host has enqueued the whole call before the first event fires: the
    events then bracket device work only, not host launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def phase_kernels(torch, kernels, F):
    """Build, check and time both kernels; returns per-kernel rows for
    the main-path shapes (bf16 prefill at bucket 64, bf16 decode)."""
    t0 = time.perf_counter()
    built = kernels.build()
    print(f"[kernels] built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    # -- K1f: flash-attention forward --
    for shape in ((1, 8, 64, 64), (1, 8, 128, 64), (2, 8, 2048, 64),
                  (1, 8, 80, 64)):
        for causal in (True, False):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (randn(shape, dt) for _ in range(3))
                o, lse = kernels.flash_attention_lse(q, k, v, causal)
                po, plse = kernels.flash_attention_lse_plain(q, k, v, causal)
                torch.cuda.synchronize()
                err_o = (o.float() - po.float()).abs().max().item()
                err_lse = (lse - plse).abs().max().item()
                name = _dtype_name(dt)
                _check(math.isfinite(err_o) and err_o <= TOL_O[name]
                       and err_lse <= TOL_LSE,
                       f"flash_attention_lse {shape} causal={causal} {name}: "
                       f"|o| err {err_o}, |lse| err {err_lse}")
                ms = _device_ms(lambda: kernels.flash_attention_lse(q, k, v, causal))
                plain_ms = _device_ms(
                    lambda: kernels.flash_attention_lse_plain(q, k, v, causal))
                lib_ms = _device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal))
                b, h, t, hd = shape
                pairs = t * (t + 1) // 2 if causal else t * t
                itemsize = q.element_size()
                nbytes = 4 * b * h * t * hd * itemsize + b * h * t * 4
                bound, by = _bound_ms(nbytes, 4 * b * h * hd * pairs, name)
                print(f"[kernels] flash_attention_lse {shape} causal={causal} "
                      f"{name}: err o {err_o:.3g} lse {err_lse:.3g}; "
                      f"{ms:.4f} ms (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, "
                      f"bound {bound:.5f} by {by})")
                if shape == (1, 8, 64, 64) and causal and dt == torch.bfloat16:
                    rows["flash_attention_lse"] = dict(
                        max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, library_ms=lib_ms)

    # -- K6: flash decode --
    cases = (((8, 128, 8, 64), [5, 128, 1, 33, 47, 64, 99, 20]),
             ((4, 4096, 8, 64), [1, 4096, 1023, 2049]))
    for (B, S, h, hd), lens in cases:
        for dt in (torch.float32, torch.bfloat16):
            q = randn((B, h, hd), dt)
            ck, cv = randn((B, S, h, hd), dt), randn((B, S, h, hd), dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            o = kernels.flash_decode(q, ck, cv, lengths)
            po = kernels.flash_decode_plain(q, ck, cv, lengths)
            torch.cuda.synchronize()
            err_o = (o.float() - po.float()).abs().max().item()
            name = _dtype_name(dt)
            _check(math.isfinite(err_o) and err_o <= TOL_O[name],
                   f"flash_decode {(B, S, h, hd)} {name}: |o| err {err_o}")
            ms = _device_ms(lambda: kernels.flash_decode(q, ck, cv, lengths))
            plain_ms = _device_ms(
                lambda: kernels.flash_decode_plain(q, ck, cv, lengths))
            qs = q[:, :, None]
            ks, vs = ck.transpose(1, 2), cv.transpose(1, 2)
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            lib_ms = _device_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask))
            keys = sum(lens)
            itemsize = q.element_size()
            nbytes = (2 * keys * h * hd * itemsize + 2 * B * h * hd * itemsize
                      + 4 * B)
            bound, by = _bound_ms(nbytes, 4 * h * hd * keys, name)
            print(f"[kernels] flash_decode {(B, S, h, hd)} lengths {lens} "
                  f"{name}: err o {err_o:.3g}; {ms:.4f} ms (plain "
                  f"{plain_ms:.4f}, sdpa {lib_ms:.4f}, bound {bound:.5f} by "
                  f"{by})")
            if S == 128 and dt == torch.bfloat16:
                rows["flash_decode"] = dict(
                    max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=lib_ms)
    return rows


def _serve_argv(dtype: str):
    c = SERVE
    return ["--vocab", str(c["vocab"]), "--d-model", str(c["d_model"]),
            "--heads", str(c["heads"]), "--layers", str(c["layers"]),
            "--max-seq", str(c["max_seq"]), "--max-batch", str(c["max_batch"]),
            "--buckets", ",".join(map(str, c["buckets"])),
            "--requests", str(c["requests"]),
            "--prompt-len", f"{c['prompt'][0]}:{c['prompt'][1]}",
            "--max-new", str(c["max_new"]),
            "--decode-steps", str(c["decode_steps"]),
            "--dtype", dtype, "--seed", str(c["seed"])]


def phase_serve(torch, kernels):
    from flexflow_torch.apps import serve

    stats = {}
    for fn in kernels.KERNELS:
        fn.launches = 0
    rc = serve.main(_serve_argv("bfloat16"), device="cuda", stats_out=stats)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    _check(rc == 0, f"serve exited {rc}")
    _check(stats["completed"] == SERVE["requests"] and stats["failed"] == 0,
           f"serve completed {stats['completed']} of {SERVE['requests']}, "
           f"failed {stats['failed']}")
    L, K = SERVE["layers"], SERVE["decode_steps"]
    want = {"flash_attention_lse": L * stats["prefills"],
            "flash_decode": L * K * stats["decode_supersteps"]}
    _check(all(launches[n] == want[n] > 0 for n in want),
           f"launch counts {launches}, expected {want}")
    steps = K * stats["decode_supersteps"]
    print(f"[serve] tokens/s {stats['tokens_per_s']:.1f}; decode "
          f"{stats['decode_s'] * 1e3 / steps:.3f} ms/step "
          f"({stats['decode_s'] * 1e3 / stats['decode_tokens']:.3f} ms/token "
          f"over {stats['decode_tokens']} tokens); latency p50 "
          f"{stats['request_latency_ms_p50']:.1f} ms p95 "
          f"{stats['request_latency_ms_p95']:.1f} ms; prefills "
          f"{stats['prefills']}, supersteps {stats['decode_supersteps']}; "
          f"launches {launches}")
    return launches


def phase_parity(torch):
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.serving import (
        Server, ServingExecutor, synthetic_requests)

    c = SERVE
    cfg = FFConfig(compute_dtype="float32", seed=c["seed"])
    ff = build_transformer_lm(
        batch_size=c["max_batch"], seq_len=c["max_seq"],
        vocab_size=c["vocab"], d_model=c["d_model"], num_heads=c["heads"],
        num_layers=c["layers"], config=cfg)
    tokens = {}
    params = state = None
    for decode_kernel in (None, False):
        sex = ServingExecutor(ff, cfg, max_batch=c["max_batch"],
                              max_seq=c["max_seq"], buckets=c["buckets"],
                              decode_kernel=decode_kernel, device="cuda")
        if params is None:
            params, state = sex.init(c["seed"])
        reqs = synthetic_requests(c["requests"], c["vocab"],
                                  prompt_len=c["prompt"],
                                  max_new_tokens=c["max_new"], seed=c["seed"])
        results, stats = Server(sex, params, state,
                                decode_steps=c["decode_steps"]).run(reqs)
        _check(stats["failed"] == 0, f"f32 serve (decode_kernel="
               f"{decode_kernel}) failed {stats['failed']} requests")
        tokens[decode_kernel] = {rid: r.tokens for rid, r in results.items()}
    diff = [rid for rid in tokens[None] if tokens[None][rid] != tokens[False][rid]]
    _check(not diff, f"f32 greedy tokens differ between the decode kernel "
           f"and the plain decode for requests {diff}")
    n = sum(len(t) for t in tokens[None].values())
    print(f"[parity] f32 greedy tokens identical, kernel vs plain decode: "
          f"{len(tokens[None])} requests, {n} tokens")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from flexflow_torch.ops import kernels

    # f32 references in full f32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rows = phase_kernels(torch, kernels, F)
    t1 = time.perf_counter()
    launches = phase_serve(torch, kernels)
    t2 = time.perf_counter()
    phase_parity(torch)
    t3 = time.perf_counter()
    print(f"[phases] kernels {t1 - t0:.1f}s, serve {t2 - t1:.1f}s, parity "
          f"{t3 - t2:.1f}s")

    meta = {
        "flash_attention_lse": ("flexflow_torch/csrc/flash_fwd.cu",
                                "flexflow_tpu/ops/pallas_kernels.py:147"),
        "flash_decode": ("flexflow_torch/csrc/flash_decode.cu",
                         "flexflow_tpu/ops/pallas_kernels.py:1085"),
    }
    line = {"kernels": [
        dict(name=name, route="cuda", source=meta[name][0],
             replaces=meta[name][1], launches=launches[name], **rows[name])
        for name in ("flash_attention_lse", "flash_decode")
    ]}
    print(json.dumps(line))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
