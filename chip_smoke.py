"""On-GPU smoke test of the PyTorch/CUDA port (``flexflow_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (built
for Hopper, sm_90a)::

    python3 chip_smoke.py

Eighteen phases, in order; any failure raises and exits non-zero:

1. **Kernels.**  Builds every CUDA kernel of the port from
   ``flexflow_torch/csrc`` and holds the serving kernels against their
   plain PyTorch versions on the card (f32: ``o`` within 1e-4; bf16:
   ``o`` within 2e-2, the bf16 rounding of ``p`` and of the output;
   ``lse`` within 1e-3; and ``o`` element by element, see ``TOL_ELEM``),
   with each kernel's median device time over 20 runs beside its plain
   version's and ``F.scaled_dot_product_attention``'s (a yardstick the
   port never calls).  K1f also at the head dims its bf16 wgmma kernel
   pads (8, 24, 72, 128) at t = 1, 80, 130, causal and not, f32 and
   bf16; the registers, spills and shared memory of the bf16 K1f/K1b
   kernels at each tile width; the host side of one K1f call at the
   serve shape (bf16, which encodes three tensor maps, and f32).  K6
   (split-K decode) at ``DECODE_CASES``, f32 and bf16: every element by
   K1f's rule (``_decode_close``) and bit-identical across two launches,
   at the serve and long-cache shapes timed with its split count beside
   SDPA's masked call.
2. **Training kernels.**  K1b (flash backward) against its plain
   backward with non-zero ``o`` and ``lse`` cotangents, at the training
   shape (16, 8, 2048, 64) bf16 causal, at non-causal, ragged (t = 80,
   1, 130) and f32 shapes, and at hd 8, 24, 72 and 128 x t = 1, 80, 130,
   causal and not, f32 and bf16: every element of every gradient within
   ``TOL_ELEM`` of the plain one (bf16 ``stream_bwd``, f32 ``bwd``), and
   bit-identical across two launches.  K3 (fused cross-entropy) forward and
   backward against its plain version at (32768, 32768) bf16, at a
   ragged V (32771) and on an f32 case with planted argmax ties, labels
   over the whole vocabulary (0, V-1 and chunk edges included):
   ``nll``/``lse`` within 1e-4, every element of ``dlogits`` within
   ``TOL_XENT_BWD`` of the plain one, ``pred`` exactly.  Times: median
   device time beside the plain version, the bound and SDPA's backward /
   ``F.cross_entropy`` as yardsticks; K1f again at the training shape.
3. **Serve.**  Runs the full-width bf16 LM (vocab 32768, d_model 512,
   8 heads, 6 layers, max_seq 128, 8 slots, buckets 64/128, 16 requests
   of 4-32 prompt tokens and 32 new tokens, decode K=8) through
   ``flexflow_torch.apps.serve.main`` and checks that every request
   completes and that the kernels' launch counters equal ``layers x
   prefills`` (flash prefill) and ``layers x K x supersteps`` (flash
   decode), and that no training kernel ran.
4. **Parity.**  Serves the same requests in f32 with the decode kernel
   and with the plain einsum decode: the greedy tokens must be identical.
5. **Train.**  Trains the full-width bf16 LM (batch 16, seq 2048, 6
   layers, vocab 32768, Adam lr 1e-4; ``bench.py``'s LM shape) through
   ``flexflow_torch.apps.transformer.main`` for 1 warmup and 5 timed
   steps: the loss is finite at every step and falls from the first to
   the last, and the launch counts are exact (K1f = K1b = 6 x steps,
   K3 forward = backward = steps, no decode).  Prints tokens/s, ms/step,
   MFU against 989 TFLOP/s and the share of the step in K1f, K1b and K3.
6. **Train parity.**  One f32 Adam step of a 2-layer LM at vocab 32768
   (batch 2, seq 256, TF32 off) from the same params and batch on the
   card (kernels) and on the CPU (plain versions): loss, every gradient
   and every updated parameter agree within the stated tolerances.
7. **Profile.**  One warm train step of the phase 5 model under
   ``torch.profiler``: the device busy share and device time by kernel.
8. **DLRM kernels.**  K4 (row gather, one table and three through
   ``gather_rows_multi``) and K5 (row scatter-add) against
   their plain versions bit for bit, and K5 against itself across two
   launches, at the main-path shape ((8 x 10^6, 64) f32, 2048 uniform
   ids), at the DLRM step's own ids (8 stacked tables x 256 ids in {0,
   1}: 16 rows named 128 times each), with zipf(1.2) ids, all ids equal,
   4096 ids of one row (the single-launch cap), 8192 ids (K5's two-launch
   route) uniform and all equal, int32 ids with
   negative and >= R ones, n = 0 and 1, D = 16, 65 and 512, and the LM's
   token table (32768 ids into (32768, 512)); rows the ids do not name
   never change.  Times beside the byte bound, the plain version and
   ``F.embedding`` / ``index_add_``; at the main-path shape K4, its
   three-table launch and ``F.embedding`` each timed three ways (one
   launch, the chain slope, the chain slope over cold rows:
   ``_gather_times``) beside the launch floor.
9. **DLRM train.**  ``bench.py``'s DLRM leg (8 x 10^6 x 64 tables, MLPs
   64-512-512-64 and 576-1024-1024-1024-1, batch 256, bf16) through
   ``flexflow_torch.apps.dlrm.main`` for 1 warmup and 10 timed steps:
   plain SGD and lazy Adam on the row-sparse path (K4 = K5 = steps;
   K4 = 2 x steps, one of them the three-table launch, and K5 = 3 x
   steps), momentum SGD on the dense path
   (no K4/K5): finite losses, exact launch counts, no attention or
   cross-entropy launch, only the batch's rows changed.  Prints
   samples/s, ms/step, MFU and peak memory.
10. **DLRM parity.**  One f32 step at 8 x 100,000 x 64 (ids over the
    whole vocabulary with planted duplicates) on the card and on the CPU
    for plain SGD, lazy momentum and lazy Adam: the loss, every
    parameter's step and the optimizer state agree within the stated
    tolerances, and untouched rows stay bit-identical on both sides.
11. **DLRM profile.**  One warm plain-SGD DLRM step under
    ``torch.profiler``.
12. **Stream kernels.**  K1s and K1sb (in bf16 K1f's wgmma kernel of
    ``csrc/flash_fwd.cu`` and K1b's wgmma pair of ``csrc/flash_bwd.cu``;
    in f32 the FMA kernels of ``csrc/flash_stream.cu``) against their
    plain versions (K1f's and K1b's) element by element with
    ``TOL_ELEM``, non-zero ``o`` and ``lse`` cotangents, at the shapes of
    phases 1-2, at (1, 8, 8192, 64), ragged t (1, 80, 130), causal and
    not, f32 and bf16, hd 32/64/128, the plain versions run one head at a
    time; at every bf16 case, at the main-path shape (4, 8, 8192, 64) and
    at (1, 8, 32768, 64) the bf16 K1s and K1sb bit-identical to K1f and
    K1b (``_stream_is_k1``); K1f/K1b themselves against the plain
    versions at 8k and 32k, and the chunked form (chunk 8192) against
    K1f at 32k.  Registers, spills and shared memory of each streamed
    kernel.  Device times, bf16 causal, at the serve (t = 64, 128), 2k,
    8k and 32k shapes: K1f beside K1s and K1b beside K1sb timed in turns
    in this warm process, each with its share of 989 TFLOP/s, SDPA and
    the bound (the plain versions at 8k and 32k).
13. **Long-context train.**  ``bench.py``'s 8k and 32k legs (vocab 32768,
    d_model 512, 8 heads, 6 layers, Adam lr 1e-4, bf16) through
    ``apps.transformer.main``: 8k streamed (1 + 5 steps; K1s = K1sb = 6
    x steps, no K1f/K1b), 8k default dispatch (1 + 2 steps; K1f = K1b =
    6 x steps, no K1s/K1sb), 32k streamed (1 + 2 steps); K3 forward =
    backward = steps; finite, falling losses; ms/step, tokens/s, MFU,
    peak memory and the kernels' shares; then one warm 8k step of each
    dispatch under ``torch.profiler``.  The dispatch is chosen by setting
    ``kernels._STREAMED`` in this process.
14. **Long-context parity.**  Phase 6's f32 step under the streamed
    dispatch: K1s/K1sb on the card against the plain versions on the CPU.
15. **Probe kernels.**  The kernels of the P1/P2 race (v2, v3, v4, b2: in
    bf16 all on ``wgmma``, v2 on K1f's kernel of ``csrc/flash_fwd.cu``, v3
    and v4 on the two-pass kernel of ``csrc/flash_probe.cu``, b2 on K1b's
    pair of ``csrc/flash_bwd.cu``; in f32 the FMA kernels of
    ``csrc/flash_probe.cu`` and ``csrc/flash_probe_bwd.cu``) against their
    plain versions element by
    element with ``TOL_ELEM`` (the forward variants by K1f's rule, b2 by
    ``stream_bwd``) at every block they instantiate: (16, 8, 2048, 64)
    bf16 causal, non-causal, f32, hd 128, ragged t (1, 80, 130, 200) and
    two shapes whose key tiles wrap the two-pass kernels' ring across its
    passes (``PROBE_WRAP``); v3 and v4 bit-identical across two launches;
    at (4, 8, 8192, 64) against the plain versions run one batch row at a
    time and against K1f/K1b (twice ``TOL_ELEM``); v4 issues every
    product and v3 stops at the diagonal (``_probe_poison``); at every
    bf16 shape v2 at block 128 gives K1f's ``o`` and b2 at block 64, from
    the delta K1b's dq pass wrote, K1b's gradients bit for bit
    (``_row_state_bits``); exact launch counts.  Registers, spills (none
    allowed at the race's hd 64) and shared memory of the bf16 v2, v3, v4
    and b2.
    Device times at the race's shapes beside the bound of the causal
    function and of the products each variant does, the plain version and
    SDPA.  Then the path
    that runs them: ``flexflow_torch.tools.probe_flash_variants`` and
    ``probe_flash_bwd_variants`` in-process at (16, 8, 2048, 64) and (4,
    8, 8192, 64); every variant prints a finite positive time and an
    error within ``TOL_RACE``, the launch counts equal the races' calls,
    and the races' chain slopes for K1f, K1s, K1b and K1sb are printed
    beside phase 12's device times.
16. **AlexNet kernels.**  K3 forward and backward at AlexNet's loss
    shape, (2048, 1000) bf16 (V a multiple of 8: the 16-byte-load path),
    labels over every class and planted argmax ties, against the plain
    version (``nll``/``lse`` within 1e-4, every ``dlogits`` element within
    ``TOL_XENT_BWD``, ``pred`` exactly); one launch (``_device_ms``, in
    turns with ``F.cross_entropy``) and the chain slope (``_chain_ms``)
    beside the bound, the plain version, ``F.cross_entropy`` and the
    launch floor.
17. **AlexNet train.**  ``bench.py``'s AlexNet leg (batch 2048, 229 x 229
    x 3, 1000 classes, bf16, SGD lr 0.01 momentum 0.9 wd 1e-4, 3 warmup +
    20 timed steps) through the bench entry's
    ``flexflow_torch.bench.bench_alexnet``: a finite loss at every step,
    exact launch counts (K3 forward = backward = steps, no other kernel);
    images/s, ms/step, MFU and peak memory.  Then one warm step under
    ``torch.profiler`` (busy share, time by kernel and by kernel group),
    the SGD update's device time by CUDA events.
18. **AlexNet parity.**  One f32 SGD step of AlexNet at its full widths
    at image 67 (batch 8, 1000 classes, TF32 off) on the card (cuDNN,
    cuBLAS, K3) and on the CPU (plain versions) from the same params and
    batch, the CPU taking the card's branch at each ReLU and max-pool
    window where its own differs only within rounding of the kink
    (``_CardBranches``): loss, every gradient and every updated parameter
    within the stated tolerances.

Then it prints a ``kernels`` JSON line (``launches``: the serve, train,
DLRM, long-context, race and AlexNet runs together, split in
``launches_by_path``), the card's name
and power limit from ``nvidia-smi``, and as its last line the JSON
object ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits 2 and prints no result.
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
#: Phase 1's K6 cases: cache shapes (B, S, h, hd) and each slot's length.
#: The serve shape and a long cache (timed, ``DECODE_TIMED``), one slot of
#: one key in 4096 (every split but the first empty), an S that is not a
#: multiple of the chunk length (33 keys), the head dims 8, 24, 72 and 128,
#: and B h of 264 and 528 (two splits, one).
DECODE_CASES = (
    ((8, 128, 8, 64), (5, 128, 1, 33, 47, 64, 99, 20)),
    ((4, 4096, 8, 64), (1, 4096, 1023, 2049)),
    ((1, 4096, 8, 64), (1,)),
    ((2, 1000, 4, 64), (1000, 517)),
    ((3, 300, 4, 8), (300, 1, 177)),
    ((3, 300, 4, 24), (13, 300, 64)),
    ((3, 300, 4, 72), (299, 2, 150)),
    ((3, 300, 4, 128), (300, 100, 33)),
    ((33, 256, 8, 64), tuple(256 - (37 * i) % 256 for i in range(33))),
    ((66, 64, 8, 64), tuple(64 - (7 * i) % 64 for i in range(66))),
)
DECODE_TIMED = ((8, 128, 8, 64), (4, 4096, 8, 64))
#: Flash attention (K1f's o, K1b's dq/dk/dv) against the plain versions,
#: element by element: ``|got - want| <= rtol |want| + arel * mass``,
#: where ``mass`` is the sum of the absolute terms the element adds up
#: (``_flash_fwd_close``, ``_flash_bwd_mass``).  f32: sums taken in
#: another order.  bf16: the output one ulp apart (2^-7 of itself), and
#: the terms' operands rounded to bf16 on each side: K1f rounds ``p``
#: against its running row maximum, so every term seen before the row's
#: maximum may move by 2^-8 of itself; K1b rounds ``p`` and ``ds`` from
#: the same lse and delta as the plain version, so only the rare values
#: that straddle a rounding boundary move.
#: The bf16 K1b, K1sb and b2 (``stream_bwd``) are held to the bounds of
#: ``bwd`` plus one bf16 ulp of the element's largest term (``atop *
#: top``, ``_flash_bwd_top``): their scores come from the tensor cores and
#: their exponent from ex2 of one FFMA, so a ``p`` or ``ds`` that
#: straddles a rounding boundary rounds the other way more often than in
#: the f32 FMA kernels; it moves its term by one ulp, at most 2^-7 of the
#: term, and in a sum of a few terms that cancel one such move is more
#: than 2^-11 of the mass.  ``bwd`` holds the f32 K1b (the same numbers as
#: ``stream_bwd``'s f32 row).
TOL_ELEM = {
    "fwd": {"float32": (0.0, 2.0 ** -18), "bfloat16": (2.0 ** -7, 2.0 ** -8)},
    "bwd": {"float32": (0.0, 2.0 ** -18), "bfloat16": (2.0 ** -7, 2.0 ** -11)},
    "stream_bwd": {"float32": (0.0, 2.0 ** -18, 0.0),
                   "bfloat16": (2.0 ** -7, 2.0 ** -11, 2.0 ** -7)},
}
#: K3's dlogits against the plain version, element by element: both
#: sides compute one f32 value from the same lse and round it once, so
#: ``rtol |want|`` (f32: expf against torch.exp; bf16: one ulp), plus
#: 1e-5 |g_nll| at the label, where ``p g - g_nll`` may cancel.
TOL_XENT_BWD = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
#: K3's per-row nll and lse: f32 sums of up to 32771 exponentials.
TOL_XENT = 1e-4

#: The training configuration of phase 5 (bench.py's LM leg,
#: ``_bench_lm(batch=16, seq=2048, layers=6)``).
TRAIN = dict(batch=16, seq=2048, layers=6, vocab=32768, d_model=512,
             heads=8, lr=1e-4, iters=5, warmup=1, seed=1234)
#: The f32 parity step of phase 6, and its tolerances: loss absolute;
#: gradients relative to each tensor's largest magnitude plus an
#: absolute floor (the key biases' gradient is zero in exact arithmetic
#: and rounding noise on both sides); Adam's first step is about
#: lr * sign(g), so updated params are compared within 1e-3 * lr where
#: |g| >= max(1e-4 * max|g|, 1e-6) and within 2 * lr elsewhere.
PARITY_TRAIN = dict(batch=2, seq=256, layers=2, vocab=32768, d_model=512,
                    heads=8, lr=1e-4, seed=0)
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = (1e-4, 1e-7)

#: The DLRM configuration of phases 9 and 11: bench.py's DLRM leg on one
#: chip (``bench.py:205-235``: ``dlrm_random_benchmark_config(8)``, batch
#: 256, bf16, ``SGDOptimizer(lr=0.01)``) through ``apps.dlrm.main``, 1
#: warmup + 10 timed steps.  ``--momentum 0 --wd 0`` make the flags'
#: optimizer the leg's: FFConfig's defaults (momentum 0.9, wd 1e-4) would
#: take the dense path.
DLRM = dict(batch=256, tables=8, vocab=1_000_000, dim=64,
            bot=(64, 512, 512, 64), top=(576, 1024, 1024, 1024, 1), lr=0.01,
            iters=10, warmup=1, seed=1234)
#: The f32 step of phase 10: 8 x 100,000 x 64 tables, batch 256.
DLRM_PARITY = dict(batch=256, vocab=100_000, seed=0)
#: Phase 10's tolerances: the loss absolute; each parameter's step
#: ``p1 - p0`` within ``rtol`` of the tensor's largest step plus two f32
#: ulps of its largest value (``p1`` is rounded to f32 on each side); each
#: optimizer state tensor within ``rtol`` of its largest magnitude plus
#: ``atol`` (f32 sums in another order on the two sides).  Lazy Adam's
#: first step is about lr * sign(g), so its params are held as in phase 6.
TOL_DLRM_LOSS = 1e-5
TOL_DLRM_STEP = (1e-4, 1e-9)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _zero_counts() -> None:
    """Sets the launch count of every kernel wrapper of the port to 0."""
    from flexflow_torch.ops import probe_kernels

    for fn in probe_kernels.KERNELS:
        fn.launches = 0


def _counts() -> dict:
    """{wrapper name: launches} for every kernel wrapper of the port."""
    from flexflow_torch.ops import probe_kernels

    return {fn.__name__: fn.launches for fn in probe_kernels.KERNELS}


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


def _pair_ms(a, b, reps: int = 20):
    """Device ms of ``a()`` and ``b()`` timed in turns (a, b, b, a) in one
    warm process, each the mean of its two medians (``_device_ms``)."""
    ta = _device_ms(a, reps)
    tb = _device_ms(b, reps)
    tb = (tb + _device_ms(b, reps)) / 2
    return (ta + _device_ms(a, reps)) / 2, tb


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
                elem = _flash_fwd_close(kernels, q, k, v, causal, o, po)
                name = _dtype_name(dt)
                _check(math.isfinite(err_o) and err_o <= TOL_O[name]
                       and err_lse <= TOL_LSE and elem <= 1.0,
                       f"flash_attention_lse {shape} causal={causal} {name}: "
                       f"|o| err {err_o} ({elem:.3g} of the element "
                       f"tolerance), |lse| err {err_lse}")
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
                      f"{name}: err o {err_o:.3g} ({elem:.3g} of the element "
                      f"tolerance) lse {err_lse:.3g}; "
                      f"{ms:.4f} ms (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, "
                      f"bound {bound:.5f} by {by})")
                if shape == (1, 8, 64, 64) and causal and dt == torch.bfloat16:
                    rows["flash_attention_lse"] = dict(
                        max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, library_ms=lib_ms)
    # The head dims the bf16 kernel pads to a tile width of 32, 64 or 128,
    # at ragged lengths (checked, not timed).
    worst, n = 0.0, 0
    for hd in (8, 24, 72, 128):
        for t in (1, 80, 130):
            for causal in (True, False):
                for dt in (torch.float32, torch.bfloat16):
                    q, k, v = (randn((1, 2, t, hd), dt) for _ in range(3))
                    o, lse = kernels.flash_attention_lse(q, k, v, causal)
                    po, plse = kernels.flash_attention_lse_plain(q, k, v,
                                                                 causal)
                    torch.cuda.synchronize()
                    elem = _flash_fwd_close(kernels, q, k, v, causal, o, po)
                    err_lse = (lse - plse).abs().max().item()
                    _check(elem <= 1.0 and err_lse <= TOL_LSE,
                           f"flash_attention_lse (1, 2, {t}, {hd}) causal="
                           f"{causal} {_dtype_name(dt)}: {elem} of the "
                           f"element tolerance, |lse| err {err_lse}")
                    worst, n = max(worst, elem), n + 1
    print(f"[kernels] flash_attention_lse at hd 8/24/72/128 x t 1/80/130, "
          f"causal and not, f32 and bf16 ({n} cases): worst element "
          f"{worst:.3g} of its tolerance")
    for width in (32, 64, 128):
        print(f"[kernels] bf16 K1f/K1b at tile width {width}: " + ", ".join(
            f"{k} {r} registers, {sp} spilled bytes, {sm} B shared"
            for k, (r, sp, sm) in kernels.flash_attrs(width).items()))
    # The host side of one K1f call at the serve shape: the bf16 wrapper
    # encodes three tensor maps per call, the f32 one none.
    host = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (randn((1, 8, 64, 64), dt) for _ in range(3))
        with torch.no_grad():
            kernels.flash_attention_lse(q, k, v, True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                kernels.flash_attention_lse(q, k, v, True)
            host[_dtype_name(dt)] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
    print(f"[kernels] host side of one flash_attention_lse call at (1, 8, "
          f"64, 64), mean of 200 unsynchronised calls: bf16 "
          f"{host['bfloat16']:.2f} us, f32 {host['float32']:.2f} us")

    # -- K6: flash decode (split-K), every element and two launches --
    worst = 0.0
    for (B, S, h, hd), lens in DECODE_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = randn((B, h, hd), dt)
            ck, cv = randn((B, S, h, hd), dt), randn((B, S, h, hd), dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            o = kernels.flash_decode(q, ck, cv, lengths)
            again = kernels.flash_decode(q, ck, cv, lengths)
            po = kernels.flash_decode_plain(q, ck, cv, lengths)
            torch.cuda.synchronize()
            err_o = (o.float() - po.float()).abs().max().item()
            elem = _decode_close(kernels, q, ck, cv, lengths, o, po)
            splits = kernels.decode_splits(B, S, h)
            name = _dtype_name(dt)
            _check(math.isfinite(err_o) and err_o <= TOL_O[name]
                   and elem <= 1.0 and torch.equal(o, again),
                   f"flash_decode {(B, S, h, hd)} ({splits} splits) {name}: "
                   f"|o| err {err_o} ({elem:.3g} of the element tolerance), "
                   f"two launches equal: {torch.equal(o, again)}")
            worst = max(worst, elem)
            if (B, S, h, hd) not in DECODE_TIMED:
                continue
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
            print(f"[kernels] flash_decode {(B, S, h, hd)} lengths {list(lens)} "
                  f"{name}: err o {err_o:.3g} ({elem:.3g} of the element "
                  f"tolerance); {splits} splits, {ms:.4f} ms (plain "
                  f"{plain_ms:.4f}, sdpa masked {lib_ms:.4f}, bound "
                  f"{bound:.5f} by {by})")
            if dt == torch.bfloat16:
                key = ("flash_decode" if (B, S, h, hd) == DECODE_TIMED[0]
                       else f"flash_decode@{(B, S, h, hd)}")
                rows[key] = dict(
                    max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=lib_ms,
                    splits=splits)
    print(f"[kernels] flash_decode at {len(DECODE_CASES)} shapes (splits "
          f"{sorted({kernels.decode_splits(*c[0][:3]) for c in DECODE_CASES})}"
          f", hd 8/24/64/72/128, f32 and bf16): worst element {worst:.3g} "
          f"of its tolerance, every pair of launches bit-identical")
    return rows


def _close(got, want, mass, rtol: float, arel: float, top=None,
           atop: float = 0.0) -> float:
    """The worst ``|got - want| / (rtol |want| + arel mass + atop top)``
    over every element (above 1 fails); where that tolerance is 0 the two
    must be equal, and a non-finite ``got`` gives ``inf``."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return math.inf
    err = (got - want).abs()
    tol = rtol * want.abs() + arel * mass.float()
    if top is not None:
        tol = tol + atop * top.float()
    ratio = (err / tol).nan_to_num(nan=0.0)  # 0/0: equal where tol is 0
    return ratio.max().item()


def _flash_bwd_mass(q, k, v, o, lse, do, g_lse, causal, rows: int = 4096):
    """Per element of ``(dq, dk, dv)``, the sum of the absolute terms
    the backward adds up, in f32, one head and ``rows`` query rows at a
    time: ``p^T |do|`` for dv, and ``scale |ds| |k|`` / ``scale |ds|^T |q|``
    for dq / dk with ``|ds|`` taken as ``p (|do| |v|^T + rowsum |o do| +
    |g_lse|)``, since ``dp - delta`` may cancel down to the rounding of
    its terms."""
    import torch

    b, h, t, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = tuple(torch.empty((b, h, t, hd), device=q.device) for _ in range(3))
    cols = torch.arange(t, device=q.device)
    for i in range(b):
        for j in range(h):
            qi, ki, vi, oi, doi = (x[i, j].float() for x in (q, k, v, o, do))
            mk = torch.zeros((t, hd), device=q.device)
            mv = torch.zeros((t, hd), device=q.device)
            for r in range(0, t, rows):
                sl = slice(r, min(t, r + rows))
                s = qi[sl] @ ki.transpose(0, 1) * scale
                if causal:
                    s = s.masked_fill(cols[None, :] > cols[sl, None], -math.inf)
                p = torch.exp(s - lse[i, j, sl, None])
                delta = (oi[sl] * doi[sl]).abs().sum(-1) + g_lse[i, j, sl].abs()
                ds = p * (doi[sl].abs() @ vi.abs().transpose(0, 1)
                          + delta[:, None])
                out[0][i, j, sl] = scale * ds @ ki.abs()
                mk += scale * ds.transpose(0, 1) @ qi[sl].abs()
                mv += p.transpose(0, 1) @ doi[sl].abs()
                del s, p, ds
            out[1][i, j] = mk
            out[2][i, j] = mv
    return out


def _flash_bwd_top(q, k, v, o, lse, do, g_lse, causal):
    """Per element of ``(dq, dk, dv)``, its largest absolute term, in
    f32, one head and a block of query rows at a time: ``scale |ds_ij|
    |k_j|`` over keys j for dq, ``scale |ds_ij| |q_i|`` over queries i for
    dk, ``p_ij |do_i|`` for dv.  One ``p`` or ``ds`` that rounds to the
    other side of a bf16 boundary moves its element by one ulp of its
    term, at most 2^-7 of this."""
    import torch

    b, h, t, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = tuple(torch.empty((b, h, t, hd), device=q.device) for _ in range(3))
    cols = torch.arange(t, device=q.device)
    rows = max(1, (1 << 27) // (t * hd))  # 512 MB per (rows, t, hd) temporary
    for i in range(b):
        for j in range(h):
            qi, ki, vi, oi, doi = (x[i, j].float() for x in (q, k, v, o, do))
            aq, ak, ado = qi.abs(), ki.abs(), doi.abs()
            delta = (oi * doi).sum(-1) - g_lse[i, j].float()
            tk = torch.zeros((t, hd), device=q.device)
            tv = torch.zeros((t, hd), device=q.device)
            for r in range(0, t, rows):
                sl = slice(r, min(t, r + rows))
                s = qi[sl] @ ki.transpose(0, 1) * scale
                if causal:
                    s = s.masked_fill(cols[None, :] > cols[sl, None], -math.inf)
                p = torch.exp(s - lse[i, j, sl, None])
                ds = (p * (doi[sl] @ vi.transpose(0, 1) - delta[sl, None])).abs()
                out[0][i, j, sl] = (ds[:, :, None] * ak[None]).amax(1) * scale
                tk = torch.maximum(
                    tk, (ds[:, :, None] * aq[sl, None]).amax(0) * scale)
                tv = torch.maximum(tv, (p[:, :, None] * ado[sl, None]).amax(0))
                del s, p, ds
            out[1][i, j] = tk
            out[2][i, j] = tv
    return out


def _flash_fwd_close(kernels, q, k, v, causal, o, po) -> float:
    """K1f's ``o`` against the plain ``po`` by ``_close``: the mass of
    ``o = sum_j p_j v_j / l`` is the plain forward over ``|v|``."""
    mass = kernels.flash_attention_lse_plain(q, k, v.abs(), causal)[0]
    return _close(o, po, mass, *TOL_ELEM["fwd"][_dtype_name(q.dtype)])


def _decode_close(kernels, q, ck, cv, lengths, o, po) -> float:
    """K6's ``o`` against the plain ``po`` by ``_close`` with K1f's rule
    (``TOL_ELEM["fwd"]``): the mass of ``o = sum_j p_j v_j / l`` is the
    plain decode over ``|v|``.  K6 rounds ``p`` against the running
    maximum of its key group, as the reference rounds it against the
    running maximum of its key block, and merges the splits in f32."""
    mass = kernels.flash_decode_plain(q, ck, cv.abs(), lengths)
    return _close(o, po, mass, *TOL_ELEM["fwd"][_dtype_name(q.dtype)])


def _xent_bwd_close(d, pd, labels, g_nll, rtol, rows=4096) -> float:
    """K3's dlogits against the plain ``pd`` by ``_close``, ``rows`` rows
    at a time: ``rtol |pd|``, plus ``1e-5 |g_nll|`` at each label."""
    import torch

    worst = 0.0
    for r in range(0, d.shape[0], rows):
        sl = slice(r, r + rows)
        mass = torch.zeros(pd[sl].shape, device=pd.device)
        mass[torch.arange(mass.shape[0], device=pd.device),
             labels[sl].long()] = g_nll[sl].abs()
        worst = max(worst, _close(d[sl], pd[sl], mass, rtol, 1e-5))
    return worst


def phase_train_kernels(torch, kernels, F):
    """Check and time K1b and K3 (and K1f at the training shape);
    returns per-kernel rows for the training path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}

    def randn(shape, dt, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(dt)

    # -- K1b: flash-attention backward --
    train_shape = (TRAIN["batch"], TRAIN["heads"], TRAIN["seq"],
                   TRAIN["d_model"] // TRAIN["heads"])
    # The timed training shape, the shapes of earlier slices, then the
    # head dims the bf16 kernels pad (8, 24, 72, 128) at ragged lengths.
    cases = [(train_shape, True, torch.bfloat16),
             ((2, 8, 80, 64), False, torch.float32),
             ((2, 8, 80, 64), True, torch.bfloat16),
             ((1, 8, 1, 64), True, torch.float32),
             ((1, 2, 130, 128), False, torch.bfloat16),
             ((2, 4, 256, 32), True, torch.float32)]
    n_named = len(cases)
    cases += [((1, 2, t, hd), causal, dt) for hd in (8, 24, 72, 128)
              for t in (1, 80, 130) for causal in (True, False)
              for dt in (torch.bfloat16, torch.float32)]
    worst_small = 0.0
    for i_case, (shape, causal, dt) in enumerate(cases):
        name = _dtype_name(dt)
        q, k, v = (randn(shape, dt) for _ in range(3))
        o, lse = kernels.flash_attention_lse_plain(q, k, v, causal)
        do, g_lse = randn(shape, dt), randn(shape[:3], torch.float32)
        got = kernels.flash_attention_lse_bwd(q, k, v, o, lse, do, g_lse,
                                              causal)
        again = kernels.flash_attention_lse_bwd(q, k, v, o, lse, do, g_lse,
                                                causal)
        want = kernels.flash_attention_lse_bwd_plain(q, k, v, o, lse, do,
                                                     g_lse, causal)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        # bf16 K1b runs on the tensor cores (stream_bwd), f32 on FMA (bwd).
        rtol, arel, atop = (TOL_ELEM["stream_bwd"][name] if name == "bfloat16"
                            else TOL_ELEM["bwd"][name] + (0.0,))
        mass = _flash_bwd_mass(q, k, v, o, lse, do, g_lse, causal)
        tops = (_flash_bwd_top(q, k, v, o, lse, do, g_lse, causal) if atop
                else (None,) * 3)
        err = max(_close(a, w, m, rtol, arel, tp, atop)
                  for a, w, m, tp in zip(got, want, mass, tops))
        _check(err <= 1.0 and same,
               f"flash_attention_lse_bwd {shape} causal={causal} {name}: "
               f"gradient error {err} of the element tolerance, two "
               f"launches bit-identical: {same}")
        if i_case >= n_named:
            worst_small = max(worst_small, err)
        else:
            print(f"[train-kernels] flash_attention_lse_bwd {shape} "
                  f"causal={causal} {name}: worst element {err:.3g} of its "
                  f"tolerance, two launches bit-identical")
        del mass, tops, again
        if shape != train_shape:
            continue
        b, h, t, hd = shape
        pairs = t * (t + 1) // 2 if causal else t * t
        isz = q.element_size()
        ms = _device_ms(lambda: kernels.flash_attention_lse_bwd(
            q, k, v, o, lse, do, g_lse, causal))
        plain_ms = _device_ms(lambda: kernels.flash_attention_lse_bwd_plain(
            q, k, v, o, lse, do, g_lse, causal))
        qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        lib_ms = _device_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True))
        # Five t x t x hd products (s, dp, dv, dq, dk) over the causal
        # pairs; q, k, v, o, do, lse, g_lse read once, dq, dk, dv written.
        bound, by = _bound_ms(8 * b * h * t * hd * isz + 2 * b * h * t * 4,
                              10 * b * h * hd * pairs, name)
        print(f"[train-kernels] flash_attention_lse_bwd {shape} {name}: "
              f"{ms:.4f} ms (plain {plain_ms:.4f}, sdpa backward "
              f"{lib_ms:.4f}, bound {bound:.5f} by {by})")
        rows["flash_attention_lse_bwd"] = dict(
            max_abs_err=max((a.float() - w.float()).abs().max().item()
                            for a, w in zip(got, want)),
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms)
        # K1f at the training shape (a row of its own in PERF.md).
        fo, flse = kernels.flash_attention_lse(q, k, v, causal)
        torch.cuda.synchronize()
        f_err = (fo.float() - o.float()).abs().max().item()
        f_elem = _flash_fwd_close(kernels, q, k, v, causal, fo, o)
        _check(f_err <= TOL_O[name] and f_elem <= 1.0
               and (flse - lse).abs().max().item() <= TOL_LSE,
               f"flash_attention_lse {shape}: |o| err {f_err} ({f_elem} of "
               f"the element tolerance)")
        with torch.no_grad():
            f_ms = _device_ms(lambda: kernels.flash_attention_lse(q, k, v,
                                                                  causal))
        f_plain = _device_ms(lambda: kernels.flash_attention_lse_plain(
            q, k, v, causal))
        f_lib = _device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        f_bound, f_by = _bound_ms(4 * b * h * t * hd * isz + b * h * t * 4,
                                  4 * b * h * hd * pairs, name)
        print(f"[train-kernels] flash_attention_lse {shape} causal {name}: "
              f"worst element {f_elem:.3g} of its tolerance; {f_ms:.4f} ms (plain {f_plain:.4f}, sdpa {f_lib:.4f}, bound "
              f"{f_bound:.5f} by {f_by})")
        rows["flash_attention_lse@train"] = dict(
            max_abs_err=f_err, ms=f_ms, plain_ms=f_plain, bound_ms=f_bound,
            bound_by=f_by, library_ms=f_lib)
        del q, k, v, o, lse, do, got, want, qs, ks, vs, out, fo

    print(f"[train-kernels] flash_attention_lse_bwd at hd 8/24/72/128 x t "
          f"1/80/130, causal and not, bf16 and f32: worst element "
          f"{worst_small:.3g} of its tolerance, every case bit-identical "
          f"across two launches")

    # -- K3: fused softmax cross-entropy, forward and backward --
    n_main = TRAIN["batch"] * TRAIN["seq"]
    for n, v, dt, ties in ((n_main, TRAIN["vocab"], torch.bfloat16, False),
                           (1000, 32771, torch.bfloat16, False),
                           (1000, 32771, torch.float32, False),
                           (512, 32768, torch.float32, True)):
        name = _dtype_name(dt)
        x = randn((n, v), torch.float32, 3.0)
        labels = torch.randint(0, v, (n,), generator=g, device="cuda",
                               dtype=torch.int32)
        labels[:4] = torch.tensor([0, v - 1, 8 * 256 - 1, 8 * 256],
                                  device="cuda", dtype=torch.int32)
        if ties:
            # Equal maxima inside one 8-element chunk, across the chunks
            # of one thread, across threads and at the row's two ends.
            top = x.max() + 1.0
            for r, cols in enumerate(((3, 5), (9, 2048 + 9), (2047, 2048),
                                      (v - 1, 0), (100, 7, 30000))):
                x[r, list(cols)] = top
        x = x.to(dt)
        nll, lse, pred = kernels.softmax_xent(x, labels)
        gn = torch.full((n,), 1.0 / n, device="cuda")
        gl = randn((n,), torch.float32)
        d = kernels.softmax_xent_bwd(x, labels, lse, gn, gl)
        pn, pl, pp = kernels.softmax_xent_plain(x, labels)
        # The kernel's lse on both sides: the backward alone is compared.
        pd = kernels.softmax_xent_bwd_plain(x, labels, lse, gn, gl)
        torch.cuda.synchronize()
        e_nll = (nll - pn).abs().max().item()
        e_lse = (lse - pl).abs().max().item()
        e_d = _xent_bwd_close(d, pd, labels, gn, TOL_XENT_BWD[name])
        miss = int((pred != pp).sum().item())
        _check(e_nll <= TOL_XENT and e_lse <= TOL_XENT and e_d <= 1.0
               and miss == 0,
               f"softmax_xent ({n}, {v}) {name}: nll err {e_nll}, lse err "
               f"{e_lse}, dlogits error {e_d} of the element tolerance, "
               f"{miss} pred mismatches")
        if ties:
            _check([int(pred[r]) for r in range(5)] == [3, 9, 2047, 0, 7],
                   f"softmax_xent ties: pred {pred[:5].tolist()}")
        print(f"[train-kernels] softmax_xent ({n}, {v}) {name}"
              f"{' ties' if ties else ''}: nll err {e_nll:.3g} lse err "
              f"{e_lse:.3g}, dlogits worst element {e_d:.3g} of its "
              f"tolerance, pred exact")
        if n != n_main:
            continue
        isz = x.element_size()
        ms = _device_ms(lambda: kernels.softmax_xent(x, labels))
        plain_ms = _device_ms(lambda: kernels.softmax_xent_plain(x, labels))
        lab64 = labels.long()
        lib_ms = _device_ms(lambda: F.cross_entropy(x, lab64,
                                                    reduction="none"))
        # Logits read once, labels read, nll/lse/pred written; about four
        # f32 operations per logit (max, subtract, exp, sum).
        bound, by = _bound_ms(n * v * isz + 16 * n, 4 * n * v, "float32")
        print(f"[train-kernels] softmax_xent ({n}, {v}) {name}: {ms:.4f} ms "
              f"(plain {plain_ms:.4f}, F.cross_entropy {lib_ms:.4f}, bound "
              f"{bound:.5f} by {by})")
        rows["softmax_xent"] = dict(
            max_abs_err=max(e_nll, e_lse), ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms)
        b_ms = _device_ms(lambda: kernels.softmax_xent_bwd(x, labels, lse,
                                                           gn, gl))
        b_plain = _device_ms(lambda: kernels.softmax_xent_bwd_plain(
            x, labels, lse, gn, gl))
        xr = x.detach().clone().requires_grad_(True)
        ce = F.cross_entropy(xr, lab64, reduction="none")
        gce = gn.to(ce.dtype)
        b_lib = _device_ms(lambda: torch.autograd.grad(ce, xr, gce,
                                                       retain_graph=True))
        # Logits read and dlogits written once, rows' scalars read; about
        # four f32 operations per logit (subtract, exp, multiply, select).
        b_bound, b_by = _bound_ms(2 * n * v * isz + 16 * n, 4 * n * v,
                                  "float32")
        print(f"[train-kernels] softmax_xent_bwd ({n}, {v}) {name}: "
              f"{b_ms:.4f} ms (plain {b_plain:.4f}, F.cross_entropy backward "
              f"{b_lib:.4f}, bound {b_bound:.5f} by {b_by})")
        rows["softmax_xent_bwd"] = dict(
            max_abs_err=(d.float() - pd.float()).abs().max().item(),
            ms=b_ms, plain_ms=b_plain, bound_ms=b_bound, bound_by=b_by,
            library_ms=b_lib)
        del xr, ce, gce, pd, d, pn, pl, pp
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
    _zero_counts()
    rc = serve.main(_serve_argv("bfloat16"), device="cuda", stats_out=stats)
    torch.cuda.synchronize()
    launches = _counts()
    _check(rc == 0, f"serve exited {rc}")
    _check(stats["completed"] == SERVE["requests"] and stats["failed"] == 0,
           f"serve completed {stats['completed']} of {SERVE['requests']}, "
           f"failed {stats['failed']}")
    L, K = SERVE["layers"], SERVE["decode_steps"]
    want = {"flash_attention_lse": L * stats["prefills"],
            "flash_decode": L * K * stats["decode_supersteps"]}
    _check(all(launches[n] == want[n] > 0 for n in want),
           f"launch counts {launches}, expected {want}")
    _check(all(c == 0 for n, c in launches.items() if n not in want),
           f"serving launched a training kernel: {launches}")
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


def _train_argv(c):
    return ["-b", str(c["batch"]), "--seq", str(c["seq"]),
            "--layers", str(c["layers"]), "--vocab", str(c["vocab"]),
            "--d-model", str(c["d_model"]), "--heads", str(c["heads"]),
            "--optimizer", "adam", "--lr", str(c["lr"]),
            "--dtype", "bfloat16", "-i", str(c["iters"]),
            "--seed", str(c["seed"])]


def train_flops(c) -> float:
    """FLOPs of one train step of the LM configuration ``c``: 3 x the
    forward, the forward ``L (24 b s d^2 + 4 b s^2 d) + 2 b s d V``
    (bench.py's ``_train_flops`` over ``search/cost_model.py::op_cost``;
    the full ``s^2`` even when causal)."""
    b, s, d, L, V = c["batch"], c["seq"], c["d_model"], c["layers"], c["vocab"]
    return 3.0 * (L * (24 * b * s * d * d + 4 * b * s * s * d)
                  + 2 * b * s * d * V)


def phase_train(torch, kernels, rows):
    """The full-width bf16 LM trained through the app; returns the
    launch counts of this run."""
    from flexflow_torch.apps import transformer

    stats = {}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rc = transformer.main(_train_argv(TRAIN), device="cuda", stats_out=stats)
    torch.cuda.synchronize()
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check(rc == 0, f"transformer exited {rc}")
    losses = stats["step_losses"]
    steps = TRAIN["warmup"] + TRAIN["iters"]
    _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
           f"step losses {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    L = TRAIN["layers"]
    want = {n: 0 for n in launches}
    want.update(flash_attention_lse=L * steps,
                flash_attention_lse_bwd=L * steps, softmax_xent=steps,
                softmax_xent_bwd=steps)
    _check(launches == want, f"launch counts {launches}, expected {want}")
    ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
    tokens_s = stats["samples_per_s"] * TRAIN["seq"]
    mfu = train_flops(TRAIN) / (ms_step * 1e-3) / PEAK_FLOPS["bfloat16"]
    shares = {
        "K1f": L * rows["flash_attention_lse@train"]["ms"],
        "K1b": L * rows["flash_attention_lse_bwd"]["ms"],
        "K3": rows["softmax_xent"]["ms"] + rows["softmax_xent_bwd"]["ms"],
    }
    share_s = ", ".join(f"{k} {v:.3f} ms ({100 * v / ms_step:.1f}%)"
                        for k, v in shares.items())
    print(f"[train] losses {[round(x, 5) for x in losses]}; {ms_step:.3f} "
          f"ms/step, tokens/s {tokens_s:.1f}, MFU {100 * mfu:.2f}% of 989 "
          f"TFLOP/s ({train_flops(TRAIN):.4g} FLOP/step); from the kernels' "
          f"measured times: {share_s}; peak memory {peak_gb:.2f} GB; "
          f"launches {launches}")
    return launches


def _profile_step(torch, tag: str, step):
    """``step()`` once under torch.profiler: the device busy share of its
    wall time and device time by kernel name.  Returns the device events
    as ``(us, name, count)``, longest first.  One step runs first in the
    profiler's warmup, unrecorded: a window's first kernels were lost
    from a trace that had no warmup (AlexNet's conv1, ~9 ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies): host ops would count
    # their kernels' time a second time, and so would the schedule's
    # device-side step annotation.
    dev = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")), reverse=True)
    busy_ms = sum(us for us, _, _ in dev) / 1e3
    print(f"[{tag}] one train step: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy_ms / wall_ms:.1f}%), {sum(n for _, _, n in dev)} "
          f"device events")
    for us, key, count in dev[:20]:
        print(f"[{tag}] {us / 1e3:10.3f} ms ({100 * us / 1e3 / wall_ms:5.1f}%)"
              f" x{count:<4d} {key[:80]}")
    return dev


def phase_profile(torch, c=None, tag: str = "profile"):
    """One warm train step of the LM configuration ``c`` (phase 5's by
    default) under torch.profiler: device time by kernel name and the
    step's device busy share."""
    from flexflow_torch.apps.common import make_optimizer
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    c = c or TRAIN
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="bfloat16",
                   optimizer="adam", learning_rate=c["lr"], seed=c["seed"])
    ff = build_transformer_lm(batch_size=c["batch"], seq_len=c["seq"],
                              vocab_size=c["vocab"], d_model=c["d_model"],
                              num_heads=c["heads"], num_layers=c["layers"],
                              config=cfg)
    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device="cuda")
    state = list(ex.init())
    batch = Trainer(ex).synthetic_batch()

    def step():
        state[:3] = ex.train_step(*state, batch)[:3]

    for _ in range(2):
        step()
    _profile_step(torch, tag, step)


def phase_train_parity(torch, kernels, streamed: bool = False):
    """One f32 Adam step on the card (kernels) and on the CPU (plain
    versions) from the same params and batch; with ``streamed``, under
    the streamed dispatch (``kernels._STREAMED`` set in this process),
    so the card runs K1s/K1sb."""
    import numpy as np

    from flexflow_torch.config import FFConfig
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.optim import AdamOptimizer
    from flexflow_torch.runtime.executor import Executor

    c = PARITY_TRAIN
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="float32",
                   seed=c["seed"])
    ff = build_transformer_lm(
        batch_size=c["batch"], seq_len=c["seq"], vocab_size=c["vocab"],
        d_model=c["d_model"], num_heads=c["heads"], num_layers=c["layers"],
        config=cfg)
    params0 = Executor(ff, cfg, device="cpu").init_params()
    batch = synthetic_host_batch(ff, np.random.default_rng(c["seed"]),
                                 {"tokens": c["vocab"], "label": c["vocab"]})
    out = {}
    bwd = (kernels.flash_attention_lse_streamed_bwd if streamed
           else kernels.flash_attention_lse_bwd)
    tag = "longctx-parity" if streamed else "train-parity"
    for dev in ("cuda", "cpu"):
        ex = Executor(ff, cfg, optimizer=AdamOptimizer(lr=c["lr"]), device=dev)
        params = {op: {k: p.detach().clone().to(ex.device)
                       for k, p in g.items()}
                  for op, g in params0.items()}
        before = bwd.launches
        # The two halves of Executor.train_step (no --clip-norm here).
        saved, kernels._STREAMED = kernels._STREAMED, streamed
        try:
            loss, _, _, grads = ex.loss_and_grads(params, {}, batch)
        finally:
            kernels._STREAMED = saved
        grads_cpu = {op: {k: v.detach().cpu() for k, v in g.items()}
                     for op, g in grads.items()}
        ex.optimizer.update(params, ex.optimizer.init(params), grads)
        if dev == "cuda":
            torch.cuda.synchronize()
            _check(bwd.launches - before == c["layers"],
                   f"the f32 parity step did not run {bwd.__name__}")
        out[dev] = (float(loss), grads_cpu,
                    {op: {k: v.detach().cpu() for k, v in g.items()}
                     for op, g in params.items()})
    (lc, gc, pc), (lp, gp, pp) = out["cuda"], out["cpu"]
    _check(abs(lc - lp) <= TOL_TRAIN_LOSS,
           f"f32 step loss: card {lc}, CPU {lp}")
    rtol, atol = TOL_TRAIN_GRAD
    worst_g = worst_p = 0.0
    for op in gp:
        for k in gp[op]:
            want, got = gp[op][k], gc[op][k]
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            _check(err <= rtol * scale + atol,
                   f"f32 grad {op}.{k}: err {err} at scale {scale}")
            worst_g = max(worst_g, err / (rtol * scale + atol))
            g = want.abs()
            big = g >= max(1e-4 * g.max().item(), 1e-6)
            diff = (pc[op][k] - pp[op][k]).abs()
            d_big = diff[big].max().item() if big.any() else 0.0
            _check(d_big <= 1e-3 * c["lr"] and diff.max().item() <= 2 * c["lr"],
                   f"f32 updated {op}.{k}: err {d_big} where |g| is not "
                   f"noise, {diff.max().item()} overall")
            worst_p = max(worst_p, d_big)
    print(f"[{tag}] f32 step card vs CPU: loss {lc:.7f} vs {lp:.7f}; "
          f"worst grad err {worst_g:.3g} of its tolerance; worst "
          f"updated-param err {worst_p:.3g} (lr {c['lr']})")


def _dlrm_model(batch: int, vocab: int, dtype: str, seed: int, **cfg_kw):
    """The DLRM graph of the DLRM phases (``apps.dlrm``'s for the same
    flags) and its config."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.dlrm import DLRMConfig, build_dlrm

    c = DLRM
    cfg = FFConfig(batch_size=batch, compute_dtype=dtype, seed=seed, **cfg_kw)
    spec = DLRMConfig(sparse_feature_size=c["dim"],
                      embedding_size=[vocab] * c["tables"],
                      mlp_bot=list(c["bot"]), mlp_top=list(c["top"]))
    return build_dlrm(batch, spec, cfg), cfg


def _dlrm_argv(optimizer: str = "sgd", extra=()):
    c = DLRM

    def dash(xs):
        return "-".join(str(x) for x in xs)

    return ["-b", str(c["batch"]), "-i", str(c["iters"]), "--dtype", "bfloat16",
            "--optimizer", optimizer, "--lr", str(c["lr"]), "--momentum", "0",
            "--wd", "0", "--seed", str(c["seed"]),
            "--arch-sparse-feature-size", str(c["dim"]),
            "--arch-embedding-size", dash([c["vocab"]] * c["tables"]),
            "--arch-mlp-bot", dash(c["bot"]), "--arch-mlp-top", dash(c["top"]),
            *extra]


def dlrm_flops(ff) -> float:
    """FLOPs of one train step: 3 x the forward's ``2 B in out`` of every
    linear layer (``bench.py::_train_flops`` for these ops)."""
    from flexflow_torch.ops import Linear

    b = ff.input_tensors[0].shape[0]
    return 3.0 * sum(2 * b * op.in_dim * op.attrs["out_dim"]
                     for op in ff.layers if isinstance(op, Linear))


def _touched(torch, ids, shape):
    """(T, V) bool on the card: the rows of each table that a (B, T) id
    batch addresses."""
    mask = torch.zeros(shape, dtype=torch.bool, device="cuda")
    for t in range(shape[0]):
        mask[t, torch.as_tensor(ids[:, t], device="cuda").long()] = True
    return mask


def _chain_ms(fn, n1: int = 16, n2: int = 80, reps: int = 5) -> float:
    """Device ms per call of ``fn(i)`` from the slope of chains of ``n1``
    and ``n2`` calls in a row, the best of ``reps`` runs each.  Each run
    first parks the card in a spin longer than the host takes to enqueue
    the chain, so the events bracket back-to-back device work only; the
    slope cancels what a chain pays once (the events, the first launch's
    ramp).  Unlike ``_device_ms``, which brackets one launch, it reads a
    kernel of a few microseconds."""
    import torch

    for i in range(n2):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n2):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(4e9 * host_s) + 2_000_000  # _sleep's cycles: 2x at ~2 GHz

    def best(n):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for i in range(n):
                fn(i)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    return (best(n2) - best(n1)) / (n2 - n1)


#: K4's cold-row chain: distinct id vectors a chain cycles through, so that
#: the rows it reads (GATHER_COLD x 2048 x 256 bytes = 128 MB at the DLRM
#: shape) are more than the 50 MB L2 holds, as a real DLRM batch finds them.
GATHER_COLD = 256


def _gather_times(torch, fn, table, ids, cold_ids):
    """``fn(table, ids)`` timed three ways (ms): one launch between events
    (``_device_ms``), the chain slope on the same ids (warm L2), and the
    chain slope through ``cold_ids`` (a new id vector at every call,
    cycling: rows from HBM)."""
    turn = [0]

    def cold(_):
        turn[0] += 1
        return fn(table, cold_ids[turn[0] % len(cold_ids)])

    return (_device_ms(lambda: fn(table, ids)),
            _chain_ms(lambda _: fn(table, ids)), _chain_ms(cold))


def _gather_exact(torch, kernels, name, table, ids):
    """K4 and its three-table entry against the plain versions bit for bit
    (NaN rows included); the third table differs from the first so that a
    row of the wrong table shows.  Returns K4's one-table rows and the
    plain ones."""
    want = kernels.gather_rows_plain(table, ids)
    tables = (table, table.neg(), table * 0.5)
    wants = kernels.gather_rows_multi_plain(tables, ids)
    got = kernels.gather_rows(table, ids)
    multi = kernels.gather_rows_multi(tables, ids)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    same_multi = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                     for a, b in zip(multi, wants))
    _check(same and same_multi and len(multi) == 3,
           f"gather_rows {name}: one table exact {same}, three tables "
           f"exact {same_multi}")
    return got, want


def phase_dlrm_kernels(torch, kernels, F):
    """K4 (one and three tables) and K5 against their plain versions on the
    card, bit for bit, and K5 against itself across two launches; device
    times beside the byte bound, the plain version and ``F.embedding`` /
    ``index_add_``, and K4 at the main-path shape three ways
    (``_gather_times``) beside the launch floor.  Returns the rows of the
    main-path shape."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(3)
    c = DLRM
    main_rows = c["tables"] * c["vocab"]
    main_n = c["batch"] * c["tables"]
    binned = 2 * kernels._SCATTER_CAP  # K5's two-launch route
    cases = (
        ("main", main_rows, c["dim"], main_n, "uniform"),
        ("step", main_rows, c["dim"], main_n, "step"),
        ("zipf", main_rows, c["dim"], main_n, "zipf"),
        ("equal", main_rows, c["dim"], main_n, "equal"),
        ("cap equal", main_rows, c["dim"], kernels._SCATTER_CAP, "equal"),
        ("binned", main_rows, c["dim"], binned, "uniform"),
        ("binned equal", main_rows, c["dim"], binned, "equal"),
        ("out of range", 100_000, c["dim"], main_n, "range"),
        ("n=0", 100_000, c["dim"], 0, "uniform"),
        ("n=1", 100_000, c["dim"], 1, "uniform"),
        ("D=16", 100_000, 16, main_n, "uniform"),
        ("D=65", 100_000, 65, main_n, "zipf"),
        ("D=512", 100_000, 512, main_n, "zipf"),
        ("wte", 32768, 512, 32768, "uniform"),
    )
    out = {}
    for name, R, D, n, kind in cases:
        table = torch.randn((R, D), generator=g, device="cuda")
        if kind == "uniform":
            ids = torch.randint(0, R, (n,), generator=g, device="cuda")
        elif kind == "step":  # the DLRM step's stacked ids: {0, 1} per table
            ids = (torch.randint(0, 2, (c["batch"], c["tables"]), generator=g,
                                 device="cuda")
                   + torch.arange(c["tables"], device="cuda") * c["vocab"]
                   ).reshape(-1)
        elif kind == "zipf":  # data/trace.py's skew
            z = np.minimum(np.random.default_rng(5).zipf(1.2, n), R) - 1
            ids = torch.as_tensor(z, device="cuda")
        elif kind == "range":  # negative and >= R among valid ones
            ids = torch.randint(-R // 8, R + R // 8, (n,), generator=g,
                                device="cuda")
        else:
            ids = torch.full((n,), R // 2, device="cuda", dtype=torch.int64)
        if name in ("wte", "out of range"):
            ids = ids.to(torch.int32)  # the LM's token ids
        upd = torch.randn((n, D), generator=g, device="cuda")
        rows, want = _gather_exact(torch, kernels, name, table, ids)
        t1, t2, t3 = table.clone(), table.clone(), table.clone()
        kernels.scatter_add_rows(t1, ids, upd)
        kernels.scatter_add_rows(t2, ids, upd)
        kernels.scatter_add_rows_plain(t3, ids, upd)
        torch.cuda.synchronize()
        valid = ids[(ids >= 0) & (ids < R)].long()
        hit = torch.zeros((R,), dtype=torch.bool, device="cuda")
        hit[valid] = True
        stray = bool(((t1 != table).any(1) & ~hit).any())
        _check(torch.equal(t1, t3) and torch.equal(t1, t2) and not stray,
               f"row kernels {name} ({R}, {D}) n={n}: scatter exact "
               f"{torch.equal(t1, t3)}, repeat exact {torch.equal(t1, t2)}, "
               f"rows outside the ids changed {stray}")
        if kind == "range":
            _check(bool(rows[(ids < 0) | (ids >= R)].isnan().all()),
                   "gather_rows: an out-of-range id did not give a NaN row")
        err_g = (rows - want).nan_to_num().abs().max().item() if n else 0.0
        err_s = (t1 - t3).abs().max().item() if n else 0.0
        del t2, t3
        uniq = int(torch.unique(valid).numel())
        line = (f"[dlrm-kernels] {name}: table ({R}, {D}) f32, {n} "
                f"{str(ids.dtype)[6:]} ids ({kind}, {valid.numel()} in range, "
                f"{uniq} distinct; K5 in {kernels.scatter_plan(n)[0]} "
                f"launches): gather (one and three tables) and "
                f"scatter bit-exact against the plain versions, scatter "
                f"bit-identical across two launches")
        if n == 0:
            _check(torch.equal(t1, table), "scatter with n = 0 changed the table")
        if n == 0 or kind == "range":  # the library calls refuse such ids
            print(line)
            continue
        isz = ids.element_size()
        ms_g = _device_ms(lambda: kernels.gather_rows(table, ids))
        plain_g = _device_ms(lambda: kernels.gather_rows_plain(table, ids))
        lib_g = _device_ms(lambda: F.embedding(ids, table))
        bound_g, by_g = _bound_ms(n * isz + uniq * D * 4 + n * D * 4, 0.0,
                                  "float32")
        ms_s = _device_ms(lambda: kernels.scatter_add_rows(t1, ids, upd))
        plain_s = _device_ms(lambda: kernels.scatter_add_rows_plain(t1, ids, upd))
        lib_s = _device_ms(lambda: t1.index_add_(0, ids, upd))
        bound_s, by_s = _bound_ms(n * isz + n * D * 4 + 2 * uniq * D * 4,
                                  n * D, "float32")
        print(f"{line}; gather {ms_g:.6f} ms (plain {plain_g:.6f}, "
              f"F.embedding {lib_g:.6f}, bound {bound_g:.6f} by {by_g}); "
              f"scatter {ms_s:.6f} ms (plain {plain_s:.6f}, index_add_ "
              f"{lib_s:.6f}, bound {bound_s:.6f} by {by_s})")
        row_s = dict(max_abs_err=err_s, ms=ms_s, plain_ms=plain_s,
                     bound_ms=bound_s, bound_by=by_s, library_ms=lib_s)
        if name == "main":
            ways, out["gather_rows_multi"] = _gather_main(torch, kernels, F,
                                                          table, ids, g)
            out["gather_rows"] = dict(max_abs_err=err_g, ms=ms_g, plain_ms=plain_g,
                                      bound_ms=bound_g, bound_by=by_g,
                                      library_ms=lib_g, **ways)
            out["scatter_add_rows"] = row_s
        elif name in ("step", "wte"):
            out["scatter_add_rows"][f"{name}_shape"] = row_s
        del table, t1, rows, want, upd, hit
    return out


def _gather_main(torch, kernels, F, table, ids, g):
    """K4 at the main-path shape: K4 and ``F.embedding`` three ways
    (``_gather_times``) beside the launch floor (the chain slope of
    ``torch.cuda._sleep(0)``), and the three-table launch against three
    one-table launches and its plain version.  Returns the keys it adds to
    the ``gather_rows`` row and ``gather_rows_multi``'s row."""
    R, D = table.shape
    n = ids.shape[0]
    cold = [torch.randint(0, R, (n,), generator=g, device="cuda")
            for _ in range(GATHER_COLD)]
    floor = _chain_ms(lambda _: torch.cuda._sleep(0))
    lib = _gather_times(torch, lambda t, i: F.embedding(i, t), table, ids,
                        cold)
    one = _gather_times(torch, kernels.gather_rows, table, ids, cold)
    tables = (table, table.neg(), table * 0.5)
    multi = _gather_times(
        torch, lambda t, i: kernels.gather_rows_multi(tables, i), table, ids,
        cold)
    three = _gather_times(
        torch, lambda t, i: [kernels.gather_rows(x, i) for x in tables],
        table, ids, cold)
    plain_m = _device_ms(lambda: kernels.gather_rows_multi_plain(tables, ids))
    err_m = max((a - b).abs().max().item() for a, b in zip(
        kernels.gather_rows_multi(tables, ids),
        kernels.gather_rows_multi_plain(tables, ids)))
    uniq = int(torch.unique(ids).numel())
    bound_m, by_m = _bound_ms(n * ids.element_size() + 3 * (uniq + n) * D * 4,
                              0.0, "float32")
    fmt = lambda t: " / ".join(f"{x:.6f}" for x in t)
    print(f"[dlrm-kernels] gather_rows main: {fmt(one)} ms (single launch / "
          f"chain slope / cold-row chain slope); F.embedding {fmt(lib)} ms; "
          f"launch floor (chain slope of torch.cuda._sleep(0)) {floor:.6f} "
          f"ms")
    print(f"[dlrm-kernels] gather_rows_multi main, 3 tables: {fmt(multi)} "
          f"ms; three gather_rows launches {fmt(three)} ms; plain "
          f"{plain_m:.6f} ms; bound {bound_m:.6f} by {by_m}; err {err_m}")
    ways = dict(chain_ms=one[1], cold_ms=one[2], floor_ms=floor,
                library_chain_ms=lib[1], library_cold_ms=lib[2])
    return ways, dict(max_abs_err=err_m, ms=multi[0], plain_ms=plain_m,
                      bound_ms=bound_m, bound_by=by_m, library_ms=None,
                      chain_ms=multi[1], cold_ms=multi[2],
                      three_launches=dict(ms=three[0], chain_ms=three[1],
                                          cold_ms=three[2]))


def phase_dlrm_train(torch, kernels):
    """The full-width DLRM through ``apps.dlrm.main``: plain SGD and lazy
    Adam on the row-sparse path, momentum SGD on the dense path.  Returns
    the launch counts by run and the SGD run's trained params."""
    import numpy as np

    from flexflow_torch.apps import dlrm
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.runtime.executor import Executor

    c = DLRM
    ff, cfg = _dlrm_model(c["batch"], c["vocab"], "bfloat16", c["seed"])
    t0 = time.perf_counter()
    table0 = Executor(ff, cfg, device="cuda").init_params()["embeddings"]["tables"]
    init_s = time.perf_counter() - t0
    # The app's fixed synthetic batch: ids in {0, 1} (Trainer.synthetic_batch).
    ids = synthetic_host_batch(ff, np.random.default_rng(0))["sparse_input"]
    touched = _touched(torch, ids, table0.shape[:2])
    flops = dlrm_flops(ff)
    steps = c["warmup"] + c["iters"]
    runs = (("sgd", _dlrm_argv("sgd"), 1, 1),
            # Lazy Adam gathers the batch's rows, then the unique rows of
            # the table, m and v in one launch (gather_rows_multi); it
            # scatters into the table, m and v.
            ("lazy_adam", _dlrm_argv("adam", ["--lazy-sparse-opt"]), 2, 3),
            ("dense", _dlrm_argv("sgd", ["--momentum", "0.9"]), 0, 0))
    by_run, sgd_params = {}, None
    for name, argv, k4, k5 in runs:
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_counts()
        rc = dlrm.main(argv, device="cuda", stats_out=stats)
        torch.cuda.synchronize()
        launches = _counts()
        # The run's own peak, above what this script already holds.
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        _check(rc == 0, f"dlrm {name} exited {rc}")
        losses = stats["step_losses"]
        _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
               f"dlrm {name} step losses {losses}")
        want = {n: 0 for n in launches}
        # Every K4 launch past the batch's gathers the state's rows too.
        want.update(gather_rows=k4 * steps, scatter_add_rows=k5 * steps,
                    gather_rows_multi=max(k4 - 1, 0) * steps)
        _check(launches == want, f"dlrm {name} launch counts {launches}, "
               f"expected {want}")
        params, opt_state, _ = stats.pop("final")
        table = params["embeddings"]["tables"]
        changed = (table != table0).any(-1)
        _check(not bool((changed & ~touched).any()) and bool(changed[touched].all()),
               f"dlrm {name}: rows outside the batch changed, or a batch row "
               f"did not")
        if name == "lazy_adam":
            m = opt_state["m"]["embeddings"]["tables"]
            _check(not bool(((m != 0).any(-1) & ~touched).any()),
                   "lazy Adam moved the moments of untouched rows")
        ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
        mfu = flops / (ms_step * 1e-3) / PEAK_FLOPS["bfloat16"]
        print(f"[dlrm-train] {name}: losses {[round(x, 6) for x in losses]}; "
              f"{ms_step:.4f} ms/step, samples/s {stats['samples_per_s']:.1f}, "
              f"MFU {100 * mfu:.4f}% of 989 TFLOP/s ({flops:.4g} FLOP/step); "
              f"peak memory {peak_gb:.2f} GB; {int(touched.sum())} touched "
              f"rows changed, the other rows bit-identical; launches {launches}")
        by_run[name] = launches
        if name == "sgd":
            sgd_params = params
        del stats, params, opt_state, table, changed
    print(f"[dlrm-train] table init (CPU draw of 8 x 10^6 x 64 f32, then "
          f"copied to the card) {init_s:.1f}s")
    return by_run, sgd_params


def phase_dlrm_parity(torch, kernels):
    """One f32 step at 8 x 100,000 x 64 on the card (kernels) and on the
    CPU (plain versions) from the same params and batch, for plain SGD,
    lazy momentum and lazy Adam."""
    import numpy as np

    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.optim import AdamOptimizer, SGDOptimizer
    from flexflow_torch.runtime.executor import Executor

    c = DLRM_PARITY
    ff, cfg = _dlrm_model(c["batch"], c["vocab"], "float32", c["seed"])
    params0 = Executor(ff, cfg, device="cpu").init_params()
    batch = synthetic_host_batch(ff, np.random.default_rng(c["seed"]),
                                 {"sparse_input": c["vocab"]})
    ids = batch["sparse_input"]
    ids[1:9] = ids[0]                      # duplicates at distances 1 to 8
    ids[200] = ids[20]                     # and at distance 180
    ids[:, 3] = np.minimum(ids[:, 3], 5)   # table 3: six rows, 256 ids
    touched = _touched(torch, ids, params0["embeddings"]["tables"].shape[:2]).cpu()
    b1 = 0.9
    opts = {
        "sgd": (lambda: SGDOptimizer(lr=0.1), 1, 1),
        "lazy_momentum": (lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                               weight_decay=1e-4,
                                               lazy_sparse=True), 2, 2),
        "lazy_adam": (lambda: AdamOptimizer(lr=1e-3, b1=b1,
                                            lazy_sparse=True), 2, 3),
    }
    rtol, atol = TOL_DLRM_STEP
    for name, (make, k4, k5) in opts.items():
        out = {}
        for dev in ("cuda", "cpu"):
            opt = make()
            ex = Executor(ff, cfg, optimizer=opt, device=dev)
            _check([op.name for op in ex._sparse_ops] == ["embeddings"],
                   f"dlrm parity {name}: the tables are not on the sparse path")
            params = {op: {k: p.clone().to(ex.device) for k, p in g.items()}
                      for op, g in params0.items()}
            before = (kernels.gather_rows.launches,
                      kernels.scatter_add_rows.launches,
                      kernels.gather_rows_multi.launches)
            params, state, _, m = ex.train_step(params, opt.init(params), {},
                                                ex.shard_batch(batch))
            if dev == "cuda":
                torch.cuda.synchronize()
                _check((kernels.gather_rows.launches - before[0],
                        kernels.scatter_add_rows.launches - before[1],
                        kernels.gather_rows_multi.launches - before[2])
                       == (k4, k5, k4 - 1),
                       f"dlrm parity {name}: not one launch set of K4/K5 "
                       f"(the state's rows in one K4 launch)")
            cpu = {op: {k: v.detach().cpu() for k, v in g.items()}
                   for op, g in params.items()}
            if isinstance(state, dict) and "t" in state:
                state = {"m": state["m"], "v": state["v"]}
            elif state is not None:
                state = {"v": state}
            state = {s: {op: {k: v.cpu() for k, v in g.items()}
                         for op, g in tree.items()}
                     for s, tree in (state or {}).items()}
            out[dev] = (float(m["train_loss"]), cpu, state)
        (lc, pc, sc), (lp, pp, sp) = out["cuda"], out["cpu"]
        _check(abs(lc - lp) <= TOL_DLRM_LOSS,
               f"dlrm parity {name}: loss card {lc}, CPU {lp}")
        worst = 0.0
        for op in pp:
            for k in pp[op]:
                p0 = params0[op][k]
                dc, dp = pc[op][k] - p0, pp[op][k] - p0
                if name == "lazy_adam":
                    g = (sp["m"][op][k] / (1 - b1)).abs()
                    big = g >= max(1e-4 * g.max().item(), 1e-6)
                    diff = (dc - dp).abs()
                    lr = 1e-3
                    err = diff[big].max().item() if big.any() else 0.0
                    _check(err <= 1e-3 * lr and diff.max().item() <= 2 * lr,
                           f"dlrm parity {name} {op}.{k}: step err {err}")
                    worst = max(worst, err / (1e-3 * lr))
                else:
                    tol = (rtol * dp.abs().max().item()
                           + 2.0 ** -22 * p0.abs().max().item())
                    err = (dc - dp).abs().max().item()
                    _check(err <= tol, f"dlrm parity {name} {op}.{k}: step "
                           f"err {err} against {tol}")
                    worst = max(worst, err / tol)
                if op == "embeddings":
                    cold = ~touched
                    _check(torch.equal(pc[op][k][cold], p0[cold])
                           and torch.equal(pp[op][k][cold], p0[cold]),
                           f"dlrm parity {name}: untouched rows moved")
        for s in sp:
            for op in sp[s]:
                for k in sp[s][op]:
                    want, got = sp[s][op][k], sc[s][op][k]
                    tol = rtol * want.abs().max().item() + atol
                    err = (got - want).abs().max().item()
                    _check(err <= tol, f"dlrm parity {name} state {s} {op}.{k}: "
                           f"err {err} against {tol}")
                    worst = max(worst, err / tol)
        print(f"[dlrm-parity] {name}: loss card {lc:.8f} CPU {lp:.8f}; worst "
              f"param step / state error {worst:.3g} of its tolerance; "
              f"{int(touched.sum())} touched rows, every other row "
              f"bit-identical to its initial value on both sides")


def phase_dlrm_profile(torch, params) -> None:
    """One warm full-width plain-SGD DLRM step (the sparse path) under
    torch.profiler, from the dlrm-train SGD run's params."""
    from flexflow_torch.apps.common import make_optimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    c = DLRM
    ff, cfg = _dlrm_model(c["batch"], c["vocab"], "bfloat16", c["seed"],
                          optimizer="sgd", learning_rate=c["lr"],
                          momentum=0.0, weight_decay=0.0)
    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device="cuda")
    _check(bool(ex._sparse_ops), "the profiled DLRM step is not sparse")
    batch = Trainer(ex).synthetic_batch()

    def step():
        ex.train_step(params, None, {}, batch)

    for _ in range(2):
        step()
    _profile_step(torch, "dlrm-profile", step)


#: The long-context legs of phase 13 (``bench.py:287-308``,
#: ``bench_transformer_longctx`` and ``bench_transformer_32k``): the
#: phase 5 model at seq 8192 (batch 4) and 32768 (batch 1).
LONGCTX_8K = dict(TRAIN, batch=4, seq=8192, iters=5)
LONGCTX_32K = dict(TRAIN, batch=1, seq=32768, iters=2)


def _per_row(fn, *xs, heads: bool = False):
    """``fn`` over the leading batch dim one row at a time (``heads``:
    one head of one row at a time), outputs concatenated: the plain
    versions at long t, whose f32 t x t temporaries for the whole batch
    would not fit the card (at 32k one is 4.3 GB per head)."""
    import torch

    def part(x, i, j):
        if x is None:
            return None
        return x[i:i + 1] if j is None else x[i:i + 1, j:j + 1]

    cols = range(xs[0].shape[1]) if heads else (None,)
    rows = []
    for i in range(xs[0].shape[0]):
        outs = [fn(*(part(x, i, j) for x in xs)) for j in cols]
        rows.append(tuple(torch.cat(parts, 1) for parts in zip(*outs)))
    return tuple(torch.cat(parts) for parts in zip(*rows))


def _flash_parts(torch, kernels, q, k, v, do, g_lse, causal,
                 pair: str = "stream"):
    """The forward's ``o``/``lse`` and the backward's gradients of a kernel
    pair, ``stream`` (K1s/K1sb, through ``flash_attention_lse_streamed``)
    or ``k1`` (K1f/K1b), against the plain versions, one head at a time,
    within ``TOL_ELEM``'s ``fwd`` and ``stream_bwd``.  The backward takes
    the plain forward's ``o`` and ``lse``.  Returns ({"o", "lse", "dq",
    "dk", "dv": worst element ratio, above 1 fails}, {"fwd", "bwd": worst
    absolute error}); lse is held within ``TOL_LSE``."""
    name = _dtype_name(q.dtype)
    if pair == "stream":
        fwd_t = kernels.flash_attention_lse_streamed
        bwd_t = kernels.flash_attention_lse_streamed_bwd
    else:
        fwd_t, bwd_t = kernels.flash_attention_lse, kernels.flash_attention_lse_bwd
    fwd = lambda a, b, c: _per_row(
        lambda x, y, z: kernels.flash_attention_lse_plain(x, y, z, causal),
        a, b, c, heads=True)
    bwd = lambda *a: _per_row(
        lambda *x: kernels.flash_attention_lse_bwd_plain(*x, causal), *a,
        heads=True)
    with torch.no_grad():
        o, lse = fwd_t(q, k, v, causal)
        po, plse = fwd(q, k, v)
        mass = fwd(q, k, v.abs())[0]
    e_lse = (lse - plse).abs().max().item()
    parts = {"o": _close(o, po, mass, *TOL_ELEM["fwd"][name]),
             "lse": e_lse / TOL_LSE if math.isfinite(e_lse) else math.inf}
    errs = {"fwd": max((o.float() - po.float()).abs().max().item(), e_lse)}
    del o, lse, mass
    got = bwd_t(q, k, v, po, plse, do, g_lse, causal)
    want = bwd(q, k, v, po, plse, do, g_lse)
    rtol, arel, atop = TOL_ELEM["stream_bwd"][name]
    masses = _flash_bwd_mass(q, k, v, po, plse, do, g_lse, causal)
    tops = (_flash_bwd_top(q, k, v, po, plse, do, g_lse, causal) if atop
            else (None,) * 3)
    errs["bwd"] = 0.0
    for key, a, w, m, tp in zip(("dq", "dk", "dv"), got, want, masses, tops):
        parts[key] = _close(a, w, m, rtol, arel, tp, atop)
        errs["bwd"] = max(errs["bwd"], (a.float() - w.float()).abs().max().item())
    return parts, errs


def _hold_stream(torch, kernels, q, k, v, do, g_lse, causal,
                 pair: str = "stream"):
    """:func:`_flash_parts` of K1s/K1sb (or, with ``pair="k1"``, of
    K1f/K1b), failing the run above the tolerance.  Returns (worst element
    ratio, {"fwd", "bwd": worst absolute error})."""
    parts, errs = _flash_parts(torch, kernels, q, k, v, do, g_lse, causal,
                               pair)
    worst = max(parts.values())
    _check(worst <= 1.0, f"{pair} kernels {tuple(q.shape)} causal={causal} "
           f"{_dtype_name(q.dtype)} against plain: " + ", ".join(
               f"{k} {v:.3g}" for k, v in parts.items())
           + " of the element tolerance")
    return worst, errs


def _stream_is_k1(torch, kernels, q, k, v, do, g_lse, causal) -> None:
    """The bf16 K1s and K1sb launch K1f's wgmma kernel and K1b's wgmma
    pair (``kernels.fwd_entry``, ``bwd_entry``): the same bits as K1f and
    K1b, and each wrapper counts its own launch."""
    fns = (kernels.flash_attention_lse, kernels.flash_attention_lse_streamed,
           kernels.flash_attention_lse_bwd,
           kernels.flash_attention_lse_streamed_bwd)
    before = [f.launches for f in fns]
    with torch.no_grad():
        o, lse = kernels.flash_attention_lse(q, k, v, causal)
        fwd = all(torch.equal(a, b) for a, b in zip(
            kernels.flash_attention_lse_streamed(q, k, v, causal), (o, lse)))
    bwd = all(torch.equal(a, b) for a, b in zip(
        kernels.flash_attention_lse_streamed_bwd(q, k, v, o, lse, do, g_lse,
                                                 causal),
        kernels.flash_attention_lse_bwd(q, k, v, o, lse, do, g_lse, causal)))
    torch.cuda.synchronize()
    counts = [f.launches - n for f, n in zip(fns, before)]
    _check(fwd and bwd and counts == [1, 1, 1, 1],
           f"{tuple(q.shape)} causal={causal}: K1s equals K1f {fwd}, K1sb "
           f"equals K1b {bwd}, launches {counts}")


def phase_stream_kernels(torch, kernels, F):
    """K1s and K1sb against their plain versions on the card, element by
    element, and against K1f/K1b at the long-context shapes; device times
    at the main-path shape.  Returns per-kernel rows."""
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    for hd in kernels._STREAM_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            a = kernels.flash_stream_attrs(hd, dt)
            print(f"[stream-kernels] hd {hd} {_dtype_name(dt)}: "
                  + ", ".join(f"{k} {r} registers, {sp} spilled bytes, "
                              f"{sm} B shared" for k, (r, sp, sm) in a.items()))
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(shape, causal, dt)
             for shape in ((1, 8, 64, 64), (1, 8, 128, 64), (2, 8, 2048, 64),
                           (1, 8, 80, 64))
             for causal in (True, False) for dt in (f32, bf16)]
    cases += [((16, 8, 2048, 64), True, bf16), ((2, 8, 80, 64), False, f32),
              ((2, 8, 80, 64), True, bf16), ((1, 8, 1, 64), True, f32),
              ((1, 2, 130, 128), False, bf16), ((2, 4, 256, 32), True, f32),
              ((1, 8, 130, 64), True, bf16), ((1, 2, 130, 32), True, bf16),
              ((1, 2, 200, 128), True, f32), ((1, 8, 8192, 64), True, bf16)]
    worst = 0.0
    for shape, causal, dt in cases:
        q, k, v, do = (randn(shape, dt) for _ in range(4))
        g_lse = randn(shape[:3], f32)
        ratio, _ = _hold_stream(torch, kernels, q, k, v, do, g_lse, causal)
        if dt == bf16:
            _stream_is_k1(torch, kernels, q, k, v, do, g_lse, causal)
        torch.cuda.synchronize()
        _check(ratio <= 1.0, f"streamed kernels {shape} causal={causal} "
               f"{_dtype_name(dt)}: {ratio} of the element tolerance")
        worst = max(worst, ratio)
        del q, k, v, do, g_lse
    print(f"[stream-kernels] {len(cases)} shapes against the plain versions "
          f"(o, lse, dq, dk, dv; causal and not, f32 and bf16, t = 1 to "
          f"8192, hd 32/64/128): worst element {worst:.3g} of its tolerance")

    # -- the main-path shape: against plain and K1f/K1b --
    main = (LONGCTX_8K["batch"], LONGCTX_8K["heads"], LONGCTX_8K["seq"],
            LONGCTX_8K["d_model"] // LONGCTX_8K["heads"])
    q, k, v, do = (randn(main, bf16) for _ in range(4))
    g_lse = randn(main[:3], f32)
    r_plain, err = _hold_stream(torch, kernels, q, k, v, do, g_lse, True)
    # K1f/K1b themselves at the 8k default arm's shape (phase 13), element
    # by element against the plain versions
    r_k1_plain, err_k1 = _hold_stream(torch, kernels, q, k, v, do, g_lse,
                                      True, pair="k1")
    _stream_is_k1(torch, kernels, q, k, v, do, g_lse, True)
    print(f"[stream-kernels] {main}: K1s/K1sb worst element {r_plain:.3g} "
          f"(plain) of its tolerance; K1f/K1b worst element {r_k1_plain:.3g} "
          f"(plain), max abs err fwd {err_k1['fwd']:.3g}, bwd "
          f"{err_k1['bwd']:.3g}; the bf16 K1s/K1sb bit-identical to K1f/K1b")
    del q, k, v, do, g_lse

    # -- 32k: K1s/K1sb and K1f/K1b against the plain versions, one head
    # at a time, and the chunked form against K1f --
    big = (1, 8, 32768, 64)
    q, k, v, do = (randn(big, bf16) for _ in range(4))
    g_lse = randn(big[:3], f32)
    r_big, err_big = _hold_stream(torch, kernels, q, k, v, do, g_lse, True)
    r_big_k1, err_big_k1 = _hold_stream(torch, kernels, q, k, v, do, g_lse,
                                        True, pair="k1")
    _stream_is_k1(torch, kernels, q, k, v, do, g_lse, True)
    torch.cuda.empty_cache()
    with torch.no_grad():
        o, lse = kernels.flash_attention_lse(q, k, v, True)
        co, clse = kernels.flash_attention_lse_chunked(q, k, v, True,
                                                       chunk=8192)
        mass = kernels.flash_attention_lse(q, k, v.abs(), True)[0]
    # Each chunk's o is rounded to bf16 before the f32 merge (2^-8 of its
    # own mass) and each side rounds p against its own running maximum
    # (2^-8 each): 3 x 2^-8 < 2^-6 of the mass, plus one output ulp.
    r_chunk = _close(co, o, mass, 2.0 ** -7, 2.0 ** -6)
    e_clse = (clse - lse).abs().max().item()
    torch.cuda.synchronize()
    _check(r_big <= 1.0 and r_chunk <= 1.0 and e_clse <= TOL_LSE,
           f"32k: streamed {r_big}, chunked {r_chunk} of the element "
           f"tolerance, chunked lse err {e_clse}")
    print(f"[stream-kernels] {big} bf16 causal against the plain versions "
          f"one head at a time: K1s/K1sb worst element {r_big:.3g} of its "
          f"tolerance (max abs err fwd {err_big['fwd']:.3g}, bwd "
          f"{err_big['bwd']:.3g}), K1f/K1b {r_big_k1:.3g} (fwd "
          f"{err_big_k1['fwd']:.3g}, bwd {err_big_k1['bwd']:.3g}), the bf16 "
          f"K1s/K1sb bit-identical to K1f/K1b; chunked "
          f"(chunk 8192) {r_chunk:.3g} of its tolerance against K1f, lse err "
          f"{e_clse:.3g}")
    del q, k, v, do, g_lse, o, lse, co, clse, mass
    torch.cuda.empty_cache()

    # -- device times, bf16 causal: K1f beside K1s and K1b beside K1sb in
    # turns (_pair_ms), at the serve, 2k, 8k and 32k shapes, with SDPA and
    # the bound (the plain versions at 8k one batch row at a time, at 32k
    # one head at a time; at 2k and the serve shape phases 1 and 2 time
    # them)
    for shape in ((1, 8, 64, 64), (1, 8, 128, 64), (16, 8, 2048, 64), main,
                  big):
        b, h, t, hd = shape
        reps = 5 if t >= 32768 else 20
        q, k, v, do = (randn(shape, bf16) for _ in range(4))
        g_lse = randn(shape[:3], f32)
        with torch.no_grad():
            o, lse = kernels.flash_attention_lse(q, k, v, True)
            t_f, t_s = _pair_ms(
                lambda: kernels.flash_attention_lse(q, k, v, True),
                lambda: kernels.flash_attention_lse_streamed(q, k, v, True),
                reps)
            t_lf = _device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), reps)
        t_b, t_sb = _pair_ms(
            lambda: kernels.flash_attention_lse_bwd(q, k, v, o, lse, do,
                                                    g_lse, True),
            lambda: kernels.flash_attention_lse_streamed_bwd(
                q, k, v, o, lse, do, g_lse, True), reps)
        qs, ks, vs = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        t_lb = _device_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), reps)
        del qs, ks, vs, out
        t_pf = t_pb = None
        if shape in (main, big):
            heads, preps = shape == big, 3 if shape == big else 20
            with torch.no_grad():
                t_pf = _device_ms(lambda: _per_row(
                    lambda *x: kernels.flash_attention_lse_plain(*x, True),
                    q, k, v, heads=heads), preps)
            t_pb = _device_ms(lambda: _per_row(
                lambda *x: kernels.flash_attention_lse_bwd_plain(*x, True),
                q, k, v, o, lse, do, g_lse, heads=heads), preps)
        pairs = t * (t + 1) // 2
        f_flops, b_flops = 4 * b * h * hd * pairs, 10 * b * h * hd * pairs
        fb, fby = _bound_ms(4 * b * h * t * hd * 2 + b * h * t * 4, f_flops,
                            "bfloat16")
        bb, bby = _bound_ms(8 * b * h * t * hd * 2 + 2 * b * h * t * 4,
                            b_flops, "bfloat16")

        def pct(flops, ms):
            return 100 * flops / (ms * 1e-3) / PEAK_FLOPS["bfloat16"]

        print(f"[stream-kernels] {shape} bf16 causal: K1f {t_f:.4f} ms "
              f"({pct(f_flops, t_f):.1f}% of 989 TFLOP/s), K1s {t_s:.4f} "
              f"({pct(f_flops, t_s):.1f}%), sdpa {t_lf:.4f} "
              f"({pct(f_flops, t_lf):.1f}%), bound {fb:.5f} by {fby}; K1b "
              f"{t_b:.4f} ({pct(b_flops, t_b):.1f}%), K1sb {t_sb:.4f} "
              f"({pct(b_flops, t_sb):.1f}%), sdpa backward {t_lb:.4f} "
              f"({pct(b_flops, t_lb):.1f}%), bound {bb:.5f} by {bby}"
              + ("" if t_pf is None else f"; plain {t_pf:.4f} / {t_pb:.4f} "
                 f"(one {'head' if heads else 'batch row'} at a time)"))
        rows[f"stream@{shape}"] = dict(K1f=t_f, K1s=t_s, K1b=t_b, K1sb=t_sb)
        fwd = dict(ms=t_f, plain_ms=t_pf, bound_ms=fb, bound_by=fby,
                   library_ms=t_lf)
        bwd = dict(ms=t_b, plain_ms=t_pb, bound_ms=bb, bound_by=bby,
                   library_ms=t_lb)
        if shape == main:
            rows["flash_attention_lse_streamed"] = dict(
                fwd, ms=t_s, max_abs_err=err["fwd"])
            rows["flash_attention_lse_streamed_bwd"] = dict(
                bwd, ms=t_sb, max_abs_err=err["bwd"])
            rows["flash_attention_lse@8k"] = dict(
                fwd, max_abs_err=err_k1["fwd"])
            rows["flash_attention_lse_bwd@8k"] = dict(
                bwd, max_abs_err=err_k1["bwd"])
        elif shape == big:
            rows["stream@32k"] = dict(fwd_ms=t_s, bwd_ms=t_sb)
            rows["flash_attention_lse@32k"] = dict(
                fwd, max_abs_err=err_big_k1["fwd"])
            rows["flash_attention_lse_bwd@32k"] = dict(
                bwd, max_abs_err=err_big_k1["bwd"])
            rows["flash_attention_lse_streamed@32k"] = dict(
                fwd, ms=t_s, max_abs_err=err_big["fwd"])
            rows["flash_attention_lse_streamed_bwd@32k"] = dict(
                bwd, ms=t_sb, max_abs_err=err_big["bwd"])
        del q, k, v, do, g_lse, o, lse
        torch.cuda.empty_cache()
    return rows


def phase_longctx_train(torch, kernels, rows):
    """``bench.py``'s long-context legs through ``apps.transformer.main``
    at full width: 8k with the streamed dispatch and with the default
    one, 32k streamed.  The dispatch is chosen by setting
    ``kernels._STREAMED`` in this process, as ``tests/test_pallas.py``
    sets ``pallas_kernels._STREAMED``.  Then one warm 8k step of each
    dispatch under torch.profiler.  Returns launch counts by leg."""
    from flexflow_torch.apps import transformer

    legs = (("longctx_8k_streamed", LONGCTX_8K, True),
            ("longctx_8k_default", dict(LONGCTX_8K, iters=2), False),
            ("longctx_32k", LONGCTX_32K, True))
    by_leg = {}
    for name, c, streamed in legs:
        stats = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_counts()
        saved, kernels._STREAMED = kernels._STREAMED, streamed
        try:
            rc = transformer.main(_train_argv(c), device="cuda",
                                  stats_out=stats)
            torch.cuda.synchronize()
        finally:
            kernels._STREAMED = saved
        launches = _counts()
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        _check(rc == 0, f"{name} exited {rc}")
        losses = stats["step_losses"]
        steps = c["warmup"] + c["iters"]
        _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
               f"{name} step losses {losses}")
        _check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
        L = c["layers"]
        fwd, bwd = (("flash_attention_lse_streamed",
                     "flash_attention_lse_streamed_bwd") if streamed else
                    ("flash_attention_lse", "flash_attention_lse_bwd"))
        want = {n: 0 for n in launches}
        want.update({fwd: L * steps, bwd: L * steps, "softmax_xent": steps,
                     "softmax_xent_bwd": steps})
        _check(launches == want, f"{name} launch counts {launches}, "
               f"expected {want}")
        ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
        tokens_s = stats["samples_per_s"] * c["seq"]
        flops = train_flops(c)
        mfu = flops / (ms_step * 1e-3) / PEAK_FLOPS["bfloat16"]
        if c["seq"] == 32768:
            a_f, a_b = rows["stream@32k"]["fwd_ms"], rows["stream@32k"]["bwd_ms"]
        elif streamed:
            a_f = rows["flash_attention_lse_streamed"]["ms"]
            a_b = rows["flash_attention_lse_streamed_bwd"]["ms"]
        else:
            a_f = rows["flash_attention_lse@8k"]["ms"]
            a_b = rows["flash_attention_lse_bwd@8k"]["ms"]
        names = ("K1s", "K1sb") if streamed else ("K1f", "K1b")
        shares = {names[0]: L * a_f, names[1]: L * a_b,
                  "K3": rows["softmax_xent"]["ms"] + rows["softmax_xent_bwd"]["ms"]}
        share_s = ", ".join(f"{k} {v:.3f} ms ({100 * v / ms_step:.1f}%)"
                            for k, v in shares.items())
        print(f"[longctx-train] {name} (batch {c['batch']} x seq {c['seq']}, "
              f"{c['warmup']} + {c['iters']} steps): losses "
              f"{[round(x, 5) for x in losses]}; {ms_step:.3f} ms/step, "
              f"tokens/s {tokens_s:.1f}, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
              f"({flops:.4g} FLOP/step); from the kernels' measured times: "
              f"{share_s}; peak memory {peak_gb:.2f} GB; launches {launches}")
        by_leg[name] = launches
    for streamed, tag in ((True, "longctx-profile"),
                          (False, "longctx-profile-default")):
        saved, kernels._STREAMED = kernels._STREAMED, streamed
        try:
            phase_profile(torch, LONGCTX_8K, tag)
        finally:
            kernels._STREAMED = saved
    return by_leg


#: Phase 15's race shapes: the LM's attention at the 2k training shape and
#: at the 8k long-context shape (phases 5 and 13), bf16 causal.
PROBE_RACE = ((16, 8, 2048, 64), (4, 8, 8192, 64))
#: The races' printed error (against K1f / K1b, the first 64 rows of the
#: first head) within this share of that slice's largest magnitude: four
#: bf16 ulps.  It checks that a race times the function it names; the race
#: kernels are held element by element before it.
TOL_RACE = 2.0 ** -5
#: Shapes whose key tiles wrap the bf16 two-pass kernels' ring (depth 3)
#: across their two passes, with (shape, causal): 2 to 10 key tiles per
#: CTA at blocks 64 and 128, most not a multiple of the depth.
PROBE_WRAP = (((1, 2, 640, 128), True), ((1, 2, 450, 64), False))
def race_products(name: str, t: int) -> float:
    """The products the race kernel ``name`` does at length ``t``, in units
    of the causal function's (``t (t + 1) / 2`` score pairs, two products
    each): v3 recomputes Q K^T in its second pass (1.5), v4 runs both
    passes over every key (``3 t^2 / t (t + 1)``, about 3); 1 for the
    others."""
    pairs = t * (t + 1) / 2
    return {"flash_fwd_two_pass": 1.5,
            "flash_fwd_full_row": 1.5 * t * t / pairs}.get(name, 1.0)


#: The kernel wrapper each race variant launches (None: the yardstick).
RACE_WRAPPERS = {
    "v1_base": "flash_attention_lse", "v2_lanes": "flash_fwd_row_state",
    "v3_twopass": "flash_fwd_two_pass", "v4_fullrow": "flash_fwd_full_row",
    "v5_sdpa": None, "v6_stream": "flash_attention_lse_streamed",
    "b1_prod": "flash_attention_lse_bwd", "b2_lanes": "flash_bwd_row_state",
    "b3_stream": "flash_attention_lse_streamed_bwd", "b4_sdpa": None,
}


def _probe_hold(torch, kernels, probe, q, k, v, do, g_lse, causal, block,
                ref: str, calls):
    """The race kernels v2, v3, v4 and b2 at ``block`` against ``ref``:
    ``plain`` (the plain versions, one batch row at a time; the forward
    variants within ``TOL_ELEM["fwd"]``, K1f's rule, and b2 within
    ``TOL_ELEM["stream_bwd"]``, since its products round as K1sb's) or
    ``k1`` (K1f and K1b, within twice those).  b2 takes ``delta =
    rowsum(o do) - g_lse`` and ``lse`` from the reference forward.  Adds
    the wrappers' calls to ``calls``; fails the run above the tolerance.
    Returns (worst element ratio, {wrapper: worst absolute error})."""
    name = _dtype_name(q.dtype)
    if ref == "plain":
        fwd = lambda a, b, c: _per_row(
            lambda x, y, z: kernels.flash_attention_lse_plain(x, y, z, causal),
            a, b, c, heads=True)
        bwd = lambda *a: _per_row(
            lambda *x: kernels.flash_attention_lse_bwd_plain(*x, causal), *a,
            heads=True)
        factor = 1.0
    else:
        fwd = lambda a, b, c: kernels.flash_attention_lse(a, b, c, causal)
        bwd = lambda *a: kernels.flash_attention_lse_bwd(*a, causal)
        factor = 2.0
    with torch.no_grad():
        po, plse = fwd(q, k, v)
        mass = fwd(q, k, v.abs())[0]
    rtol, arel = TOL_ELEM["fwd"][name]
    parts, errs = {}, {}
    for fn in (probe.flash_fwd_row_state, probe.flash_fwd_two_pass,
               probe.flash_fwd_full_row):
        o = fn(q, k, v, causal, block)
        calls[fn.__name__] += 1
        parts[fn.__name__] = _close(o, po, mass, factor * rtol,
                                    factor * arel)
        errs[fn.__name__] = (o.float() - po.float()).abs().max().item()
        if fn is not probe.flash_fwd_row_state:
            again = fn(q, k, v, causal, block)
            calls[fn.__name__] += 1
            _check(torch.equal(o, again), f"{fn.__name__} {tuple(q.shape)} "
                   f"block {block}: two launches differ")
            del again
        del o
    del mass
    delta = (po.float() * do.float()).sum(dim=-1) - g_lse
    got = probe.flash_bwd_row_state(q, k, v, do, plse, delta, causal, block)
    calls["flash_bwd_row_state"] += 1
    want = bwd(q, k, v, po, plse, do, g_lse)
    rtol, arel, atop = TOL_ELEM["stream_bwd"][name]
    masses = _flash_bwd_mass(q, k, v, po, plse, do, g_lse, causal)
    tops = (_flash_bwd_top(q, k, v, po, plse, do, g_lse, causal) if atop
            else (None,) * 3)
    errs["flash_bwd_row_state"] = 0.0
    for key, a, w, m, tp in zip(("dq", "dk", "dv"), got, want, masses, tops):
        parts[f"b2 {key}"] = _close(a, w, m, factor * rtol, factor * arel, tp,
                                    factor * atop)
        errs["flash_bwd_row_state"] = max(
            errs["flash_bwd_row_state"],
            (a.float() - w.float()).abs().max().item())
    worst = max(parts.values())
    _check(worst <= 1.0, f"race kernels {tuple(q.shape)} causal={causal} "
           f"{name} block {block} against {ref}: " + ", ".join(
               f"{k} {v:.3g}" for k, v in parts.items())
           + " of the element tolerance")
    return worst, errs


def _row_state_bits(torch, kernels, probe, q, k, v, do, g_lse, causal,
                    calls) -> None:
    """The bf16 v2 and b2 on K1f's kernel and K1b's pair, bit for bit: v2
    at block 128 is K1f's instantiation less the lse store, so its ``o``
    must be K1f's; b2 at block 64 is K1b's tiling, so given the delta that
    K1b's dq pass wrote it must give K1b's ``dq``, ``dk``, ``dv``.  Adds
    the race wrappers' calls to ``calls``; fails the run otherwise."""
    shape = tuple(q.shape)
    with torch.no_grad():
        o, lse = kernels.flash_attention_lse(q, k, v, causal)
        o2 = probe.flash_fwd_row_state(q, k, v, causal, 128)
        calls["flash_fwd_row_state"] += 1
        _check(torch.equal(o2, o), f"v2 {shape} causal={causal} block 128: "
               f"o is not K1f's bit for bit")
        delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
        want = kernels._launch_bwd("K1b", False, q, k, v, o, lse, do, g_lse,
                                   causal, delta=delta)
        got = probe.flash_bwd_row_state(q, k, v, do, lse, delta, causal, 64)
        calls["flash_bwd_row_state"] += 1
        _check(all(torch.equal(a, w) for a, w in zip(got, want)),
               f"b2 {shape} causal={causal} block 64 from K1b's delta: "
               f"dq, dk, dv not K1b's bit for bit")


def _probe_poison(torch, kernels, probe, q, k, v, block, calls,
                  plain: bool = False):
    """The formulations' key ranges, causal, with a NaN at the last key of
    ``v``: v4 multiplies every key tile's ``v`` by its ``p`` (an exact 0
    above the diagonal), so every row of its ``o`` is NaN, as in
    ``_v4_kernel``'s one product over the row and in the plain version's
    (checked with ``plain``); v3 stops each 64-row warpgroup at its
    diagonal, so its rows before the last key's tile stay finite and its
    last row is NaN.  Returns {"v3", "v4"(, "plain"): 0.0 if the NaN rows
    are as they must be, else inf}."""
    t = q.shape[-2]
    vp = v.clone()
    vp[..., t - 1, :] = float("nan")
    k0 = (t - 1) // block * block  # the first key of the last key tile
    parts = {}
    with torch.no_grad():
        nan4 = probe.flash_fwd_full_row(q, k, vp, True, block).isnan().any(-1)
        nan3 = probe.flash_fwd_two_pass(q, k, vp, True, block).isnan().any(-1)
        calls["flash_fwd_full_row"] += 1
        calls["flash_fwd_two_pass"] += 1
        parts["v4"] = 0.0 if bool(nan4.all()) else math.inf
        parts["v3"] = 0.0 if bool(nan3[..., t - 1].all()) and not bool(
            nan3[..., :k0].any()) else math.inf
        if plain:
            po = _per_row(lambda x, y, z: kernels.flash_attention_lse_plain(
                x, y, z, True), q, k, vp, heads=True)[0]
            parts["plain"] = 0.0 if bool(po.isnan().any(-1).all()) else \
                math.inf
    return parts


def phase_probe_kernels(torch, kernels, F, rows):
    """The kernels of the P1/P2 race (v2, v3, v4 and b2: in bf16 K1f's
    kernel, the two-pass kernel of ``csrc/flash_probe.cu`` and K1b's pair;
    in f32 the FMA kernels of ``csrc/flash_probe.cu`` and
    ``csrc/flash_probe_bwd.cu``) against their plain versions element by
    element, the bf16 v2 and b2 also against K1f and K1b bit for bit, then
    timed at the race's shapes; then the path that runs them: both races
    (``flexflow_torch.tools.probe_flash_variants`` and
    ``probe_flash_bwd_variants``) at the 2k and 8k shapes, in-process, with
    exact launch counts.  Returns (per-kernel rows, the races' launch
    counts)."""
    from flexflow_torch.ops import probe_kernels as probe
    from flexflow_torch.tools import (probe_flash_bwd_variants,
                                      probe_flash_variants)

    g = torch.Generator(device="cuda").manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16
    blocks = probe.PROBE_BLOCKS
    out = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    # -- element by element against the plain versions --
    calls = {fn.__name__: 0 for fn in probe.PROBE_KERNELS}
    _zero_counts()
    train, long = PROBE_RACE
    cases = [(train, True, bf16), ((2, 8, 1024, 64), False, bf16),
             ((2, 8, 1024, 64), True, f32), ((2, 8, 1024, 128), True, bf16),
             ((1, 4, 256, 128), False, f32), ((1, 8, 80, 64), True, bf16),
             ((1, 8, 1, 64), True, f32), ((1, 2, 130, 128), False, bf16),
             ((1, 2, 200, 64), False, f32), ((1, 2, 200, 128), True, f32)]
    cases += [(shape, causal, bf16) for shape, causal in PROBE_WRAP]
    worst, err_train = 0.0, {}
    for shape, causal, dt in cases:
        q, k, v, do = (randn(shape, dt) for _ in range(4))
        g_lse = randn(shape[:3], f32)
        for block in blocks:
            ratio, errs = _probe_hold(torch, kernels, probe, q, k, v, do,
                                      g_lse, causal, block, "plain", calls)
            worst = max(worst, ratio)
            if shape == train and block == blocks[0]:
                err_train = errs
        if dt == bf16:
            _row_state_bits(torch, kernels, probe, q, k, v, do, g_lse,
                            causal, calls)
        del q, k, v, do, g_lse
    torch.cuda.synchronize()
    print(f"[probe-kernels] {len(cases)} shapes x blocks {blocks} against "
          f"the plain versions (v2, v3, v4: o; b2: dq, dk, dv; causal and "
          f"not, f32 and bf16, hd 64/128, t = 1 to 2048, the ring-wrapping "
          f"{[s for s, _ in PROBE_WRAP]}): worst element {worst:.3g} of its "
          f"tolerance; v3 and v4 bit-identical across two launches; bf16 v2 "
          f"at block 128 K1f's o and b2 at block 64 from K1b's delta K1b's "
          f"dq, dk, dv, bit for bit, at every bf16 shape")
    for shape, plain in ((train, False), (PROBE_WRAP[0][0], True)):
        q, k, v = (randn(shape, bf16) for _ in range(3))
        for block in blocks:
            parts = _probe_poison(torch, kernels, probe, q, k, v, block, calls,
                                  plain)
            _check(max(parts.values()) == 0.0, f"{shape} block {block}, a "
                   f"NaN at the last key: {parts} (v4 must reach every "
                   f"row, v3 stop at the diagonal)")
        del q, k, v
    print(f"[probe-kernels] a NaN at the last key of v, causal: every row of "
          f"v4 NaN, v3's rows before the last key tile finite, at "
          f"{train} and {PROBE_WRAP[0][0]}, blocks {blocks}")
    for name in ("v2", "v3", "v4", "b2 dq", "b2 dkv"):
        attrs = {(hd, blk): probe.probe_attrs(name, hd, blk)
                 for hd in probe.PROBE_HEAD_DIMS for blk in blocks}
        print(f"[probe-kernels] {name} bf16 registers, spill bytes, shared "
              f"memory by (hd, block): {attrs}")
        _check(all(a[1] == 0 for (hd, _), a in attrs.items() if hd == 64),
               f"{name} bf16 spills at the race's head dim 64: {attrs}")
    q, k, v, do = (randn(long, bf16) for _ in range(4))
    g_lse = randn(long[:3], f32)
    _row_state_bits(torch, kernels, probe, q, k, v, do, g_lse, True, calls)
    for block in blocks:
        r_plain, _ = _probe_hold(torch, kernels, probe, q, k, v, do, g_lse,
                                 True, block, "plain", calls)
        r_k1, _ = _probe_hold(torch, kernels, probe, q, k, v, do, g_lse, True,
                              block, "k1", calls)
        print(f"[probe-kernels] {long} bf16 causal block {block}: worst "
              f"element {r_plain:.3g} (plain, row by row), {r_k1:.3g} "
              f"(K1f/K1b, twice the tolerance) of its tolerance")
    del q, k, v, do, g_lse
    torch.cuda.synchronize()
    got = _counts()
    _check(all(got[n] == c > 0 for n, c in calls.items()),
           f"race kernel launches {got} against the calls made {calls}")

    # -- device times at the race's shapes --
    for shape in PROBE_RACE:
        b, h, t, hd = shape
        q, k, v, do = (randn(shape, bf16) for _ in range(4))
        with torch.no_grad():
            o, lse = kernels.flash_attention_lse(q, k, v, True)
        delta = (o.float() * do.float()).sum(dim=-1)
        full = t <= 2048  # the plain versions' f32 t x t temporaries fit
        pairs = t * (t + 1) // 2
        # The causal function's work (v3 computes 1.5x its products, v4
        # 3x): q, k, v read and o written; q, k, v, do, lse, delta read
        # and dq, dk, dv written.
        fb, fby = _bound_ms(4 * b * h * t * hd * 2, 4 * b * h * hd * pairs,
                            "bfloat16")
        bb, bby = _bound_ms(7 * b * h * t * hd * 2 + 2 * b * h * t * 4,
                            10 * b * h * hd * pairs, "bfloat16")
        plain_f = lambda *x: probe.flash_fwd_row_state_plain(*x, True)
        plain_b = lambda *x: probe.flash_bwd_row_state_plain(*x, True)
        with torch.no_grad():
            pf = _device_ms(lambda: plain_f(q, k, v) if full else _per_row(
                lambda *x: (plain_f(*x),), q, k, v), 5)
            lf = _device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
        pb = _device_ms(lambda: plain_b(q, k, v, do, lse, delta) if full
                        else _per_row(plain_b, q, k, v, do, lse, delta), 5)
        qs, ks, vs = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        sd = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lb = _device_ms(lambda: torch.autograd.grad(sd, (qs, ks, vs), do,
                                                    retain_graph=True))
        del qs, ks, vs, sd
        leg = "train" if shape == train else "longctx"
        for fn in probe.PROBE_KERNELS:
            bwd = fn is probe.flash_bwd_row_state
            with torch.no_grad():
                ms = {block: _device_ms(
                    (lambda: fn(q, k, v, do, lse, delta, True, block)) if bwd
                    else (lambda: fn(q, k, v, True, block)))
                    for block in blocks}
            bound, by = (bb, bby) if bwd else (fb, fby)
            plain, lib = (pb, lb) if bwd else (pf, lf)
            extra = {}
            if fn.__name__ in ("flash_fwd_two_pass", "flash_fwd_full_row"):
                extra["bound_done_ms"], _ = _bound_ms(
                    4 * b * h * t * hd * 2,
                    race_products(fn.__name__, t) * 4 * b * h * hd * pairs,
                    "bfloat16")
            print(f"[probe-kernels] {fn.__name__} {shape} bf16 causal: "
                  + ", ".join(f"block {blk} {m:.6f} ms" for blk, m in
                              ms.items())
                  + f" ({min(ms.values()) / bound:.1f}x its bound {bound:.6f} "
                  f"by {by}"
                  + (f", {min(ms.values()) / extra['bound_done_ms']:.2f}x the "
                     f"bound {extra['bound_done_ms']:.6f} of the products it "
                     f"does" if extra else "")
                  + f"; plain {plain:.6f}"
                  f"{'' if full else ', one batch row at a time'}; sdpa "
                  f"{'backward' if bwd else 'forward'} {lib:.6f})")
            row = dict(ms=ms[blocks[0]], ms_by_block=ms, plain_ms=plain,
                       bound_ms=bound, bound_by=by, library_ms=lib, **extra)
            if leg == "train":
                out[fn.__name__] = dict(max_abs_err=err_train[fn.__name__],
                                        **row)
            else:
                out[fn.__name__]["longctx_shape"] = row
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()

    # -- the path: both races at the 2k and 8k shapes --
    _zero_counts()
    race = []
    for shape in PROBE_RACE:
        argv = [str(x) for x in shape]
        for tool in (probe_flash_variants, probe_flash_bwd_variants):
            _check(tool.main(argv, rows_out=race) == 0,
                   f"{tool.__name__} {argv} failed")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = _counts()
    want = {n: 0 for n in launches}
    for r in race:
        if RACE_WRAPPERS[r["name"]] is not None:
            want[RACE_WRAPPERS[r["name"]]] += r["calls"]
    # The backward race's K1f forward, for o and lse, once per run.
    want["flash_attention_lse"] += len(PROBE_RACE)
    _check(launches == want and all(
        launches[fn.__name__] > 0 for fn in probe.PROBE_KERNELS),
        f"race launch counts {launches}, expected {want}")
    for r in race:
        _check(r["unsupported"] is None and r["ms"] is not None
               and math.isfinite(r["ms"]) and r["ms"] > 0
               and r["err"] <= TOL_RACE * r["scale"],
               f"race row {r}: no finite positive time, or its error beyond "
               f"{TOL_RACE} of {r['scale']}")
    # The race's timer against the kernel table's (_device_ms, phase 12).
    table = {(train, "v1_base"): rows[f"stream@{train}"]["K1f"],
             (train, "v6_stream"): rows[f"stream@{train}"]["K1s"],
             (train, "b1_prod"): rows[f"stream@{train}"]["K1b"],
             (train, "b3_stream"): rows[f"stream@{train}"]["K1sb"],
             (long, "v1_base"): rows["flash_attention_lse@8k"]["ms"],
             (long, "v6_stream"): rows["flash_attention_lse_streamed"]["ms"],
             (long, "b1_prod"): rows["flash_attention_lse_bwd@8k"]["ms"],
             (long, "b3_stream"):
                 rows["flash_attention_lse_streamed_bwd"]["ms"]}
    pairs = [(r, table[r["shape"], r["name"]]) for r in race
             if (r["shape"], r["name"]) in table]
    print("[probe-kernels] race slope / phase 12 device time: " + ", ".join(
        f"{r['name']} {r['shape']} {r['ms']:.4f} / {ms:.4f} = "
        f"{r['ms'] / ms:.3f}" for r, ms in pairs))
    print(f"[probe-kernels] races at {PROBE_RACE}: {len(race)} rows, every "
          f"error within {TOL_RACE} of its slice; launches {launches}")
    return out, launches


#: The AlexNet configuration of phases 16-18: bench.py's AlexNet leg
#: (``bench.py:180-202``: batch 2048, 229 x 229 x 3 NHWC, 1000 classes,
#: bf16, SGD lr 0.01 momentum 0.9 wd 1e-4, 3 warmup + 20 timed steps)
#: through the port's bench entry, ``flexflow_torch.bench.bench_alexnet``.
ALEXNET = dict(batch=2048, image=229, classes=1000, iters=20, warmup=3)
#: Phase 18's f32 step: the full widths at image 67 (flat 256), batch 8,
#: 1000 classes, held as phase 6's step is (``TOL_TRAIN_LOSS``,
#: ``TOL_TRAIN_GRAD``); the updated params within ``lr`` times the
#: gradient bound plus two f32 ulps of the tensor's largest value.
ALEXNET_PARITY = dict(batch=8, image=67, classes=1000, seed=0)
SGD_ALEXNET = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)


def phase_alexnet_kernels(torch, kernels, F):
    """K3 at AlexNet's loss shape, (2048, 1000) bf16, against its plain
    version (labels over every class, planted argmax ties), timed by
    ``_device_ms`` and by chain slope beside the bound and
    ``F.cross_entropy``.  Returns the rows of both K3 kernels at this
    shape."""
    g = torch.Generator(device="cuda").manual_seed(16)
    n, v = ALEXNET["batch"], ALEXNET["classes"]
    x = 3.0 * torch.randn((n, v), generator=g, device="cuda")
    labels = torch.randint(0, v, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    labels[:3] = torch.tensor([0, v - 1, 8], device="cuda", dtype=torch.int32)
    # Equal maxima inside one 8-element chunk, across chunks, at the
    # row's two ends and three in a row.
    top = x.max() + 1.0
    for r, cols in enumerate(((3, 5), (7, 8), (v - 1, 0), (100, 7, v - 2))):
        x[r, list(cols)] = top
    x = x.to(torch.bfloat16)
    nll, lse, pred = kernels.softmax_xent(x, labels)
    gn = torch.full((n,), 1.0 / n, device="cuda")
    gl = torch.randn((n,), generator=g, device="cuda")
    d = kernels.softmax_xent_bwd(x, labels, lse, gn, gl)
    pn, pl, pp = kernels.softmax_xent_plain(x, labels)
    pd = kernels.softmax_xent_bwd_plain(x, labels, lse, gn, gl)
    torch.cuda.synchronize()
    e_nll = (nll - pn).abs().max().item()
    e_lse = (lse - pl).abs().max().item()
    e_d = _xent_bwd_close(d, pd, labels, gn, TOL_XENT_BWD["bfloat16"])
    miss = int((pred != pp).sum().item())
    _check(e_nll <= TOL_XENT and e_lse <= TOL_XENT and e_d <= 1.0
           and miss == 0,
           f"softmax_xent ({n}, {v}) bf16: nll err {e_nll}, lse err {e_lse}, "
           f"dlogits error {e_d} of the element tolerance, {miss} pred "
           f"mismatches")
    _check([int(pred[r]) for r in range(4)] == [3, 7, 0, 7],
           f"softmax_xent ties: pred {pred[:4].tolist()}")
    print(f"[alexnet-kernels] softmax_xent ({n}, {v}) bf16 with planted "
          f"ties: nll err {e_nll:.3g} lse err {e_lse:.3g}, dlogits worst "
          f"element {e_d:.3g} of its tolerance, pred exact")
    lab64 = labels.long()
    xr = x.detach().clone().requires_grad_(True)
    ce = F.cross_entropy(xr, lab64, reduction="none")
    gce = gn.to(ce.dtype)
    fns = {
        "fwd": (lambda: kernels.softmax_xent(x, labels),
                lambda: kernels.softmax_xent_plain(x, labels),
                lambda: F.cross_entropy(x, lab64, reduction="none")),
        "bwd": (lambda: kernels.softmax_xent_bwd(x, labels, lse, gn, gl),
                lambda: kernels.softmax_xent_bwd_plain(x, labels, lse, gn, gl),
                lambda: torch.autograd.grad(ce, xr, gce, retain_graph=True)),
    }
    # Logits read (and, backward, dlogits written) once, the rows'
    # scalars moved; about four f32 operations per logit.
    bounds = {"fwd": _bound_ms(n * v * 2 + 16 * n, 4 * n * v, "float32"),
              "bwd": _bound_ms(2 * n * v * 2 + 16 * n, 4 * n * v, "float32")}
    errs = {"fwd": max(e_nll, e_lse),
            "bwd": (d.float() - pd.float()).abs().max().item()}
    floor = _chain_ms(lambda i: torch.cuda._sleep(0))
    rows = {}
    for part, (kern, plain, lib) in fns.items():
        ms, lib_ms = _pair_ms(kern, lib)
        chain = _chain_ms(lambda i: kern())
        lib_chain = _chain_ms(lambda i: lib())
        plain_ms = _device_ms(plain)
        bound, by = bounds[part]
        name = "softmax_xent" if part == "fwd" else "softmax_xent_bwd"
        print(f"[alexnet-kernels] {name} ({n}, {v}) bf16: one launch "
              f"{ms:.6f} ms, chain slope {chain:.6f} (plain {plain_ms:.6f}; "
              f"F.cross_entropy{' backward' if part == 'bwd' else ''} "
              f"{lib_ms:.6f}, slope {lib_chain:.6f}; bound {bound:.6f} by "
              f"{by}; launch floor {floor:.6f})")
        rows[f"{name}@alexnet"] = dict(
            max_abs_err=errs[part], ms=ms, chain_ms=chain, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms,
            library_chain_ms=lib_chain, launch_floor_ms=floor)
    return rows


def phase_alexnet_train(torch, kernels):
    """bench.py's AlexNet leg through the port's bench entry at its full
    shape; returns the launch counts of this run."""
    from flexflow_torch import bench
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.search.cost_model import train_flops

    c = ALEXNET
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_counts()
    sps, mfu, batch = bench.bench_alexnet(
        device="cuda", batch_size=c["batch"], image_size=c["image"],
        num_classes=c["classes"], iters=c["iters"], warmup=c["warmup"],
        stats_out=stats)
    torch.cuda.synchronize()
    launches = _counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    losses = stats["step_losses"]
    steps = c["warmup"] + c["iters"]
    _check(batch == c["batch"] and len(losses) == steps
           and all(math.isfinite(x) for x in losses),
           f"alexnet step losses {losses}")
    want = {n: 0 for n in launches}
    want.update(softmax_xent=steps, softmax_xent_bwd=steps)
    _check(launches == want, f"alexnet launch counts {launches}, expected "
           f"{want}")
    ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
    flops = train_flops(build_alexnet(batch_size=c["batch"],
                                      image_size=c["image"],
                                      num_classes=c["classes"]))
    print(f"[alexnet-train] losses {[round(x, 5) for x in losses]}; "
          f"{ms_step:.3f} ms/step, images/s {sps:.1f}, MFU "
          f"{100 * mfu:.2f}% of 989 TFLOP/s ({flops:.5g} FLOP/step); peak "
          f"memory {peak_gb:.2f} GB; launches {launches}")
    return launches


#: Kernel-name groups of phase 17's profile, first match wins (the pools'
#: kernels name their layout, ``nhwc``, as cuDNN's do).
ALEXNET_GROUPS = (
    ("K3", ("xent",)),
    ("pool", ("pool",)),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad",
                      "winograd", "fft", "nhwc", "nchw")),
    ("GEMM (cuBLAS)", ("gemm", "cublas", "cutlass", "nvjet", "splitk")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise, reductions", ("",)),
)


def phase_alexnet_profile(torch):
    """One warm step of phase 17's model under torch.profiler: the busy
    share, time by kernel and by kernel group; the optimizer's share by
    CUDA events around ``optimizer.update``.  (conv1's layouts and the
    step with cuDNN's plans timed or not are
    ``flexflow_torch/tools/alexnet_conv.py``'s.)"""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    c = ALEXNET
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="bfloat16")
    ff = build_alexnet(batch_size=c["batch"], image_size=c["image"],
                       num_classes=c["classes"], config=cfg)
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(**SGD_ALEXNET),
                  device="cuda")
    state = list(ex.init())
    batch = Trainer(ex).synthetic_batch()

    def step():
        state[:3] = ex.train_step(*state, batch)[:3]

    for _ in range(3):
        step()
    groups = {name: 0.0 for name, _ in ALEXNET_GROUPS}
    for us, key, _ in _profile_step(torch, "alexnet-profile", step):
        name = next(n for n, subs in ALEXNET_GROUPS
                    if any(s in key.lower() for s in subs))
        groups[name] += us / 1e3
    busy = sum(groups.values())
    print("[alexnet-profile] device ms by kernel group: " + ", ".join(
        f"{n} {ms:.3f} ({100 * ms / busy:.1f}%)" for n, ms in groups.items()))

    # The optimizer's device time: events around optimizer.update on one
    # warm step, with the host enqueueing ahead behind a spin.
    params, opt_state, st = state
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    _, _, _, grads = ex.loss_and_grads(params, st, batch)
    ev[1].record()
    params, opt_state = ex.optimizer.update(params, opt_state, grads)
    ev[2].record()
    ev[2].synchronize()
    state[:2] = params, opt_state
    fb, upd = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    print(f"[alexnet-profile] forward+backward {fb:.3f} ms, SGD update "
          f"{upd:.3f} ms (CUDA events); the profile's busy {busy:.3f} ms is "
          f"{100 * busy / (fb + upd):.1f}% of their sum")


class _CardBranches:
    """AlexNet's kinks taken the card's way on the CPU: each ReLU's mask
    and each max pool's choice of window element, recorded in call order
    on the card's step (``replay`` False) and taken by the CPU's step
    (``replay`` True).  An input within rounding of a kink (a ReLU input
    at zero, two maxima of a pool window) may take the other branch on
    the card, and the two gradients then differ by that branch's whole
    term, not by rounding: one ReLU input of linear2 did so at phase 18's
    step with cuDNN's plans timed and untimed alike, while every
    convolution kept within a few f32 epsilons of its absolute terms
    (``python3 -m flexflow_torch.tools.alexnet_conv plans``).  Each place
    where the CPU's own branch differs must be a kink to within ``rtol``
    of its tensor's largest magnitude; ``moved`` counts them."""

    def __init__(self, torch, rtol: float):
        import flexflow_torch.ops.conv as conv
        import flexflow_torch.ops.linear as linear

        self.torch, self.rtol, self.replay = torch, rtol, False
        self.conv, self.linear = conv, linear
        self.act, self.F = conv.apply_activation, conv.F
        self.log, self.at, self.moved = [], 0, {"relu": 0, "pool": 0}

    def __enter__(self):
        owner = self

        class _F:
            """``torch.nn.functional`` with ``max_pool2d`` through the
            log."""

            def __getattr__(self, name):
                return getattr(owner.F, name)

            def max_pool2d(self, x, kernel, stride):
                return owner._pool(x, kernel, stride)

        self.at = 0
        self.conv.apply_activation = self.linear.apply_activation = self._act
        self.conv.F = _F()
        return self

    def __exit__(self, *exc):
        self.conv.apply_activation = self.linear.apply_activation = self.act
        self.conv.F = self.F
        _check(exc[0] is not None or not self.replay
               or self.at == len(self.log),
               f"the CPU's step took {self.at} of the card's {len(self.log)} "
               f"branch records")

    def _next(self, own, what: str):
        if not self.replay:
            self.log.append((what, own.cpu()))
            return None
        kind, card = self.log[self.at]
        self.at += 1
        _check(kind == what and card.shape == own.shape,
               f"branch record {self.at}: the card's {kind} {card.shape}, "
               f"the CPU's {what} {own.shape}")
        return card

    def _act(self, y, activation):
        if activation != "relu":
            return self.act(y, activation)
        own = y.detach() > 0
        card = self._next(own, "relu")
        if card is None:
            return self.act(y, activation)
        diff = own != card
        if diff.any():
            a = y.detach().abs()
            _check(a[diff].max() <= self.rtol * a.max(),
                   f"a ReLU input {a[diff].max().item()} away from zero "
                   f"took the other branch on the card")
            self.moved["relu"] += int(diff.sum())
        return self.torch.where(card, y, self.torch.zeros((), dtype=y.dtype))

    def _pool(self, x, kernel, stride):
        y, idx = self.F.max_pool2d(x, kernel, stride, return_indices=True)
        card = self._next(idx, "pool")
        if card is None:
            return y
        picked = x.flatten(2).gather(2, card.flatten(2)).view_as(y)
        gap = (y - picked).detach()
        if (idx != card).any():
            _check(gap.max() <= self.rtol * x.detach().abs().max(),
                   f"a max-pool window whose maxima are {gap.max().item()} "
                   f"apart took the other element on the card")
            self.moved["pool"] += int((gap > 0).sum())
        return picked


def phase_alexnet_parity(torch, kernels):
    """One f32 SGD step of AlexNet at image 67 on the card (cuDNN, cuBLAS,
    K3; TF32 off) and on the CPU (plain versions) from the same params
    and batch, the CPU taking the card's branch at every kink
    (``_CardBranches``)."""
    import numpy as np

    from flexflow_torch.config import FFConfig
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor

    c = ALEXNET_PARITY
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="float32",
                   seed=c["seed"])
    ff = build_alexnet(batch_size=c["batch"], image_size=c["image"],
                       num_classes=c["classes"], config=cfg)
    params0 = Executor(ff, cfg, device="cpu").init_params()
    batch = synthetic_host_batch(ff, np.random.default_rng(c["seed"]),
                                 {"label": c["classes"]})
    out = {}
    branches = _CardBranches(torch, TOL_TRAIN_GRAD[0])
    for dev in ("cuda", "cpu"):
        ex = Executor(ff, cfg, optimizer=SGDOptimizer(**SGD_ALEXNET),
                      device=dev)
        params = {op: {k: p.detach().clone().to(ex.device)
                       for k, p in g.items()}
                  for op, g in params0.items()}
        _zero_counts()
        branches.replay = dev == "cpu"
        with branches:
            loss, _, _, grads = ex.loss_and_grads(params, {}, batch)
        grads_cpu = {op: {k: v.detach().cpu() for k, v in g.items()}
                     for op, g in grads.items()}
        ex.optimizer.update(params, ex.optimizer.init(params), grads)
        if dev == "cuda":
            torch.cuda.synchronize()
            n = _counts()
            _check(n["softmax_xent"] == n["softmax_xent_bwd"] == 1,
                   f"the f32 AlexNet step launched K3 {n['softmax_xent']} / "
                   f"{n['softmax_xent_bwd']} times")
        out[dev] = (float(loss), grads_cpu,
                    {op: {k: v.detach().cpu() for k, v in g.items()}
                     for op, g in params.items()})
    (lc, gc, pc), (lp, gp, pp) = out["cuda"], out["cpu"]
    _check(abs(lc - lp) <= TOL_TRAIN_LOSS,
           f"f32 AlexNet step loss: card {lc}, CPU {lp}")
    rtol, atol = TOL_TRAIN_GRAD
    lr = SGD_ALEXNET["lr"]
    worst_g = worst_p = 0.0
    for op in gp:
        for k in gp[op]:
            want, got = gp[op][k], gc[op][k]
            scale = want.abs().max().item()
            tol = rtol * scale + atol
            err = (got - want).abs().max().item()
            _check(err <= tol, f"f32 AlexNet grad {op}.{k}: err {err} at "
                   f"scale {scale}")
            worst_g = max(worst_g, err / tol)
            ulp = 2 * float(np.spacing(np.float32(pp[op][k].abs().max())))
            d = (pc[op][k] - pp[op][k]).abs().max().item()
            _check(d <= lr * tol + ulp, f"f32 AlexNet updated {op}.{k}: err "
                   f"{d}, bound {lr * tol + ulp}")
            worst_p = max(worst_p, d / (lr * tol + ulp))
    print(f"[alexnet-parity] f32 SGD step card vs CPU: loss {lc:.7f} vs "
          f"{lp:.7f}; worst grad err {worst_g:.3g} of its tolerance, worst "
          f"updated-param err {worst_p:.3g} of its tolerance; cuDNN's plans "
          f"{'timed' if torch.backends.cudnn.benchmark else 'untimed'}; "
          f"the CPU took the card's branch where its own differed at "
          f"{branches.moved['relu']} ReLU inputs and "
          f"{branches.moved['pool']} pool windows, each within "
          f"{TOL_TRAIN_GRAD[0]:g} of its tensor's largest magnitude of a "
          f"kink")


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
    t = [time.perf_counter()]
    rows = phase_kernels(torch, kernels, F)
    t.append(time.perf_counter())
    rows.update(phase_train_kernels(torch, kernels, F))
    t.append(time.perf_counter())
    serve_launches = phase_serve(torch, kernels)
    t.append(time.perf_counter())
    phase_parity(torch)
    t.append(time.perf_counter())
    train_launches = phase_train(torch, kernels, rows)
    t.append(time.perf_counter())
    phase_train_parity(torch, kernels)
    t.append(time.perf_counter())
    phase_profile(torch)
    t.append(time.perf_counter())
    rows.update(phase_dlrm_kernels(torch, kernels, F))
    t.append(time.perf_counter())
    dlrm_launches, dlrm_params = phase_dlrm_train(torch, kernels)
    t.append(time.perf_counter())
    phase_dlrm_parity(torch, kernels)
    t.append(time.perf_counter())
    phase_dlrm_profile(torch, dlrm_params)
    del dlrm_params
    t.append(time.perf_counter())
    rows.update(phase_stream_kernels(torch, kernels, F))
    t.append(time.perf_counter())
    longctx_launches = phase_longctx_train(torch, kernels, rows)
    t.append(time.perf_counter())
    phase_train_parity(torch, kernels, streamed=True)
    t.append(time.perf_counter())
    probe_rows, probe_launches = phase_probe_kernels(torch, kernels, F, rows)
    rows.update(probe_rows)
    t.append(time.perf_counter())
    rows.update(phase_alexnet_kernels(torch, kernels, F))
    t.append(time.perf_counter())
    alexnet_launches = phase_alexnet_train(torch, kernels)
    phase_alexnet_profile(torch)
    t.append(time.perf_counter())
    phase_alexnet_parity(torch, kernels)
    t.append(time.perf_counter())
    names = ("kernels", "train-kernels", "serve", "parity", "train",
             "train-parity", "profile", "dlrm-kernels", "dlrm-train",
             "dlrm-parity", "dlrm-profile", "stream-kernels", "longctx-train",
             "longctx-parity", "probe-kernels", "alexnet-kernels",
             "alexnet-train", "alexnet-parity")
    print("[phases] " + ", ".join(f"{n} {b - a:.1f}s"
                                  for n, a, b in zip(names, t, t[1:])))

    src, pk = "flexflow_torch/csrc/", "flexflow_tpu/ops/pallas_kernels.py"
    meta = {
        "flash_attention_lse": (src + "flash_fwd.cu", pk + ":147"),
        "flash_decode": (src + "flash_decode.cu", pk + ":1085"),
        "flash_attention_lse_bwd": (src + "flash_bwd.cu", pk + ":719"),
        "softmax_xent": (src + "softmax_xent.cu", pk + ":1187"),
        "softmax_xent_bwd": (src + "softmax_xent.cu", pk + ":1227"),
        "gather_rows": (src + "embedding_rows.cu", pk + ":1379"),
        "gather_rows_multi": (src + "embedding_rows.cu", pk + ":1379"),
        "scatter_add_rows": (src + "embedding_rows.cu", pk + ":1412"),
        "flash_attention_lse_streamed": (src + "flash_fwd.cu", pk + ":361"),
        "flash_attention_lse_streamed_bwd": (src + "flash_bwd.cu",
                                             pk + ":664"),
        "flash_fwd_row_state": (src + "flash_fwd.cu",
                                "tools/probe_flash_variants.py:46"),
        "flash_fwd_two_pass": (src + "flash_probe.cu",
                               "tools/probe_flash_variants.py:103"),
        "flash_fwd_full_row": (src + "flash_probe.cu",
                               "tools/probe_flash_variants.py:174"),
        "flash_bwd_row_state": (src + "flash_bwd.cu",
                                "tools/probe_flash_bwd_variants.py:155"),
    }
    entries = []
    for name, (source, replaces) in meta.items():
        by_path = {"serve": serve_launches[name],
                   "train": train_launches[name],
                   **{f"dlrm_{run}": counts[name]
                      for run, counts in dlrm_launches.items()},
                   **{leg: counts[name]
                      for leg, counts in longctx_launches.items()},
                   "probe": probe_launches[name],
                   "alexnet": alexnet_launches[name]}
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=sum(by_path.values()),
                     launches_by_path=by_path, **rows[name])
        if name == "flash_attention_lse":
            entry["train_shape"] = rows["flash_attention_lse@train"]
            entry["longctx_shape"] = rows["flash_attention_lse@8k"]
            entry["longctx_32k_shape"] = rows["flash_attention_lse@32k"]
        if name == "flash_attention_lse_bwd":
            entry["longctx_shape"] = rows["flash_attention_lse_bwd@8k"]
            entry["longctx_32k_shape"] = rows["flash_attention_lse_bwd@32k"]
        if name == "flash_attention_lse_streamed":
            entry["f32_source"] = src + "flash_stream.cu"
            entry["longctx_32k_shape"] = rows["flash_attention_lse_streamed@32k"]
        if name in ("softmax_xent", "softmax_xent_bwd"):
            entry["alexnet_shape"] = rows[f"{name}@alexnet"]
        if name == "flash_decode":
            entry["long_cache_shape"] = rows[
                f"flash_decode@{DECODE_TIMED[1]}"]
        if name == "flash_attention_lse_streamed_bwd":
            entry["f32_source"] = src + "flash_stream.cu"
            entry["longctx_32k_shape"] = rows[
                "flash_attention_lse_streamed_bwd@32k"]
        if name in ("flash_fwd_two_pass", "flash_fwd_full_row"):
            entry["bf16_kernel"] = ("wg_two_pass_kernel: wgmma from TMA-fed "
                                    "shared memory (csrc/wgmma_tile.cuh, "
                                    "csrc/flash_wg.cuh)")
            entry["f32_kernel"] = "two_pass_kernel: FMA (csrc/mma_tile.cuh)"
        if name == "flash_fwd_row_state":
            entry["f32_source"] = src + "flash_probe.cu"
            entry["bf16_kernel"] = ("wg_fwd_kernel, K1f's, at the race's key "
                                    "tile without the lse: wgmma from "
                                    "TMA-fed shared memory "
                                    "(csrc/wgmma_tile.cuh, csrc/flash_wg.cuh)")
            entry["f32_kernel"] = "row_state_kernel: FMA (csrc/mma_tile.cuh)"
        if name == "flash_bwd_row_state":
            entry["f32_source"] = src + "flash_probe_bwd.cu"
            entry["bf16_kernel"] = ("wg_dq_kernel (the caller's delta) and "
                                    "wg_dkv_kernel, K1b's pair: wgmma from "
                                    "TMA-fed shared memory "
                                    "(csrc/wgmma_tile.cuh)")
            entry["f32_kernel"] = ("row_state_dq_kernel, row_state_dkv_kernel:"
                                   " FMA (csrc/mma_tile.cuh)")
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
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
