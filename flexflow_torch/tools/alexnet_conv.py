"""AlexNet's convolutions on the card: conv1's layouts, the step with
``torch.backends.cudnn.benchmark`` on and off, and the exactness of the
plans cuDNN picks in f32.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 -m flexflow_torch.tools.alexnet_conv             # all three
    python3 -m flexflow_torch.tools.alexnet_conv layouts
    python3 -m flexflow_torch.tools.alexnet_conv on-off
    python3 -m flexflow_torch.tools.alexnet_conv plans --benchmark 0

- ``layouts``: conv1 (Cin = 3) of ``chip_smoke.ALEXNET``'s step alone,
  forward and weight gradient, as the op lays it out (channels-last), as
  NCHW-contiguous tensors, and with the input channels zero-padded to 8.
- ``on-off``: ms per step of that AlexNet with the flag on and off, a
  process each, in turns (on, off, off, on).  cuDNN keeps the plan it
  picks at a shape's first call for the life of the process, whatever
  the flag says later, so the two settings never share a process.
- ``plans``: ``chip_smoke.ALEXNET_PARITY``'s f32 step (TF32 off) with
  the flag as given, in a process of its own: each convolution's
  forward, data gradient, weight gradient and bias gradient on the card
  from the float64 reference's own inputs, with the device kernels it
  ran, and its worst error in f32 epsilons of the element's absolute
  terms (the same sum with every term made non-negative); then the whole
  step's parameter gradients on the card and on the CPU in f32 against
  float64, in the same unit, and the ReLU inputs whose sign differs from
  the reference's.  A plain f32 sum of ``n`` terms errs by at most about
  ``n`` epsilons of its absolute terms, and by about ``sqrt(n)`` in
  practice; TF32 (10-bit mantissa) would show some 8000.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

#: (name, kernel, stride, padding) of AlexNet's convolutions, each with a
#: fused ReLU; a max pool (3, stride 2) follows conv1, conv2 and conv5.
CONVS = (("conv1", 11, 4, 2), ("conv2", 5, 1, 2), ("conv3", 3, 1, 1),
         ("conv4", 3, 1, 1), ("conv5", 3, 1, 1))
POOLED = ("conv1", "conv2", "conv5")
EPS32 = 2.0 ** -23


def _alexnet_executor(c, dtype: str, device: str, seed: int = 0):
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor

    import chip_smoke

    cfg = FFConfig(batch_size=c["batch"], compute_dtype=dtype, seed=seed)
    ff = build_alexnet(batch_size=c["batch"], image_size=c["image"],
                       num_classes=c["classes"], config=cfg)
    return ff, Executor(ff, cfg, optimizer=SGDOptimizer(
        **chip_smoke.SGD_ALEXNET), device=device)


def layouts() -> None:
    import chip_smoke

    c = chip_smoke.ALEXNET
    _, ex = _alexnet_executor(c, "bfloat16", "cuda")
    w = ex.init_params()["conv1"]["kernel"].detach()
    g = torch.Generator(device="cuda").manual_seed(17)
    img = torch.randn((c["batch"], c["image"], c["image"], 3), generator=g,
                      device="cuda").to(torch.bfloat16)
    dy = torch.randn((c["batch"], 64, 56, 56), generator=g,
                     device="cuda").to(torch.bfloat16)
    dy_cl = dy.contiguous(memory_format=torch.channels_last)
    forms = {
        "channels-last": (img.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                          dy_cl),
        "NCHW": (img.permute(0, 3, 1, 2).contiguous(),
                 w.permute(3, 2, 0, 1).contiguous(), dy),
        "Cin 8": (F.pad(img, (0, 5)).permute(0, 3, 1, 2),
                  F.pad(w, (0, 0, 0, 5)).permute(3, 2, 0, 1), dy_cl),
    }
    out = []
    for name, (xx, ww, gy) in forms.items():
        f_ms = chip_smoke._device_ms(
            lambda: F.conv2d(xx, ww, stride=4, padding=2), reps=5)
        w_ms = chip_smoke._device_ms(
            lambda: torch.ops.aten.convolution_backward(
                gy, xx, ww, None, (4, 4), (2, 2), (1, 1), False, (0, 0), 1,
                (False, True, False)), reps=5)
        out.append(f"{name} forward {f_ms:.3f} / weight grad {w_ms:.3f}")
    print(f"[layouts] conv1 alone at batch {c['batch']}, bf16, "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark} (ms): "
          + "; ".join(out))


def step_ms(benchmark: bool, warmup: int = 3, steps: int = 5) -> float:
    """ms per step of ``chip_smoke.ALEXNET``'s bf16 step in this process,
    with ``torch.backends.cudnn.benchmark`` set before the first step."""
    import chip_smoke
    from flexflow_torch.runtime.trainer import Trainer

    torch.backends.cudnn.benchmark = benchmark
    _, ex = _alexnet_executor(chip_smoke.ALEXNET, "bfloat16", "cuda")
    state = list(ex.init())
    batch = Trainer(ex).synthetic_batch()
    for _ in range(warmup):
        state[:3] = ex.train_step(*state, batch)[:3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state[:3] = ex.train_step(*state, batch)[:3]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _child(args) -> str:
    return subprocess.run(
        [sys.executable, "-m", "flexflow_torch.tools.alexnet_conv", *args],
        cwd=os.getcwd(), capture_output=True, text=True, check=True,
        timeout=900).stdout


def on_off() -> None:
    times = {True: [], False: []}
    for on in (True, False, False, True):
        out = _child(["step-ms", "--benchmark", str(int(on))])
        times[on].append(float(out.split()[-1]))
    print(f"[on-off] ms/step with cudnn.benchmark on {times[True]}, off "
          f"{times[False]} (a process each, in turns: on, off, off, on)")


def _forward(params, image, labels, keep=None):
    """AlexNet's forward and mean cross-entropy in plain ops, at the
    tensors' dtype and device, with the convolutions laid out as
    ``ops/conv.py`` lays them out (channels-last views).  ``keep``
    receives each convolution's input and pre-activation output (NCHW
    views) and each ReLU's input."""
    keep = {} if keep is None else keep
    x = image.permute(0, 3, 1, 2)
    for name, _, s, p in CONVS:
        w, b = params[name]["kernel"], params[name]["bias"]
        y = F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=s, padding=p)
        if y.requires_grad:
            y.retain_grad()
        keep[name] = (x, y)
        x = torch.relu(y)
        if name in POOLED:
            x = F.max_pool2d(x, 3, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for name in ("linear1", "linear2", "linear3"):
        x = x @ params[name]["kernel"].T + params[name]["bias"]
        keep[name] = x
        if name != "linear3":
            x = torch.relu(x)
    return F.cross_entropy(x, labels.long())


def _step(params, image, labels, device, dtype):
    p = {op: {k: v.detach().to(device, dtype).requires_grad_(True)
              for k, v in g.items()} for op, g in params.items()}
    keep = {}
    loss = _forward(p, image.to(device, dtype), labels.to(device), keep)
    loss.backward()
    grads = {op: {k: v.grad.detach().cpu().double() for k, v in g.items()}
             for op, g in p.items()}
    return float(loss.detach()), grads, keep


def _names(fn) -> list:
    """The device kernels ``fn()`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def _eps_of_abs(got, want, absterm) -> float:
    """Worst ``|got - want|`` in f32 epsilons of the element's absolute
    terms (elements whose terms are all zero must match exactly)."""
    err = (got.double().cpu() - want).abs()
    return float((err / (absterm * EPS32).clamp_min(1e-300)).max())


def plans(benchmark: bool) -> None:
    import chip_smoke
    from flexflow_torch.data.loader import synthetic_host_batch

    torch.backends.cudnn.benchmark = benchmark
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = chip_smoke.ALEXNET_PARITY
    ff, cpu_ex = _alexnet_executor(c, "float32", "cpu", seed=c["seed"])
    params = cpu_ex.init_params()
    batch = synthetic_host_batch(ff, np.random.default_rng(c["seed"]),
                                 {"label": c["classes"]})
    image = torch.from_numpy(batch["image"])
    labels = torch.from_numpy(batch["label"])
    tag = f"[plans benchmark={int(benchmark)}]"

    # The float64 reference, and each convolution from its inputs.
    l64, g64, k64 = _step(params, image, labels, "cpu", torch.float64)
    for name, _, s, p in CONVS:
        x, y = k64[name]
        x, dy = x.detach(), y.grad.detach()
        w = params[name]["kernel"].double().permute(3, 2, 0, 1)
        b = params[name]["bias"].double()
        args = ((s, s), (p, p), (1, 1), False, (0, 0), 1, (True, True, True))
        ref = (F.conv2d(x, w, b, stride=s, padding=p),
               *torch.ops.aten.convolution_backward(dy, x, w, [w.shape[0]],
                                                    *args))
        fa = F.conv2d(x.abs(), w.abs(), b.abs(), stride=s, padding=p)
        absg = (fa, *torch.ops.aten.convolution_backward(
            dy.abs(), x.abs(), w.abs(), [w.shape[0]], *args))
        xc = x.float().cuda().contiguous(memory_format=torch.channels_last)
        dyc = dy.float().cuda().contiguous(memory_format=torch.channels_last)
        wc = params[name]["kernel"].cuda().permute(3, 2, 0, 1)
        bc = params[name]["bias"].cuda()
        fwd = lambda: F.conv2d(xc, wc, bc, stride=s, padding=p)
        bwd = lambda: torch.ops.aten.convolution_backward(
            dyc, xc, wc, [wc.shape[0]], *args)
        fwd(), bwd()
        got = (fwd(), *bwd())
        errs = [_eps_of_abs(a, r, t) for a, r, t in zip(got, ref, absg)]
        n_terms = (w.shape[1] * w.shape[2] * w.shape[3],
                   w.shape[0] * w.shape[2] * w.shape[3],
                   dy.shape[0] * dy.shape[2] * dy.shape[3],
                   dy.shape[0] * dy.shape[2] * dy.shape[3])
        print(f"{tag} {name}: worst error in f32 eps of the absolute terms: "
              + ", ".join(f"{part} {e:.3g} (n {n})" for part, e, n in zip(
                  ("forward", "data grad", "weight grad", "bias grad"),
                  errs, n_terms)))
        print(f"{tag} {name} forward kernels: {_names(fwd)}")
        print(f"{tag} {name} backward kernels: {_names(bwd)}")

    # The whole step: card and CPU f32 against float64.
    l_cuda, g_cuda, k_cuda = _step(params, image, labels, "cuda",
                                   torch.float32)
    l_cpu, g_cpu, k_cpu = _step(params, image, labels, "cpu", torch.float32)
    for name in [n for n, *_ in CONVS] + ["linear1", "linear2"]:
        ref = k64[name][1] if name in k64 and isinstance(k64[name], tuple) \
            else k64[name]
        for dev, kk in (("card", k_cuda), ("CPU", k_cpu)):
            got = kk[name][1] if isinstance(kk[name], tuple) else kk[name]
            flips = int(((got.detach().double().cpu() > 0)
                         != (ref.detach() > 0)).sum())
            if flips:
                print(f"{tag} {dev} f32: {flips} ReLU inputs of {name} with "
                      f"the other sign")
    print(f"{tag} loss float64 {l64!r}, card f32 {l_cuda!r}, CPU f32 "
          f"{l_cpu!r}")
    for op in g64:
        for k in g64[op]:
            want = g64[op][k]
            scale = float(want.abs().max())
            e_card = float((g_cuda[op][k] - want).abs().max())
            e_cpu = float((g_cpu[op][k] - want).abs().max())
            diff = float((g_cuda[op][k] - g_cpu[op][k]).abs().max())
            print(f"{tag} grad {op}.{k}: max |ref| {scale:.4g}; error card "
                  f"{e_card:.4g}, CPU {e_cpu:.4g}; card - CPU {diff:.4g} "
                  f"({diff / (1e-4 * scale + 1e-7):.3g} of "
                  f"chip_smoke.TOL_TRAIN_GRAD)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", default="all",
                    choices=("all", "layouts", "on-off", "plans", "step-ms"))
    ap.add_argument("--benchmark", type=int, choices=(0, 1), default=1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("alexnet_conv: no CUDA device", file=sys.stderr)
        return 2
    if a.what == "step-ms":
        print(step_ms(bool(a.benchmark)))
        return 0
    if a.what == "plans":
        plans(bool(a.benchmark))
        return 0
    if a.what in ("all", "layouts"):
        torch.backends.cudnn.benchmark = True
        layouts()
    if a.what in ("all", "on-off"):
        on_off()
    if a.what == "all":
        for on in (0, 1):
            print(_child(["plans", "--benchmark", str(on)]), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
