"""Compare builds of a splash-attention source on one card.

    python -m internevo_tpu_torch.tools.compare_bwd_builds NAME=PATH[:FLAG,FLAG...] ...

Each PATH is a variant of ``csrc/splash_attention_bwd.cu`` or of
``csrc/splash_attention_fwd.cu`` with the same C entry points and the same
control data (it may include ``hopper.cuh`` and ``splash.cuh``); a library
that exports ``splash_attention_fwd_bf16`` is taken as a forward.  Each is
compiled with the package's nvcc flags and the extra FLAGs into
``internevo_tpu_torch/build/compare/NAME.so``, and its ``ptxas`` spill and
warning lines are printed (a warning may say that the wgmmas were
serialised).  Then it is held against its plain version at two shapes, seed
5, segments of ``tools/profile_step.py::packed_segments`` (at most 2048
tokens), 32 q heads of 128: MHA, and GQA 32/8 with dropout 0.1.

- A backward: dq, dk and dv against ``plain_backward`` (relative L2) at the
  ``chip_smoke.py`` kernel_bwd shapes, one packed row of 4096 tokens, the
  forward run by the package's own kernel.
- A forward: out (elements outside ``chip_smoke.py``'s bound, relative L2)
  and lse against ``plain_forward`` at its kernel phase's shapes, two rows
  of 4096 tokens with 357 padding tokens each.

Then the kernels are timed with CUDA events in turns, the builds in order
and then reversed, at both shapes.  One JSON line a build, then one with the
times.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops.cuda import build
from ..ops.cuda import splash_attention as splash
from .profile_step import packed_segments

SHAPES = {"packed_mha": dict(hkv=32, rate=0.0), "gqa_32_8_dropout_0.1": dict(hkv=8, rate=0.1)}
S, HEADS, HEAD_DIM, MAX_SEG, SEED = 4096, 32, 128, 2048, 5
FWD_B, FWD_PAD = 2, 357       # the forward's rows: chip_smoke.py's scoring batch
OUT_RTOL = OUT_ATOL = 1.6e-2  # chip_smoke.py's bound on the forward's out


def compile_build(name: str, path: str, flags: list) -> tuple:
    out = build.BUILD_DIR / "compare" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), *flags, "-o", str(out), path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}\n{proc.stderr}")
    return out, [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "spill" in ln or "warning" in ln.lower()]


def _qkv(dev, B: int, hkv: int):
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(B, S, HEADS, HEAD_DIM, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, S, hkv, HEAD_DIM, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    return q, k, v, g


def inputs(dev, hkv: int, rate: float):
    """The backward's arguments at one shape, from seed 5, with the forward
    run by the package's own kernel."""
    q, k, v, g = _qkv(dev, 1, hkv)
    seg = torch.from_numpy(packed_segments(1, S, MAX_SEG, 0, np.random.RandomState(SEED))[0]).to(dev)
    seed = splash._norm_seed([1234, 0, 0, 0, 0]) if rate else None
    out, lse = splash.splash_attention_with_lse(q, k, v, seg, dropout_rate=rate, dropout_seed=seed)
    do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    return (q, k, v, out, lse, do, None, seg, None, HEAD_DIM**-0.5, True), rate, seed


def forward_inputs(dev, hkv: int, rate: float):
    """``ForwardCall``'s arguments at one shape, from seed 5."""
    q, k, v, _ = _qkv(dev, FWD_B, hkv)
    seg = torch.from_numpy(packed_segments(FWD_B, S, MAX_SEG, FWD_PAD, np.random.RandomState(SEED))[0]).to(dev)
    seed = splash._norm_seed([1234, 0, 0, 0, 0]) if rate else None
    return (q, k, v, seg, None, HEAD_DIM**-0.5, True, False, rate, seed)


def check_backward(args, rate, seed) -> dict:
    got = splash._kernel_backward(*args, False, rate, seed)
    want = splash.plain_backward(*args, rate, seed)
    return {n: float((a.float() - b.float()).norm() / b.float().norm()) for n, a, b in zip(("dq", "dk", "dv"), got, want)}


def check_forward(args) -> dict:
    call = splash.ForwardCall(*args)
    call.launch()
    q, k, v, seg, _, scale, causal, _, rate, seed = args
    out, lse = splash.plain_forward(q, k, v, seg, None, scale, causal, rate, seed)
    d = (call.out.float() - out.float()).abs()
    fin = ~torch.isneginf(lse)
    return {"out_outside": int((d > OUT_ATOL + OUT_RTOL * out.float().abs()).sum()), "out_max_abs": float(d.max()),
            "out_rel_l2": float((call.out.float() - out.float()).norm() / out.float().norm()),
            "lse_max_abs": float((call.lse - lse)[fin].abs().max()),
            "empty_rows_agree": bool(torch.equal(torch.isneginf(call.lse), ~fin))}


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main(argv: list) -> int:
    dev = torch.device("cuda")
    builds = {}
    for spec in argv:
        name, rest = spec.split("=", 1)
        path, _, flags = rest.partition(":")
        lib, spills = compile_build(name, path, [f for f in flags.split(",") if f])
        forward = hasattr(ctypes.CDLL(str(lib)), "splash_attention_fwd_bf16")
        builds[name] = (lib, spills, splash.SOURCE if forward else splash.BWD_SOURCE)
    kinds = {source for _, _, source in builds.values()}
    # the package's own forward builds first (the backward's inputs run it)
    cases = {name: inputs(dev, **c) for name, c in SHAPES.items()} if splash.BWD_SOURCE in kinds else {}
    fwd_cases = {name: forward_inputs(dev, **c) for name, c in SHAPES.items()} if splash.SOURCE in kinds else {}
    for name, (lib, spills, source) in builds.items():
        build._loaded[source] = ctypes.CDLL(str(lib))
        if source == splash.SOURCE:
            checks = {case: check_forward(args) for case, args in fwd_cases.items()}
        else:
            checks = {case: check_backward(*c) for case, c in cases.items()}
        print(json.dumps({"build": name, "source": source, "spills": spills, "checks": checks}), flush=True)
    times = {}
    for name in list(builds) + list(builds)[::-1]:
        lib, _, source = builds[name]
        build._loaded[source] = ctypes.CDLL(str(lib))
        if source == splash.SOURCE:
            for case, args in fwd_cases.items():
                call = splash.ForwardCall(*args)
                times.setdefault(name, {}).setdefault(case, []).append({"fwd_ms": time_ms(call.launch)})
            continue
        for case, (args, rate, seed) in cases.items():
            call = splash.BackwardCall(*args, False, rate, seed)
            times.setdefault(name, {}).setdefault(case, []).append(
                {"dkdv_ms": time_ms(call.launch_dkdv), "dq_ms": time_ms(call.launch_dq)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
