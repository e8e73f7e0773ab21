"""Compare builds of the splash-backward source on one card.

    python -m internevo_tpu_torch.tools.compare_bwd_builds NAME=PATH[:FLAG,FLAG...] ...

Each PATH is a variant of ``csrc/splash_attention_bwd.cu`` with the same C
entry points and the same control data (it may include ``hopper.cuh``).  Each
is compiled with the package's nvcc flags and the extra FLAGs into
``internevo_tpu_torch/build/compare/NAME.so``, its ``ptxas`` spill lines are
printed, and its dq, dk and dv are held against ``plain_backward`` (relative
L2) at the ``chip_smoke.py`` kernel_bwd shapes: one packed row of 4096 tokens,
32 q heads of 128, MHA, and GQA 32/8 with dropout 0.1 (segments of
``tools/profile_step.py::packed_segments``, seed 5).  Then both kernels are
timed with CUDA events in turns, the builds in order and then reversed, at
both shapes.  One JSON line a build, then one with the times.
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


def compile_build(name: str, path: str, flags: list) -> tuple:
    out = build.BUILD_DIR / "compare" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), *flags, "-o", str(out), path]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}\n{proc.stderr}")
    return out, [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "spill" in ln]


def inputs(dev, hkv: int, rate: float):
    """The backward's arguments at one shape, from seed 5, with the forward
    run by the package's own kernel."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(1, S, HEADS, HEAD_DIM, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(1, S, hkv, HEAD_DIM, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    seg = torch.from_numpy(packed_segments(1, S, MAX_SEG, 0, np.random.RandomState(SEED))[0]).to(dev)
    seed = splash._norm_seed([1234, 0, 0, 0, 0]) if rate else None
    out, lse = splash.splash_attention_with_lse(q, k, v, seg, dropout_rate=rate, dropout_seed=seed)
    do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    return (q, k, v, out, lse, do, None, seg, None, HEAD_DIM**-0.5, True), rate, seed


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
        builds[name] = compile_build(name, path, [f for f in flags.split(",") if f])
    cases = {name: inputs(dev, **c) for name, c in SHAPES.items()}  # the package's own forward builds first
    for name, (lib, spills) in builds.items():
        build._loaded[splash.BWD_SOURCE] = ctypes.CDLL(str(lib))
        rel = {}
        for case, (args, rate, seed) in cases.items():
            got = splash._kernel_backward(*args, False, rate, seed)
            want = splash.plain_backward(*args, rate, seed)
            rel[case] = {n: float((a.float() - b.float()).norm() / b.float().norm())
                         for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        print(json.dumps({"build": name, "spills": spills, "rel_l2": rel}), flush=True)
    times = {}
    for name in list(builds) + list(builds)[::-1]:
        build._loaded[splash.BWD_SOURCE] = ctypes.CDLL(str(builds[name][0]))
        for case, (args, rate, seed) in cases.items():
            call = splash.BackwardCall(*args, False, rate, seed)
            times.setdefault(name, {}).setdefault(case, []).append(
                {"dkdv_ms": time_ms(call.launch_dkdv), "dq_ms": time_ms(call.launch_dq)})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
