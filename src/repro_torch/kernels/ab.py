"""A/B of K3-bwd source variants on one card.

    PYTHONPATH=src python -m repro_torch.kernels.ab \\
        --variant two_ctas=DKDV_MIN_CTAS=1,DQ_MIN_CTAS=1 \\
        --variant parent=@path/to/flash_attention_bwd.cu \\
        --shape 8,1024,15,5,64,bfloat16

A variant is the committed `csrc/flash_attention_bwd.cu` with some of its
`static constexpr` knobs set to other values (`NAME=VALUE`, comma-separated;
each knob must be defined exactly once), or another source file with the
same C entry points (`@path`).  Every variant is built beside the committed
one under `build/repro_torch/ab/` (gitignored), with the build's own nvcc
flags, and called through `flash_attention_bwd` in place of the built
library.  For each shape the committed source and the variants run in
turns (committed, variants, variants reversed, committed) on the same
operands: one JSON line each with the device ms of every kernel function
(torch.profiler, mean over the calls), the largest error as a share of the
plain version's largest gradient, and whether a second call gave the same
bits; and first one line with the card and each build's registers and spill
bytes (ptxas).  Nothing here runs at import time, and it needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

SOURCE = "flash_attention_bwd.cu"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def with_knobs(source: str, knobs: dict[str, str]) -> str:
    """`source` with each `static constexpr <type> NAME = ...;` of `knobs`
    set to its value; raises KeyError for a knob not defined exactly once."""
    for name, value in knobs.items():
        pattern = re.compile(
            rf"(static constexpr \w+ {re.escape(name)} = )[^;]*;")
        if len(pattern.findall(source)) != 1:
            raise KeyError(f"knob {name} is not defined exactly once in the "
                           "source")
        source = pattern.sub(lambda m: f"{m.group(1)}{value};", source)
    return source


def parse_variant(spec: str) -> tuple[str, str]:
    """(name, source) of `NAME=@path` or `NAME=KNOB=VALUE[,KNOB=VALUE...]`."""
    from repro_torch.kernels import build

    name, _, rest = spec.partition("=")
    if not name or not rest:
        raise ValueError(f"variant {spec!r} is not NAME=@path or "
                         "NAME=KNOB=VALUE,...")
    if rest.startswith("@"):
        return name, Path(rest[1:]).read_text()
    knobs = dict(kv.split("=", 1) for kv in rest.split(","))
    return name, with_knobs((build.CSRC / SOURCE).read_text(), knobs)


def build_variants(sources: dict[str, str]) -> dict[str, Path]:
    """Compile every variant's source (one nvcc each, started together)
    into build/repro_torch/ab/<name>/; returns the libraries' paths."""
    from repro_torch.kernels import build

    running = {}
    for name, text in sources.items():
        out = build.BUILD_DIR / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / SOURCE).write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(out / "lib.so"), str(out / SOURCE)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True),
                         out)
    libs = {}
    for name, (proc, out) in running.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        (out / "ptxas.txt").write_text(err)
        libs[name] = out / "lib.so"
    return libs


def registers(report: Path) -> dict[str, list[int]]:
    """[registers, spill bytes] of each kernel function in a ptxas report."""
    from repro_torch.kernels import build

    found = build.ptxas_report("flash_attention_bwd", report)
    return {k.split("::")[-1].split("(const")[0].replace("(int)", ""):
            [v["registers"], v["spill_store_bytes"] + v["spill_load_bytes"]]
            for k, v in found.items()}


def load(path: Path, entries) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry in entries:
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def kernel_ms(fn, reps: int) -> dict[str, float]:
    """Device ms a call of each kernel function `fn` launches (mean)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            name = e.key.split("::")[-1].split("<")[0]
            out[name] = out.get(name, 0.0) + (e.self_device_time_total
                                              / reps / 1e3)
    return out


def operands(B, S, H, KV, hd, dtype, fa):
    """Padded random operands and K3's output and lse for them."""
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                             (B, S, H, hd)))
    qp, kp, vp = fa.pad_operands(q, k, v)
    dop = fa.pad_operands(do, k, v)[0]
    out, lse = fa.flash_attention_fwd(qp, kp, vp, scale=hd ** -0.5,
                                      sk_valid=S)
    return (qp, kp, vp, out, lse, dop), {"scale": hd ** -0.5, "sk_valid": S}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", action="append", default=[],
                   help="NAME=KNOB=VALUE[,KNOB=VALUE...] or NAME=@path")
    p.add_argument("--shape", action="append", default=[],
                   help="B,S,H,KV,hd,dtype (default 8,1024,15,5,64,bfloat16)")
    p.add_argument("--reps", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel A/B needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    sources = {"committed": (build.CSRC / SOURCE).read_text()}
    sources.update(parse_variant(v) for v in args.variant)
    paths = build_variants(sources)
    libs = {n: load(path, fa._BWD_ENTRY.values()) for n, path in paths.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "registers": {
        n: registers(path.with_name("ptxas.txt"))
        for n, path in paths.items()}}), flush=True)
    order = list(sources) + list(sources)[::-1]
    for spec in args.shape or ["8,1024,15,5,64,bfloat16"]:
        *dims, dtype = spec.split(",")
        shape = tuple(int(d) for d in dims)
        ops, kw = operands(*shape, DTYPES[dtype], fa)
        want = flash_attention_bwd_ref(*ops, **kw)
        for name in order:
            fa._bwd_lib = lambda lib=libs[name]: lib
            got = fa.flash_attention_bwd(*ops, **kw)
            again = fa.flash_attention_bwd(*ops, **kw)
            torch.cuda.synchronize()
            err = max(float((g.float() - w.float()).abs().max())
                      / float(w.float().abs().max())
                      for g, w in zip(got, want))
            ms = kernel_ms(lambda: fa.flash_attention_bwd(*ops, **kw),
                           args.reps)
            print(json.dumps({
                "variant": name, "shape": shape, "dtype": dtype,
                "ms": sum(ms.values()), "kernel_ms": ms,
                "max_err_share": err,
                "repeat_bit_equal": all(torch.equal(a, b)
                                        for a, b in zip(got, again))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
