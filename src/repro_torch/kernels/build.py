"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library under `<checkout>/build/repro_torch/`,
at first use, and loaded with `ctypes`.  The library's file name carries a
hash of the source, of every shared header (`csrc/*.cuh`) and of the whole
nvcc command line (compile and link flags), so an edited source or header is
rebuilt and a built one is reused.  `build_all` starts one `nvcc` per
source, all at once.  Each library keeps ptxas's report beside it
(`ptxas_report` parses it: registers, shared memory, spills per kernel
function; `ptxas_function` picks one function by name).
Nothing here runs at import time: the CPU tests import every module on
machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("edp_reduce", "tiled_matmul", "flash_attention",
           "flash_attention_bwd", "gp_fit")

# -fmad=false: no multiply-add contraction, so the kernel rounds each product
# and sum exactly as the plain PyTorch version does (one op per rounding).
# -Xptxas -v: ptxas's resource report (registers, spills) of every kernel.
# No kernel links -lcuda: K2 fetches cuTensorMapEncodeTiled through
# cudaGetDriverEntryPoint.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH, $CUDA_HOME or "
                       "/usr/local/cuda)")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def report_path(name: str) -> Path:
    return library_path(name).with_suffix(".ptxas.txt")


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every named source whose library is not built yet, one `nvcc`
    each, all started together.  Each writes to a temporary name and is
    renamed when done, so no process ever loads a half-written library.
    Returns the wall seconds each build took (0.0 for a library already
    built); raises with nvcc's messages if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True),
                         tmp, out)
    errors = []
    for name, (proc, tmp, out) in running.items():
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed to build {name} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        report_path(name).write_text(err)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def _demangle(names: list[str]) -> dict[str, str]:
    tool = Path(nvcc_path()).with_name("cu++filt")
    if not names or not tool.exists():
        return {n: n for n in names}
    out = subprocess.run([str(tool)], input="\n".join(names), text=True,
                         capture_output=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def ptxas_report(name: str,
                 path: Path | None = None) -> dict[str, dict[str, int]]:
    """ptxas's resources per kernel function of `csrc/<name>.cu` (built with
    `-Xptxas -v`; or of the report at `path`): registers, static shared
    memory, spill stores and loads and stack frame in bytes.  Dynamic
    shared memory is the wrapper's (`smem_bytes`)."""
    path = report_path(name) if path is None else path
    if not path.exists():
        return {}
    funcs: dict[str, dict[str, int]] = {}
    current = None
    for line in path.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w$]+)'?", line)
        if m:
            current = m.group(1)
            funcs.setdefault(current, {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            funcs[current].update(stack_bytes=int(m.group(1)),
                                  spill_store_bytes=int(m.group(2)),
                                  spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            funcs[current]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            funcs[current]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    funcs = {k: v for k, v in funcs.items() if "registers" in v}
    names = _demangle(sorted(funcs))
    return {names[k]: v for k, v in sorted(funcs.items())}


def _template_arg(a) -> tuple[str, str]:
    """(demangled, mangled) spelling of an int or type-name template argument
    ("float", "__nv_bfloat16")."""
    if isinstance(a, int):
        return str(a), f"Li{a}E"
    return a, {"float": "f"}.get(a, f"{len(a)}{a}")


def ptxas_function(name: str, function: str, *template_args) -> dict[str, int]:
    """`ptxas_report`'s entry for the one kernel function
    `function<template_args...>` of `csrc/<name>.cu` (ints or type names),
    found by its demangled name or, where cu++filt is missing, its mangled
    one; raises unless exactly one function matches."""
    spelled = [_template_arg(a) for a in template_args]
    demangled = f"{function}<{', '.join(d for d, _ in spelled)}>"
    mangled = (f"{len(function)}{function}I"
               + "".join(m for _, m in spelled) + "E")
    found = [v for k, v in ptxas_report(name).items()
             if re.search(rf"(?<!\w){re.escape(demangled)}",
                          k.replace("(int)", "")) or mangled in k]
    if len(found) != 1:
        raise LookupError(f"ptxas reports {len(found)} functions {demangled} "
                          f"in {name}")
    return found[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
