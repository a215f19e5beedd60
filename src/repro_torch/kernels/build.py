"""Build the CUDA sources in ``kernels/csrc`` at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes).  The libraries go
to ``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  All sources compile in parallel, one ``nvcc``
process each.  Nothing here runs at import time.  ptxas's report of each
build is kept beside its library; `kernel_registers` reads the registers
and spills of every kernel from it.

No ``--use_fast_math``: the Sinkhorn kernels divide by ε in IEEE arithmetic,
as the reference does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("sinkhorn_step.cu", "fgc_scan.cu", "lr_step.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch need the CUDA "
            "toolkit (set CUDA_HOME)")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> dict[str, Path]:
    """Compile every missing library (all ``nvcc`` processes started
    together) and return {source stem: library path}.  ptxas's register
    and spill report of each build is kept beside its library as
    ``<stem>.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {Path(s).stem: out / f"lib{Path(s).stem}.so" for s in SOURCES}
    todo = [(stem, path) for stem, path in libs.items() if not path.is_file()]
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = []
    for stem, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(out / f"{stem}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append((stem, path, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for stem, path, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)      # atomic: concurrent builds agree
        else:
            failed.append(f"{stem}.cu (nvcc exit {rc}):\n"
                          + (out / f"{stem}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return libs


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    with _lock:
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(str(build_all()[stem]))
        return _libs[stem]


_TEMPLATE_ARG = re.compile(r"13__nv_bfloat16|[fd]|Lb[01]E|Li(\d+)E|.")
_TEMPLATE_TEXT = {"13__nv_bfloat16": "bf16", "f": "f32", "d": "f64",
                  "Lb1E": "vector", "Lb0E": "scalar"}


def kernel_name(mangled: str) -> str:
    """`row_kernel<f32,f32,vector>` from an Itanium-mangled kernel name:
    the length-prefixed identifier followed by its template arguments (the
    length may follow other digits, as in a namespace's hash)."""
    for start in range(len(mangled)):
        digits = re.match(r"\d+", mangled[start:])
        if not digits:
            continue
        begin = start + digits.end()
        end = begin + int(digits.group())
        ident = mangled[begin:end]
        if not (ident.isidentifier() and mangled[end:end + 1] == "I"):
            continue
        args, pos = [], end + 1
        while pos < len(mangled) and mangled[pos] != "E":
            tok = _TEMPLATE_ARG.match(mangled, pos)
            args.append(tok.group(1) or _TEMPLATE_TEXT.get(tok.group(),
                                                            tok.group()))
            pos = tok.end()
        return f"{ident}<{','.join(args)}>"
    return mangled


def kernel_registers(text: str) -> list[tuple[str, int, int]]:
    """[(kernel, registers, spill-store bytes)] from ``ptxas -v`` output."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spill = kernel_name(m.group(1)), 0
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out
