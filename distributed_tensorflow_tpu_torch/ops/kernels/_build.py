"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes), placed in ``build/kernels/`` at the root of
the checkout.  The file name carries a hash of the source and of every
``csrc/`` header it includes (``#include "x.cuh"``, followed through the
headers' own includes), so an edited source or header builds anew and a
stale library is never loaded.  Nothing builds
at import: the first launch of a kernel builds its library, and
:func:`build` builds several at once, one ``nvcc`` process each, all
started together.

A ``csrc/<name>.cpp`` is host code (no CUDA): it compiles the same way
with the system C++ compiler (``c++``, the host compiler ``nvcc`` itself
calls), which is also there on a machine with no card.

A failed build raises with the compiler's output; a build that succeeds
keeps it beside the library (``<library>.log``), where
:func:`ptxas_report` reads each kernel's registers and spills.  Every launch function
in ``csrc/`` returns ``cudaGetLastError()``; :func:`check` raises when it
is not 0, so a launch the card refused never passes silently.

:func:`bind` hands out a C function with its ctypes signature set once
and caches it, so a wrapper's launch spends no host time on the lock,
the library lookup or the signature.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["BUILD_DIR", "CSRC", "bind", "build", "check", "cxx", "load",
           "ptxas_report", "stream_ptr"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# --split-compile=0 optimizes a source's kernels on every core at once
# (paged_attention.cu's 42 kernels were the whole build's longest pole);
# every kernel's registers, stack and spills are the same (ptxas -v)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels build from source")


HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")


def cxx() -> str:
    """The system C++ compiler that builds ``csrc/*.cpp``; raises when
    there is none."""
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (put c++ on PATH): the port's "
                           "host routines build from source")
    return cxx


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, or ``csrc/<name>.cpp`` for host code."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _command(name: str, out: Path) -> list:
    src = _source(name)
    if src.suffix == ".cpp":
        return [cxx(), *HOST_FLAGS, "-o", str(out), str(src)]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path) -> list:
    """``path`` and every local header it includes, transitively, in the
    order first met."""
    seen, todo = [], [path]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        for inc in _INCLUDE.findall(p.read_bytes()):
            dep = (p.parent / inc.decode()).resolve()
            if dep.exists():
                todo.append(dep)
    return seen


def _target(name: str) -> Path:
    src = _source(name)
    h = hashlib.sha256(" ".join(
        HOST_FLAGS if src.suffix == ".cpp" else NVCC_FLAGS).encode())
    for src in _sources(src):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build_locked(names) -> float:
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{_source(name).name} (exit {proc.returncode}):\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            out.with_suffix(".log").write_bytes(log)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build(*names: str) -> float:
    """Build the named sources (all of ``csrc/`` when none is named) that
    are not built yet, in parallel; returns the seconds it took."""
    names = names or tuple(sorted(p.stem for pattern in ("*.cu", "*.cpp")
                                  for p in CSRC.glob(pattern)))
    with _lock:
        return _build_locked(names)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked((name,))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def bind(lib: str, name: str, argtypes: Sequence,
         restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``csrc/<lib>.cu``, returning
    ``restype`` (by default ``int``, a CUDA error code) and taking
    ``argtypes``: built, loaded and typed on the first call, then served
    from a cache."""
    fn = _bound.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _bound[(lib, name)] = fn
    return fn


_PTXAS_NAME = re.compile(r"(?:Compiling entry function '|Function "
                         r"properties for )(\w+)")
_USED = re.compile(r"Used (\d+) registers")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")


# builtin types in a mangled template argument list
_BUILTIN = {"a": "signed char", "b": "bool", "c": "char", "f": "float",
            "h": "unsigned char", "i": "int", "j": "unsigned"}
_ARG = re.compile(r"L[a-z](n?)(\d+)E|(\d+)|([a-z])")


def _template_args(s: str):
    """The template arguments that ``s`` starts with (``I...E`` of a
    mangled name: integer literals, builtin types, named types), or None
    when ``s`` starts with none or with one of another form."""
    if not s.startswith("I"):
        return None
    args, i = [], 1
    while i < len(s) and s[i] != "E":
        m = _ARG.match(s, i)
        if m is None:
            return None
        neg, lit, length, builtin = m.groups()
        if lit is not None:
            args.append(("-" if neg else "") + lit)
            i = m.end()
        elif length is not None:
            args.append(s[m.end():m.end() + int(length)])
            i = m.end() + int(length)
        elif builtin in _BUILTIN:
            args.append(_BUILTIN[builtin])
            i = m.end()
        else:
            return None
    return args if i < len(s) else None


def _kernel_name(mangled: str) -> str:
    """``<identifier>_kernel<template arguments>`` out of a mangled name
    (the identifier is the one whose length prefix fits; the arguments
    comma-separated, left out when they do not parse), else the mangled
    name."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        ident = mangled[end:end + int(m.group(1))]
        if ident.endswith("_kernel") and ident.isidentifier():
            args = _template_args(mangled[end + len(ident):])
            return f"{ident}<{','.join(args)}>" if args else ident
    return mangled


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """What ``ptxas -v`` said of each kernel of ``csrc/<name>.cu`` when its
    library was built (building it first): {"kernel<template arguments>":
    {"registers", "stack", "spill_stores", "spill_loads"}}."""
    load(name)
    path = _target(name).with_suffix(".log")
    report: Dict[str, Dict[str, int]] = {}
    key = None
    for line in path.read_text(errors="replace").splitlines():
        m = _PTXAS_NAME.search(line)
        if m:
            key = _kernel_name(m.group(1))
            report.setdefault(key, {})
        elif key and _FRAME.search(line):
            f = _FRAME.search(line)
            report[key].update(stack=int(f.group(1)),
                               spill_stores=int(f.group(2)),
                               spill_loads=int(f.group(3)))
        elif key and _USED.search(line):
            report[key]["registers"] = int(_USED.search(line).group(1))
    return report


def check(rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_ptr(tensor) -> int:
    """The raw handle of PyTorch's current stream on the tensor's card
    (what ``torch.cuda.current_stream(dev).cuda_stream`` gives, without
    building a Stream object on every launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(tensor.get_device())
