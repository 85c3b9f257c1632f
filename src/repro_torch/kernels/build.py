"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, from the sources in this checkout only, into
``build/kernels/`` at the repository root (git-ignored). A library is
named by the hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds and an unchanged one
loads what is there. All sources compile in
parallel, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}   # loaded libraries, one per source


class _Libraries:
    """The kernel libraries this process has built or loaded, read by the
    serve engine's retrace watchdog like an entry point's cache: one built
    or loaded mid-serve is an nvcc build (or a load) on a live tick."""

    def __init__(self):
        self.builds = 0

    def _cache_size(self) -> int:
        return self.builds + len(_LIBS)


LOADED = _Libraries()


class Built(NamedTuple):
    path: Path        # the shared library
    seconds: float    # nvcc's wall time; 0.0 when an up-to-date library was found
    log: str          # nvcc's output (ptxas -v: registers, spills); "" when found


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Built]:
    """Compile the named sources (all of csrc/ by default) that have no
    up-to-date library yet, in parallel. Returns {name: Built}."""
    srcs = sorted(CSRC.glob("*.cu"))
    if names is not None:
        srcs = [s for s in srcs if s.stem in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in srcs:
        target = _target(src)
        out[src.stem] = Built(target, 0.0, "")
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, target, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, target, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        out[src.stem] = Built(target, time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, target)
        LOADED.builds += 1
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name].path))
        _LIBS[name] = lib
    return lib


def occupancy(fn, names, *args) -> dict:
    """Call a kernel library's occupancy entry point `fn(*args, out)` (int
    arguments, then five ints per kernel written into out: registers a
    thread, local bytes a thread, dynamic shared bytes a CTA, threads a
    CTA, CTAs an SM) and return {name: {"registers", "local_bytes",
    "smem_bytes", "threads", "ctas_per_sm", "warps_per_sm"}} for the
    kernels `names`, in the entry point's order. Needs a CUDA card."""
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * (5 * len(names)))()
    err = fn(*args, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    keys = ("registers", "local_bytes", "smem_bytes", "threads", "ctas_per_sm")
    table = {}
    for i, name in enumerate(names):
        row = dict(zip(keys, out[5 * i:5 * i + 5]))
        row["warps_per_sm"] = row["ctas_per_sm"] * row["threads"] // 32
        table[name] = row
    return table
