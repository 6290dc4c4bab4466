"""Build the port's CUDA sources into shared libraries at first use.

Each source in :data:`SOURCES` (``kernels/<name>/csrc/<name>.cu``, and
the cache-grid profiler's ``core/cgra/csrc/cache_grid.cu``) is compiled by
``nvcc`` on its own into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout, where ``<hash>`` covers the source bytes and the compiler
flags, so an edited source builds anew and an unchanged one is reused.
The sources expose a plain C interface and include no PyTorch headers,
which keeps a build to seconds; the wrappers load the library with
:mod:`ctypes` and pass device pointers and the current stream as integers.

Nothing is built when a module is imported: only a wrapper handed a CUDA
tensor (or :func:`build`, called by ``chip_smoke.py``) starts ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"

SOURCES = {
    "paged_attention": KERNELS_DIR / "paged_attention" / "csrc"
    / "paged_attention.cu",
    "gather_runahead": KERNELS_DIR / "gather_runahead" / "csrc"
    / "gather_runahead.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "csrc"
    / "flash_attention.cu",
    "moe_dispatch": KERNELS_DIR / "moe_dispatch" / "csrc"
    / "moe_dispatch.cu",
    "ssd_scan": KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan.cu",
    "cache_grid": KERNELS_DIR.parent / "core" / "cgra" / "csrc"
    / "cache_grid.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    blob = SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"{name}-{hashlib.sha256(blob).hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{name: log}`` for the libraries compiled now, where
    ``log`` holds ``ptxas``'s register and spill report.  Raises after every
    started compiler has exited if any of them failed."""
    names = list(SOURCES) if names is None else list(names)
    report, running = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        report[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``name`` (building it first if missing)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
