"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together; the ``*.cuh`` headers they
share are part of the build's hash) and linked into one shared
library with a plain C interface, ``librepro_torch_kernels.so``, which
is loaded with :mod:`ctypes`. The build runs at first use and lands in
``build/kernels/<hash>/`` at the root of the checkout, keyed on a hash of
the sources and flags, so a checkout builds its own kernels and a changed
source is rebuilt. Nothing here runs at import time: the CPU tests import
every module on a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: no multiply-add contraction anywhere, so each kernel's
# float arithmetic rounds exactly as its plain version's does.
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "--fmad=false", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype)
    "repro_block_agg": ([_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                         _I, _I, _P, _P, _P, _P, _I, _P], _I),
    "repro_fused_fold": ([_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                          _I, _I, _P, _P, _P, _P, _P, _I, ctypes.c_float,
                          ctypes.c_float, _I, _P], _I),
    "repro_fused_fold_plan": ([_I, _I, _P], None),
    "repro_grouped_hist": ([_P, _P, _P, ctypes.c_longlong, _I, _I,
                            ctypes.c_float, ctypes.c_float, _P, _P,
                            ctypes.c_longlong, _I, _P], _I),
    "repro_grouped_hist_plan": ([ctypes.c_longlong, _I, _I, _I, _P], None),
    "repro_grouped_hist_resident": ([_I], _I),
    "repro_bitmap_active": ([_P, _P, _I, _I, _P, _P, _I, _P], _I),
    "repro_bitmap_active_multi": ([_P, _P, _I, _I, _P, _I, _P, _I, _P],
                                  _I),
    "repro_round_select": ([_P, _P, _P, _I, _P, _I, _P, _P,
                            ctypes.c_longlong, ctypes.c_longlong, _I, _I,
                            _I] + [_P] * 6 + [_I, _P], _I),
    "repro_selective_scan": ([_P] * 7 + [_I] * 5 + [_P] * 3 + [_I, _P],
                             _I),
    "repro_selective_scan_bwd": ([_P] * 9 + [_I] * 6 + [_P] * 10
                                 + [_I, _P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "repro_torch are built at first use and need the "
                       "CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into the shared library unless this exact
    build exists; returns its path. Compiler output (``-Xptxas -v``:
    registers, shared memory, spills) is kept in ``build.log`` beside
    it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=out_dir.name + "."))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        objs = [str(tmp / (src.stem + ".o")) for src in sources()]
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o",
                               str(tmp / LIB_NAME), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.rename(tmp, out_dir)  # atomic publish
        except OSError:
            if not lib.exists():  # not a lost race with another process
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # gone after the rename
    return lib


#: the running cost analyses' callbacks (:func:`repro_torch.launch.
#: step_cost.analyze` adds one while its step runs)
LAUNCH_REPORTS: List = []


def report(name: str, read_bytes: int, write_bytes: int,
           stand_in: bool = False) -> None:
    """Tell every running cost analysis that kernel ``name`` launched,
    reading ``read_bytes`` and writing ``write_bytes`` (each input read
    once, each output written once). A wrapper calls it where it counts
    the launch: a ``ctypes`` call is out of the dispatcher's sight. A
    wrapper's stand-in on the meta device reports the launch it stands
    for with ``stand_in`` and counts none."""
    for fn in LAUNCH_REPORTS:
        fn(name, read_bytes, write_bytes, stand_in)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
