"""Build and load the port's CUDA kernels.

Each source `csrc/<source>.cu` is compiled by `nvcc` for `sm_90a` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with `ctypes`; one library exports several entry
points (the f64 and f32 instances of a kernel, or the probes).  Builds go
to `socp_tpu_torch/_build/` (listed in .gitignore), keyed by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, at first use;
`build()` compiles every missing library with one `nvcc` per source, all
started together.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "chol_batched": (_P, _P, _I, _I, _P),
    "tri_pair_batched": (_P, _P, _P, _I, _I, _I, _P),
    "chol_single": (_P, _P, _P, _I, _P),
    "tri_pair_single": (_P, _P, _P, _I, _I, _P),
}
# entry point (the C symbol) -> (source name, argtypes); every kernel or
# check entry point returns the launch's cudaError_t as an int, every query
# its answer.
KERNELS = {
    f"{name}_{t}": (name, args)
    for name, args in _SIGNATURES.items() for t in ("f64", "f32")
}
KERNELS.update({
    "probe_eft": ("probes", (_P, _P, _P, _P, _P, _P, _I, _P)),
    "probe_read": ("probes", (_P, _P, _I, _I, _P)),
    "probe_write": ("probes", (_P, _P, _I, _I, _P)),
    "probe_fwd": ("probes", (_P, _P, _P, _I, _I, _P)),
    "probe_empty": ("probes", (_P,)),
})
# layout queries: what a kernel's source alone knows, asked by its wrapper
QUERIES = {
    "chol_single_scratch_ints": ("chol_single", (_I,)),
    "tri_pair_single_max_n": ("tri_pair_single", (_I,)),
}
# checks the card runs on the kernels' building blocks (csrc/div_rn.cu)
CHECKS = {f"div_rn_{t}": ("div_rn", (_P, _P, _P, ctypes.c_long, _P))
          for t in ("f64", "f32")}
ENTRY_POINTS = {**KERNELS, **QUERIES, **CHECKS}
SOURCES = tuple(dict.fromkeys(src for src, _ in ENTRY_POINTS.values()))

_loaded: dict = {}   # entry point -> loaded C function


def _target(source: str) -> tuple[Path, Path]:
    src = CSRC / f"{source}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):    # the sources' shared code
        key.update(header.read_bytes())
    return src, BUILD_DIR / f"{source}-{key.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def build(sources=SOURCES) -> tuple[float, str]:
    """Compile the named sources that are not built yet.  Returns the
    seconds taken and nvcc's output (ptxas register / shared-memory
    report); raises with the output if any compile fails."""
    t0 = time.perf_counter()
    todo = [(name, *_target(name)) for name in sources]
    todo = [t for t in todo if not t[2].exists()]
    if not todo:
        return 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, proc, tmp, out))
    logs, failed = [], []
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        logs.append(f"[{name}]\n{log}")
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    text = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
    return time.perf_counter() - t0, text


def kernel(name: str):
    """The C entry point `name` (a kernel, a query or a check), its source
    built and loaded at first use."""
    fn = _loaded.get(name)
    if fn is None:
        source, argtypes = ENTRY_POINTS[name]
        _, out = _target(source)
        if not out.exists():
            build((source,))
        fn = getattr(ctypes.CDLL(str(out)), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
