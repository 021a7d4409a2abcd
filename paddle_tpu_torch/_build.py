"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by its own `nvcc` process into a
shared library with a plain C interface,
`build/paddle_tpu_torch/lib<name>-<hash>.so`, the first time it is used.
`<hash>` covers the source, every `csrc/*.cuh` header and the flags, so
an edited source is rebuilt and a stale library is never loaded. The
library is loaded with `ctypes`; the wrappers pass tensor pointers and
the current stream as `c_void_p` and raise when the C entry point
returns a nonzero `cudaError_t`.

`build_all()` starts one `nvcc` per source at once and waits for all of
them, so the build takes as long as the slowest source.

LAUNCH COUNTERS. Each wrapper keeps its counts as attributes of itself
(`flash_attention_fwd.launches`) and adds to them through `count` where
it launches its kernel. A CUDA graph's capture records launches without
running them: while a thread is inside `capture_tally()`, its counts go
to the tally that yields and the shared counters are left alone, so a
capture on one thread never takes back another thread's launches.
`add_counts` puts a replay's recorded launches onto the shared counters.
A kernel of more than one input dtype also counts its launches by dtype
(`launches_bf16`, `launches_f16`, `launches_f32`: `count_dtype`;
`launches_by_dtype` reads them, `reset_counts` zeroes them all).
The shared counters change under one lock, so threads that launch or
replay at once lose no update.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# ptxas register/shared-memory report per source, from the last build
build_log: Dict[str, str] = {}
_count_lock = threading.Lock()
_capturing = threading.local()


def sources() -> List[str]:
    """Kernel source names (`csrc/<name>.cu`), sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def source_hash(name: str) -> str:
    """Hash of `csrc/<name>.cu`, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_hash(name)}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            "paddle_tpu_torch/csrc on first use and need the CUDA toolkit")
    return nvcc


def cuobjdump() -> str:
    """The toolkit's `cuobjdump` beside `nvcc` (it lists a library's SASS:
    `cuobjdump -sass lib<name>-<hash>.so`)."""
    path = Path(_nvcc()).with_name("cuobjdump")
    if not path.exists():
        raise RuntimeError(f"cuobjdump not found beside {_nvcc()}")
    return str(path)


def build_all(names=None) -> Dict[str, str]:
    """Build every missing library in parallel (one nvcc per source);
    returns the ptxas report of each source built. Raises with the
    compiler's output when a build fails."""
    names = sources() if names is None else list(names)
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for n in todo:
            out = library_path(n)
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[n] = log
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n"
                              f"{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return {n: build_log[n] for n in todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point `symbol` of `csrc/<name>.cu` with its argument
    types declared (pointers and the stream as c_void_p) and an int
    (cudaError_t) result; declared once, then looked up per launch."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def count(wrapper, attr: str = "launches", n: int = 1) -> None:
    """Add `n` to `wrapper.<attr>`, or to this thread's capture tally
    while it is inside `capture_tally()`."""
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        tally[(wrapper, attr)] = tally.get((wrapper, attr), 0) + n
        return
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)


DTYPE_TAGS = {"torch.float32": "f32", "torch.bfloat16": "bf16",
              "torch.float16": "f16"}


def count_dtype(wrapper, dtype) -> None:
    """One launch of `wrapper`'s kernel on inputs of `dtype`: `launches`
    and `launches_<tag>` each gain one."""
    count(wrapper)
    count(wrapper, f"launches_{DTYPE_TAGS[str(dtype)]}")


def launches_by_dtype(wrapper) -> Dict[str, int]:
    """{tag: launches} of a wrapper that counts by dtype."""
    return {t: getattr(wrapper, f"launches_{t}")
            for t in DTYPE_TAGS.values()
            if hasattr(wrapper, f"launches_{t}")}


def reset_counts(wrapper) -> None:
    """Zero `launches` and every `launches_<option or dtype>` count."""
    with _count_lock:
        for attr in list(vars(wrapper)):
            if attr == "launches" or attr.startswith("launches_"):
                setattr(wrapper, attr, 0)


def add_counts(tally: Dict[Tuple[object, str], int]) -> None:
    """Add a tally from `capture_tally()` to the shared counters."""
    with _count_lock:
        for (wrapper, attr), n in tally.items():
            setattr(wrapper, attr, getattr(wrapper, attr) + n)


@contextmanager
def capture_tally() -> Iterator[Dict[Tuple[object, str], int]]:
    """Count this thread's launches into the dict this yields, not into
    the shared counters, until the block ends."""
    tally: Dict[Tuple[object, str], int] = {}
    _capturing.tally = tally
    try:
        yield tally
    finally:
        _capturing.tally = None
