"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own nvcc process, all started together, for
sm_90a; the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The build runs at first use, into
build/kernels/ beside the package, named by a hash of the sources and flags
so an edited source rebuilds. Only the repository's sources are compiled.

No --use_fast_math: gating, the MaxQuantity bisection and merge ties depend
on IEEE expf/logf/division. -fmad=false keeps each multiply and add rounded
on its own, as PyTorch's elementwise kernels round them, so a kernel and its
plain version differ only where a reduction sums in another order."""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _tag():
    """Hash of the flags and every source and header: names the build."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build_library():
    """Compile every csrc/*.cu (in parallel) and link one shared library.
    Returns its path; reuses an existing build of the same sources."""
    sources = _sources()
    tag = _tag()
    lib = BUILD_DIR / f"libmonorfs_kernels_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        log = open(BUILD_DIR / f"{src.stem}_{tag}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, _, log, proc in procs:
        if proc.wait() != 0:
            failed.append(src.name)
        log.close()
    if failed:
        logs = "\n".join(
            (BUILD_DIR / f"{Path(n).stem}_{tag}.log").read_text() for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *[str(o) for _, o, _, _ in procs]],
        check=True,
    )
    os.replace(tmp, lib)
    return lib


def build_log():
    """ptxas register / shared-memory report of the current build (only the
    logs of the current sources' tag)."""
    return "\n".join(p.read_text() for p in sorted(BUILD_DIR.glob(f"*_{_tag()}.log")))


@functools.cache
def library():
    return ctypes.CDLL(str(build_library()))


def function(name, argtypes, restype=ctypes.c_int):
    """The C entry point `name` with its argument types declared (pointers
    and the stream as c_void_p; ctypes would otherwise cut them to 32 bits).
    Launchers return a cudaError_t as int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
