"""Build the port's native pieces from the repository's own sources.

Three artifacts, each built at first use into ``build/molar_tpu_torch/``
(listed in ``.gitignore``) and rebuilt when a source is newer:

* ``libwithin_ghost.so`` — the CUDA kernels in ``csrc/*.cu``, compiled by
  ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
  (loaded with ctypes, no PyTorch headers: seconds to build, not minutes);
* ``libxtc_codec.so`` — ``molar_tpu/native/xtc_codec.cpp``, compiled by path
  with ``g++`` (the codec is shared, not copied; nothing is imported from
  ``molar_tpu``);
* ``native_baseline`` — ``benchmarks/native_baseline.cpp`` linked with the
  codec: the single-core C++ reference of the headline workload.

Every build failure raises :class:`BuildError`. Outputs are written to a
temporary name and renamed into place, so concurrent builds (test
workers) never load a half-written file.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import tempfile

PKG_DIR = pathlib.Path(__file__).resolve().parent
REPO_DIR = PKG_DIR.parent
BUILD_DIR = REPO_DIR / "build" / "molar_tpu_torch"

KERNEL_SOURCES = [PKG_DIR / "csrc" / "within_ghost.cu"]
CODEC_SOURCE = REPO_DIR / "molar_tpu" / "native" / "xtc_codec.cpp"
BASELINE_SOURCE = REPO_DIR / "benchmarks" / "native_baseline.cpp"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # The kernels compute d^2 with explicit _rn intrinsics; --fmad=false
    # also keeps any other float expression from contracting into an FMA,
    # so rounding matches the plain torch versions.
    "--fmad=false",
    "-Xptxas", "-v",
]


class BuildError(RuntimeError):
    pass


def _stale(out: pathlib.Path, sources) -> bool:
    if not out.exists():
        return True
    built = out.stat().st_mtime
    return any(pathlib.Path(s).stat().st_mtime > built for s in sources)


def _compile(cmd_prefix, sources, out: pathlib.Path, cmd_suffix=()) -> str:
    """Run one compiler command into a temp file, rename it to ``out``, and
    return the compiler's diagnostics (stderr + stdout)."""
    for s in sources:
        if not pathlib.Path(s).is_file():
            raise BuildError(f"missing source {s}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*cmd_prefix, *map(str, sources), *cmd_suffix, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(
                f"build of {out.name} failed ({' '.join(cmd)}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stderr + proc.stdout


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise BuildError("g++ not found")
    return gxx


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise BuildError("nvcc not found (CUDA toolkit required for the kernels)")


def build_kernels() -> tuple[pathlib.Path, str]:
    """The CUDA kernel library; returns (path, compiler diagnostics — the
    ``-Xptxas -v`` register/spill report, empty when already built)."""
    out = BUILD_DIR / "libwithin_ghost.so"
    log = ""
    if _stale(out, KERNEL_SOURCES):
        log = _compile([nvcc_path(), *NVCC_FLAGS], KERNEL_SOURCES, out)
    return out, log


def build_codec() -> pathlib.Path:
    """The XTC codec shared library (same flags as ``molar_tpu.native``)."""
    out = BUILD_DIR / "libxtc_codec.so"
    if _stale(out, [CODEC_SOURCE]):
        _compile(
            [_gxx(), "-O3", "-shared", "-fPIC", "-std=c++17"], [CODEC_SOURCE], out
        )
    return out


def build_native_baseline() -> pathlib.Path:
    """The single-core C++ headline reference (``bench.py``'s denominator)."""
    out = BUILD_DIR / "native_baseline"
    srcs = [BASELINE_SOURCE, CODEC_SOURCE]
    if _stale(out, srcs):
        _compile([_gxx(), "-O3", "-std=c++17"], srcs, out)
    return out
