"""Build the port's native pieces from the repository's own sources.

Four artifacts, each built at first use into ``build/molar_tpu_torch/``
(listed in ``.gitignore``) and rebuilt when a source is newer:

* ``libmolar_kernels.so`` — the CUDA kernels in ``csrc/*.cu``, each source
  compiled by its own ``nvcc`` for ``sm_90a`` (all started together), then
  linked into one shared library with a plain C interface (loaded with
  ctypes, no PyTorch headers: seconds to build, not minutes);
* ``libxtc_codec.so`` — ``molar_tpu/native/xtc_codec.cpp``, compiled by path
  with ``g++`` (the codec is shared, not copied; nothing is imported from
  ``molar_tpu``);
* ``native_baseline`` — ``benchmarks/native_baseline.cpp`` linked with the
  codec: the single-core C++ reference of the headline workload;
* ``native_workloads`` — ``benchmarks/native_workloads.cpp`` linked with the
  codec: the single-core C++ reference of the selection workloads
  (``native_workloads <which> <xtc> <meta> <max_frames> <dcd_out>``, one
  JSON line a workload with ``fps`` and ``check``).

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

KERNEL_SOURCES = [PKG_DIR / "csrc" / name
                  for name in ("cell_bin.cu", "within_ghost.cu", "within_rows.cu")]
CODEC_SOURCE = REPO_DIR / "molar_tpu" / "native" / "xtc_codec.cpp"
BASELINE_SOURCE = REPO_DIR / "benchmarks" / "native_baseline.cpp"
WORKLOADS_SOURCE = REPO_DIR / "benchmarks" / "native_workloads.cpp"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _compile_objects(nvcc: str, sources) -> tuple[list[pathlib.Path], str]:
    """One ``nvcc -c`` per source, all running at once, each into its own
    temporary object. Returns (objects, diagnostics); raises
    :class:`BuildError` (after every compiler has ended) if any failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in sources:
            if not pathlib.Path(src).is_file():
                raise BuildError(f"missing source {src}")
            fd, obj = tempfile.mkstemp(prefix=pathlib.Path(src).stem + ".", suffix=".o",
                                       dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            jobs.append((cmd, pathlib.Path(obj), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for cmd, _, proc in jobs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}:\n{out}")
        if failed:
            raise BuildError("kernel build failed:\n" + "\n".join(failed))
    except BaseException:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
        raise
    return [obj for _, obj, _ in jobs], log


def build_kernels() -> tuple[pathlib.Path, str]:
    """The CUDA kernel library; returns (path, compiler diagnostics — the
    ``-Xptxas -v`` register/spill report, empty when already built)."""
    out = BUILD_DIR / "libmolar_kernels.so"
    log = ""
    if _stale(out, KERNEL_SOURCES):
        nvcc = nvcc_path()
        objects, log = _compile_objects(nvcc, KERNEL_SOURCES)
        try:
            log += _compile([nvcc, "-shared"], objects, out)
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
    return out, log


def build_codec() -> pathlib.Path:
    """The XTC codec shared library (same flags as ``molar_tpu.native``)."""
    out = BUILD_DIR / "libxtc_codec.so"
    if _stale(out, [CODEC_SOURCE]):
        _compile(
            [_gxx(), "-O3", "-shared", "-fPIC", "-std=c++17"], [CODEC_SOURCE], out
        )
    return out


def _build_native(name: str, source: pathlib.Path) -> pathlib.Path:
    out = BUILD_DIR / name
    srcs = [source, CODEC_SOURCE]
    if _stale(out, srcs):
        _compile([_gxx(), "-O3", "-std=c++17"], srcs, out)
    return out


def build_native_baseline() -> pathlib.Path:
    """The single-core C++ headline reference (``bench.py``'s denominator)."""
    return _build_native("native_baseline", BASELINE_SOURCE)


def build_native_workloads() -> pathlib.Path:
    """The single-core C++ reference of the selection workloads
    (``benchmarks/workloads.py``'s denominator, built with its flags)."""
    return _build_native("native_workloads", WORKLOADS_SOURCE)
