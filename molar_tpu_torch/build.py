"""Build the port's native pieces from the repository's own sources.

Six artifacts, each built at first use into ``build/molar_tpu_torch/``
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
  JSON line a workload with ``fps`` and ``check``);
* ``native_membrane`` — ``benchmarks/native_membrane.cpp``: the single-core
  C++ reference of the membrane workload (``native_membrane <sidecar>``,
  one JSON line with ``fps`` and the three check scalars);
* ``libmolar_gromacs.so`` — ``molar_tpu/native/gromacs_plugin.cpp``, the
  TPR/CPT shim, compiled by path against a GROMACS source and build tree
  (``GROMACS_SOURCE_DIR`` / ``GROMACS_BUILD_DIR`` / ``GROMACS_LIB_DIR``);
  built only on request: ``python -m molar_tpu_torch.build gromacs-plugin
  [-o OUT]``. Without it ``io.tpr`` reads through its pure decoder.

Every build failure raises :class:`BuildError`. Outputs are written to a
temporary name and renamed into place, so concurrent builds (test
workers) never load a half-written file.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

PKG_DIR = pathlib.Path(__file__).resolve().parent
REPO_DIR = PKG_DIR.parent
BUILD_DIR = REPO_DIR / "build" / "molar_tpu_torch"

KERNEL_SOURCES = [PKG_DIR / "csrc" / name
                  for name in ("cell_bin.cu", "within_ghost.cu", "within_rows.cu")]
CODEC_SOURCE = REPO_DIR / "molar_tpu" / "native" / "xtc_codec.cpp"
BASELINE_SOURCE = REPO_DIR / "benchmarks" / "native_baseline.cpp"
WORKLOADS_SOURCE = REPO_DIR / "benchmarks" / "native_workloads.cpp"
MEMBRANE_SOURCE = REPO_DIR / "benchmarks" / "native_membrane.cpp"
GROMACS_PLUGIN_SOURCE = REPO_DIR / "molar_tpu" / "native" / "gromacs_plugin.cpp"
#: Where ``io.tpr`` looks for the plugin after ``MOLAR_GROMACS_PLUGIN``.
GROMACS_PLUGIN = BUILD_DIR / "libmolar_gromacs.so"

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


def _build_native(name: str, *srcs: pathlib.Path) -> pathlib.Path:
    out = BUILD_DIR / name
    if _stale(out, srcs):
        _compile([_gxx(), "-O3", "-std=c++17"], srcs, out)
    return out


def build_native_baseline() -> pathlib.Path:
    """The single-core C++ headline reference (``bench.py``'s denominator)."""
    return _build_native("native_baseline", BASELINE_SOURCE, CODEC_SOURCE)


def build_native_workloads() -> pathlib.Path:
    """The single-core C++ reference of the selection workloads
    (``benchmarks/workloads.py``'s denominator, built with its flags)."""
    return _build_native("native_workloads", WORKLOADS_SOURCE, CODEC_SOURCE)


def build_native_membrane() -> pathlib.Path:
    """The single-core C++ reference of the membrane workload
    (``benchmarks/workloads.py``'s ``run_native_membrane``, its flags)."""
    return _build_native("native_membrane", MEMBRANE_SOURCE)


def build_gromacs_plugin(output=None, env=None) -> pathlib.Path:
    """The GROMACS TPR/CPT plugin, compiled against the tree named by
    ``GROMACS_SOURCE_DIR``, ``GROMACS_BUILD_DIR`` and ``GROMACS_LIB_DIR``
    (in ``env``, default the process environment), with the include
    directories of ``molar_tpu/native/build_gromacs_plugin.py``. Always
    rebuilds; raises :class:`BuildError` when a variable is unset."""
    env = os.environ if env is None else env
    src, bld, lib = (env.get(k) for k in
                     ("GROMACS_SOURCE_DIR", "GROMACS_BUILD_DIR", "GROMACS_LIB_DIR"))
    if not (src and bld and lib):
        raise BuildError("set GROMACS_SOURCE_DIR, GROMACS_BUILD_DIR and GROMACS_LIB_DIR")
    includes = [
        f"{src}/src",
        f"{src}/src/gromacs/utility/include",
        f"{src}/src/gromacs/math/include",
        f"{src}/src/gromacs/topology/include",
        f"{src}/api/legacy/include",
        f"{src}/src/external",
        f"{bld}/api/legacy/include",
        f"{bld}/src/include",
    ]
    if os.path.isdir(f"{src}/src/external/thread_mpi/include"):
        includes.append(f"{src}/src/external/thread_mpi/include")
    out = pathlib.Path(output) if output else GROMACS_PLUGIN
    _compile(
        [env.get("CXX", "g++"), "-O2", "-std=c++17", "-shared", "-fPIC"],
        [GROMACS_PLUGIN_SOURCE], out,
        [*(f"-I{p}" for p in includes), f"-L{lib}", f"-Wl,-rpath,{lib}", "-lgromacs"],
    )
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m molar_tpu_torch.build",
                                 description="build one of the port's native pieces")
    ap.add_argument("what", choices=["gromacs-plugin"])
    ap.add_argument("-o", "--output", default=None,
                    help=f"output path (default {GROMACS_PLUGIN})")
    args = ap.parse_args(argv)
    try:
        out = build_gromacs_plugin(args.output)
    except BuildError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
