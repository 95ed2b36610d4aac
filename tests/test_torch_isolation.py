"""The port stands without JAX: the machine with the card has no JAX, and any
``molar_tpu`` import reaches the JAX package's import-time pytree
registration. A subprocess with both blocked imports every module of the
port and runs the headline slice at a tiny size on the CPU; a static scan
finds no JAX or ``molar_tpu`` import in the port or in ``chip_smoke.py``.
"""

import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "molar_tpu_torch"

_RUN_WITHOUT_JAX = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["molar_tpu"] = None
    import importlib, pkgutil, tempfile, os
    import numpy as np
    import molar_tpu_torch
    for m in pkgutil.walk_packages(molar_tpu_torch.__path__, "molar_tpu_torch."):
        importlib.import_module(m.name)
    from molar_tpu_torch import headline
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.ops.neighbor import grid_dims

    n, npro, side, cutoff = 2000, 200, 2.714, 0.5
    coords0, masses = headline.make_system(n, npro, side)
    box = PeriodicBox(np.diag([side] * 3))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.xtc")
        headline.write_trajectory(path, coords0, box.matrix, 6)
        dims = grid_dims(box.box_extents(), cutoff)
        pidx = np.arange(npro)
        caps0 = headline.base_caps(path, box.inv, dims, pidx)
        ids, rmsd, count, check, _ = headline.run(
            path, coords0[pidx], masses[pidx], pidx, box, cutoff, dims, caps0, 4, "cpu")
        from molar_tpu_torch.io.xtc import XtcHandler
        with XtcHandler(path) as h:
            last = h.read_frame(5).coords.astype(np.float64)
    d = last[:, None, :] - last[None, pidx, :]
    d -= side * np.round(d / side)
    hits = np.flatnonzero(((d * d).sum(-1) <= cutoff**2).any(1))
    assert ids.tolist() == list(range(6)), ids
    assert count[5] == len(hits) and check[5] == int((hits + 1).sum()) % 2**32
    assert np.isfinite(rmsd).all() and (rmsd > 0).all()
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "molar_tpu")
              and sys.modules[m] is not None]
    assert not leaked, leaked
    print("OK", int(count[5]))
    """
)


def test_port_runs_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_WITHOUT_JAX], cwd=REPO, capture_output=True,
        text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|molar_tpu)(\.|\s|$)", re.M)


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(REPO)}: {m.group(0).strip()}"
        for f in files for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders


def test_kernel_source_is_cuda_for_hopper():
    from molar_tpu_torch import build

    src = (PORT / "csrc" / "within_ghost.cu").read_text()
    assert "__global__" in src and 'extern "C"' in src
    assert "neighbor_pallas.py:_ghost_kernel" in src
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR == REPO / "build" / "molar_tpu_torch"
