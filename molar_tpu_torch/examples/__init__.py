"""The JAX package's six ``examples/`` scripts, for the port.

Run each with ``python -m molar_tpu_torch.examples.<name>``:

* ``rmsd_trajectory`` — per-frame RMSD of a selection after the
  mass-weighted fit, a :class:`~molar_tpu_torch.tasks.trajectory.WindowAnalysisTask`
  whose window function fits every frame of a window on the card;
* ``contacts`` — atoms within a cutoff of a target selection a frame, a
  window function over the ghost kernels;
* ``structure_report`` — SASA and volume, COM, gyration, DSSP and an SES
  mesh of one structure, through ``Sel``;
* ``membrane_curvature`` — the TOML-configured membrane analysis,
  ``MembraneDevice(membrane)`` over the trajectory's windows;
* ``tip3to4_tutorial`` — the reference README's tutorial through ``Sel``;
* ``assign_ff`` — perception, GAFF types and espaloma charges of a molecule.

Their computing calls run on the card unless the process asked for the CPU
(:func:`molar_tpu_torch.config.set_default_device`).
"""
