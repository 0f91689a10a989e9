"""Launchers: meshes and the training driver (port of ``repro.launch``;
the reference's multi-pod dry-run, which reads XLA's compiled programs,
is not ported)."""
