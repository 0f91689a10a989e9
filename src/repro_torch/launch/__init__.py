"""Launchers: meshes, the training driver and the multi-pod dry run (port
of ``repro.launch``; the reference's ``compat`` shim for jax's
cost-analysis return shapes has no counterpart, see ``dryrun``)."""
