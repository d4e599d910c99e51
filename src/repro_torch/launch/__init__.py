"""Entry points of the port (``python -m repro_torch.launch.serve``,
``.train``, ``.dryrun``, ``.roofline``) and the dry-run's parts: the mesh
layouts and the H100's constants (``mesh``), the step inputs on the
``meta`` device (``input_specs``) and the step's op, byte and collective
counts (``op_stats``)."""
