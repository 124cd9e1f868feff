"""launch subsystem: the dry run of every (arch x shape x mesh) cell on a
simulated world of ranks (``hostsim``), its meshes (``mesh``) and its
allocation-free input specs (``specs``).  Importing it touches no process
group."""
