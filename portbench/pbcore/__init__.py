"""The port's benchmark harness: general code that every cell shares.

``run.py`` (one directory up) is the command.  It finds a cell's
configuration, traffic mix and per-layer metrics by the names in
``BENCHMARK.json``, each in a file of its own under ``portbench/``:

  configs/<config>.json    the configuration as it is run (sizes, source,
                           what was reduced or assumed)
  traffic/<traffic>.json   the mix's parameters and the driver that runs it
                           (``pbcore/drivers/<driver>.py``)
  metrics/<metric>.py      one reader a per-layer metric

``pbcore.frozen`` holds the yardstick (peaks, operation and byte counts,
the serving summary, the request generator); ``portbench/reference``
holds the plain references that decide ``correct``.  Nothing here imports
JAX or the JAX package.
"""
