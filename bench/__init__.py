"""The benchmark of ``repro_torch``: one command (``bench/run.py``) that runs
one cell of ``BENCHMARK.json`` once and prints one JSON line.

Everything here is the yardstick, frozen against later changes to the
program, and found by the names in ``BENCHMARK.json``: a configuration
(``configs/<config>.json``) names its family, whose plain reference,
weights' layout and ``Arch`` are ``reference/<family>.py``, cost arithmetic
``costs/<family>.py`` and mapping onto the program ``program/<family>.py``;
a traffic mix (``traffic/<mix>.json``, read by the one generator
``lib/traffic.py``) names its entry, whose adapter is
``adapters/<entry>.py``; a per-layer metric is read by
``metrics/<metric>.py``; a cell's limits of ``correct`` are
``limits/<cell>.json``.  The datasheet peaks are ``peaks.py``.  Nothing
here imports ``jax`` or the JAX package ``repro``.  The program,
``repro_torch``, is imported only by ``run.py`` and ``calibrate.py`` (which
put it on the card), the adapters (which drive it and plant its faults) and
``program/`` (which hands it its configuration and weights); the
reference and the cost arithmetic import nothing of it.
"""
