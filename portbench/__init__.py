"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; everything that belongs to
one configuration, traffic mix or metric sits in a file of its own under
``configs/``, ``traffic/``, ``checks/`` and ``metrics/``, found by the name
``BENCHMARK.json`` gives.  The references, the traffic generator, the
trace reduction and the FLOP and byte counts are the benchmark's own and
import nothing of the program.
"""
