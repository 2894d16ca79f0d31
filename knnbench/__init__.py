"""knnbench: the benchmark of ``repro_torch``, the PyTorch and CUDA port of
the TrueKNN search, on NVIDIA cards.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line::

    python3 knnbench/run.py --workload kitti-scan2map --seed 7 --seconds 10 --trace 0

Everything a cell names is found by name: ``configs/<config>.json`` (the
cloud, k, the backend and the CPU tests' size), ``traffic/<traffic>.json``
(the parameters of a driver), ``kinds/<kind>.py`` (the driver a traffic
file's ``kind`` names), ``datasets/<dataset>.py`` (a cloud that
``datagen.py``'s frozen generators do not make) and
``metrics/<metric>.py`` (one reader per metric).  The yardstick lives here too and imports nothing of the
program: the data generators (``datagen.py``), the plain exact-kNN
reference and its control (``reference.py``), the comparison that decides
``correct`` (``compare.py``), the H100's peaks and the byte counts of a
round (``roofline.py``) and the reduction of a profiler trace
(``trace.py``).
"""
