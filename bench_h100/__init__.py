"""The benchmark of phaneron_tpu_torch on one NVIDIA H100.

Cells, configurations and metrics are named in BENCHMARK.json at the
root of the checkout; ``python3 -m bench_h100 --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` runs one cell once (run.py).  A cell's
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<mix>.json``, its comparison limits ``limits/<cell>.json``, a
per-layer metric's reader ``metrics/<metric>.py``.  ``reference/`` is the
plain PyTorch reference that decides ``correct``, ``roofline.py`` the
work of a tick counted from its shapes.
"""
