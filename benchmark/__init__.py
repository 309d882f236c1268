"""The benchmark of hnsw_tpu_torch on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell and prints one JSON line. A cell
(``workloads/<cell>.json``) names its configuration (``configs/``), whose
data comes from a generator in ``data/``, and its traffic mix
(``traffic/<mix>.json``), which a generator in ``traffic/`` drives. Each
per-layer metric is a reader in ``metrics/``. ``reference.py`` and
``compare.py`` decide ``correct``; ``roofline.py`` holds the peaks and the
byte counts; ``control.py`` reads the comparison's controls on the chip.
"""
