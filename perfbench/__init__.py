"""The benchmark of the PyTorch port, anytime3d_tpu_torch: ``run.py`` runs one cell (see ``BENCHMARK.json``)."""
