"""Multigrid Poisson models (PyTorch port of ``pysco_tpu/models``)."""
