"""Multi-device run modes: the mesh and its collectives, the replicated mode
and the slab mode (PyTorch port of ``pysco_tpu/parallel``)."""
