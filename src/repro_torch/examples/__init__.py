"""Runnable walkthroughs of the port: ``python -m repro_torch.examples.train_geo``
and ``python -m repro_torch.examples.serve_geo`` (the counterparts of the
JAX package's ``examples/train_geo.py`` and ``examples/serve_geo.py``)."""
