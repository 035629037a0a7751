"""The demo programs (``examples/``): each runs as
``python -m kangaroo_tpu_torch.examples.<name>_demo`` (``--device cpu`` for
the plain PyTorch versions) and writes its artefacts into ``$KANGAROO_OUT``
(default ``out/``)."""
