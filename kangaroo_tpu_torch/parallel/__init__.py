"""Multi-device SGM (``kangaroo_tpu/parallel``): a mesh of devices and the
row- and column-sharded aggregation strategies with their sharded tail."""
