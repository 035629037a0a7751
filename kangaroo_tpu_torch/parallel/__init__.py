"""Multi-device paths (``kangaroo_tpu/parallel``): a mesh of devices, the
row- and column-sharded SGM aggregations with their sharded tail, sharded
stencils, disparity-sharded census WTA and DTAM, the z-sharded volume with
its fuses and raycasts, sharded ICP, and frame-parallel batches."""
