"""Multi-device runs of the port over a single-process device mesh (twin of
``hcunet_tpu/parallel``): :mod:`.mesh` (axes, placement, the JAX parameter
sharding rule), :mod:`.spatial` and :mod:`.tiled` (X-sharded inference with
halo exchange) and :mod:`.train` (data- and model-parallel training)."""
