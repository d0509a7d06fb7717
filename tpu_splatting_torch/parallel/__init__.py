"""Multi-device paths of the port (``tpu_splatting/parallel``'s
counterpart): camera-batch data parallelism and point-sharded projection
(``data_parallel``), band-sharded stream rasterization of one large frame
(``stream_sharded``) and the multi-device dry run (``dryrun``), over the
single-process ``Mesh`` of ``mesh``."""
