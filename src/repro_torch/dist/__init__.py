"""Distribution layer over ``torch.distributed``: logical-axis sharding rules,
context-parallel decode, pipeline parallelism and the sharded train step.

``sharding`` is rule resolution (no device state touched at import) plus each
rank's shard of a resolved spec; ``context_parallel``, ``pipeline_parallel``
and ``trainstep`` hold the multi-process execution paths.  One process runs
per rank: the library uses the process group that the caller initialized
(``init_process_group`` is called only by entry points and tests) and the
mesh built on it (``repro_torch.launch.mesh``).
"""
