"""Launch layer: the training driver (``launch.train``).

The JAX package's ``mesh``, ``sharding``, ``dryrun`` and ``perf`` modules
are ROADMAP Queue 1 item 15, part three.
"""
