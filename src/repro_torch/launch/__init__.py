"""Launch layer: meshes on ``torch.distributed`` (``mesh``), the sharding
rules on DTensor (``sharding``), the dry run and the perf driver on a fake
process group (``dryrun``, ``perf``) and the training driver (``train``).
"""
