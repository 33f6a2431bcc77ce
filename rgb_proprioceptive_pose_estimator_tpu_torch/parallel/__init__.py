from rgb_proprioceptive_pose_estimator_tpu_torch.parallel import dist

# The reference's names whose counterpart has another name here, as a
# path from this package: a process joins the group (the reference's
# init_distributed joins a host; here each rank joins, and
# dist.launch_host starts a host's ranks).
REFERENCE_NAMES = {"init_distributed": "dist.init"}

# The reference's names with no counterpart, and why: they build and use
# a jax.sharding mesh. The port runs one process per device under DDP,
# and each rank builds its own rows of the global batch (HostPipeline's
# rank and world), so there is no mesh, no sharding to name and no
# global batch to split.
NOT_OWED = {
    "make_mesh": "no device mesh: one process per device (DDP)",
    "batch_sharding": "no jax.sharding: each rank loads its own rows",
    "replicated_sharding": "no jax.sharding: DDP replicates the model",
    "shard_batch": "no global batch to split: each rank loads its rows",
}

__all__ = ["dist"]
