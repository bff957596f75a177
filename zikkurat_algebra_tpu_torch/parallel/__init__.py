"""Multi-device scale-out over `torch.distributed`: one process per
device, SPMD (the torch counterpart of zikkurat_algebra_tpu/parallel/).

`mesh.init_multihost` joins the process group (NCCL on cards, gloo on
the CPU) and `mesh.make_mesh` gives the flat 'data' mesh.  Arrays are
split on their last (batch or domain) axis into contiguous chunks, chunk
i on rank i (`mesh.shard_batch`, `mesh.gather_batch`); each function
takes and returns this rank's chunk, or a value replicated on every
rank:

- `vector.sharded_sum`, `vector.sharded_dot` (an int64 all_reduce of
  limb columns, then one wide reduction);
- `msm.sharded_msm` (the local Pippenger, an all_gather of the partial
  points, a tree of additions);
- `ntt.ShardedNTT` (the four-step transform with three all_to_all
  transposes), `poly.ShardedPolyOps` and `gfft.ShardedGroupFFT`.
"""
