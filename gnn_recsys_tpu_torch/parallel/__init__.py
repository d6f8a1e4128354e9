from gnn_recsys_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch  # noqa: F401
