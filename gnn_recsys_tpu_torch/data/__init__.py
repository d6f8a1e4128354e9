from gnn_recsys_tpu_torch.data.split import TrainValSplit, train_valid_split  # noqa: F401
