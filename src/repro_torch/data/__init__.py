from repro_torch.data.synthetic import DataConfig, ShardedDataset  # noqa: F401
