from repro_torch.data.synthetic import DataConfig, ShardedDataset, sample_online  # noqa: F401
