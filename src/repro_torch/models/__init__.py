from repro_torch.models import attention, blocks, embeddings, mlp, model, resnet  # noqa: F401
