from repro_torch.models import attention, blocks, embeddings, mlp, model, moe, resnet  # noqa: F401
