from repro_torch.models import model, resnet  # noqa: F401
