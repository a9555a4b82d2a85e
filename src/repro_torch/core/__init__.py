"""CoDA (Alg. 1+2), its objective, optimizer seam and schedules."""
from repro_torch.core import coda, objective, optimizer, schedules  # noqa: F401
