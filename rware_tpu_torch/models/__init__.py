"""Policy and value networks."""
from rware_tpu_torch.models.networks import (
    ActorCritic,
    CentralCritic,
    RecurrentActorCritic,
    sample_action,
)

__all__ = ["ActorCritic", "CentralCritic", "RecurrentActorCritic", "sample_action"]
