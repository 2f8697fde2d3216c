"""Policy networks."""
from rware_tpu_torch.models.networks import ActorCritic, sample_action

__all__ = ["ActorCritic", "sample_action"]
