from rware_tpu_torch.utils.spaces import MultiAgentActionSpace, MultiAgentObservationSpace

__all__ = ["MultiAgentActionSpace", "MultiAgentObservationSpace"]
