from fpl_plus_torch.agents.agent_abstract import NetRunAgent
from fpl_plus_torch.agents.agent_seg import SegmentationAgent

__all__ = ["NetRunAgent", "SegmentationAgent"]
