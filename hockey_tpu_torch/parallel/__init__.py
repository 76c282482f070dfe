"""Multi-device training and inference over torch.distributed."""
