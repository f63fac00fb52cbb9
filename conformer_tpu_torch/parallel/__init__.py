"""Multi-device training: the ("data", "model") mesh over a
torch.distributed process group and its collectives (counterpart of
conformer_tpu/parallel)."""
