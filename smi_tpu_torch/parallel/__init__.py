"""Rank grid and halo exchange over ``torch.distributed``."""
