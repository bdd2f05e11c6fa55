"""Mesh axes and their collectives over ``torch.distributed``."""
