"""The fleet mesh's row layout and its collectives over ``torch.distributed``."""
