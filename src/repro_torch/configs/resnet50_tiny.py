"""ResNet50 on Tiny-ImageNet-class data (64x64 images, 200 classes) — the
paper's second model (§IV-A), and RESNET20_SMALL for fast runs.

Port of ``repro/configs/resnet50_tiny.py``.  Pruning protocol per Appendix
B: the stem conv, the block-last convs and the shortcuts are never pruned."""
from repro_torch.models.cnn import RESNET50_TINY as CFG  # noqa: F401
from repro_torch.models.cnn import RESNET20_SMALL as SMOKE_CFG  # noqa: F401
