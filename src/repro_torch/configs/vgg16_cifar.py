"""VGG16 on CIFAR-class data — the paper's own primary model (§IV-A, [21]'s
variation), and the same-family VGG11_SMALL for fast runs.

Port of ``repro/configs/vgg16_cifar.py``: prunable units are conv filters,
importance the BN scaling factors (CIG-BNscalor)."""
from repro_torch.models.cnn import VGG16_CIFAR as CFG  # noqa: F401
from repro_torch.models.cnn import VGG11_SMALL as SMOKE_CFG  # noqa: F401
