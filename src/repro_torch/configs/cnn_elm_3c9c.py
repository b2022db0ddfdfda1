"""The paper's 3c-2s-9c-2s CNN-ELM (Tables 2/3, not-MNIST, 20 classes)."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="cnn-elm-3c9c", family="cnn",
    cnn_channels=(3, 9), cnn_kernel=5, cnn_pool=2,
    image_size=28, image_channels=1, num_classes=20,
    elm_lambda=100.0,
    source="this paper, Table 2/3",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="cnn-elm-3c9c-reduced", cnn_channels=(2, 4))
